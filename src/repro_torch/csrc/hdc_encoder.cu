// Demeter n-gram encoder (bind + bundle + majority) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/hdc_encoder.py::_kernel (launched
// by hdc_encode).
//
// Bound: integer issue.  The bind and the bundling are 32-bit XOR / logic
// work over every (read, word, gram): 2.68e9 word-grams for a batch of
// 256 windows of 8,192 tokens at W = 1,280.  On compute capability 9.0
// integer add and logic issue at 64 a clock per SM (~16.7 T/s at
// 1.98 GHz); the output is 4 bytes per (read, word).
//
// Design (hdc_common.cuh): one warp encodes a run of 128 consecutive
// words of one read with the rolling word recurrence (a 16-byte pair-table
// load, one shuffle and four XORs a gram per lane) and bit-sliced
// Harley-Seal counters, then decides the majority with a bit-sliced
// comparison: ~6 instructions per word-gram, where binding n item-memory
// words and updating 32 per-bit counters takes ~140.  A block
// covers kEncReads reads x kEncRuns runs; it stages the pair table of its
// kEncRuns * 128 words (16 KB), its reads' tokens (16 to a word) and pair
// ids (8 to a word), and the runs' edge columns in shared memory.
// Alphabets above 4 take hdc_encode_wide_kernel (hdc_common.cuh's wide
// path); the 2-bit kernel is unchanged by it.
#include "hdc_common.cuh"

namespace {

constexpr int kEncRuns = 2;   // runs (of 128 words) per block
constexpr int kEncReads = 4;  // reads per block
constexpr int kThreads = 32 * kEncRuns * kEncReads;
constexpr int kCols = kEncRuns * demeter::kRunWords;

struct Layout {
  int tw, pw;            // words of one read's tokens / pair ids
  long long tbl, edge;   // word offsets of the pair table and edge columns
  long long toks, pairs;
  long long total;       // bytes
};

__host__ __device__ inline Layout layout(int L, int n) {
  Layout s;
  s.tw = demeter::tok_words(L);
  s.pw = demeter::pair_words(L);
  s.tbl = 0;
  s.edge = s.tbl + static_cast<long long>(demeter::kPairs) * kCols;
  s.toks = s.edge + demeter::round16(kEncRuns * n * 4);
  s.pairs = s.toks + static_cast<long long>(kEncReads) * s.tw;
  s.total = (s.pairs + static_cast<long long>(kEncReads) * s.pw) * 4;
  return s;
}

template <int K>
__global__ void __launch_bounds__(kThreads)
hdc_encode_kernel(const int32_t* __restrict__ tokens,
                  const int32_t* __restrict__ lengths,
                  const uint32_t* __restrict__ imr,
                  const uint32_t* __restrict__ tie,
                  uint32_t* __restrict__ out, int B, int L, int n, int A,
                  int W) {
  extern __shared__ __align__(16) uint32_t smem[];
  const Layout lay = layout(L, n);
  uint32_t* tbl = smem + lay.tbl;
  uint32_t* edge = smem + lay.edge;
  uint32_t* toks = smem + lay.toks;
  uint32_t* pairs = smem + lay.pairs;

  const int w0 = blockIdx.x * kCols;
  const int r0 = blockIdx.y * kEncReads;
  const int tid = threadIdx.x;
  demeter::stage_tokens(toks, tokens, r0, kEncReads, B, L, A, lay.tw, tid,
                        kThreads);
  demeter::stage_pair_table(tbl, imr, n, A, W, w0, kCols, tid, kThreads);
  demeter::stage_edges(edge, imr, n, A, W, w0, kEncRuns, tid, kThreads);
  __syncthreads();
  demeter::stage_pairs(pairs, toks, kEncReads, L, n, lay.tw, lay.pw, tid,
                       kThreads);
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  const int rr = warp / kEncRuns, u = warp % kEncRuns;
  const int r = r0 + rr;
  if (r >= B) return;
  const int g = max(L - n + 1, 0);
  const int m = max(lengths[r] - (n - 1), 0);
  const int pos0 = u * demeter::kRunWords + demeter::kLaneWords * lane;
  const int own = min(kCols, W - w0);  // words this block stores
  if (u * demeter::kRunWords >= own) return;
  const uint4 words = demeter::encode_run<K>(
      toks + rr * lay.tw, pairs + rr * lay.pw, tbl, kCols,
      edge + u * n * 4, imr, n, A, W, w0, u, min(m, g), m,
      demeter::tie_words(tie, W, w0, pos0), lane);
  uint32_t* dst = out + static_cast<size_t>(r) * W + w0;
  const uint32_t vals[4] = {words.x, words.y, words.z, words.w};
#pragma unroll
  for (int v = 0; v < demeter::kLaneWords; ++v) {
    if (pos0 + v < own) dst[pos0 + v] = vals[v];
  }
}

template <int K>
cudaError_t launch(const int32_t* tokens, const int32_t* lengths,
                   const uint32_t* imr, const uint32_t* tie, uint32_t* out,
                   int B, int L, int n, int A, int W, long long smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      hdc_encode_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((W + kCols - 1) / kCols, (B + kEncReads - 1) / kEncReads);
  hdc_encode_kernel<K><<<grid, kThreads, smem, stream>>>(
      tokens, lengths, imr, tie, out, B, L, n, A, W);
  return cudaGetLastError();
}

// The wide path (5 <= A <= 65,536; hdc_common.cuh): symbols 2 to a word,
// the F / G tables of the block's 256 words and the runs' (n, A) edge
// columns in shared memory when they fit there (`fg` null), else read
// from the wrapper's global F / G rows (`fg`, row stride wide_table_stride)
// and from imr.
struct WideLayout {
  int tw;
  long long tbl, edge, toks;  // word offsets (tbl, edge unused from global)
  long long total;            // bytes
};

__host__ __device__ inline WideLayout wide_layout(int L, int n, int A,
                                                  bool shared_tables) {
  WideLayout s;
  s.tw = demeter::wide_tok_words(L);
  s.tbl = 0;
  s.edge = s.tbl;
  s.toks = s.tbl;
  if (shared_tables) {
    s.edge = s.tbl + 2LL * A * kCols;
    s.toks = s.edge + demeter::round16(kEncRuns * n * A);
  }
  s.total = (s.toks + static_cast<long long>(kEncReads) * s.tw) * 4;
  return s;
}

template <int K>
__global__ void __launch_bounds__(kThreads)
hdc_encode_wide_kernel(const int32_t* __restrict__ tokens,
                       const int32_t* __restrict__ lengths,
                       const uint32_t* __restrict__ imr,
                       const uint32_t* __restrict__ tie,
                       const uint32_t* __restrict__ fg,
                       uint32_t* __restrict__ out, int B, int L, int n,
                       int A, int W) {
  extern __shared__ __align__(16) uint32_t smem[];
  const bool shared_tables = fg == nullptr;
  const WideLayout lay = wide_layout(L, n, A, shared_tables);
  uint32_t* toks = smem + lay.toks;

  const int w0 = blockIdx.x * kCols;
  const int r0 = blockIdx.y * kEncReads;
  const int tid = threadIdx.x;
  demeter::stage_tokens_wide(toks, tokens, r0, kEncReads, B, L, A, lay.tw,
                             tid, kThreads);
  if (shared_tables) {
    demeter::stage_wide_tables(smem + lay.tbl, imr, n, A, W, w0, kCols, tid,
                               kThreads);
    demeter::stage_wide_edges(smem + lay.edge, imr, n, A, W, w0, kEncRuns,
                              tid, kThreads);
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  const int rr = warp / kEncRuns, u = warp % kEncRuns;
  const int r = r0 + rr;
  if (r >= B) return;
  const int g = max(L - n + 1, 0);
  const int m = max(lengths[r] - (n - 1), 0);
  const int pos0 = u * demeter::kRunWords + demeter::kLaneWords * lane;
  const int own = min(kCols, W - w0);
  if (u * demeter::kRunWords >= own) return;
  const uint4 tie4 = demeter::tie_words(tie, W, w0, pos0);
  uint4 words;
  if (shared_tables) {
    words = demeter::encode_run_wide<K>(
        toks + rr * lay.tw, smem + lay.tbl, kCols,
        smem + lay.edge + u * n * A, A, 1, imr, n, A, W, w0, u, min(m, g), m,
        tie4, lane);
  } else {
    const int we = (w0 + (u + 1) * demeter::kRunWords) % W;
    words = demeter::encode_run_wide<K>(
        toks + rr * lay.tw, fg + w0, demeter::wide_table_stride(W), imr + we,
        static_cast<size_t>(A) * W, W, imr, n, A, W, w0, u, min(m, g), m,
        tie4, lane);
  }
  uint32_t* dst = out + static_cast<size_t>(r) * W + w0;
  const uint32_t vals[4] = {words.x, words.y, words.z, words.w};
#pragma unroll
  for (int v = 0; v < demeter::kLaneWords; ++v) {
    if (pos0 + v < own) dst[pos0 + v] = vals[v];
  }
}

template <int K>
cudaError_t launch_wide(const int32_t* tokens, const int32_t* lengths,
                        const uint32_t* imr, const uint32_t* tie,
                        const uint32_t* fg, uint32_t* out, int B, int L,
                        int n, int A, int W, long long smem,
                        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      hdc_encode_wide_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((W + kCols - 1) / kCols, (B + kEncReads - 1) / kEncReads);
  hdc_encode_wide_kernel<K><<<grid, kThreads, smem, stream>>>(
      tokens, lengths, imr, tie, fg, out, B, L, n, A, W);
  return cudaGetLastError();
}

}  // namespace

// Shared-memory bytes of one block (the wrapper checks it before launch).
// A <= 4 stages 2-bit symbols and ignores shared_tables; a wider alphabet
// counts its F / G tables and edge columns when shared_tables is nonzero.
extern "C" long long hdc_encode_smem_bytes(int L, int n, int A,
                                           int shared_tables) {
  if (A <= 4) return layout(L, n).total;
  return wide_layout(L, n, A, shared_tables != 0).total;
}

// tokens (B, L) int32, lengths (B,) int32, imr (n, A, W) uint32 with
// 1 <= A <= 65,536, tie (W,) uint32 -> out (B, W) uint32.  For A > 4, fg
// is null (the F / G tables in shared memory) or the (2A, Wx) global
// tables, Wx = wide_table_stride(W): fg[a][x] = imr[0][a][(x + 1) mod W],
// fg[A + b][x] = imr[n-1][b][x mod W].  Returns a cudaError_t.
extern "C" int hdc_encode_launch(const int32_t* tokens,
                                 const int32_t* lengths,
                                 const uint32_t* imr, const uint32_t* tie,
                                 const uint32_t* fg, uint32_t* out, int B,
                                 int L, int n, int A, int W, void* stream) {
  if (B <= 0 || W <= 0) return 0;
  const int g = L - n + 1 > 0 ? L - n + 1 : 0;
  if (A < 1 || A > demeter::kMaxAlphabet || n < 1 || g > demeter::kMaxGrams) {
    return cudaErrorInvalidValue;
  }
  const long long smem = hdc_encode_smem_bytes(L, n, A, fg == nullptr);
  if (smem > demeter::kMaxSmemBytes) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (A > 4) {
    switch (demeter::planes_for(g)) {
      case 8: return launch_wide<8>(tokens, lengths, imr, tie, fg, out, B, L,
                                    n, A, W, smem, st);
      case 14: return launch_wide<14>(tokens, lengths, imr, tie, fg, out, B,
                                      L, n, A, W, smem, st);
      default: return launch_wide<20>(tokens, lengths, imr, tie, fg, out, B,
                                      L, n, A, W, smem, st);
    }
  }
  switch (demeter::planes_for(g)) {
    case 8: return launch<8>(tokens, lengths, imr, tie, out, B, L, n, A, W,
                             smem, st);
    case 14: return launch<14>(tokens, lengths, imr, tie, out, B, L, n, A, W,
                               smem, st);
    default: return launch<20>(tokens, lengths, imr, tie, out, B, L, n, A, W,
                               smem, st);
  }
}
