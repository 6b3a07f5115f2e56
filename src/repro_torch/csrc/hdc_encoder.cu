// Demeter n-gram encoder (bind + bundle + majority) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/hdc_encoder.py::_kernel (launched
// by hdc_encode).  One thread owns one (read, word) pair and keeps the
// word's 32 bit counters in registers; a block covers kEncReads reads x
// kEncWords words.  The block stages its slice of the rolled item memory
// (n * A * kEncWords words: 32 KB at n = 16, A = 4) and its reads' tokens
// (as bytes) in shared memory; the TPU kernel's 4-way predicated select
// becomes a shared-memory lookup.
//
// Bound: operations.  Each gram costs n loads + XORs and 32 counter
// updates per word, against 4 bytes of output per word; the design keeps
// all of it in registers and shared memory and writes each encoded word
// once.
#include "hdc_common.cuh"

namespace {

constexpr int kEncWords = 128;  // words per block (threadIdx.x)
constexpr int kEncReads = 2;    // reads per block (threadIdx.y)

__global__ void __launch_bounds__(kEncWords * kEncReads)
hdc_encode_kernel(const int32_t* __restrict__ tokens,
                  const int32_t* __restrict__ lengths,
                  const uint32_t* __restrict__ imr,
                  const uint32_t* __restrict__ tie,
                  uint32_t* __restrict__ out, int B, int L, int n, int A,
                  int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* ims = reinterpret_cast<uint32_t*>(smem);
  uint8_t* toks = smem + static_cast<size_t>(n) * A * kEncWords * 4;

  const int w0 = blockIdx.x * kEncWords;
  const int r0 = blockIdx.y * kEncReads;
  const int tid = threadIdx.y * kEncWords + threadIdx.x;
  constexpr int nthreads = kEncWords * kEncReads;

  demeter::stage_item_memory(ims, imr, n * A, W, w0, kEncWords, tid,
                             nthreads);
  demeter::stage_tokens(toks, tokens, r0, kEncReads, B, L, A, tid, nthreads);
  __syncthreads();

  const int r = r0 + threadIdx.y;
  const int w = w0 + threadIdx.x;
  if (r >= B || w >= W) return;
  const int g = max(L - n + 1, 0);
  const int m = max(lengths[r] - (n - 1), 0);
  out[static_cast<size_t>(r) * W + w] = demeter::encode_word(
      toks + threadIdx.y * L, min(m, g), m, ims, kEncWords, A, n,
      threadIdx.x, tie[w]);
}

}  // namespace

// Shared-memory bytes of one block (the wrapper checks it before launch).
extern "C" long long hdc_encode_smem_bytes(int L, int n, int A) {
  const long long bytes =
      static_cast<long long>(n) * A * kEncWords * 4 +
      static_cast<long long>(kEncReads) * L;
  return (bytes + 15) / 16 * 16;
}

// tokens (B, L) int32, lengths (B,) int32, imr (n, A, W) uint32,
// tie (W,) uint32 -> out (B, W) uint32.  Returns a cudaError_t.
extern "C" int hdc_encode_launch(const int32_t* tokens,
                                 const int32_t* lengths,
                                 const uint32_t* imr, const uint32_t* tie,
                                 uint32_t* out, int B, int L, int n, int A,
                                 int W, void* stream) {
  if (B <= 0 || W <= 0) return 0;
  const long long smem = hdc_encode_smem_bytes(L, n, A);
  if (smem > demeter::kMaxSmemBytes) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      hdc_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((W + kEncWords - 1) / kEncWords,
                  (B + kEncReads - 1) / kEncReads);
  const dim3 block(kEncWords, kEncReads);
  hdc_encode_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      tokens, lengths, imr, tie, out, B, L, n, A, W);
  return cudaGetLastError();
}
