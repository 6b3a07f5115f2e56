// Fused encode->search for Hopper (sm_90a): read tokens -> agreement
// (dim - Hamming distance) against every prototype, with the encoded
// reads kept in shared memory.
//
// Replaces the TPU kernels repro/kernels/fused_profile.py::_kernel and its
// double-buffered twin _kernel_dma (launched by fused_profile).  The TPU
// grid puts the prototype-chunk axis outermost and re-encodes the batch
// tile once per chunk; here every read is encoded once per cluster.
//
// Bound.  At the main path's shapes (B = 256, S ~ 9.8k, D = 40,960) the
// search is B * S * D = 1.0e11 bit agreements.  On the tensor cores that
// is 3.1e6 mma.sync m16n8k256 b1 instructions, measured to issue at ~0.47
// a clock per SM (8.1e15 operations/s counting an AND and an add a bit,
// about 4x the int8 peak; tools/search_mma_probe.py), so the products
// alone take ~0.025 ms: the least time for this work.  The `__popc`
// search it replaces ran at ~80 % of the popc pipe (16 a clock per SM).
// What is left is the prototype stream: each read tile reads its share of
// the AM (S * W * 4 bytes, ~50 MB) from L2, so larger read tiles mean
// fewer L2 bytes.  The encode is ~6 integer instructions per
// word-gram (hdc_common.cuh), ~0.02 ms of work a launch.
//
// Design.  A thread-block cluster of C blocks owns a tile of BB = 16 * MT
// reads (one or two m16 row blocks of the mma; bb = 16 or 32) and a 1/P
// share of the prototypes (P clusters per tile, chosen from the SM count
// to fill the card).  Rows of a tail tile past B are neither encoded nor
// written.
//   1. Encode: block `rank` encodes words [rank * span, (rank + 1) * span)
//      of the BB reads with the encoder kernel's warp-run routine into its
//      own shared memory.
//   2. Share: after a cluster barrier each block copies the other ranks'
//      words through distributed shared memory, so every block holds the
//      whole (BB, W) encoded tile.  It never reaches global memory.
//   3. Search: block `rank` scores the tile against its 1/(P C) of the
//      prototypes on the tensor cores.  A warp takes 16 prototypes at a
//      time and walks W in steps of 32 words; each step's (16, 32)-word
//      prototype tile arrives through the warp's own cp.async ring, and
//      feeds 4 * MT * 2 mma.sync m16n8k256 .and.popc with the read tile's
//      fragments from shared memory.  agreement = D - |a| - |b| +
//      2 popc(a & b): the row popcounts |a| come from the tile, |b| from a
//      row-popcount pass over the prototypes launched just before.
// The sums are integers below 2^31, so the result is exact.
//
// Fragment mapping (checked on the card by tools/search_mma_probe.py):
// thread (g = lane / 4, t = lane % 4) supplies words 8 t + 2 s and
// 8 t + 2 s + 1 of a 32-word step as a0/a2 (read row g), a1/a3 (row
// g + 8) and b0/b1 (prototype g) of the s-th mma; the words of both
// operands pair up, so each step sums popc(a & b) over all 32 words.
// Shared rows are 32-word multiples with 16-byte chunks XOR-swizzled by
// row parity (word w of row r at w ^ 4 (r & 1)), so the 16-byte
// fragment loads of a quarter warp hit distinct banks.
//
// Inert padding: words past W of the encoded rows are zero, and the
// prototype rows are padded with zero words to a multiple of 32 words, so
// pad words add nothing to popc(a & b); rows past B are never written, so
// what their tile rows hold does not matter.
#include <cooperative_groups.h>

#include "hdc_common.cuh"
#include "mma_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace mma;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kGroupProtos = 16;         // prototypes per warp group
constexpr int kStageWords = kGroupProtos * kStepWords;

// Prototype ring stages per warp: deeper where shared memory allows.
__host__ __device__ constexpr int ring_stages(int mt) {
  return mt == 1 ? 4 : 2;
}

__host__ __device__ inline int steps_of(int W) {
  return (W + kStepWords - 1) / kStepWords;
}

struct Layout {
  int qs;                 // encoded row stride in words (multiple of 32)
  int span, runs, cols;   // this rank's words, its runs, table columns
  int tw, pw;
  long long q, ra, scratch;        // word offsets
  long long tbl, edge, toks, pairs;  // in the scratch (encode phase)
  long long total;                 // bytes
};

__host__ __device__ inline Layout layout(int rows, int cluster, int L, int n,
                                         int W) {
  Layout s;
  s.qs = steps_of(W) * kStepWords;
  s.span = (W + cluster - 1) / cluster;
  s.runs = (s.span + demeter::kRunWords - 1) / demeter::kRunWords;
  s.cols = s.runs * demeter::kRunWords;
  s.tw = demeter::tok_words(L);
  s.pw = demeter::pair_words(L);
  s.q = 0;
  s.ra = s.q + static_cast<long long>(rows) * s.qs;
  s.scratch = s.ra + demeter::round16(rows);
  s.tbl = s.scratch;
  s.edge = s.tbl + static_cast<long long>(demeter::kPairs) * s.cols;
  s.toks = s.edge + demeter::round16(s.runs * n * 4);
  s.pairs = s.toks + static_cast<long long>(rows) * s.tw;
  const long long enc = s.pairs + static_cast<long long>(rows) * s.pw;
  const long long ring =
      s.scratch + static_cast<long long>(kWarps) * ring_stages(rows / 16) *
                      kStageWords;
  s.total = (enc > ring ? enc : ring) * 4;
  return s;
}

// Stages 16 prototype rows [pbase, pbase + 16) x words [32 ks, 32 ks + 32)
// into one ring slot (rows at or past pend are zero-filled).
__device__ __forceinline__ void issue_step(uint32_t* slot,
                                           const uint32_t* __restrict__ protos,
                                           int Wp, int pbase, int pend,
                                           int ks, int lane) {
  stage_step<1, true, true>(slot, protos, Wp, pbase, kGroupProtos, pend,
                            ks * kStepWords, Wp, lane, 32);
}

template <int MT>
__device__ __forceinline__ void search_group(
    const uint32_t* __restrict__ q, int qs, const int32_t* ra,
    uint32_t* ring, const uint32_t* __restrict__ protos, int Wp,
    const int32_t* __restrict__ pc, int32_t* __restrict__ out, int r0,
    int rend, int S, int W, int dim, int pbase, int pend, int lane) {
  constexpr int NS = ring_stages(MT);
  const int g = lane >> 2, t = lane & 3;
  const int nks = steps_of(W);
  int acc[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;

#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < nks) issue_step(ring + s * kStageWords, protos, Wp, pbase, pend,
                            s, lane);
    cp_async_commit();
  }
  // Chunk offsets of this thread's words 8 t .. 8 t + 7 in a swizzled row
  // of parity g & 1 (rows g and g + 8 share it).
  const int lo = ((2 * t) ^ (g & 1)) << 2;
  const int hi = ((2 * t + 1) ^ (g & 1)) << 2;
  for (int ks = 0; ks < nks; ++ks) {
    const int nx = ks + NS - 1;
    if (nx < nks) issue_step(ring + (nx % NS) * kStageWords, protos, Wp,
                             pbase, pend, nx, lane);
    cp_async_commit();
    cp_async_wait<NS - 1>();
    __syncwarp();
    const uint32_t* slot = ring + (ks % NS) * kStageWords;
    uint4 b[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const uint32_t* row = slot + (nt * 8 + g) * kStepWords;
      b[nt][0] = *reinterpret_cast<const uint4*>(row + lo);
      b[nt][1] = *reinterpret_cast<const uint4*>(row + hi);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const uint32_t* rg = q + (mt * 16 + g) * qs + ks * kStepWords;
      const uint32_t* rg8 = rg + 8 * qs;
      const uint4 ag[2] = {*reinterpret_cast<const uint4*>(rg + lo),
                           *reinterpret_cast<const uint4*>(rg + hi)};
      const uint4 ag8[2] = {*reinterpret_cast<const uint4*>(rg8 + lo),
                            *reinterpret_cast<const uint4*>(rg8 + hi)};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          mma_and_popc(acc[mt][nt], ag[h].x, ag8[h].x, ag[h].y, ag8[h].y,
                       b[nt][h].x, b[nt][h].y);
          mma_and_popc(acc[mt][nt], ag[h].z, ag8[h].z, ag[h].w, ag8[h].w,
                       b[nt][h].z, b[nt][h].w);
        }
      }
    }
    __syncwarp();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int rr = mt * 16 + g + 8 * half;
      const int r = r0 + rr;
      if (r >= rend) continue;
      const int base = dim - ra[rr];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int p = pbase + nt * 8 + 2 * t + i;
          if (p < pend) {
            out[static_cast<size_t>(r) * S + p] =
                base - __ldg(pc + p) + 2 * acc[mt][nt][2 * half + i];
          }
        }
      }
    }
  }
}

template <int MT, int K>
__global__ void __launch_bounds__(kThreads, 1)
fused_profile_kernel(const int32_t* __restrict__ tokens,
                     const int32_t* __restrict__ lengths,
                     const uint32_t* __restrict__ imr,
                     const uint32_t* __restrict__ tie,
                     const uint32_t* __restrict__ protos,
                     const int32_t* __restrict__ pc,
                     int32_t* __restrict__ out, int B, int L, int n, int A,
                     int W, int Wp, int S, int dim) {
  constexpr int BB = 16 * MT;  // reads of the tile
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int C = static_cast<int>(cluster.num_blocks());
  const Layout lay = layout(BB, C, L, n, W);

  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* q = smem + lay.q;
  int32_t* ra = reinterpret_cast<int32_t*>(smem + lay.ra);
  uint32_t* tbl = smem + lay.tbl;
  uint32_t* edge = smem + lay.edge;
  uint32_t* toks = smem + lay.toks;
  uint32_t* pairs = smem + lay.pairs;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = blockIdx.y * BB;
  const int rend = min(B, r0 + BB);  // reads of this tile end here
  const int w0 = rank * lay.span;
  const int own = max(min(lay.span, W - w0), 0);

  // -- 1. encode this rank's words of the BB reads ------------------------
  demeter::stage_tokens(toks, tokens, r0, BB, rend, L, A, lay.tw, tid,
                        kThreads);
  if (own > 0) {
    demeter::stage_pair_table(tbl, imr, n, A, W, w0, lay.cols, tid, kThreads);
    demeter::stage_edges(edge, imr, n, A, W, w0, lay.runs, tid, kThreads);
  }
  for (int k = tid; k < BB * (lay.qs - W); k += kThreads) {
    const int rr = k / (lay.qs - W);
    q[rr * lay.qs + swz(rr, W + k - rr * (lay.qs - W))] = 0u;
  }
  __syncthreads();
  demeter::stage_pairs(pairs, toks, BB, L, n, lay.tw, lay.pw, tid, kThreads);
  __syncthreads();
  const int g = max(L - n + 1, 0);
  for (int task = warp; task < BB * lay.runs; task += kWarps) {
    const int rr = task / lay.runs, u = task - rr * lay.runs;
    const int r = r0 + rr;
    if (r >= rend || u * demeter::kRunWords >= own) continue;
    const int m = max(lengths[r] - (n - 1), 0);
    const int pos0 = u * demeter::kRunWords + demeter::kLaneWords * lane;
    const uint4 words = demeter::encode_run<K>(
        toks + rr * lay.tw, pairs + rr * lay.pw, tbl, lay.cols,
        edge + u * n * 4, imr, n, A, W, w0, u, min(m, g), m,
        demeter::tie_words(tie, W, w0, pos0), lane);
    const uint32_t vals[4] = {words.x, words.y, words.z, words.w};
#pragma unroll
    for (int v = 0; v < demeter::kLaneWords; ++v) {
      if (pos0 + v < own) q[rr * lay.qs + swz(rr, w0 + pos0 + v)] = vals[v];
    }
  }

  // -- 2. gather the other ranks' words through distributed smem ----------
  cluster.sync();
  for (int other = 1; other < C; ++other) {
    const int src = (rank + other) % C;
    const uint32_t* remote = cluster.map_shared_rank(q, src);
    const int s0 = src * lay.span;
    const int cnt = max(min(lay.span, W - s0), 0);
    for (int k = tid; k < BB * cnt; k += kThreads) {
      const int rr = k / cnt;
      const int idx = rr * lay.qs + swz(rr, s0 + k - rr * cnt);
      q[idx] = remote[idx];
    }
  }
  cluster.sync();  // no block leaves while another still reads its smem

  // -- 3. row popcounts of the tile, then the tensor-core search ----------
  for (int rr = warp; rr < BB; rr += kWarps) {
    int c = 0;
    for (int w = lane; w < lay.qs; w += 32) c += __popc(q[rr * lay.qs + w]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      c += __shfl_xor_sync(demeter::kFull, c, off);
    }
    if (lane == 0) ra[rr] = c;
  }
  __syncthreads();

  const int parts = static_cast<int>(gridDim.z) * C;
  const int part = static_cast<int>(blockIdx.z) * C + rank;
  const int per = ((S + parts - 1) / parts + kGroupProtos - 1) /
                  kGroupProtos * kGroupProtos;
  const int p0 = part * per;
  const int p1 = min(S, p0 + per);
  uint32_t* ring = smem + lay.scratch +
                   static_cast<long long>(warp) * ring_stages(MT) *
                       kStageWords;
  for (int pb = p0 + warp * kGroupProtos; pb < p1;
       pb += kWarps * kGroupProtos) {
    search_group<MT>(q, lay.qs, ra, ring, protos, Wp, pc, out, r0, rend, S,
                     W, dim, pb, min(p1, pb + kGroupProtos), lane);
  }
}

void launch_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                   dim3 grid, long long smem, cudaStream_t stream) {
  cfg->gridDim = grid;
  cfg->blockDim = dim3(kThreads, 1, 1);
  cfg->dynamicSmemBytes = static_cast<size_t>(smem);
  cfg->stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = grid.x;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

template <int MT, int K>
cudaError_t launch(const int32_t* tokens, const int32_t* lengths,
                   const uint32_t* imr, const uint32_t* tie,
                   const uint32_t* protos, int32_t* pc, int32_t* out, int B,
                   int L, int n, int A, int W, int Wp, int S, int dim,
                   int cluster, cudaStream_t stream) {
  const Layout lay = layout(16 * MT, cluster, L, n, W);
  if (lay.total > demeter::kMaxSmemBytes) return cudaErrorInvalidValue;
  auto kernel = fused_profile_kernel<MT, K>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(lay.total));
  if (err != cudaSuccess) return err;

  err = launch_row_popcount(protos, Wp, Wp, S, pc, stream);
  if (err != cudaSuccess) return err;

  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int tiles = (B + 16 * MT - 1) / (16 * MT);
  int splits = sms / (tiles * cluster);
  splits = splits < 1 ? 1 : (splits > 65535 ? 65535 : splits);

  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  launch_config(&cfg, attr, dim3(cluster, tiles, splits), lay.total, stream);
  err = cudaLaunchKernelEx(&cfg, kernel, tokens, lengths, imr, tie, protos,
                           static_cast<const int32_t*>(pc), out, B, L, n, A,
                           W, Wp, S, dim);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int MT>
cudaError_t launch_planes(const int32_t* tokens, const int32_t* lengths,
                          const uint32_t* imr, const uint32_t* tie,
                          const uint32_t* protos, int32_t* pc, int32_t* out,
                          int B, int L, int n, int A, int W, int Wp, int S,
                          int dim, int cluster, cudaStream_t st) {
  const int g = L - n + 1 > 0 ? L - n + 1 : 0;
  switch (demeter::planes_for(g)) {
    case 8: return launch<MT, 8>(tokens, lengths, imr, tie, protos, pc, out,
                                 B, L, n, A, W, Wp, S, dim, cluster, st);
    case 14: return launch<MT, 14>(tokens, lengths, imr, tie, protos, pc, out,
                                   B, L, n, A, W, Wp, S, dim, cluster, st);
    default: return launch<MT, 20>(tokens, lengths, imr, tie, protos, pc, out,
                                   B, L, n, A, W, Wp, S, dim, cluster, st);
  }
}

}  // namespace

// Shared-memory bytes of one block at bb = 16 or 32 reads a tile (mirrored
// by repro_torch.kernels.fused_profile.smem_bytes), or -1 for another bb.
extern "C" long long fused_profile_smem_bytes(int bb, int cluster, int L,
                                              int n, int A, int W) {
  (void)A;
  if (bb != 16 && bb != 32) return -1;
  return layout(bb, cluster, L, n, W).total;
}

// Clusters of this tiling the card can hold at once (reads of 150 tokens
// or shorter use the 8-plane kernel), or -1 on a CUDA error: a diagnostic
// for the tiling sweep.
extern "C" int fused_profile_max_active_clusters(int bb, int cluster, int L,
                                                 int n, int W) {
  if (bb != 16 && bb != 32) return -1;
  const Layout lay = layout(bb, cluster, L, n, W);
  auto kernel =
      bb == 32 ? fused_profile_kernel<2, 8> : fused_profile_kernel<1, 8>;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(lay.total)) != cudaSuccess) {
    return -1;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  launch_config(&cfg, attr, dim3(cluster, 1, 1), lay.total, nullptr);
  int count = 0;
  return cudaOccupancyMaxActiveClusters(&count, kernel, &cfg) == cudaSuccess
             ? count
             : -1;
}

// tokens (B, L) int32, lengths (B,) int32, imr (n, A, W) uint32 with
// A <= 4 (symbols outside [0, A) are clamped into it), tie (W,) uint32,
// protos (S, Wp) uint32 with Wp = ceil(W / 32) * 32 (zero pad words,
// 16-byte aligned rows), pc (S,) int32 scratch for the prototypes'
// popcounts -> out (B, S) int32.  bb (reads per tile) is 16 or 32,
// cluster 1, 2, 4 or 8.  Returns a cudaError_t.
extern "C" int fused_profile_launch(const int32_t* tokens,
                                    const int32_t* lengths,
                                    const uint32_t* imr, const uint32_t* tie,
                                    const uint32_t* protos, int32_t* pc,
                                    int32_t* out, int B, int L, int n, int A,
                                    int W, int S, int dim, int bb,
                                    int cluster, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  const int g = L - n + 1 > 0 ? L - n + 1 : 0;
  if (cluster < 1 || cluster > 8 || A < 1 || A > 4 || n < 1 ||
      g > demeter::kMaxGrams) {
    return cudaErrorInvalidValue;
  }
  const int Wp = steps_of(W) * kStepWords;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bb) {
    case 16:
      return launch_planes<1>(tokens, lengths, imr, tie, protos, pc, out, B,
                              L, n, A, W, Wp, S, dim, cluster, st);
    case 32:
      return launch_planes<2>(tokens, lengths, imr, tie, protos, pc, out, B,
                              L, n, A, W, Wp, S, dim, cluster, st);
    default: return cudaErrorInvalidValue;
  }
}
