// Fused encode->search for Hopper (sm_90a): read tokens -> agreement
// (dim - Hamming distance) against every prototype, with the encoded
// reads kept in shared memory.
//
// Replaces the TPU kernels repro/kernels/fused_profile.py::_kernel and its
// double-buffered twin _kernel_dma (launched by fused_profile).  The TPU
// grid puts the prototype-chunk axis outermost and re-encodes the batch
// tile once per chunk; here every read is encoded exactly once per launch.
//
// Design.  A thread-block cluster of C blocks owns a tile of BB reads.
//   1. Encode: block `rank` encodes words [rank * span, (rank + 1) * span)
//      of the BB reads (the same per-word math as the encoder kernel) into
//      its own shared memory, from its shared-memory slice of the rolled
//      item memory.
//   2. Share: after a cluster barrier each block copies the other ranks'
//      words through distributed shared memory, so every block holds the
//      whole (BB, W) encoded tile.  It never reaches global memory.
//   3. Search: block `rank` scores the tile against its 1/C share of the
//      prototypes.  A warp takes one prototype at a time; its lanes stride
//      over 16-byte chunks of the row, XOR them with the BB encoded rows,
//      popcount, and reduce over the warp.
// C blocks per tile keep B/BB*C blocks in flight (512 at B = 256, BB = 4,
// C = 8) while each read is encoded once and the prototypes are read once
// per tile.
//
// Bound.  At the main path's shapes (B = 256, S ~ 9.8k, W = 1280) the
// search dominates: B * S * W word XOR + popcount + add, with the AM
// (S * W * 4 bytes, ~50 MB) read once per read tile, mostly from L2.
// Encoding costs ~B * 135 grams * W * (n + 32) operations.  The design
// streams each prototype word once per tile and reuses it for BB reads
// from registers.
//
// Inert padding: words past W of the encoded rows are zero, and the
// prototype rows are padded with zero words to a multiple of 4 words, so
// pad words add nothing to the Hamming distance; rows past B are never
// written.
#include <cooperative_groups.h>

#include "hdc_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

struct Layout {
  long long q_words;    // BB * W4 * 4 encoded words (16-byte aligned rows)
  long long im_words;   // n * A * span item-memory words
  long long tok_bytes;  // BB * L token bytes
  long long total;
};

__host__ __device__ inline Layout layout(int bb, int cluster, int L, int n,
                                         int A, int W) {
  const int w4 = (W + 3) / 4;
  const int span = (W + cluster - 1) / cluster;
  Layout s;
  s.q_words = static_cast<long long>(bb) * w4 * 4;
  s.im_words = static_cast<long long>(n) * A * span;
  s.tok_bytes = static_cast<long long>(bb) * L;
  s.total = ((s.q_words + s.im_words) * 4 + s.tok_bytes + 15) / 16 * 16;
  return s;
}

template <int BB>
__global__ void __launch_bounds__(kThreads)
fused_profile_kernel(const int32_t* __restrict__ tokens,
                     const int32_t* __restrict__ lengths,
                     const uint32_t* __restrict__ imr,
                     const uint32_t* __restrict__ tie,
                     const uint4* __restrict__ protos,
                     int32_t* __restrict__ out, int B, int L, int n, int A,
                     int W, int S, int dim) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int C = static_cast<int>(cluster.num_blocks());
  const int w4 = (W + 3) / 4;
  const int row_words = w4 * 4;
  const int span = (W + C - 1) / C;
  const Layout lay = layout(BB, C, L, n, A, W);

  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* q = reinterpret_cast<uint32_t*>(smem);
  uint32_t* ims = q + lay.q_words;
  uint8_t* toks = reinterpret_cast<uint8_t*>(ims + lay.im_words);

  const int tid = threadIdx.x;
  const int r0 = blockIdx.y * BB;
  const int w0 = rank * span;
  const int own = max(min(span, W - w0), 0);

  // -- 1. encode this rank's words of the BB reads ------------------------
  demeter::stage_item_memory(ims, imr, n * A, W, w0, span, tid, kThreads);
  demeter::stage_tokens(toks, tokens, r0, BB, B, L, A, tid, kThreads);
  for (int k = tid; k < BB * (row_words - W); k += kThreads) {
    const int rr = k / (row_words - W);
    q[rr * row_words + W + (k - rr * (row_words - W))] = 0u;
  }
  __syncthreads();
  const int g = max(L - n + 1, 0);
  for (int p = tid; p < BB * own; p += kThreads) {
    const int rr = p / own;
    const int wl = p - rr * own;
    const int r = r0 + rr;
    const int m = r < B ? max(lengths[r] - (n - 1), 0) : 0;
    q[rr * row_words + w0 + wl] = demeter::encode_word(
        toks + rr * L, min(m, g), m, ims, span, A, n, wl, tie[w0 + wl]);
  }

  // -- 2. gather the other ranks' words through distributed smem ----------
  cluster.sync();
  for (int other = 1; other < C; ++other) {
    const int src = (rank + other) % C;
    const uint32_t* remote = cluster.map_shared_rank(q, src);
    const int s0 = src * span;
    const int cnt = max(min(span, W - s0), 0);
    for (int k = tid; k < BB * cnt; k += kThreads) {
      const int rr = k / cnt;
      const int idx = rr * row_words + s0 + (k - rr * cnt);
      q[idx] = remote[idx];
    }
  }
  cluster.sync();  // no block leaves while another still reads its smem

  // -- 3. search this rank's share of the prototypes ----------------------
  const int per = (S + C - 1) / C;
  const int p0 = rank * per;
  const int p1 = min(S, p0 + per);
  const int warp = tid / 32;
  const int lane = tid % 32;
  const uint4* q4 = reinterpret_cast<const uint4*>(q);
  for (int p = p0 + warp; p < p1; p += kWarps) {
    int acc[BB];
#pragma unroll
    for (int rr = 0; rr < BB; ++rr) acc[rr] = 0;
    const uint4* prow = protos + static_cast<size_t>(p) * w4;
    for (int c = lane; c < w4; c += 32) {
      const uint4 pv = __ldg(prow + c);
#pragma unroll
      for (int rr = 0; rr < BB; ++rr) {
        const uint4 qv = q4[rr * w4 + c];
        acc[rr] += __popc(pv.x ^ qv.x) + __popc(pv.y ^ qv.y) +
                   __popc(pv.z ^ qv.z) + __popc(pv.w ^ qv.w);
      }
    }
    int mine = 0;
#pragma unroll
    for (int rr = 0; rr < BB; ++rr) {
      int v = acc[rr];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        v += __shfl_xor_sync(0xffffffffu, v, off);
      }
      if (lane == rr) mine = v;
    }
    if (lane < BB && r0 + lane < B) {
      out[static_cast<size_t>(r0 + lane) * S + p] = dim - mine;
    }
  }
}

template <int BB>
cudaError_t launch(const int32_t* tokens, const int32_t* lengths,
                   const uint32_t* imr, const uint32_t* tie,
                   const uint32_t* protos, int32_t* out, int B, int L, int n,
                   int A, int W, int S, int dim, int cluster,
                   cudaStream_t stream) {
  const Layout lay = layout(BB, cluster, L, n, A, W);
  if (lay.total > demeter::kMaxSmemBytes) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_profile_kernel<BB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(lay.total));
  if (err != cudaSuccess) return err;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, (B + BB - 1) / BB, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(lay.total);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fused_profile_kernel<BB>, tokens, lengths,
                           imr, tie, reinterpret_cast<const uint4*>(protos),
                           out, B, L, n, A, W, S, dim);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Shared-memory bytes of one block (mirrored by
// repro_torch.kernels.fused_profile.smem_bytes).
extern "C" long long fused_profile_smem_bytes(int bb, int cluster, int L,
                                              int n, int A, int W) {
  return layout(bb, cluster, L, n, A, W).total;
}

// tokens (B, L) int32, lengths (B,) int32, imr (n, A, W) uint32,
// tie (W,) uint32, protos (S, ceil(W / 4) * 4) uint32 with zero pad words
// and 16-byte aligned rows -> out (B, S) int32.  bb in {1, 2, 4, 8, 16},
// cluster in {1, 2, 4, 8}.  Returns a cudaError_t.
extern "C" int fused_profile_launch(const int32_t* tokens,
                                    const int32_t* lengths,
                                    const uint32_t* imr, const uint32_t* tie,
                                    const uint32_t* protos, int32_t* out,
                                    int B, int L, int n, int A, int W, int S,
                                    int dim, int bb, int cluster,
                                    void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (cluster < 1 || cluster > 8) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bb) {
    case 1: return launch<1>(tokens, lengths, imr, tie, protos, out, B, L, n,
                             A, W, S, dim, cluster, st);
    case 2: return launch<2>(tokens, lengths, imr, tie, protos, out, B, L, n,
                             A, W, S, dim, cluster, st);
    case 4: return launch<4>(tokens, lengths, imr, tie, protos, out, B, L, n,
                             A, W, S, dim, cluster, st);
    case 8: return launch<8>(tokens, lengths, imr, tie, protos, out, B, L, n,
                             A, W, S, dim, cluster, st);
    case 16: return launch<16>(tokens, lengths, imr, tie, protos, out, B, L,
                               n, A, W, S, dim, cluster, st);
    default: return cudaErrorInvalidValue;
  }
}
