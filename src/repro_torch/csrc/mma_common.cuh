// Shared device code of the three search kernels (fused_profile.cu,
// hamming_am.cu, am_matmul.cu): cp.async staging, the b1 mma, the +-1
// expansion of packed words, the row popcounts of the b1 search and the
// slab tiling of the standalone searches (am_matmul.cu takes only its
// slab width; its wgmma code is in wgmma_common.cuh).
//
// Packed HD vectors are uint32 words, LSB-first; a b1 search step covers
// 32 words of every row, staged in shared memory as 32-word rows of eight
// 16-byte chunks.  Chunk c of row r sits at chunk c ^ (r & kMask); with
// kMask = 1 (the b1 layout) thread (g = lane / 4, t = lane % 4) loads
// chunks 2t and 2t + 1 of rows g and g + 8, so a quarter warp (rows g,
// g + 1, all t) hits 8 distinct chunks, all 32 banks.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

namespace mma {

constexpr int kStepWords = 32;  // words of a row per search step

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copies `bytes` (0..16) of src to 16 bytes at dst, zero-filling the rest.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}

// Copies `bytes` (0 or 4) of src to 4 bytes at dst, zero-filling the rest.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Word w of row r of the b1 layout (kMask = 1).
__device__ __forceinline__ int swz(int r, int w) { return w ^ ((r & 1) << 2); }

// c += popc(a & b) over a 16 x 256-bit row block and 8 256-bit columns:
// a0/a2 hold words of row g, a1/a3 of row g + 8, b0/b1 of column g.
// Volatile asm, as the fused kernel was measured with: the b1 mmas keep
// their program order.
__device__ __forceinline__ void mma_and_popc(int (&c)[4], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Four +-1 int8 from the top bit of each byte of z: 0x01 (+1) where the
// bit is 0, 0xFF (-1) where it is 1.  prmt's sign mode (selector nibbles
// 8..B) replicates each byte's top bit over the byte; the OR sets bit 0.
__device__ __forceinline__ uint32_t pm1_of_top_bits(uint32_t z) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(r) : "r"(z), "r"(0u),
      "r"(0xBA98u));
  return r | 0x01010101u;
}

// Stages rows [row0, row0 + rows) x words [w0, w0 + 32) of a uint32
// matrix with row stride ld into dst (rows x 32 words, chunk c of row r at
// chunk c ^ (r & kMask)).  Rows at or past rend and words at or past W
// are zero.  kVec: W and ld are multiples of 4 and src is 16-byte
// aligned, so a chunk is wholly inside or outside a row; else words are
// copied one by one.  kFullSteps: W is a multiple of 32 (the fused
// kernel's padded prototype rows), so no word is past W.
template <int kMask, bool kVec, bool kFullSteps = false>
__device__ __forceinline__ void stage_step(uint32_t* dst,
                                           const uint32_t* __restrict__ src,
                                           int ld, int row0, int rows,
                                           int rend, int w0, int W, int tid,
                                           int nthreads) {
#pragma unroll
  for (int c = tid; c < rows * 8; c += nthreads) {
    const int r = c >> 3, part = c & 7;
    const int gr = row0 + r, gw = w0 + part * 4;
    uint32_t* d = dst + r * kStepWords + ((part ^ (r & kMask)) << 2);
    // Rows past rend read row row0 (in bounds) and copy nothing.
    const uint32_t* s =
        src + static_cast<size_t>(gr < rend ? gr : row0) * ld;
    if constexpr (kFullSteps) {
      cp_async16(d, s + gw, gr < rend ? 16 : 0);
    } else if constexpr (kVec) {
      const bool in = gr < rend && gw < W;
      cp_async16(d, s + (in ? gw : 0), in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = gr < rend && gw + e < W;
        cp_async4(d + e, s + (in ? gw + e : 0), in ? 4 : 0);
      }
    }
  }
}

// pc[row] = popcount of words [0, W) of each row (stride ld), a warp a row.
__global__ void row_popcount_kernel(const uint32_t* __restrict__ src, int ld,
                                    int W, int rows,
                                    int32_t* __restrict__ pc) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const uint32_t* p = src + static_cast<size_t>(row) * ld;
  int c = 0;
  for (int w = lane; w < W; w += 32) c += __popc(__ldg(p + w));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    c += __shfl_xor_sync(0xffffffffu, c, off);
  }
  if (lane == 0) pc[row] = c;
}

// The SM count of the current device.
inline cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// Word e (0..3) of a 16-byte chunk (e is a constant once unrolled).
__device__ __forceinline__ uint32_t word_of(const uint4& v, int e) {
  return e == 0 ? v.x : (e == 1 ? v.y : (e == 2 ? v.z : v.w));
}

inline cudaError_t launch_row_popcount(const uint32_t* src, int ld, int W,
                                       int rows, int32_t* pc,
                                       cudaStream_t stream) {
  row_popcount_kernel<<<(rows + 7) / 8, 256, 0, stream>>>(src, ld, W, rows,
                                                          pc);
  return cudaGetLastError();
}

// -- the slab tiling of hamming_am (and the slab width of am_matmul) -------
//
// A block owns all kRows queries of its query tile (the whole batch at
// B <= 256) and a slab of 16 NT prototypes, and walks W in 32-word steps
// through a kStages-deep cp.async ring holding both tiles.  Its 8
// warps are 4 (queries, 64 rows: 4 m16 tiles) x 2 (prototypes, NT n8
// tiles).  So each prototype word is read from device memory once a
// launch and the packed query tile (1.3 MB at B = 256, W = 1,280) once a
// block, mostly from L2.
namespace slab {

constexpr int kThreads = 256;
constexpr int kWarpsN = 2;
constexpr int kRows = 256;      // queries a block
constexpr int kStages = 4;
constexpr int kMinNT = 2, kMaxNT = 6;

__host__ __device__ constexpr int protos(int nt) { return kWarpsN * 8 * nt; }

__host__ __device__ constexpr int stage_words(int nt) {
  return (kRows + protos(nt)) * kStepWords;
}

__host__ __device__ constexpr int smem_bytes(int nt) {
  return kStages * stage_words(nt) * 4;
}

// The n8 tiles a warp takes: the NT whose grid finishes first on `sms`
// SMs, one block an SM (a block of NT takes time ~ NT; ties go to the
// larger slab, which re-reads the query tile fewer times).
inline int pick_nt(int B, int S, int sms) {
  const int tiles = (B + kRows - 1) / kRows;
  int best = kMaxNT;
  long long best_cost = -1;
  for (int nt = kMaxNT; nt >= kMinNT; --nt) {
    const long long blocks =
        static_cast<long long>((S + protos(nt) - 1) / protos(nt)) * tiles;
    const long long cost = (blocks + sms - 1) / sms * nt;
    if (best_cost < 0 || cost < best_cost) best = nt, best_cost = cost;
  }
  return best;
}

// Stages step ks of the block's query rows [b0, b0 + kRows) and prototype
// rows [s0, s0 + protos(NT)) into one ring slot (rows past B or S zero).
template <int NT, int kMask, bool kVec>
__device__ __forceinline__ void stage(uint32_t* slot,
                                      const uint32_t* __restrict__ q,
                                      const uint32_t* __restrict__ p, int B,
                                      int S, int W, int b0, int s0, int ks) {
  const int tid = threadIdx.x;
  stage_step<kMask, kVec>(slot, q, W, b0, kRows, B, ks * kStepWords, W, tid,
                          kThreads);
  stage_step<kMask, kVec>(slot + kRows * kStepWords, p, W, s0, protos(NT), S,
                          ks * kStepWords, W, tid, kThreads);
}

// Runs the ring: for every step ks, step(query tile, prototype tile, ks)
// once the slot has landed.  Every warp's work on a slot ends before the
// slot is refilled (the barrier at the top of the next step).
template <int NT, int kMask, bool kVec, class Step>
__device__ __forceinline__ void run(uint32_t* smem,
                                    const uint32_t* __restrict__ q,
                                    const uint32_t* __restrict__ p, int B,
                                    int S, int W, int b0, int s0,
                                    Step& step) {
  const int nks = (W + kStepWords - 1) / kStepWords;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nks) {
      stage<NT, kMask, kVec>(smem + st * stage_words(NT), q, p, B, S, W, b0,
                             s0, st);
    }
    cp_async_commit();
  }
  for (int ks = 0; ks < nks; ++ks) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nx = ks + kStages - 1;
    if (nx < nks) {
      stage<NT, kMask, kVec>(smem + (nx % kStages) * stage_words(NT), q, p,
                             B, S, W, b0, s0, nx);
    }
    cp_async_commit();
    const uint32_t* qs = smem + (ks % kStages) * stage_words(NT);
    step(qs, qs + kRows * kStepWords, ks);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Launches a slab kernel of `nt` n8 tiles a warp over (B, S): one block a
// slab and query tile.
template <class Kernel, class... Args>
cudaError_t launch(Kernel kernel, int nt, int B, int S, cudaStream_t stream,
                   Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(nt));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + protos(nt) - 1) / protos(nt), (B + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem_bytes(nt), stream>>>(args...);
  return cudaGetLastError();
}

// Query tiles the grid's second axis holds at most.
constexpr int kMaxQueryTiles = 65535;

}  // namespace slab
}  // namespace mma
