// Packed associative-memory search for Hopper (sm_90a): agreement
// (dim - Hamming distance) of every query against every prototype, from
// bit-packed 32-bit words, on the tensor cores.
//
// Replaces the TPU kernel repro/kernels/hamming_am.py::_kernel (launched
// by hamming_am).  The TPU grid walks W innermost and carries an int32
// (bm, bn) accumulator in VMEM from step to step; here a block owns an
// output tile and walks W itself, keeping the sums in registers.
//
// Search.  mma.sync m16n8k256 b1 .and.popc, with
//   agreement = dim - |a| - |b| + 2 popc(a & b)
// (.xor.popc runs five times slower on the H100;
// tools/search_mma_probe.py).  Fragment mapping, swizzle and the mma are
// the fused kernel's (mma_common.cuh): thread (g, t) supplies words
// 8t .. 8t + 7 of a 32-word step for rows g and g + 8.
//
// Tiling (mma_common.cuh, mma::slab).  A block owns all 256 queries of a
// query tile and a slab of 16 NT prototypes, and walks W in 32-word steps
// through a 4-deep cp.async ring; its 8 warps are 4 (64 queries) x 2 (NT
// n8 tiles of prototypes).  NT (2..6) is picked from S and the SM count so
// the slabs fill the SMs in as few waves as they can (NT = 5 at
// S = 9,780 on 132 SMs: 123 blocks, one wave).  Bytes a launch at the
// main path's shapes (B = 256, S = 9,780, W = 1,280): the AM, S W 4 =
// 50.1 MB, is read once from device memory (each prototype row belongs to
// one slab); the packed query batch, B W 4 = 1.3 MB, is read once a block,
// 123 x 1.3 = 161 MB, from L2, where it stays.
//
// Row popcounts.  |b| comes from the staged prototype tiles: every thread
// popcounts 16-byte chunks of the slab's rows as they land, so the AM is
// not read again.  |a| comes from a small pass over the queries launched
// just before (1.3 MB, ~1 us): each of the 123 blocks would otherwise
// popcount the whole query tile, 123 times the work.
//
// Ragged shapes: rows past B or S and words past W are staged as zeros
// (inert in a & b) and never written; nothing is padded in device memory.
// W not a multiple of 4 (or unaligned rows) stages word by word.  The sums
// are at most 32 W + dim, below 2^31.
//
// Bound.  Operations: B S D bit agreements, counted as 2 B S D (an AND and
// an add a bit), at the b1 mma rate measured on the H100 (~0.47 a clock per
// SM): ~0.025 ms at the main path's shapes.
#include <cstdint>

#include <cuda_runtime.h>

#include "mma_common.cuh"

namespace {

using namespace mma;
constexpr int kThreads = slab::kThreads;

template <int NT, bool kVec>
__global__ void __launch_bounds__(slab::kThreads, 1)
hamming_am_kernel(const uint32_t* __restrict__ q,
                  const uint32_t* __restrict__ p,
                  const int32_t* __restrict__ ra, int32_t* __restrict__ out,
                  int B, int S, int W, int dim) {
  constexpr int kProtos = slab::protos(NT);
  constexpr int kPcSlots = (kProtos * 8 + kThreads - 1) / kThreads;
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int32_t pb[kProtos];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mrow = (warp / slab::kWarpsN) * 64;
  const int ncol = (warp % slab::kWarpsN) * NT * 8;
  const int g = lane >> 2, t = lane & 3;
  const int s0 = blockIdx.x * kProtos;
  const int b0 = blockIdx.y * slab::kRows;
  // Chunk offsets of this thread's words 8t .. 8t + 7 in a row of parity
  // g & 1 (rows g, g + 8 and prototype g share it).
  const int lo = ((2 * t) ^ (g & 1)) << 2;
  const int hi = ((2 * t + 1) ^ (g & 1)) << 2;

  int acc[4][NT][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;
  int pcnt[kPcSlots];
#pragma unroll
  for (int i = 0; i < kPcSlots; ++i) pcnt[i] = 0;

  auto step = [&](const uint32_t* qs, const uint32_t* ps, int) {
    // |b|: chunk c of the flattened slab tile is 16 bytes of row c / 8.
#pragma unroll
    for (int i = 0; i < kPcSlots; ++i) {
      const int c = tid + i * kThreads;
      if (c < kProtos * 8) {
        const uint4 v = *reinterpret_cast<const uint4*>(ps + c * 4);
        pcnt[i] += __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
      }
    }
    uint4 b[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint32_t* row = ps + (ncol + nt * 8 + g) * kStepWords;
      b[nt][0] = *reinterpret_cast<const uint4*>(row + lo);
      b[nt][1] = *reinterpret_cast<const uint4*>(row + hi);
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const uint32_t* rg = qs + (mrow + mt * 16 + g) * kStepWords;
      const uint32_t* rg8 = rg + 8 * kStepWords;
      const uint4 ag[2] = {*reinterpret_cast<const uint4*>(rg + lo),
                           *reinterpret_cast<const uint4*>(rg + hi)};
      const uint4 ag8[2] = {*reinterpret_cast<const uint4*>(rg8 + lo),
                            *reinterpret_cast<const uint4*>(rg8 + hi)};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          mma_and_popc(acc[mt][nt], ag[h].x, ag8[h].x, ag[h].y, ag8[h].y,
                       b[nt][h].x, b[nt][h].y);
          mma_and_popc(acc[mt][nt], ag[h].z, ag8[h].z, ag[h].w, ag8[h].w,
                       b[nt][h].z, b[nt][h].w);
        }
      }
    }
  };
  slab::run<NT, 1, kVec>(smem, q, p, B, S, W, b0, s0, step);

  // The 8 threads of a slab row are 8 consecutive lanes.
#pragma unroll
  for (int i = 0; i < kPcSlots; ++i) {
    int v = pcnt[i];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    v += __shfl_xor_sync(0xffffffffu, v, 4);
    const int c = tid + i * kThreads;
    if ((lane & 7) == 0 && c < kProtos * 8) pb[c >> 3] = v;
  }
  __syncthreads();

#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = b0 + mrow + mt * 16 + g + 8 * half;
      if (r >= B) continue;
      const int base = dim - __ldg(ra + r);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int col = ncol + nt * 8 + 2 * t + i;
          if (s0 + col < S) {
            out[static_cast<size_t>(r) * S + s0 + col] =
                base - pb[col] + 2 * acc[mt][nt][2 * half + i];
          }
        }
      }
    }
  }
}

template <bool kVec>
cudaError_t launch(int nt, const uint32_t* q, const uint32_t* p,
                   const int32_t* ra, int32_t* out, int B, int S, int W,
                   int dim, cudaStream_t st) {
  switch (nt) {
#define REPRO_HAMMING_CASE(N)                                                 \
  case N:                                                                     \
    return slab::launch(hamming_am_kernel<N, kVec>, N, B, S, st, q, p, ra,   \
                        out, B, S, W, dim);
    REPRO_HAMMING_CASE(2)
    REPRO_HAMMING_CASE(3)
    REPRO_HAMMING_CASE(4)
    REPRO_HAMMING_CASE(5)
    REPRO_HAMMING_CASE(6)
#undef REPRO_HAMMING_CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Prototypes a block of the launch at (B, S) covers on the current
// device (16 NT), or -1 on a CUDA error: for reporting the tiling.
extern "C" int hamming_am_slab_protos(int B, int S) {
  int sms = 0;
  if (sm_count(&sms) != cudaSuccess) return -1;
  return slab::protos(slab::pick_nt(B, S, sms));
}

// q (B, W) uint32, p (S, W) uint32, both row-major, ra (B,) int32 scratch
// for the queries' popcounts -> out (B, S) int32 = dim - popcount(q ^ p).
// Returns a cudaError_t.
extern "C" int hamming_am_launch(const uint32_t* q, const uint32_t* p,
                                 int32_t* ra, int32_t* out, int B, int S,
                                 int W, int dim, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if ((B + slab::kRows - 1) / slab::kRows > slab::kMaxQueryTiles) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_row_popcount(q, W, W, B, ra, st);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int nt = slab::pick_nt(B, S, sms);
  const bool vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(p) % 16 == 0;
  return vec ? launch<true>(nt, q, p, ra, out, B, S, W, dim, st)
             : launch<false>(nt, q, p, ra, out, B, S, W, dim, st);
}
