// Packed associative-memory search for Hopper (sm_90a): agreement
// (dim - Hamming distance) of every query against every prototype, from
// bit-packed 32-bit words.
//
// Replaces the TPU kernel repro/kernels/hamming_am.py::_kernel (launched
// by hamming_am).  The TPU grid walks W innermost and carries an int32
// (bm, bn) accumulator in VMEM from step to step; here a block owns a
// (kBM, kBN) output tile and walks W itself, so nothing carries over
// between blocks.
//
// Design.  A block of 256 threads (16 x 16) owns 64 queries x 64
// prototypes.  It walks W in chunks of kBW = 32 words, staging the query
// tile and the prototype tile in shared memory (rows padded to 33 words,
// so the 16 prototype rows one warp reads in a step sit in 16 different
// banks; the query rows a warp reads are broadcasts).  Each thread keeps
// a 4 x 4 register tile of int32 popcount sums: query rows ty + 16 i,
// prototype rows tx + 16 j.  Rows past B or S and words past W are
// staged as zeros: 0 ^ 0 adds no popcount, so B, S and W may be ragged
// and nothing is padded in device memory.  The epilogue writes
// dim - count with bounds checks.
//
// Bound.  Operations: B * S * W XOR + popcount + add.  At the main path's
// shapes (B = 256, S = 9,780, W = 1,280) that is 9.6e9 operations against
// 61 MB of inputs and output; __popc issues at a quarter of the 32-bit
// integer rate, so the popcount is the ceiling.  The design keeps every
// operand in shared memory or registers and loads each query and
// prototype word from shared memory once per 4 uses.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;              // queries per block
constexpr int kBN = 64;              // prototypes per block
constexpr int kBW = 32;              // words per shared-memory chunk
constexpr int kPad = kBW + 1;        // padded row length in words
constexpr int kTX = 16, kTY = 16;    // threads per block: kTX x kTY
constexpr int kRM = kBM / kTY;       // query rows per thread (4)
constexpr int kRN = kBN / kTX;       // prototype rows per thread (4)
constexpr int kThreads = kTX * kTY;

__device__ inline void stage(uint32_t (*dst)[kPad],
                             const uint32_t* __restrict__ src, int row0,
                             int rows, int w0, int W, int tid) {
#pragma unroll
  for (int k = tid; k < kBM * kBW; k += kThreads) {
    const int r = k / kBW;
    const int c = k - r * kBW;
    const int gr = row0 + r;
    const int gc = w0 + c;
    dst[r][c] = (gr < rows && gc < W)
                    ? __ldg(src + static_cast<size_t>(gr) * W + gc)
                    : 0u;
  }
}

__global__ void __launch_bounds__(kThreads)
hamming_am_kernel(const uint32_t* __restrict__ q,
                  const uint32_t* __restrict__ p, int32_t* __restrict__ out,
                  int B, int S, int W, int dim) {
  __shared__ uint32_t qs[kBM][kPad];
  __shared__ uint32_t ps[kBN][kPad];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTX + tx;
  const int b0 = blockIdx.x * kBM;
  const int s0 = blockIdx.y * kBN;

  int acc[kRM][kRN];
#pragma unroll
  for (int i = 0; i < kRM; ++i)
#pragma unroll
    for (int j = 0; j < kRN; ++j) acc[i][j] = 0;

  for (int w0 = 0; w0 < W; w0 += kBW) {
    stage(qs, q, b0, B, w0, W, tid);
    stage(ps, p, s0, S, w0, W, tid);
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < kBW; ++c) {
      uint32_t qv[kRM], pv[kRN];
#pragma unroll
      for (int i = 0; i < kRM; ++i) qv[i] = qs[ty + kTY * i][c];
#pragma unroll
      for (int j = 0; j < kRN; ++j) pv[j] = ps[tx + kTX * j][c];
#pragma unroll
      for (int i = 0; i < kRM; ++i)
#pragma unroll
        for (int j = 0; j < kRN; ++j) acc[i][j] += __popc(qv[i] ^ pv[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int r = b0 + ty + kTY * i;
    if (r >= B) continue;
#pragma unroll
    for (int j = 0; j < kRN; ++j) {
      const int s = s0 + tx + kTX * j;
      if (s < S) out[static_cast<size_t>(r) * S + s] = dim - acc[i][j];
    }
  }
}

}  // namespace

// q (B, W) uint32, p (S, W) uint32, both row-major -> out (B, S) int32
// = dim - popcount(q[b] ^ p[s]).  Returns a cudaError_t.
extern "C" int hamming_am_launch(const uint32_t* q, const uint32_t* p,
                                 int32_t* out, int B, int S, int W, int dim,
                                 void* stream) {
  if (B <= 0 || S <= 0) return 0;
  const unsigned gy = static_cast<unsigned>((S + kBN - 1) / kBN);
  if (gy > 65535u) return cudaErrorInvalidValue;
  const dim3 grid((B + kBM - 1) / kBM, gy);
  const dim3 block(kTX, kTY);
  hamming_am_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      q, p, out, B, S, W, dim);
  return cudaGetLastError();
}
