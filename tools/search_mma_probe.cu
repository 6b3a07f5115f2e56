// Throughput probe of the two exact tensor-core formulations of the
// Hamming-agreement search on Hopper (sm_90a):
//   kind 0: mma.sync m16n8k256 b1.b1 -> s32 with .and.popc (packed words)
//   kind 1: mma.sync m16n8k32  s8.s8 -> s32 (bytes already in registers)
//   kind 2: kind 1 plus the 0/1 byte unpack of the B fragment from a
//           packed word (the work an s8 search adds for every fragment)
//   kind 3: mma.sync m16n8k256 b1.b1 -> s32 with .xor.popc
// Every warp issues `iters` rounds of 8 independent mmas; the result is
// folded into `out` so nothing is elided.  Driven by search_mma_probe.py.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void mma_b1(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_b1_xor(int (&c)[4],
                                           const uint32_t (&a)[4],
                                           uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.xor.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four bits -> four 0/1 bytes (bit i to byte i).
__device__ __forceinline__ uint32_t nibble_bytes(uint32_t x) {
  return ((x & 0xFu) * 0x00204081u) & 0x01010101u;
}

template <int KIND>
__global__ void probe_kernel(int iters, uint32_t seed, int* out) {
  const uint32_t t = threadIdx.x + blockIdx.x * blockDim.x;
  uint32_t a[4] = {seed ^ t, seed * 3u + t, seed ^ (t << 3), t * 7u};
  int c[8][4] = {};
  uint32_t w = seed + t * 2654435761u;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (KIND == 0) {
        mma_b1(c[j], a, w + j, w ^ j);
      } else if (KIND == 3) {
        mma_b1_xor(c[j], a, w + j, w ^ j);
      } else if (KIND == 1) {
        mma_s8(c[j], a, (w + j) & 0x01010101u, (w ^ j) & 0x01010101u);
      } else {
        const uint32_t byte = (w >> (8 * (j & 3))) & 0xFFu;
        mma_s8(c[j], a, nibble_bytes(byte), nibble_bytes(byte >> 4));
      }
    }
    w = w * 1664525u + 1013904223u;
  }
  int s = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[t] = s;
}

// One warp: C[16][8] = sum over 8 words of popc(A[r][w] & B[c][w]) with
// A (16, 8) and B (8, 8) packed words, thread (g, tig) giving words 2 tig
// and 2 tig + 1 of its rows as its (a0, a2) / (a1, a3) and (b0, b1) --
// the fragment mapping the search kernel relies on.
__global__ void layout_check_kernel(const uint32_t* A, const uint32_t* B,
                                    int* C) {
  const int lane = threadIdx.x, g = lane >> 2, tig = lane & 3;
  const uint32_t a[4] = {A[g * 8 + 2 * tig], A[(g + 8) * 8 + 2 * tig],
                         A[g * 8 + 2 * tig + 1], A[(g + 8) * 8 + 2 * tig + 1]};
  int c[4] = {0, 0, 0, 0};
  mma_b1(c, a, B[g * 8 + 2 * tig], B[g * 8 + 2 * tig + 1]);
  C[g * 8 + 2 * tig] = c[0];
  C[g * 8 + 2 * tig + 1] = c[1];
  C[(g + 8) * 8 + 2 * tig] = c[2];
  C[(g + 8) * 8 + 2 * tig + 1] = c[3];
}

}  // namespace

extern "C" int layout_check_launch(const uint32_t* A, const uint32_t* B,
                                   int* C, void* stream) {
  layout_check_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(A, B,
                                                                      C);
  return cudaGetLastError();
}

extern "C" int probe_launch(int kind, int blocks, int threads, int iters,
                            int* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0: probe_kernel<0><<<blocks, threads, 0, st>>>(iters, 12345u, out);
      break;
    case 1: probe_kernel<1><<<blocks, threads, 0, st>>>(iters, 12345u, out);
      break;
    case 2: probe_kernel<2><<<blocks, threads, 0, st>>>(iters, 12345u, out);
      break;
    case 3: probe_kernel<3><<<blocks, threads, 0, st>>>(iters, 12345u, out);
      break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
