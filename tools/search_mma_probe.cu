// Throughput probe of the two exact tensor-core formulations of the
// Hamming-agreement search on Hopper (sm_90a):
//   kind 0: mma.sync m16n8k256 b1.b1 -> s32 with .and.popc (packed words)
//   kind 1: mma.sync m16n8k32  s8.s8 -> s32 (bytes already in registers)
//   kind 2: kind 1 plus the 0/1 byte unpack of the B fragment from a
//           packed word (the work an s8 search adds for every fragment)
//   kind 3: mma.sync m16n8k256 b1.b1 -> s32 with .xor.popc
//   kind 4: wgmma m64n128k32 s8.s8 -> s32, A and B from shared memory
//   kind 5: wgmma m64n128k16 bf16.bf16 -> f32, A and B from shared memory
//   kind 6: wgmma m64n80k32 s8.s8 -> s32, A from registers (the
//           instruction of am_matmul's packed entry at the main path's
//           slab)
// For kinds 0-3 every warp issues `iters` rounds of 8 independent mmas;
// for kinds 4-6 every warpgroup issues `iters` groups of 4 wgmma (the four
// k steps of a 128-byte swizzle atom) on one accumulator, keeping two
// groups in flight.  The result is folded into `out` so nothing is
// elided.  Driven by search_mma_probe.py.
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "../src/repro_torch/csrc/wgmma_common.cuh"

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

__device__ __forceinline__ void wgmma_s8_ss(int (&d)[64], uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

__device__ __forceinline__ void wgmma_bf16_ss(float (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

// Operands in shared memory (8 KB: 64 rows of one atom; 16 KB: 128
// rows), +-1 bytes or +-1.0 bf16, zero-filled nowhere.
template <int KIND>
__global__ void __launch_bounds__(256)
wgmma_probe_kernel(int iters, int* out) {
  __shared__ __align__(1024) uint32_t smem[(8192 + 16384) / 4];
  for (int i = threadIdx.x; i < (8192 + 16384) / 4; i += blockDim.x) {
    const uint32_t h = (i + 1) * 2654435761u;
    smem[i] = KIND == 5 ? 0x3F803F80u ^ (h & 0x80008000u)
                        : (h | 0x01010101u);
  }
  wg::fence_proxy_async();
  __syncthreads();
  const uint64_t da = wg::desc_sw128(smem);
  const uint64_t db = wg::desc_sw128(smem + 8192 / 4);
  using Acc = typename std::conditional<KIND == 5, float, int>::type;
  constexpr int kRegs = KIND == 6 ? 40 : 64;
  Acc acc[kRegs];
#pragma unroll
  for (int i = 0; i < kRegs; ++i) acc[i] = 0;
  const uint32_t a = (threadIdx.x * 2654435761u) | 0x01010101u;
  for (int it = 0; it < iters; ++it) {
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (KIND == 4) {
        wgmma_s8_ss(acc, da + 2 * kk, db + 2 * kk);
      } else if constexpr (KIND == 5) {
        wgmma_bf16_ss(acc, da + 2 * kk, db + 2 * kk);
      } else {
        wg::Wgmma<80>::s8(acc, a, a ^ 1u, a + 2u, a * 3u, db + 2 * kk);
      }
    }
    wg::wgmma_commit();
    wg::wgmma_wait<1>();
  }
  wg::wgmma_wait<0>();
  wg::fence_regs(acc);
  uint32_t fold = 0;
#pragma unroll
  for (int i = 0; i < kRegs; ++i) fold += static_cast<uint32_t>(acc[i]);
  out[threadIdx.x + blockIdx.x * blockDim.x] = static_cast<int>(fold);
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
    case 4: wgmma_probe_kernel<4><<<blocks, threads, 0, st>>>(iters, out);
      break;
    case 5: wgmma_probe_kernel<5><<<blocks, threads, 0, st>>>(iters, out);
      break;
    case 6: wgmma_probe_kernel<6><<<blocks, threads, 0, st>>>(iters, out);
      break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
