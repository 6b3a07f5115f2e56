// +-1 associative-memory search for Hopper (sm_90a): agreement
// (dim + Q^ P^T) / 2 of every query against every prototype over their
// {-1, +1} expansions, on the tensor cores with wgmma.  Two entries:
//
//   am_matmul_packed_launch  packed (B, W), (S, W) uint32 words, expanded
//                            to +-1 on chip (the search path's entry);
//   am_matmul_launch         +-1 bf16 (B, K), (S, K) operands (the TPU
//                            kernel's own interface).
//
// Both replace the TPU kernel repro/kernels/am_matmul.py::_kernel
// (launched by am_matmul).  The TPU grid walks D innermost and carries an
// fp32 (bm, bn) accumulator in VMEM from step to step; here a block owns
// an output tile and walks D itself, keeping the accumulator in registers.
//
// Both share one block shape (wgmma_common.cuh has the instructions and
// the shared-memory layout): four consumer warpgroups own the 256 queries
// of a query tile, 64 rows each, and run m64nNk wgmma over a slab of N
// prototypes (N = 16 NT with NT from mma::slab::pick_nt: 80 at the main
// path's shapes, 123 blocks on 132 SMs); a fifth, producer warpgroup fills
// a ring of shared-memory stages, each with a "full" mbarrier (its loads
// landed) and an "empty" one (the 16 consumer warps are done with it).
// Each prototype byte is read from device memory once a launch; the query
// tile once a block, mostly from L2.
//
// -- The packed entry ------------------------------------------------------
//
// The bf16 entry needs the AM expanded to 16 bits a bit, 801 MB at the
// main path's shapes (B = 256, S = 9,780, W = 1,280); this entry streams
// the 50 MB of packed words and expands them on chip: nothing +-1 reaches
// device memory.
//
// Instruction: wgmma m64nNk32 s8 -> s32, one packed word a k32 step.  The
// expansion is prmt's sign mode on the word shifted left by s, OR 0x01: each
// byte i becomes 0xFF (-1) for a set bit 8 i + 7 - s and 0x01 (+1) for a
// clear one, 3 integer instructions a 32-bit register.  k = 4 t + i of a word
// holds bit 8 i + 7 - t and k = 16 + 4 t + i bit 8 i + 3 - t (s = t and
// s = t + 4), on both operands, so every k pairs the same bit of the query
// and the prototype and every product q^ p^ is to_pm1's (both negated).
//
//   * Prototypes (B operand, shared memory): warp 0 of the producer
//     warpgroup brings a stage's 16 packed words of every query and
//     prototype row in (TMA where W % 4 == 0 and both bases are 16-byte
//     aligned, else cp.async word by word into the same layout), three
//     stages deep; warps 1-3 expand the prototypes' words, once a block,
//     into four 128-byte swizzle atoms (4 words a row each) in the stage
//     and arrive on its "expanded" barrier.  A word at or past W expands
//     to 0x00 bytes, not to +1s: TMA and cp.async fill it with zeros, and
//     a zero word would add 16 to every agreement.
//   * Queries (A operand, registers): a consumer warp owns 16 rows and
//     expands their words straight into the A fragment (mma.sync
//     m16n8k32's layout, as before), so each query word is expanded once a
//     block and the expanded query tile (8 KB a word column) never touches
//     shared memory, whose bandwidth the B reads (N x 32 bytes a wgmma, four
//     warpgroups) already half use.  A consumer issues its wgmma two words
//     at a time from two register buffers, a buffer refilled only after
//     wgmma.wait_group has retired the group that read it.
//
// Budget a k32 column of a block at N = 80: the tensor pipe takes
// M N 64 / 8,192 = 160 clocks, the expansion (M + N) x 24 / 64 = 126 on the
// integer pipes.  Bound: 2 B S D operations at the int8 dense peak
// (1,979 TOP/s), 0.104 ms at the main path's shapes.  Measured on the
// H100 (chip_smoke, PERF.md): wgmma itself runs at the peak; the two
// expansions are what the kernel waits on, and stages of 16 words beat
// 8 (fewer hand-offs a launch).
//
// -- The bf16 entry --------------------------------------------------------
//
// A "TN" product: both operands are K-contiguous.  A stage is one
// 64-element (128-byte) column of the 256-query tile and of the slab,
// brought in by TMA with the 128-byte swizzle (K % 8 == 0 and 16-byte
// aligned bases), and read by m64nNk16 bf16 -> f32 wgmma from shared-
// memory descriptors.  Other K, or unaligned bases, are staged by the
// producer warpgroup with plain loads into the same layout.  TMA fills
// past B, S and K with zeros, which a bf16 product ignores.  Every
// product is +-1 or 0 and every partial sum an integer of magnitude
// <= K < 2^24, so the fp32 accumulator is exact in any summation order and
// the result equals repro/kernels/ref.py::am_matmul_ref bit for bit.
// Bound: the bytes of its bf16 prototype operand (801 MB, 0.248 ms).
//
// Both entries: the sums are integers, so the results, (dim + acc) / 2
// truncated toward zero, equal the plain versions bit for bit.  B, S and W
// (K) may be ragged: rows past B or S are zero-filled and never written.
#include <cstdint>

#include <cuda_runtime.h>

#include "mma_common.cuh"
#include "wgmma_common.cuh"

namespace {

constexpr int kRows = 256;                     // queries a block
constexpr int kConsumers = 4;                  // warpgroups of 64 queries
constexpr int kConsumerWarps = 4 * kConsumers;
constexpr int kThreads = 32 * kConsumerWarps + 128;  // + a producer group
constexpr int kSmemMax = 232448;               // a block's shared memory
constexpr int kBarrierBytes = 1024;

__host__ __device__ constexpr int round_1k(int b) {
  return (b + 1023) / 1024 * 1024;
}

// 1,024-byte-aligned start of the dynamic shared memory (one spare KB is
// allocated for it).
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  const uint32_t a = mma::smem_u32(raw);
  return raw + ((1024 - (a & 1023)) & 1023);
}

// -- the packed entry ----------------------------------------------------

constexpr int kStepWords = 16;                 // packed words a stage
constexpr int kAtoms = kStepWords / 4;         // swizzle atoms it expands to
constexpr int kPackedStages = 3;
constexpr int kExpanders = 96;                 // producer warps 1-3

// Stage layout: the expanded slab (kAtoms swizzle atoms of N x 128
// bytes), then the packed query tile (256 x kStepWords words), then the
// packed slab.
__host__ __device__ constexpr int packed_q_off(int n) {
  return kAtoms * n * 128;
}
__host__ __device__ constexpr int packed_p_off(int n) {
  return packed_q_off(n) + kRows * kStepWords * 4;
}
__host__ __device__ constexpr int packed_stage_bytes(int n) {
  return round_1k(packed_p_off(n) + n * kStepWords * 4);
}
__host__ __device__ constexpr int packed_smem_bytes(int n) {
  return 1024 + kPackedStages * packed_stage_bytes(n) + kBarrierBytes;
}

// A word's 32 +-1 bytes in k order: k 0..15 (the shifts s = 0..3) and
// k 16..31 (s = 4..7), one 16-byte chunk each.
__device__ __forceinline__ uint4 expand_lo(uint32_t x) {
  return make_uint4(mma::pm1_of_top_bits(x), mma::pm1_of_top_bits(x << 1),
                    mma::pm1_of_top_bits(x << 2),
                    mma::pm1_of_top_bits(x << 3));
}
__device__ __forceinline__ uint4 expand_hi(uint32_t x) {
  return make_uint4(mma::pm1_of_top_bits(x << 4), mma::pm1_of_top_bits(x << 5),
                    mma::pm1_of_top_bits(x << 6),
                    mma::pm1_of_top_bits(x << 7));
}

// Expands the stage's packed slab (N rows x kStepWords words at ps) into
// its swizzle atoms at pex: word j of row n fills chunks 2 (j % 4) and
// 2 (j % 4) + 1 of row n of atom j / 4, each at chunk ^ (n & 7).  kWhole:
// every word of the stage is inside W; else words at or past wlim expand
// to zero bytes.
template <int N, bool kWhole>
__device__ __forceinline__ void expand_stage(uint8_t* pex,
                                             const uint32_t* ps, int wlim,
                                             int et) {
#pragma unroll 1
  for (int u = et; u < kAtoms * N; u += kExpanders) {
    const int n = u % N, a = u / N;
    const uint4 x = *reinterpret_cast<const uint4*>(ps + n * kStepWords +
                                                     4 * a);
    uint8_t* row = pex + a * (N * 128) + n * 128;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t w = mma::word_of(x, j);
      uint4 lo = expand_lo(w), hi = expand_hi(w);
      if (!kWhole && 4 * a + j >= wlim) lo = hi = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(row + (((2 * j) ^ (n & 7)) << 4)) = lo;
      *reinterpret_cast<uint4*>(row + (((2 * j + 1) ^ (n & 7)) << 4)) = hi;
    }
  }
}

// Stages words [w0, w0 + kStepWords) of rows [row0, row0 + rows) of a
// (rend, W) uint32 matrix into dst (rows x kStepWords words) with cp.async,
// a word at a time, zero past rend and W.
__device__ __forceinline__ void copy_words(uint32_t* dst,
                                           const uint32_t* __restrict__ src,
                                           int row0, int rows, int rend,
                                           int w0, int W, int lane) {
  for (int i = lane; i < rows * kStepWords; i += 32) {
    const int gr = row0 + i / kStepWords, gw = w0 + i % kStepWords;
    const bool in = gr < rend && gw < W;
    mma::cp_async4(dst + i, in ? src + static_cast<size_t>(gr) * W + gw : src,
                   in ? 4 : 0);
  }
}

template <int N, bool kTma>
__global__ void __launch_bounds__(kThreads, 1)
am_matmul_packed_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tp,
                        const uint32_t* __restrict__ q,
                        const uint32_t* __restrict__ p,
                        int32_t* __restrict__ out, int B, int S, int W,
                        int dim) {
  constexpr int kStage = packed_stage_bytes(N);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kPackedStages * kStage);
  uint64_t* expanded = full + kPackedStages;
  uint64_t* empty = expanded + kPackedStages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int s0 = blockIdx.x * N, b0 = blockIdx.y * kRows;
  const int nks = (W + kStepWords - 1) / kStepWords;
  if (tid == 0) {
    for (int st = 0; st < kPackedStages; ++st) {
      wg::mbar_init(full + st, kTma ? 1 : 32);
      wg::mbar_init(expanded + st, kExpanders);
      wg::mbar_init(empty + st, kConsumerWarps);
    }
    wg::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // -- the producer warpgroup --
    if (warp == kConsumerWarps) {
      // Warp 0: each stage's loads, once its last round is consumed.
      if (kTma && lane != 0) return;
      for (int ks = 0; ks < nks; ++ks) {
        const int st = ks % kPackedStages, r = ks / kPackedStages;
        if (r > 0) wg::mbar_wait(empty + st, (r - 1) & 1);
        uint8_t* base = smem + st * kStage;
        if constexpr (kTma) {
          wg::mbar_arrive_expect_tx(full + st,
                                    (kRows + N) * kStepWords * 4);
          wg::tma_load_2d(base + packed_q_off(N), &tq, full + st,
                          ks * kStepWords, b0);
          wg::tma_load_2d(base + packed_p_off(N), &tp, full + st,
                          ks * kStepWords, s0);
        } else {
          copy_words(reinterpret_cast<uint32_t*>(base + packed_q_off(N)), q,
                     b0, kRows, B, ks * kStepWords, W, lane);
          copy_words(reinterpret_cast<uint32_t*>(base + packed_p_off(N)), p,
                     s0, N, S, ks * kStepWords, W, lane);
          wg::cp_async_arrive(full + st);
        }
      }
      if constexpr (!kTma) mma::cp_async_wait<0>();  // none left in flight
      return;
    }
    // Warps 1-3: expand each stage's slab once it has landed.
    const int et = tid - (kConsumerWarps + 1) * 32;
    for (int ks = 0; ks < nks; ++ks) {
      const int st = ks % kPackedStages;
      wg::mbar_wait(full + st, (ks / kPackedStages) & 1);
      uint8_t* base = smem + st * kStage;
      const auto* ps =
          reinterpret_cast<const uint32_t*>(base + packed_p_off(N));
      const int wlim = W - ks * kStepWords;
      if (wlim >= kStepWords) {
        expand_stage<N, true>(base, ps, wlim, et);
      } else {
        expand_stage<N, false>(base, ps, wlim, et);
      }
      wg::fence_proxy_async();
      wg::mbar_arrive(expanded + st);
    }
    return;
  }

  // -- the consumer warpgroups --
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (warp >> 2) * 64 + (warp & 3) * 16 + g;  // row in the tile
  // x << t and x << (t + 4) as multiplies: the integer multiply-add pipe
  // takes them, beside the logic pipe that runs prmt and the OR.  The
  // factors pass through asm so they are not folded back into shifts.
  uint32_t mlo, mhi;
  asm("mov.b32 %0, %1;" : "=r"(mlo) : "r"(1u << t));
  asm("mov.b32 %0, %1;" : "=r"(mhi) : "r"(16u << t));
  int acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0;
  uint32_t af[2][8];  // A fragments of two words, two buffers
#pragma unroll
  for (int i = 0; i < 8; ++i) af[0][i] = af[1][i] = 0;

  for (int ks = 0; ks < nks; ++ks) {
    const int st = ks % kPackedStages;
    wg::mbar_wait(expanded + st, (ks / kPackedStages) & 1);
    const uint8_t* base = smem + st * kStage;
    const auto* qs =
        reinterpret_cast<const uint32_t*>(base + packed_q_off(N));
    const uint64_t desc = wg::desc_sw128(base);
#pragma unroll
    for (int pr = 0; pr < kStepWords / 2; ++pr) {
      uint32_t(&a)[8] = af[pr & 1];
      // The group that last read this buffer (two commits ago) is done;
      // at the second pair every group of the previous stage is.
      wg::wgmma_wait<1>();
      wg::fence_regs(a);
      if (pr == 1 && ks > 0 && lane == 0) {
        wg::mbar_arrive(empty + (ks - 1) % kPackedStages);
      }
      const uint2 x0 = *reinterpret_cast<const uint2*>(
          qs + r0 * kStepWords + 2 * pr);
      const uint2 x1 = *reinterpret_cast<const uint2*>(
          qs + (r0 + 8) * kStepWords + 2 * pr);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const uint32_t w0 = e ? x0.y : x0.x, w1 = e ? x1.y : x1.x;
        a[4 * e + 0] = mma::pm1_of_top_bits(w0 * mlo);
        a[4 * e + 1] = mma::pm1_of_top_bits(w1 * mlo);
        a[4 * e + 2] = mma::pm1_of_top_bits(w0 * mhi);
        a[4 * e + 3] = mma::pm1_of_top_bits(w1 * mhi);
      }
      wg::fence_regs(a);
      wg::wgmma_fence();
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = 2 * pr + e;  // word of the stage: atom j / 4
        wg::Wgmma<N>::s8(acc, a[4 * e], a[4 * e + 1], a[4 * e + 2],
                         a[4 * e + 3],
                         desc + (((j >> 2) * N * 128 + (j & 3) * 32) >> 4));
      }
      wg::wgmma_commit();
    }
  }
  wg::wgmma_wait<0>();
  wg::fence_regs(acc);

  const int row = b0 + r0;
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    const int s = s0 + 8 * i + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + 8 * h;
      if (r >= B) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (s + e < S) {
          out[static_cast<size_t>(r) * S + s + e] =
              (dim + acc[4 * i + 2 * h + e]) / 2;
        }
      }
    }
  }
}

// -- the bf16 entry --------------------------------------------------------

constexpr int kBK = 64;                        // K a stage (128 bytes)
constexpr int kABytes = kRows * 128;           // the query tile's stage

__host__ __device__ constexpr int bf16_stage_bytes(int n) {
  return kABytes + n * 128;
}
__host__ __device__ constexpr int bf16_stages(int n) {
  return (kSmemMax - 1024 - kBarrierBytes) / bf16_stage_bytes(n) < 6
             ? (kSmemMax - 1024 - kBarrierBytes) / bf16_stage_bytes(n)
             : 6;
}
__host__ __device__ constexpr int bf16_smem_bytes(int n) {
  return 1024 + bf16_stages(n) * bf16_stage_bytes(n) + kBarrierBytes;
}

// Stages rows [row0, row0 + rows) x K [k0, k0 + 64) of a (rend, K) bf16
// matrix into dst as a K-major 128-byte-swizzled tile, zero past rend and
// K, with plain loads (any K, any alignment).
__device__ __forceinline__ void copy_bf16(uint8_t* dst,
                                          const uint16_t* __restrict__ src,
                                          int row0, int rows, int rend,
                                          int k0, int K, int tid) {
  for (int c = tid; c < rows * 8; c += 128) {
    const int r = c >> 3, ch = c & 7, gr = row0 + r, gk = k0 + 8 * ch;
    uint32_t v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t lo = 0, hi = 0;
      if (gr < rend && gk + 2 * e < K) {
        lo = src[static_cast<size_t>(gr) * K + gk + 2 * e];
      }
      if (gr < rend && gk + 2 * e + 1 < K) {
        hi = src[static_cast<size_t>(gr) * K + gk + 2 * e + 1];
      }
      v[e] = lo | (hi << 16);
    }
    *reinterpret_cast<uint4*>(dst + r * 128 + ((ch ^ (r & 7)) << 4)) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
}

template <int N, bool kTma>
__global__ void __launch_bounds__(kThreads, 1)
am_matmul_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tp,
                 const uint16_t* __restrict__ q,
                 const uint16_t* __restrict__ p, int32_t* __restrict__ out,
                 int B, int S, int K, int dim) {
  constexpr int kStages = bf16_stages(N);
  constexpr int kStage = bf16_stage_bytes(N);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStage);
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int s0 = blockIdx.x * N, b0 = blockIdx.y * kRows;
  const int nks = (K + kBK - 1) / kBK;
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      wg::mbar_init(full + st, kTma ? 1 : 128);
      wg::mbar_init(empty + st, kConsumerWarps);
    }
    wg::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // -- the producer warpgroup: TMA from one thread, or plain loads from
    // all 128 --
    if (kTma && tid != kConsumerWarps * 32) return;
    for (int ks = 0; ks < nks; ++ks) {
      const int st = ks % kStages, r = ks / kStages;
      if (r > 0) wg::mbar_wait(empty + st, (r - 1) & 1);
      uint8_t* base = smem + st * kStage;
      if constexpr (kTma) {
        wg::mbar_arrive_expect_tx(full + st, kStage);
        wg::tma_load_2d(base, &tq, full + st, ks * kBK, b0);
        wg::tma_load_2d(base + kABytes, &tp, full + st, ks * kBK, s0);
      } else {
        const int ptid = tid - kConsumerWarps * 32;
        copy_bf16(base, q, b0, kRows, B, ks * kBK, K, ptid);
        copy_bf16(base + kABytes, p, s0, N, S, ks * kBK, K, ptid);
        wg::fence_proxy_async();
        wg::mbar_arrive(full + st);
      }
    }
    return;
  }

  // -- the consumer warpgroups --
  const int wgi = warp >> 2;
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  for (int ks = 0; ks < nks; ++ks) {
    const int st = ks % kStages;
    wg::mbar_wait(full + st, (ks / kStages) & 1);
    const uint8_t* base = smem + st * kStage;
    const uint64_t da = wg::desc_sw128(base + wgi * 64 * 128);
    const uint64_t db = wg::desc_sw128(base + kABytes);
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      wg::Wgmma<N>::bf16(acc, da + 2 * kk, db + 2 * kk);  // +32 bytes
    }
    wg::wgmma_commit();
    // The previous stage's group is done: release its slot.
    wg::wgmma_wait<1>();
    if (ks > 0 && lane == 0) wg::mbar_arrive(empty + (ks - 1) % kStages);
  }
  wg::wgmma_wait<0>();
  wg::fence_regs(acc);

  const int g = lane >> 2, t = lane & 3;
  const int row = b0 + wgi * 64 + (warp & 3) * 16 + g;
  const float fdim = static_cast<float>(dim);
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    const int s = s0 + 8 * i + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + 8 * h;
      if (r >= B) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (s + e < S) {
          out[static_cast<size_t>(r) * S + s + e] =
              __float2int_rz((fdim + acc[4 * i + 2 * h + e]) * 0.5f);
        }
      }
    }
  }
}

// -- launches ----------------------------------------------------------------

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

template <class Kernel, class... Args>
cudaError_t launch_kernel(Kernel kernel, int n, int smem, int B, int S,
                          cudaStream_t stream, Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + n - 1) / n, (B + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_packed(const uint32_t* q, const uint32_t* p, int32_t* out,
                          int B, int S, int W, int dim, bool tma,
                          cudaStream_t st) {
  CUtensorMap tq{}, tp{};
  if (tma) {
    cudaError_t err = wg::make_map(&tq, CU_TENSOR_MAP_DATA_TYPE_UINT32, 4, q,
                                   B, W, kRows, kStepWords,
                                   CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err == cudaSuccess) {
      err = wg::make_map(&tp, CU_TENSOR_MAP_DATA_TYPE_UINT32, 4, p, S, W, N,
                         kStepWords, CU_TENSOR_MAP_SWIZZLE_NONE);
    }
    if (err != cudaSuccess) return err;
    return launch_kernel(am_matmul_packed_kernel<N, true>, N,
                         packed_smem_bytes(N), B, S, st, tq, tp, q, p, out, B,
                         S, W, dim);
  }
  return launch_kernel(am_matmul_packed_kernel<N, false>, N,
                       packed_smem_bytes(N), B, S, st, tq, tp, q, p, out, B,
                       S, W, dim);
}

template <int N>
cudaError_t launch_bf16(const uint16_t* q, const uint16_t* p, int32_t* out,
                        int B, int S, int K, int dim, bool tma,
                        cudaStream_t st) {
  CUtensorMap tq{}, tp{};
  if (tma) {
    cudaError_t err = wg::make_map(&tq, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                                   q, B, K, kRows, kBK,
                                   CU_TENSOR_MAP_SWIZZLE_128B);
    if (err == cudaSuccess) {
      err = wg::make_map(&tp, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p, S, K, N,
                         kBK, CU_TENSOR_MAP_SWIZZLE_128B);
    }
    if (err != cudaSuccess) return err;
    return launch_kernel(am_matmul_kernel<N, true>, N, bf16_smem_bytes(N), B,
                         S, st, tq, tp, q, p, out, B, S, K, dim);
  }
  return launch_kernel(am_matmul_kernel<N, false>, N, bf16_smem_bytes(N), B,
                       S, st, tq, tp, q, p, out, B, S, K, dim);
}

// The slab width of a launch at (B, S) on this card: mma::slab's choice.
cudaError_t pick_n(int B, int S, int* n, int* sms) {
  const cudaError_t err = mma::sm_count(sms);
  if (err != cudaSuccess) return err;
  *n = mma::slab::protos(mma::slab::pick_nt(B, S, *sms));
  return cudaSuccess;
}

#define REPRO_SLAB_CASES(F) F(32) F(48) F(64) F(80) F(96)

}  // namespace

// q (B, W) uint32, p (S, W) uint32 packed bits, both row-major -> out
// (B, S) int32 = (dim + sum over the 32 W bits of q^ p^) / 2, truncated
// toward zero, with q^ = +1 for a set bit and -1 for a clear one.
// Returns a cudaError_t.
extern "C" int am_matmul_packed_launch(const uint32_t* q, const uint32_t* p,
                                       int32_t* out, int B, int S, int W,
                                       int dim, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if ((B + kRows - 1) / kRows > mma::slab::kMaxQueryTiles) {
    return cudaErrorInvalidValue;
  }
  int n = 0, sms = 0;
  const cudaError_t err = pick_n(B, S, &n, &sms);
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool tma = W > 0 && W % 4 == 0 && aligned16(q) && aligned16(p);
  switch (n) {
#define REPRO_PACKED_CASE(N) \
  case N: return launch_packed<N>(q, p, out, B, S, W, dim, tma, st);
    REPRO_SLAB_CASES(REPRO_PACKED_CASE)
#undef REPRO_PACKED_CASE
    default: return cudaErrorInvalidValue;
  }
}

// q (B, K) bf16, p (S, K) bf16, both row-major -> out (B, S) int32
// = int((dim + q . p) / 2).  Returns a cudaError_t.
extern "C" int am_matmul_launch(const void* q, const void* p, int32_t* out,
                                int B, int S, int K, int dim, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  // The entry's contract: at most 65,535 x 128 prototypes and 65,535
  // query tiles a launch.
  if ((S + 127) / 128 > 65535 ||
      (B + kRows - 1) / kRows > mma::slab::kMaxQueryTiles) {
    return cudaErrorInvalidValue;
  }
  int n = 0, sms = 0;
  const cudaError_t err = pick_n(B, S, &n, &sms);
  if (err != cudaSuccess) return err;
  const auto* qb = static_cast<const uint16_t*>(q);
  const auto* pb = static_cast<const uint16_t*>(p);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool tma = K > 0 && K % 8 == 0 && aligned16(q) && aligned16(p);
  switch (n) {
#define REPRO_BF16_CASE(N) \
  case N: return launch_bf16<N>(qb, pb, out, B, S, K, dim, tma, st);
    REPRO_SLAB_CASES(REPRO_BF16_CASE)
#undef REPRO_BF16_CASE
    default: return cudaErrorInvalidValue;
  }
}

// The tiling of a launch of either entry (packed != 0: the packed one) at
// (B, S) and row length K (words or elements) on the current card:
// plan[0..7] = queries a block, prototypes a block, ring stages, blocks,
// dynamic shared memory a block in bytes, SMs, 1 where K lets the stages
// come by TMA (given 16-byte aligned bases), and the words (packed) or
// elements (bf16) of a row a stage.  Returns a cudaError_t.
extern "C" int am_matmul_plan(int packed, int B, int S, int K, int* plan) {
  int n = 0, sms = 0;
  const cudaError_t err = pick_n(B, S, &n, &sms);
  if (err != cudaSuccess) return err;
  int smem = 0, stages = 0;
  switch (n) {
#define REPRO_PLAN_CASE(N)                                                 \
  case N:                                                                  \
    stages = packed ? kPackedStages : bf16_stages(N);                      \
    smem = packed ? packed_smem_bytes(N) : bf16_smem_bytes(N);             \
    break;
    REPRO_SLAB_CASES(REPRO_PLAN_CASE)
#undef REPRO_PLAN_CASE
    default: return cudaErrorInvalidValue;
  }
  plan[0] = kRows;
  plan[1] = n;
  plan[2] = stages;
  plan[3] = ((S + n - 1) / n) * ((B + kRows - 1) / kRows);
  plan[4] = smem;
  plan[5] = sms;
  plan[6] = K > 0 && K % (packed ? 4 : 8) == 0;
  plan[7] = packed ? kStepWords : kBK;
  return 0;
}
