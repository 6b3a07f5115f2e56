// +-1 associative-memory search for Hopper (sm_90a): agreement
// (dim + Q^ P^T) / 2 of every query against every prototype over their
// {-1, +1} expansions, on the tensor cores.  Two entries:
//
//   am_matmul_packed_launch  packed (B, W), (S, W) uint32 words, expanded
//                            to +-1 on chip (the search path's entry);
//   am_matmul_launch         +-1 bf16 (B, K), (S, K) operands (the TPU
//                            kernel's own interface, kept as it was).
//
// Both replace the TPU kernel repro/kernels/am_matmul.py::_kernel
// (launched by am_matmul).  The TPU grid walks D innermost and carries an
// fp32 (bm, bn) accumulator in VMEM from step to step; here a block owns
// an output tile and walks D itself, keeping the accumulator in registers.
//
// -- The packed entry ------------------------------------------------------
//
// The bf16 entry needs the AM expanded to 16 bits a bit, 801 MB at the
// main path's shapes (B = 256, S = 9,780, W = 1,280), written and read
// again on every batch.  This entry streams the 50 MB of packed words and
// expands each word into tensor-core fragments in registers: nothing +-1
// reaches device memory.
//
// Instruction: mma.sync m16n8k32 s8 -> s32.  A +-1 product is exact in
// int8, one k32 step is one packed word of a row, and s8 runs at 0.39
// mmas a clock per SM on the H100 (tools/search_mma_probe.py), twice the
// products of bf16 m16n8k16 an instruction.  A thread (g, t) of the warp
// needs 8 bits of each word: byte i of its low fragment register takes
// bit 8i + 7 - t and of its high one bit 8i + 3 - t, the same bits for
// the query (A) and prototype (B) operand, so every k pairs the same bit
// of both and the 32 bits of a word are covered once.  Expansion: shift
// the word left by t (or t + 4; a multiply, on the multiply-add pipe),
// replicate each byte's top bit with prmt's sign mode (0xFF or 0x00) and
// OR in 0x01: 0xFF (-1) for a set bit, 0x01 (+1) for a clear one, 3
// integer instructions a register.  That is the negated to_pm1 on both
// operands, so every product q^ p^ is to_pm1's and no complement is spent.
// wgmma would need the expanded prototype operand in shared memory or a
// register layout of its own; it is the next step, not this one.
//
// Tiling: mma::slab (mma_common.cuh), as hamming_am.cu: a block owns all
// 256 queries of a query tile and a slab of 16 NT prototypes (NT = 5 at
// the main path's shapes: 123 blocks on 132 SMs, one wave), walks W in
// 32-word steps through a 4-deep cp.async ring, 8 warps of 64 queries x
// 8 NT prototypes.  Bytes a launch at the main path's shapes: the AM
// (50.1 MB) once from device memory, the packed query batch (1.3 MB)
// once a block, 161 MB from L2.  The rows are staged with chunk c of row
// r at c ^ (r & 7), so the 8 rows a warp's threads read in one load hit 8
// distinct 16-byte chunks.
//
// Ragged shapes: rows past B or S are staged as zero words and never
// written; words past W are skipped (a zero word would expand to +1s, not
// to an inert 0).  W not a multiple of 4 (or unaligned rows) stages word
// by word.  The sums are integers of magnitude at most 32 W, so the
// result, (dim + acc) / 2 truncated toward zero, equals
// am_matmul_plain(to_pm1(q), to_pm1(p), dim) bit for bit.
//
// Bound.  Operations: 2 B S D products and adds.  At the int8 dense peak
// (1,979 TOP/s) that is 0.104 ms at the main path's shapes; kernel 4's b1
// formulation of the same function needs 0.025 ms.  The expansion adds
// 78 integer instructions a word to a warp's 20 mmas (26 multiplies,
// 26 prmt, 26 OR), split over two pipes so that they hide behind the
// tensor pipe.
//
// -- The bf16 entry --------------------------------------------------------
//
// A "TN" product: both operands are K-contiguous, which is the
// row-major A / column-major B layout that
// mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 takes.  A block of 8 warps
// owns 128 queries x 128 prototypes; each warp owns a 64 x 32 sub-tile
// (4 x 4 mma tiles, 64 fp32 accumulators a thread).  The block walks K in
// chunks of kBK = 64 through a kStages-deep ring of shared-memory tiles
// filled by cp.async (16 bytes a thread, zero-filled past B, S and K), and
// feeds the warps with ldmatrix from rows padded to 72 elements, so the
// eight 16-byte rows of one ldmatrix phase land in distinct banks.  The
// epilogue writes int((dim + acc) * 0.5f) with bounds checks: B, S and K
// may be ragged and nothing is padded in device memory.  Rows whose
// length K is not a multiple of 8 (or whose base is not 16-byte aligned)
// are staged with plain loads instead of cp.async.  Every product is +-1
// or 0 (a zero-filled tail) and every partial sum an integer of magnitude
// <= K < 2^24, so the fp32 accumulator is exact in any summation order and
// the result equals repro/kernels/ref.py::am_matmul_ref bit for bit.  Its
// bound is bytes: the 801 MB bf16 prototype operand.
#include <cstdint>

#include <cuda_runtime.h>

#include "mma_common.cuh"

namespace {

constexpr int kBM = 128;                       // queries per block
constexpr int kBN = 128;                       // prototypes per block
constexpr int kBK = 64;                        // K per stage
constexpr int kStages = 3;                     // cp.async ring depth
constexpr int kLd = kBK + 8;                   // padded row, in bf16
constexpr int kWarpsM = 2, kWarpsN = 4;
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kWM = kBM / kWarpsM;             // 64 rows a warp
constexpr int kWN = kBN / kWarpsN;             // 32 columns a warp
constexpr int kMT = kWM / 16;                  // m16 tiles a warp
constexpr int kNT = kWN / 8;                   // n8 tiles a warp
constexpr int kTile = kBM * kLd;               // bf16 per operand tile
constexpr int kChunks = kBM * kBK / 8;         // 16-byte chunks per tile
static_assert(kBM == kBN, "one tile shape for both operands");
constexpr size_t kSmemBytes =
    static_cast<size_t>(kStages) * 2 * kTile * sizeof(uint16_t);

__device__ inline void ldmatrix_x4(uint32_t (&r)[4], const uint16_t* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(mma::smem_u32(p)));
}

__device__ inline void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage rows [row0, row0 + kBM) x columns [k0, k0 + kBK) of a (rows, K)
// bf16 matrix into `dst` (kBM x kLd), zero past the matrix's edges.
template <bool kVec>
__device__ inline void load_tile(uint16_t* dst,
                                 const uint16_t* __restrict__ src, int row0,
                                 int rows, int k0, int K, int tid) {
#pragma unroll
  for (int i = 0; i < kChunks / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int r = c / (kBK / 8);
    const int col = (c % (kBK / 8)) * 8;
    const int gr = row0 + r;
    const int gk = k0 + col;
    uint16_t* d = dst + r * kLd + col;
    if constexpr (kVec) {
      // K % 8 == 0: a chunk lies wholly inside or wholly outside a row.
      const bool in = gr < rows && gk < K;
      mma::cp_async16(d, in ? src + static_cast<size_t>(gr) * K + gk : src,
                      in ? 16 : 0);
    } else {
      uint32_t v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint32_t lo = 0, hi = 0;
        if (gr < rows && gk + 2 * e < K)
          lo = src[static_cast<size_t>(gr) * K + gk + 2 * e];
        if (gr < rows && gk + 2 * e + 1 < K)
          hi = src[static_cast<size_t>(gr) * K + gk + 2 * e + 1];
        v[e] = lo | (hi << 16);
      }
      *reinterpret_cast<uint4*>(d) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
am_matmul_kernel(const uint16_t* __restrict__ q,
                 const uint16_t* __restrict__ p, int32_t* __restrict__ out,
                 int B, int S, int K, int dim) {
  extern __shared__ __align__(16) uint16_t smem[];
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wm = warp / kWarpsN;
  const int wn = warp % kWarpsN;
  const int b0 = blockIdx.x * kBM;
  const int s0 = blockIdx.y * kBN;
  const int KT = (K + kBK - 1) / kBK;

  float acc[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  auto load_stage = [&](int stage, int kt) {
    uint16_t* a = smem + stage * 2 * kTile;
    load_tile<kVec>(a, q, b0, B, kt * kBK, K, tid);
    load_tile<kVec>(a + kTile, p, s0, S, kt * kBK, K, tid);
  };

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < KT) load_stage(st, st);
    mma::cp_async_commit();
  }

  for (int kt = 0; kt < KT; ++kt) {
    mma::cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt landed; every warp is done with kt - 1
    const int next = kt + kStages - 1;
    if (next < KT) load_stage(next % kStages, next);
    mma::cp_async_commit();

    const uint16_t* as = smem + (kt % kStages) * 2 * kTile;
    const uint16_t* bs = as + kTile;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[kMT][4];
      uint32_t bf[kNT][2];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const int r = wm * kWM + mt * 16 + (lane % 16);
        ldmatrix_x4(af[mt], as + r * kLd + kk + (lane / 16) * 8);
      }
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        const int n = wn * kWN + np * 16 + (lane % 8) + (lane / 16) * 8;
        uint32_t r[4];
        ldmatrix_x4(r, bs + n * kLd + kk + ((lane / 8) % 2) * 8);
        bf[2 * np][0] = r[0];
        bf[2 * np][1] = r[1];
        bf[2 * np + 1][0] = r[2];
        bf[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
          mma_bf16(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
    }
  }
  mma::cp_async_wait<0>();

  // Epilogue: thread (g, t) of a warp holds rows g and g + 8, columns
  // 2t and 2t + 1 of each m16 x n8 tile.
  const int g = lane / 4;
  const int t = lane % 4;
  const float fdim = static_cast<float>(dim);
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = b0 + wm * kWM + mt * 16 + g + half * 8;
      if (r >= B) continue;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int s = s0 + wn * kWN + nt * 8 + 2 * t + e;
          if (s < S) {
            out[static_cast<size_t>(r) * S + s] =
                __float2int_rz((fdim + acc[mt][nt][2 * half + e]) * 0.5f);
          }
        }
      }
    }
  }
}

template <bool kVec>
cudaError_t launch(const uint16_t* q, const uint16_t* p, int32_t* out, int B,
                   int S, int K, int dim, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      am_matmul_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((B + kBM - 1) / kBM, (S + kBN - 1) / kBN);
  am_matmul_kernel<kVec><<<grid, kThreads, kSmemBytes, stream>>>(
      q, p, out, B, S, K, dim);
  return cudaGetLastError();
}

// -- the packed entry -----------------------------------------------------

template <int NT, bool kVec>
__global__ void __launch_bounds__(mma::slab::kThreads, 1)
am_matmul_packed_kernel(const uint32_t* __restrict__ q,
                        const uint32_t* __restrict__ p,
                        int32_t* __restrict__ out, int B, int S, int W,
                        int dim) {
  using namespace mma;
  extern __shared__ __align__(16) uint32_t ring[];  // uint16_t smem[] above
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int mrow = (warp / slab::kWarpsN) * 64;
  const int ncol = (warp % slab::kWarpsN) * NT * 8;
  const int g = lane >> 2, t = lane & 3;
  const int s0 = blockIdx.x * slab::protos(NT);
  const int b0 = blockIdx.y * slab::kRows;
  // x << t and x << (t + 4) as multiplies: the integer multiply-add pipe
  // takes them, beside the logic pipe that runs prmt and the OR.  The
  // factors pass through asm so they are not folded back into shifts.
  uint32_t mlo, mhi;
  asm("mov.b32 %0, %1;" : "=r"(mlo) : "r"(1u << t));
  asm("mov.b32 %0, %1;" : "=r"(mhi) : "r"(16u << t));

  int acc[4][NT][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;

  // One 32-word step; full steps (all but a ragged last one) carry no word
  // bound, so nothing breaks the unrolled loops.
  auto words = [&](const uint32_t* qs, const uint32_t* ps, int wlim,
                   auto full) {
    constexpr bool kFull = decltype(full)::value;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (!kFull && 4 * c >= wlim) break;
      // Every row this thread reads is g mod 8, so chunk c sits at c ^ g.
      const int pos = (c ^ g) << 2;
      uint4 pw[NT], qw[4][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        pw[nt] = *reinterpret_cast<const uint4*>(
            ps + (ncol + nt * 8 + g) * kStepWords + pos);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          qw[mt][h] = *reinterpret_cast<const uint4*>(
              qs + (mrow + mt * 16 + 8 * h + g) * kStepWords + pos);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!kFull && 4 * c + e >= wlim) break;
        uint32_t bl[NT], bh[NT];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint32_t x = word_of(pw[nt], e);
          bl[nt] = pm1_of_top_bits(x * mlo);
          bh[nt] = pm1_of_top_bits(x * mhi);
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          const uint32_t x0 = word_of(qw[mt][0], e);
          const uint32_t x8 = word_of(qw[mt][1], e);
          const uint32_t a0 = pm1_of_top_bits(x0 * mlo);
          const uint32_t a1 = pm1_of_top_bits(x8 * mlo);
          const uint32_t a2 = pm1_of_top_bits(x0 * mhi);
          const uint32_t a3 = pm1_of_top_bits(x8 * mhi);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            mma_s8(acc[mt][nt], a0, a1, a2, a3, bl[nt], bh[nt]);
          }
        }
      }
    }
  };
  auto step = [&](const uint32_t* qs, const uint32_t* ps, int ks) {
    const int wlim = W - ks * kStepWords;  // words of this step inside W
    if (wlim >= kStepWords) {
      words(qs, ps, wlim, std::true_type{});
    } else {
      words(qs, ps, wlim, std::false_type{});
    }
  };
  slab::run<NT, 7, kVec>(ring, q, p, B, S, W, b0, s0, step);

#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = b0 + mrow + mt * 16 + g + 8 * half;
      if (r >= B) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int s = s0 + ncol + nt * 8 + 2 * t + i;
          if (s < S) {
            out[static_cast<size_t>(r) * S + s] =
                (dim + acc[mt][nt][2 * half + i]) / 2;
          }
        }
      }
    }
  }
}

template <bool kVec>
cudaError_t launch_packed(int nt, const uint32_t* q, const uint32_t* p,
                          int32_t* out, int B, int S, int W, int dim,
                          cudaStream_t st) {
  switch (nt) {
#define REPRO_PACKED_CASE(N)                                                  \
  case N:                                                                     \
    return mma::slab::launch(am_matmul_packed_kernel<N, kVec>, N, B, S, st,  \
                             q, p, out, B, S, W, dim);
    REPRO_PACKED_CASE(2)
    REPRO_PACKED_CASE(3)
    REPRO_PACKED_CASE(4)
    REPRO_PACKED_CASE(5)
    REPRO_PACKED_CASE(6)
#undef REPRO_PACKED_CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, W) uint32, p (S, W) uint32 packed bits, both row-major -> out
// (B, S) int32 = (dim + sum over the 32 W bits of q^ p^) / 2, truncated
// toward zero, with q^ = +1 for a set bit and -1 for a clear one.
// Returns a cudaError_t.
extern "C" int am_matmul_packed_launch(const uint32_t* q, const uint32_t* p,
                                       int32_t* out, int B, int S, int W,
                                       int dim, void* stream) {
  using namespace mma;
  if (B <= 0 || S <= 0) return 0;
  if ((B + slab::kRows - 1) / slab::kRows > slab::kMaxQueryTiles) {
    return cudaErrorInvalidValue;
  }
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int nt = slab::pick_nt(B, S, sms);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(p) % 16 == 0;
  return vec ? launch_packed<true>(nt, q, p, out, B, S, W, dim, st)
             : launch_packed<false>(nt, q, p, out, B, S, W, dim, st);
}

// q (B, K) bf16, p (S, K) bf16, both row-major -> out (B, S) int32
// = int((dim + q . p) / 2).  Returns a cudaError_t.
extern "C" int am_matmul_launch(const void* q, const void* p, int32_t* out,
                                int B, int S, int K, int dim, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if ((S + kBN - 1) / kBN > 65535) return cudaErrorInvalidValue;
  const auto* qb = static_cast<const uint16_t*>(q);
  const auto* pb = static_cast<const uint16_t*>(p);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = K % 8 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(p) % 16 == 0;
  return vec ? launch<true>(qb, pb, out, B, S, K, dim, st)
             : launch<false>(qb, pb, out, B, S, K, dim, st);
}
