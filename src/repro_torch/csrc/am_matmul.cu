// +-1 associative-memory search for Hopper (sm_90a): agreement
// (dim + Q.P^T) / 2 of every query against every prototype, from their
// {-1, +1} bf16 expansions, on the tensor cores.
//
// Replaces the TPU kernel repro/kernels/am_matmul.py::_kernel (launched by
// am_matmul).  The TPU grid walks D innermost and carries an fp32
// (bm, bn) accumulator in VMEM from step to step; here a block owns a
// (kBM, kBN) output tile and walks D itself, keeping the accumulator in
// registers.
//
// Design.  A "TN" product: both operands are K-contiguous, which is the
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
// are staged with plain loads instead of cp.async.
//
// Exactness.  Every product is +-1 or 0 (a zero-filled tail) and every
// partial sum an integer of magnitude <= K < 2^24, so the fp32
// accumulator is exact in any summation order and the result equals
// repro/kernels/ref.py::am_matmul_ref bit for bit.
//
// Bound.  Bytes: at the main path's shapes (B = 256, S = 9,780,
// K = 40,960) the prototype operand alone is 801 MB of bf16, read from
// device memory; the 2 * B * S * K = 2.05e11 flop take less time at the
// dense bf16 tensor rate.  The design streams each prototype tile once per
// 128 queries (the two query tiles of a 256-read batch are adjacent
// blocks, so the second read mostly hits L2) and keeps loads in flight
// behind the tensor-core work with the cp.async ring.
#include <cstdint>

#include <cuda_runtime.h>

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

__device__ inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ inline void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0));
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ inline void ldmatrix_x4(uint32_t (&r)[4], const uint16_t* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
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
      cp_async16(d, in ? src + static_cast<size_t>(gr) * K + gk : src, in);
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
    cp_async_commit();
  }

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt landed; every warp is done with kt - 1
    const int next = kt + kStages - 1;
    if (next < KT) load_stage(next % kStages, next);
    cp_async_commit();

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
  cp_async_wait<0>();

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

}  // namespace

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
