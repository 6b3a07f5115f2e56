// Threefry-2x32 draws of jax.random on the card: bits, uniforms and normals,
// one row of m values for each of N keys.
//
// Replaces no Pallas kernel: the JAX package draws the device model's noise
// (src/repro/accel/device.py, racetrack.py, crossbar.py) with jax.random,
// outside any kernel.  The port needs those words on the card, where a
// program draw at the main path's width is 408.9 M values a bank and every
// read batch another 408.9 M a bank, so this kernel reproduces them there:
//
// * partitionable mode (jax >= 0.5): value i of a key is the Threefry pair of
//   the counters (hi32(i), lo32(i)), reduced as out0 ^ out1;
// * original mode: the counters 0 .. m - 1 (one zero counter more for an odd
//   m) are hashed as the pairs (j, j + half), and the row is
//   concat(out0, out1).
//
// Epilogues, as jax.random builds them on the words:
//   bits     the uint32 word;
//   uniform  max(lo, fma(f, range, lo)), f = float(1 | 23 high bits) - 1;
//   normal   sqrt(2) * erf_inv(uniform on [nextafter(-1, 0), 1)), with XLA's
//            float32 ErfInv (Giles' polynomial, w = -log1p(-x x), split at
//            w < 5), its Horner steps as explicit fmaf so the rounding is a
//            stated choice and not nvcc's contraction; then optionally
//            times a per-row scale, divided by a divisor, and added into the
//            output (the read noise std(active rows) * normal lands on the
//            partial counts without a (T, B, S) noise tensor).
//
// What bounds it: integer operations -- a Threefry pair is 20 rounds of
// add / rotate / xor plus 6 key injections, ~72 32-bit operations, about
// 1.8 ms for 408.9 M pairs at the H100's 64 integer operations a clock per
// SM; writing 1.64 GB takes 0.49 ms.  The design: one thread a pair, the
// rotates as funnel shifts, stores coalesced (in the original mode a thread
// writes value j and value j + half, both runs contiguous across a warp), a
// grid-stride loop over a (pairs, keys) grid.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

template <int R>
__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, R) ^ x0;
}

template <int A, int B, int C, int D>
__device__ __forceinline__ void four(uint32_t& x0, uint32_t& x1) {
  mix<A>(x0, x1);
  mix<B>(x0, x1);
  mix<C>(x0, x1);
  mix<D>(x0, x1);
}

// 20-round Threefry-2x32 of the counter pair (x0, x1) under (k0, k1).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  four<13, 15, 26, 6>(x0, x1);
  x0 += k1;
  x1 += k2 + 1u;
  four<17, 29, 16, 24>(x0, x1);
  x0 += k2;
  x1 += k0 + 2u;
  four<13, 15, 26, 6>(x0, x1);
  x0 += k0;
  x1 += k1 + 3u;
  four<17, 29, 16, 24>(x0, x1);
  x0 += k1;
  x1 += k2 + 4u;
  four<13, 15, 26, 6>(x0, x1);
  x0 += k2;
  x1 += k0 + 5u;
}

__device__ __forceinline__ float unit_float(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// XLA's float32 ErfInv.
__device__ __forceinline__ float erf_inv(float x) {
  float w = -log1pf(__fmul_rn(-x, x));
  float p;
  if (w < 5.0f) {
    w = w - 2.5f;
    p = 2.81022636e-08f;
    p = fmaf(p, w, 3.43273939e-07f);
    p = fmaf(p, w, -3.5233877e-06f);
    p = fmaf(p, w, -4.39150654e-06f);
    p = fmaf(p, w, 0.00021858087f);
    p = fmaf(p, w, -0.00125372503f);
    p = fmaf(p, w, -0.00417768164f);
    p = fmaf(p, w, 0.246640727f);
    p = fmaf(p, w, 1.50140941f);
  } else {
    w = sqrtf(w) - 3.0f;
    p = -0.000200214257f;
    p = fmaf(p, w, 0.000100950558f);
    p = fmaf(p, w, 0.00134934322f);
    p = fmaf(p, w, -0.00367342844f);
    p = fmaf(p, w, 0.00573950773f);
    p = fmaf(p, w, -0.0076224613f);
    p = fmaf(p, w, 0.00943887047f);
    p = fmaf(p, w, 1.00167406f);
    p = fmaf(p, w, 2.83297682f);
  }
  return fabsf(x) == 1.0f ? __fmul_rn(x, CUDART_INF_F) : __fmul_rn(p, x);
}

enum Epilogue { kBits = 0, kUniform = 1, kNormal = 2 };

struct Params {
  const uint32_t* keys;    // (n_keys, 2)
  long long n_keys;
  long long m;             // values a key
  float lo, range;         // uniform: minval, maxval - minval
  const float* scale;      // normal: (n_keys, m / inner) or null
  unsigned inner;          // values per scale entry
  float divisor;           // normal: divides the scaled value (1: none)
  int accumulate;          // normal: out += value instead of out = value
  void* out;               // (n_keys, m): uint32 for bits, else float
};

template <int EPI>
__device__ __forceinline__ void emit(const Params& p, long long key,
                                     unsigned i, uint32_t word) {
  const long long at = key * p.m + i;
  if constexpr (EPI == kBits) {
    static_cast<uint32_t*>(p.out)[at] = word;
  } else if constexpr (EPI == kUniform) {
    const float u = fmaf(unit_float(word), p.range, p.lo);
    static_cast<float*>(p.out)[at] = fmaxf(p.lo, u);
  } else {
    const float u = fmaxf(p.lo, fmaf(unit_float(word), p.range, p.lo));
    float v = __fmul_rn(1.41421354f, erf_inv(u));
    if (p.scale != nullptr) {
      const long long rows = p.m / p.inner;
      v = __fmul_rn(p.scale[key * rows + i / p.inner], v);
    }
    if (p.divisor != 1.0f) v = __fdiv_rn(v, p.divisor);
    float* out = static_cast<float*>(p.out);
    out[at] = p.accumulate ? __fadd_rn(out[at], v) : v;
  }
}

template <bool PARTITIONABLE, int EPI>
__global__ void __launch_bounds__(256) threefry_kernel(Params p) {
  const long long pairs = PARTITIONABLE ? p.m : (p.m + 1) / 2;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long key = blockIdx.y; key < p.n_keys; key += gridDim.y) {
    const uint32_t k0 = p.keys[2 * key], k1 = p.keys[2 * key + 1];
    for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         j < pairs; j += stride) {
      if constexpr (PARTITIONABLE) {
        uint32_t x0 = (uint32_t)((unsigned long long)j >> 32);
        uint32_t x1 = (uint32_t)j;
        threefry2x32(k0, k1, x0, x1);
        emit<EPI>(p, key, (unsigned)j, x0 ^ x1);
      } else {
        const long long hi = j + pairs;
        uint32_t x0 = (uint32_t)j;
        uint32_t x1 = hi < p.m ? (uint32_t)hi : 0u;
        threefry2x32(k0, k1, x0, x1);
        emit<EPI>(p, key, (unsigned)j, x0);
        if (hi < p.m) emit<EPI>(p, key, (unsigned)hi, x1);
      }
    }
  }
}

template <bool PARTITIONABLE>
cudaError_t launch_mode(const Params& p, int epilogue, dim3 grid,
                        cudaStream_t stream) {
  switch (epilogue) {
    case kBits:
      threefry_kernel<PARTITIONABLE, kBits><<<grid, 256, 0, stream>>>(p);
      break;
    case kUniform:
      threefry_kernel<PARTITIONABLE, kUniform><<<grid, 256, 0, stream>>>(p);
      break;
    case kNormal:
      threefry_kernel<PARTITIONABLE, kNormal><<<grid, 256, 0, stream>>>(p);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// Draw n_keys rows of m values into out.  The wrapper checks shapes, that
// m < 2^32 and that inner divides m.  Returns the launch's CUDA error.
extern "C" int threefry_launch(const void* keys, long long n_keys,
                               long long m, int partitionable, int epilogue,
                               float lo, float range, const void* scale,
                               long long inner, float divisor, int accumulate,
                               void* out, void* stream) {
  if (n_keys <= 0 || m <= 0) return 0;
  Params p;
  p.keys = static_cast<const uint32_t*>(keys);
  p.n_keys = n_keys;
  p.m = m;
  p.lo = lo;
  p.range = range;
  p.scale = static_cast<const float*>(scale);
  p.inner = (unsigned)(inner > 0 ? inner : 1);
  p.divisor = divisor;
  p.accumulate = accumulate;
  p.out = out;
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long pairs = partitionable ? m : (m + 1) / 2;
  const long long grid_y = n_keys < 65535 ? n_keys : 65535;
  // About four waves of 8 blocks an SM, shared among the keys of a launch.
  long long grid_x = (pairs + 255) / 256;
  const long long want = (4LL * 8 * sms + grid_y - 1) / grid_y;
  if (grid_x > want) grid_x = want;
  if (grid_x < 1) grid_x = 1;
  const dim3 grid((unsigned)grid_x, (unsigned)grid_y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = partitionable
                              ? launch_mode<true>(p, epilogue, grid, s)
                              : launch_mode<false>(p, epilogue, grid, s);
  return (int)err;
}
