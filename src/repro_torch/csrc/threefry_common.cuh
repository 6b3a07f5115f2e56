// Threefry-2x32 and the float32 steps of jax.random's uniform and normal,
// shared by the kernels that draw jax.random's words on the card
// (threefry.cu, crossbar_adc.cu).  Both include this one copy, so a normal
// drawn by either is the same float32 value bit for bit.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace threefry {

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

// jax.random.normal's value of one word: sqrt(2) * erf_inv(u), u the
// word's uniform on [lo, lo + range) = [nextafter(-1, 0), 1).
__device__ __forceinline__ float normal(uint32_t word, float lo, float range) {
  const float u = fmaxf(lo, fmaf(unit_float(word), range, lo));
  return __fmul_rn(1.41421354f, erf_inv(u));
}

}  // namespace threefry
