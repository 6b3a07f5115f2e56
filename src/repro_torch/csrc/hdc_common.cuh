// Shared device code of the encoder and fused encode->search kernels.
//
// Packed HD vectors are uint32 words, LSB-first.  A read of length len has
// m = max(len - n + 1, 0) valid n-grams; gram i binds its n tokens as
//   gram_i[w] = XOR_{j<n} im_rolled[j][tok[i + j]][w]
// and bit b of the encoded word is 1 when 2 * count_b > m, the tie
// vector's bit when 2 * count_b == m, else 0 (the majority of
// repro.core.encoder.binarize_majority).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace demeter {

// Bytes a block may use of shared memory on Hopper (227 KB).
constexpr int kMaxSmemBytes = 232448;

// Encodes word `wl` of one read.
//   tok:    the read's tokens, staged in shared memory, clamped to [0, A).
//   steps:  grams to bundle, min(m, L - n + 1).
//   m:      valid grams of the read (the majority's denominator).
//   ims:    item-memory slice in shared memory, [(j * A + a) * stride + wl].
// Each thread keeps its word's 32 bit counters in registers: the counts
// reach m <= L, far below int32's range.
__device__ __forceinline__ uint32_t encode_word(
    const uint8_t* __restrict__ tok, int steps, int m,
    const uint32_t* __restrict__ ims, int stride, int A, int n, int wl,
    uint32_t tie) {
  int cnt[32];
#pragma unroll
  for (int b = 0; b < 32; ++b) cnt[b] = 0;
  for (int i = 0; i < steps; ++i) {
    uint32_t gram = 0u;
    for (int j = 0; j < n; ++j) {
      gram ^= ims[(j * A + tok[i + j]) * stride + wl];
    }
#pragma unroll
    for (int b = 0; b < 32; ++b) cnt[b] += static_cast<int>((gram >> b) & 1u);
  }
  uint32_t out = 0u;
#pragma unroll
  for (int b = 0; b < 32; ++b) {
    const int twice = 2 * cnt[b];
    const uint32_t bit =
        twice > m ? 1u : (twice == m ? (tie >> b) & 1u : 0u);
    out |= bit << b;
  }
  return out;
}

// Stages `rows` reads of `L` tokens, starting at read r0, into shared
// memory as bytes clamped to [0, A).  Rows past B are zeros.
__device__ __forceinline__ void stage_tokens(
    uint8_t* __restrict__ dst, const int32_t* __restrict__ tokens, int r0,
    int rows, int B, int L, int A, int tid, int nthreads) {
  const int total = rows * L;
  for (int k = tid; k < total; k += nthreads) {
    const int rr = k / L;
    const int r = r0 + rr;
    int t = r < B ? tokens[static_cast<size_t>(r) * L + (k - rr * L)] : 0;
    t = t < 0 ? 0 : (t >= A ? A - 1 : t);
    dst[k] = static_cast<uint8_t>(t);
  }
}

// Stages words [w0, w0 + span) of every row of im_rolled (n * A rows of W
// words) into shared memory, [row * span + wl]; words past W are zeros.
__device__ __forceinline__ void stage_item_memory(
    uint32_t* __restrict__ dst, const uint32_t* __restrict__ imr, int rows,
    int W, int w0, int span, int tid, int nthreads) {
  const int total = rows * span;
  for (int k = tid; k < total; k += nthreads) {
    const int row = k / span;
    const int w = w0 + (k - row * span);
    dst[k] = w < W ? imr[static_cast<size_t>(row) * W + w] : 0u;
  }
}

}  // namespace demeter
