// The crossbar read's per-chunk epilogue: read noise, ADC and the sum over
// row tiles, in one pass over one chunk's partial counts.
//
// Replaces no Pallas kernel: the JAX package (src/repro/accel/crossbar.py)
// draws the read noise with jax.random and leaves the ADC and the sums over
// the row tiles to XLA.  The port's read (accel/crossbar.py) takes each
// chunk's (t, B, S) float32 partial counts from a cuBLAS product; this kernel
// then does, for every (b, s) and each of the chunk's tiles in order:
//
//   count += (std[tile, b] * normal(key[tile], b * S + s)) / divisor
//                                         (the noise, when the read has any)
//   code   = rint(count / step)           (no divide when step is 1)
//   clips += code < 0 || code > levels    (only when asked)
//   code   = clamp(code, 0, levels) * step  (no multiply when step is 1)
//   sum   += code
//
// and writes sum into the (B, S) output, or adds it there.  The normal is
// jax.random.normal's value of the tile's key at that counter, drawn in
// registers with the Threefry kernel's own code (threefry_common.cuh), in
// either jax_threefry_partitionable mode, and every float32 step is the one
// the plain version takes (Threefry epilogue, round_, clamp_, mul_): at a
// lossless ADC the codes are whole counts and their sum is exact in any
// order, so the result equals the plain version's bit for bit.  At a lossy
// ADC the codes times the step are summed here in tile order, where
// torch.sum promises no order: the two may differ in the last bit.
//
// What bounds it on the card: integer operations.  A draw is ~75 32-bit
// operations (20 Threefry rounds of add / rotate / xor, the key injections,
// the normal's bit work): a 17-tile chunk at 4,096 x 29,440 is 2.05 G draws,
// 9.2 ms at the H100's 64 integer operations a clock an SM, where its bytes
// (the counts read once, the output read and written) take 2.7 ms.
// The design: one thread owns a fixed group of 4 counters (and, in the
// original mode, the 4 paired counters half a tile further on) and walks the
// chunk's tiles, so the loop holds nothing but the draws, 16-byte loads of
// neighbouring counts and the ADC's few float steps: no 64-bit multiply and
// no integer division per element (each value's query row is found once).
// Noise on or off is a template switch; the clip count is one block
// reduction and one atomic a block.

#include <cstdint>
#include <cuda_runtime.h>

#include "threefry_common.cuh"

namespace {

constexpr int kThreads = 256;

struct Params {
  const float* counts;         // (tiles, m) partial counts of the chunk
  const uint32_t* keys;        // (tiles, 2) the tiles' keys
  const float* noise_std;      // (tiles, rows) noise std, or null
  float* out;                  // (m) codes summed over the tiles
  unsigned long long* clips;   // clamped codes are counted here, or null
  unsigned m;                  // values a tile: rows * cols, < 2^31
  unsigned rows, cols;         // B queries x S columns
  int tiles;
  float lo, range;             // the normal's uniform on [lo, lo + range)
  float divisor;               // the noise is divided by it (1: not)
  float levels, step;          // codes in [0, levels], step counts a code
  int overwrite;               // out = sum instead of out += sum
};

template <int V>
__device__ __forceinline__ void load(const float* src, float* x) {
  if constexpr (V == 4) {
    const float4 v = __ldcs(reinterpret_cast<const float4*>(src));
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else {
    x[0] = __ldcs(src);
  }
}

template <int V>
__device__ __forceinline__ void store(float* dst, const float* acc,
                                      bool overwrite) {
  if constexpr (V == 4) {
    float4* d = reinterpret_cast<float4*>(dst);
    float4 v = make_float4(acc[0], acc[1], acc[2], acc[3]);
    if (!overwrite) {
      const float4 o = *d;
      v.x = __fadd_rn(o.x, v.x);
      v.y = __fadd_rn(o.y, v.y);
      v.z = __fadd_rn(o.z, v.z);
      v.w = __fadd_rn(o.w, v.w);
    }
    *d = v;
  } else {
    *dst = overwrite ? acc[0] : __fadd_rn(*dst, acc[0]);
  }
}

// One thread: V counters of a tile (partitionable: values base .. base+V-1;
// original: the pairs (j, j + half) for j in base .. base+V-1).  With V = 4
// the wrapper guarantees that every group is whole and 16-byte aligned.
template <bool PARTITIONABLE, bool NOISE, int V>
__global__ void __launch_bounds__(kThreads) crossbar_adc_kernel(Params p) {
  constexpr int N = PARTITIONABLE ? V : 2 * V;
  const unsigned half = PARTITIONABLE ? p.m : (p.m + 1) / 2;
  const unsigned groups = (half + V - 1) / V;
  const unsigned g = blockIdx.x * kThreads + threadIdx.x;
  unsigned clipped = 0;
  if (g < groups) {
    const unsigned base = g * V;
    unsigned row[N];
    bool live[N];
    float acc[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const unsigned idx = k < V ? base + k : half + base + (k - V);
      live[k] = idx < p.m;
      row[k] = live[k] ? idx / p.cols : 0u;
      acc[k] = 0.0f;
    }
    const float* c = p.counts;
    const float* sd = p.noise_std;
    for (int tile = 0; tile < p.tiles; ++tile, c += p.m) {
      float x[N];
      load<V>(c + base, x);
      if constexpr (!PARTITIONABLE) {
        if (V == 4 || live[N - 1]) {
          load<V>(c + half + base, x + V);
        } else {
          x[V] = 0.0f;                 // an odd m's last pair has no value
        }
      }
      if constexpr (NOISE) {
        const uint32_t k0 = __ldg(p.keys + 2 * tile);
        const uint32_t k1 = __ldg(p.keys + 2 * tile + 1);
        uint32_t word[N];
#pragma unroll
        for (int q = 0; q < V; ++q) {
          if constexpr (PARTITIONABLE) {
            uint32_t x0 = 0u, x1 = base + q;
            threefry::threefry2x32(k0, k1, x0, x1);
            word[q] = x0 ^ x1;
          } else {
            uint32_t x0 = base + q, x1 = live[V + q] ? half + base + q : 0u;
            threefry::threefry2x32(k0, k1, x0, x1);
            word[q] = x0;
            word[V + q] = x1;
          }
        }
#pragma unroll
        for (int k = 0; k < N; ++k) {
          float v = threefry::normal(word[k], p.lo, p.range);
          v = __fmul_rn(__ldg(sd + row[k]), v);
          if (p.divisor != 1.0f) v = __fdiv_rn(v, p.divisor);
          x[k] = __fadd_rn(x[k], v);
        }
        sd += p.rows;
      }
#pragma unroll
      for (int k = 0; k < N; ++k) {
        float code = rintf(p.step != 1.0f ? __fdiv_rn(x[k], p.step) : x[k]);
        clipped += (live[k] && (code < 0.0f || code > p.levels)) ? 1u : 0u;
        code = fminf(fmaxf(code, 0.0f), p.levels);
        if (p.step != 1.0f) code = __fmul_rn(code, p.step);
        acc[k] = __fadd_rn(acc[k], code);
      }
    }
    store<V>(p.out + base, acc, p.overwrite);
    if constexpr (!PARTITIONABLE) {
      if (V == 4 || live[N - 1]) store<V>(p.out + half + base, acc + V,
                                          p.overwrite);
    }
  }
  if (p.clips != nullptr) {            // the same branch for the whole block
    __shared__ unsigned warp_sums[kThreads / 32];
    clipped = __reduce_add_sync(0xFFFFFFFFu, clipped);
    if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x / 32] = clipped;
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned long long total = 0;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
      if (total != 0) atomicAdd(p.clips, total);
    }
  }
}

template <bool PARTITIONABLE, bool NOISE>
cudaError_t launch(const Params& p, bool vec, cudaStream_t stream) {
  const unsigned long long half = PARTITIONABLE ? p.m : (p.m + 1ull) / 2;
  const unsigned long long groups = vec ? half / 4 : half;
  const unsigned blocks = (unsigned)((groups + kThreads - 1) / kThreads);
  if (vec) {
    crossbar_adc_kernel<PARTITIONABLE, NOISE, 4>
        <<<blocks, kThreads, 0, stream>>>(p);
  } else {
    crossbar_adc_kernel<PARTITIONABLE, NOISE, 1>
        <<<blocks, kThreads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

// One chunk of tiles x rows x cols partial counts -> the (rows, cols) output.
// The wrapper checks shapes, types and that rows * cols < 2^31; keys and
// noise_std may be null when noise is 0.  Returns the launch's CUDA error.
extern "C" int crossbar_adc_launch(const void* counts, const void* keys,
                                   const void* noise_std, void* out,
                                   void* clips,
                                   long long tiles, long long rows,
                                   long long cols, int partitionable,
                                   int noise, float lo, float range,
                                   float divisor, float levels, float step,
                                   int overwrite, void* stream) {
  if (tiles <= 0 || rows <= 0 || cols <= 0) return 0;
  Params p;
  p.counts = static_cast<const float*>(counts);
  p.keys = static_cast<const uint32_t*>(keys);
  p.noise_std = static_cast<const float*>(noise_std);
  p.out = static_cast<float*>(out);
  p.clips = static_cast<unsigned long long*>(clips);
  p.m = (unsigned)(rows * cols);
  p.rows = (unsigned)rows;
  p.cols = (unsigned)cols;
  p.tiles = (int)tiles;
  p.lo = lo;
  p.range = range;
  p.divisor = divisor;
  p.levels = levels;
  p.step = step;
  p.overwrite = overwrite;
  // 16-byte groups where every group is whole: m a multiple of 4, and in
  // the original mode of 8, so that the second half starts on a group too.
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(counts) |
        reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
  const bool vec = aligned && p.m % (partitionable ? 4u : 8u) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (partitionable) {
    return (int)(noise ? launch<true, true>(p, vec, s)
                       : launch<true, false>(p, vec, s));
  }
  return (int)(noise ? launch<false, true>(p, vec, s)
                     : launch<false, false>(p, vec, s));
}
