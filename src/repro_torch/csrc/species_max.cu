// Per-species max of the agreement for Hopper (sm_90a):
//   out[r, s] = max over prototypes p with ids[p] == s of a[r, p],
// the int32 minimum (NO_SCORE) where species s has no prototype; ids
// outside [0, S) (the sharded backend's tail padding) are skipped.
//
// Replaces no Pallas kernel: repro leaves the same reduction to XLA as
// jax.ops.segment_max(..., indices_are_sorted=True)
// (src/repro/core/assoc_memory.py:288-302).  The port ran it as
// scatter_reduce_(amax), a global atomic max a element onto the 20-31
// addresses of a row, about 200x this kernel's bound.
//
// Bound.  Bytes: the (B, P) int32 agreement is read once and the (B, S)
// result written once, 4 B P + 4 B S at 3.35 TB/s (0.59 ms at B = 4,096,
// P = 121,117).  Nothing else is near it: a few integer operations an
// element.
//
// Design.  Every RefDB the port builds has non-decreasing ids, so each
// species is a run of columns (about 3,900 on AFS31, 1,465 on AFS20).
// * A block owns a chunk of at most kChunk columns and a stride of rows.
//   It stages the chunk's ids in shared memory once and splits the chunk
//   into runs of one id (ballots over the staged ids), so the ids cost
//   4 P bytes from L2 a block, not a load an element.
// * A warp takes one row at a time and, for each run of a valid id,
//   streams that run's stretch of the row in 16-byte loads (kUnroll of
//   them in flight a lane, evict-first), keeps the max in a register,
//   reduces it across the warp (__reduce_max_sync) and adds it to the
//   output with one global atomic max: one atomic a (row, run) instead of
//   one an element.  Runs of an invalid id are never read.
// * Rows need not be 16-byte aligned (121,117 x 4 B is 4 mod 16): the
//   stretches are walked in aligned 16-byte vectors and the vectors at
//   their two ends load only the elements inside.
// * Ids in no order make short runs: still exact, only slower (a warp
//   pass and an atomic a run a row).  The result is exact for any ids and
//   any S: an integer max does not depend on the order of the atomics, so
//   every run gives the same bits.
// Chunks are of equal width; the row strides are as many as let chunks x
// strides blocks be resident at once (one wave where P allows it).
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 4096;    // columns a block stages (16 KB of ids)
constexpr int kSeg = kChunk / kWarps;
constexpr int kUnroll = 4;      // 16-byte loads in flight a lane
constexpr unsigned kAll = 0xffffffffu;

// The elements of aligned vector v (positions 4v .. 4v + 3) that lie in
// [f0, f1); the others read as INT_MIN.  Position e is element e - h of
// the agreement, so 4v is 16-byte aligned.
__device__ __forceinline__ int4 load_vec(const int* __restrict__ a,
                                         long long v, long long f0,
                                         long long f1, int h) {
  const long long e = 4 * v;
  if (e >= f0 && e + 4 <= f1) {
    return __ldcs(reinterpret_cast<const int4*>(a + (e - h)));
  }
  int4 x = make_int4(INT_MIN, INT_MIN, INT_MIN, INT_MIN);
  if (e >= f0 && e < f1) x.x = __ldcs(a + (e - h));
  if (e + 1 >= f0 && e + 1 < f1) x.y = __ldcs(a + (e + 1 - h));
  if (e + 2 >= f0 && e + 2 < f1) x.z = __ldcs(a + (e + 2 - h));
  if (e + 3 >= f0 && e + 3 < f1) x.w = __ldcs(a + (e + 3 - h));
  return x;
}

__device__ __forceinline__ int max4(const int4& x) {
  return max(max(x.x, x.y), max(x.z, x.w));
}

// Max of positions [f0, f1), across the warp (every lane gets it).
__device__ __forceinline__ int stretch_max(const int* __restrict__ a,
                                           long long f0, long long f1, int h,
                                           int lane) {
  const long long v1 = (f1 + 3) >> 2;
  int m = INT_MIN;
  for (long long v = (f0 >> 2) + lane; v < v1; v += 32 * kUnroll) {
    int4 x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) x[u] = load_vec(a, v + 32 * u, f0, f1, h);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) m = max(m, max4(x[u]));
  }
  return __reduce_max_sync(kAll, m);
}

// a: (B, P) int32 rows `lda` elements apart, h = (address of a / 4) % 4;
// ids: (P,) int32; out: (B, S) int32, filled with INT_MIN beforehand.
// Block (x, y) owns columns [x cw, x cw + cw) and rows y kWarps + warp,
// stepping gridDim.y kWarps.
__global__ void __launch_bounds__(kThreads, 4)
species_max_kernel(const int* __restrict__ a, const int* __restrict__ ids,
                   int* __restrict__ out, int B, int P, long long lda, int S,
                   int cw, int h) {
  __shared__ int sid[kChunk];
  __shared__ int run_start[kChunk + 1];
  __shared__ int warp_runs[kWarps];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * cw;
  const int n = min(cw, P - c0);
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int id = __ldg(ids + c0 + i);
    sid[i] = (id >= 0 && id < S) ? id : -1;
  }
  __syncthreads();

  // Runs: position i starts one where its id differs from i - 1's.
  // Warp w counts the starts among positions [w kSeg, (w + 1) kSeg).
  const int seg0 = warp * kSeg;
  int mine = 0;
  for (int i = seg0 + lane; i < seg0 + kSeg; i += 32) {
    const bool starts = i < n && (i == 0 || sid[i] != sid[i - 1]);
    mine += __popc(__ballot_sync(kAll, starts));
  }
  if (lane == 0) warp_runs[warp] = mine;
  __syncthreads();
  int runs = 0, before = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? warp_runs[w] : 0;
    runs += warp_runs[w];
  }
  for (int i = seg0 + lane; i < seg0 + kSeg; i += 32) {
    const bool starts = i < n && (i == 0 || sid[i] != sid[i - 1]);
    const unsigned m = __ballot_sync(kAll, starts);
    if (starts) run_start[before + __popc(m & ((1u << lane) - 1))] = i;
    before += __popc(m);
  }
  if (threadIdx.x == 0) run_start[runs] = n;
  __syncthreads();

  for (int row = blockIdx.y * kWarps + warp; row < B;
       row += gridDim.y * kWarps) {
    const long long base = row * lda + c0 + h;
    int* const orow = out + (long long)row * S;
    for (int r = 0; r < runs; ++r) {
      const int lo = run_start[r];
      const int id = sid[lo];
      if (id < 0) continue;
      const int m = stretch_max(a, base + lo, base + run_start[r + 1], h,
                                lane);
      if (lane == 0 && m != INT_MIN) atomicMax(orow + id, m);
    }
  }
}

// The grid's figures for the current device, found on its first call:
// SMs and resident blocks an SM.
cudaError_t device_fit(int* sms, int* per_sm) {
  constexpr int kMaxDevices = 64;
  static int sms_of[kMaxDevices], per_sm_of[kMaxDevices];  // 0: not found
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sms_of[dev] == 0) {
    int n = 0, k = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &k, species_max_kernel, kThreads, 0);
    }
    if (err != cudaSuccess) return err;
    per_sm_of[dev] = k > 0 ? k : 1;
    sms_of[dev] = n;
  }
  *sms = sms_of[dev];
  *per_sm = per_sm_of[dev];
  return cudaSuccess;
}

}  // namespace

// a (B, P) int32 with rows lda >= P elements apart (4-byte aligned),
// ids (P,) int32, out (B, S) int32 contiguous and filled with INT_MIN by
// the caller: out = the per-species max, INT_MIN where a species has no
// prototype.  Returns a cudaError_t.
extern "C" int species_max_launch(const int* a, const int* ids, int* out,
                                  int B, int P, long long lda, int S,
                                  void* stream) {
  if (B <= 0 || S <= 0 || P <= 0) return 0;
  if (lda < P || reinterpret_cast<uintptr_t>(a) % 4 != 0) {
    return cudaErrorInvalidValue;
  }
  int sms = 0, per_sm = 0;
  const cudaError_t err = device_fit(&sms, &per_sm);
  if (err != cudaSuccess) return err;
  // Chunks of equal width; row strides so that the grid is one wave.
  const int chunks = (P + kChunk - 1) / kChunk;
  const int cw = (P + chunks - 1) / chunks;
  const long long slots = (long long)sms * per_sm;
  long long strides = slots / chunks;
  const long long most = (B + kWarps - 1) / kWarps;
  strides = strides < 1 ? 1 : (strides > most ? most : strides);
  strides = strides > 65535 ? 65535 : strides;
  const int h = static_cast<int>((reinterpret_cast<uintptr_t>(a) >> 2) & 3);
  species_max_kernel<<<dim3(chunks, (unsigned)strides), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      a, ids, out, B, P, lda, S, cw, h);
  return cudaGetLastError();
}
