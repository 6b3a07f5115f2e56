// Shared device code of the encoder and fused encode->search kernels.
//
// Packed HD vectors are uint32 words, LSB-first.  A read of length len has
// m = max(len - n + 1, 0) valid n-grams; gram i binds its n tokens as
//   gram_i[w] = XOR_{j<n} im_rolled[j][tok[i + j]][w]
// and bit b of the encoded word is 1 when 2 * count_b > m, the tie
// vector's bit when 2 * count_b == m, else 0 (the majority of
// repro.core.encoder.binarize_majority).
//
// What bounds the encode on Hopper is integer issue: 32-bit add and logic
// run at 64 a clock per SM on compute capability 9.0 (CUDA C++
// Programming Guide, arithmetic-instruction throughput table), ~16.7 T/s
// on 132 SMs at 1.98 GHz.  The design cuts the instructions per
// word-gram from ~140 to ~6:
//
// * Rolling bind.  rho rolls whole words, so
//     gram_{i+1}[w] = gram_i[w + 1] ^ T[p_i][w],
//     T[p][w] = im_rolled[0][p >> 2][w + 1] ^ im_rolled[n-1][p & 3][w],
//   with the pair id p_i = 4 tok[i] + tok[i + n] and word indices mod W.
//   A warp owns a run of kRunWords consecutive words (kLaneWords a lane):
//   per gram a lane loads its four T words with one 16-byte shared load,
//   takes its right neighbour's first word with one shuffle, and XORs.
//   The word right of the run belongs to another warp; its gram is
//   computed directly, 32 grams at a time (one a lane), from the run's
//   (n, 4) column of im_rolled, and handed over by a shuffle.  A run may
//   wrap past W (words mod W): every copy of a word computes the same
//   value, and a run stores only the words it owns.
// * Bit-sliced counters.  A lane keeps K planes per word: bit b of plane k
//   is bit k of counter b.  Grams enter 16 at a time through a
//   carry-save (Harley-Seal) adder tree into the four low planes; its
//   carry-out, weight 16, ripples into the high planes.  A full adder is
//   two LOP3s, so counting costs ~2-3 instructions per word-gram, against
//   ~64-96 for 32 separate counters.
// * Majority without unpacking.  2 c > m is c > m >> 1 when m is even and
//   c >= (m + 1) >> 1 = c > m >> 1 when m is odd; 2 c == m only for even
//   m.  A bit-sliced comparison of the planes with the constant m >> 1,
//   from the top plane down, gives both masks in ~2 instructions a plane.
//
// Tokens are 2-bit symbols (alphabets of at most 4, clamped to [0, A)),
// staged 16 to a word; the pair ids are staged as 4-bit nibbles, 8 to a
// word.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace demeter {

// Bytes a block may use of shared memory on Hopper (227 KB).
constexpr int kMaxSmemBytes = 232448;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kLaneWords = 4;               // words a lane owns in a run
constexpr int kRunWords = 32 * kLaneWords;  // words a warp encodes at once
constexpr int kPairs = 16;                  // pair ids (4 x 4 symbols)

// Most grams a read may have: the counters keep at most 20 planes.
constexpr int kMaxGrams = (1 << 20) - 1;

__host__ __device__ inline int round16(int words) {
  return (words + 3) / 4 * 4;  // words -> a multiple of 16 bytes
}

// Words of one read's staged tokens (16 a word, zero past L, room for the
// 32-gram edge windows) and of its pair ids (8 a word).
__host__ __device__ inline int tok_words(int L) {
  return round16((L + 31) / 16 + 2);
}
__host__ __device__ inline int pair_words(int L) {
  return round16(L / 8 + 2);
}

// Planes the counters of grams < g need (g < 2^planes).
__host__ __device__ inline int planes_for(int g) {
  return g < (1 << 8) ? 8 : (g < (1 << 14) ? 14 : 20);
}

// 16 tokens starting at token i.
__device__ __forceinline__ uint32_t tokens16(const uint32_t* toks2, int i) {
  const int q = i >> 4;
  return __funnelshift_r(toks2[q], toks2[q + 1], 2 * (i & 15));
}

// Stages `rows` reads starting at read r0: tokens 16 to a word at
// toks2 + rr * tw, zero past the read's L tokens and for rows past B.
__device__ __forceinline__ void stage_tokens(uint32_t* __restrict__ toks2,
                                             const int32_t* __restrict__ tokens,
                                             int r0, int rows, int B, int L,
                                             int A, int tw, int tid,
                                             int nthreads) {
  for (int k = tid; k < rows * tw; k += nthreads) {
    const int rr = k / tw;
    const int q = k - rr * tw;
    const int r = r0 + rr;
    uint32_t word = 0u;
    if (r < B) {
      const int32_t* row = tokens + static_cast<size_t>(r) * L;
#pragma unroll
      for (int t = 0; t < 16; ++t) {  // independent loads, issued together
        const int i = 16 * q + t;
        int c = i < L ? __ldg(row + i) : 0;
        c = c < 0 ? 0 : (c >= A ? A - 1 : c);
        word |= static_cast<uint32_t>(c) << (2 * t);
      }
    }
    toks2[k] = word;
  }
}

// From staged tokens: pair ids p_i = 4 tok[i] + tok[i + n] for i + n < L,
// 8 nibbles a word at pairs + rr * pw, zero elsewhere.
__device__ __forceinline__ void stage_pairs(uint32_t* __restrict__ pairs,
                                            const uint32_t* __restrict__ toks2,
                                            int rows, int L, int n, int tw,
                                            int pw, int tid, int nthreads) {
  for (int k = tid; k < rows * pw; k += nthreads) {
    const int rr = k / pw;
    const int q = k - rr * pw;
    const uint32_t* tk = toks2 + rr * tw;
    uint32_t word = 0u;
    for (int t = 0; t < 8; ++t) {
      const int i = 8 * q + t;
      if (i + n >= L) break;
      const uint32_t a = (tk[i >> 4] >> (2 * (i & 15))) & 3u;
      const uint32_t b = (tk[(i + n) >> 4] >> (2 * ((i + n) & 15))) & 3u;
      word |= (4u * a + b) << (4 * t);
    }
    pairs[k] = word;
  }
}

// The pair table of the word positions [w0, w0 + cols) (mod W):
// tbl[p * cols + pos] = imr[0][p >> 2][w + 1] ^ imr[n-1][p & 3][w], with
// symbols past A clamped (they never occur in staged tokens).
__device__ __forceinline__ void stage_pair_table(
    uint32_t* __restrict__ tbl, const uint32_t* __restrict__ imr, int n,
    int A, int W, int w0, int cols, int tid, int nthreads) {
  const uint32_t* first = imr;
  const uint32_t* last = imr + static_cast<size_t>(n - 1) * A * W;
  for (int k = tid; k < kPairs * cols; k += nthreads) {
    const int p = k / cols;
    const int w = (w0 + (k - p * cols)) % W;
    const int a = min(p >> 2, A - 1), b = min(p & 3, A - 1);
    const int w1 = w + 1 == W ? 0 : w + 1;
    tbl[k] = first[static_cast<size_t>(a) * W + w1] ^
             last[static_cast<size_t>(b) * W + w];
  }
}

// The edge columns of `runs` runs starting at word w0: for run u, the word
// right of it, we = (w0 + (u + 1) * kRunWords) mod W, as
// edge[(u * n + j) * 4 + a] = imr[j][min(a, A - 1)][we].
__device__ __forceinline__ void stage_edges(uint32_t* __restrict__ edge,
                                            const uint32_t* __restrict__ imr,
                                            int n, int A, int W, int w0,
                                            int runs, int tid, int nthreads) {
  for (int k = tid; k < runs * n * 4; k += nthreads) {
    const int u = k / (n * 4);
    const int j = (k / 4) % n;
    const int a = min(k & 3, A - 1);
    const int we = (w0 + (u + 1) * kRunWords) % W;
    edge[k] = imr[(static_cast<size_t>(j) * A + a) * W + we];
  }
}

// gram_i of one word from the n (4-symbol) entries of its column:
// col[j * 4 + a] = imr[j][a][w].
__device__ __forceinline__ uint32_t direct_gram(const uint32_t* col,
                                                const uint32_t* toks2, int i,
                                                int n) {
  uint32_t g = 0u;
  for (int j0 = 0; j0 < n; j0 += 16) {
    const uint32_t t = tokens16(toks2, i + j0);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (j0 + j < n) g ^= col[(j0 + j) * 4 + ((t >> (2 * j)) & 3u)];
    }
  }
  return g;
}

// Carry-save adder: (h, l) = (majority, parity) of (a, b, c).
__device__ __forceinline__ void csa(uint32_t& h, uint32_t& l, uint32_t a,
                                    uint32_t b, uint32_t c) {
  const uint32_t u = a ^ b;
  h = (a & b) | (u & c);
  l = u ^ c;
}

// One warp's state while it encodes one run of one read.
template <int K>
struct RunState {
  uint32_t gram[kLaneWords];     // gram_s at this lane's four words
  uint32_t pl[kLaneWords][K];    // bit-sliced counters, plane 0 lowest
};

// gram_s -> gram_{s+1}: tbl4 points at this lane's words of row 0 of the
// pair table (row stride `cols` words); e is gram_s at the word right of
// the run, needed by lane 31 only.
__device__ __forceinline__ void advance(uint32_t (&gram)[kLaneWords],
                                        const uint32_t* tbl4, int cols,
                                        uint32_t p, uint32_t e, int lane) {
  const uint4 t = *reinterpret_cast<const uint4*>(tbl4 + p * cols);
  uint32_t in = __shfl_down_sync(kFull, gram[0], 1);
  in = lane == 31 ? e : in;
  gram[0] = gram[1] ^ t.x;
  gram[1] = gram[2] ^ t.y;
  gram[2] = gram[3] ^ t.z;
  gram[3] = in ^ t.w;
}

// Counts grams s0 .. s0 + 15 (those below `steps` when kMask) and leaves
// gram_{s0+16} in st.gram.  pw0/pw1 hold the 16 pair ids; ebuf holds the
// edge grams of the current 32-gram chunk, one a lane, from lane eoff.
template <int K, bool kMask>
__device__ __forceinline__ void group16(RunState<K>& st, const uint32_t* tbl4,
                                        int cols, uint32_t pw0, uint32_t pw1,
                                        uint32_t ebuf, int eoff, int lane,
                                        int left) {
  uint32_t twosA[kLaneWords], twosB[kLaneWords], foursA[kLaneWords],
      foursB[kLaneWords], eightsA[kLaneWords], eightsB[kLaneWords];
#pragma unroll
  for (int k = 0; k < 16; k += 2) {
    uint32_t xa[kLaneWords], xb[kLaneWords];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kk = k + h;
#pragma unroll
      for (int v = 0; v < kLaneWords; ++v) {
        const uint32_t x = (!kMask || kk < left) ? st.gram[v] : 0u;
        if (h == 0) {
          xa[v] = x;
        } else {
          xb[v] = x;
        }
      }
      const uint32_t p = ((kk < 8 ? pw0 : pw1) >> (4 * (kk & 7))) & 15u;
      const uint32_t e = __shfl_sync(kFull, ebuf, eoff + kk);
      advance(st.gram, tbl4, cols, p, e, lane);
    }
#pragma unroll
    for (int v = 0; v < kLaneWords; ++v) {
      uint32_t& ones = st.pl[v][0];
      uint32_t& twos = st.pl[v][1];
      uint32_t& fours = st.pl[v][2];
      uint32_t& eights = st.pl[v][3];
      if ((k & 2) == 0) {
        csa(twosA[v], ones, ones, xa[v], xb[v]);
      } else {
        csa(twosB[v], ones, ones, xa[v], xb[v]);
        if ((k & 4) == 0) {
          csa(foursA[v], twos, twos, twosA[v], twosB[v]);
        } else {
          csa(foursB[v], twos, twos, twosA[v], twosB[v]);
          if ((k & 8) == 0) {
            csa(eightsA[v], fours, fours, foursA[v], foursB[v]);
          } else {
            csa(eightsB[v], fours, fours, foursA[v], foursB[v]);
            uint32_t carry;
            csa(carry, eights, eights, eightsA[v], eightsB[v]);
#pragma unroll
            for (int q = 4; q < K; ++q) {
              const uint32_t t = st.pl[v][q] & carry;
              st.pl[v][q] ^= carry;
              carry = t;
            }
          }
        }
      }
    }
  }
}

// Majority of one word from its planes: bit = count > m >> 1, or the tie
// bit where count == m >> 1 and m is even.
template <int K>
__device__ __forceinline__ uint32_t majority(const uint32_t (&pl)[K], int m,
                                             uint32_t tie) {
  const int half = m >> 1;
  if (half >> K) return 0u;  // no count reaches it (counts < 2^K)
  uint32_t gt = 0u, eq = kFull;
#pragma unroll
  for (int k = K - 1; k >= 0; --k) {
    if ((half >> k) & 1) {
      eq &= pl[k];
    } else {
      gt |= eq & pl[k];
      eq &= ~pl[k];
    }
  }
  return gt | (eq & ((m & 1) ? 0u : tie));
}

// Encodes run `u` (positions [u * kRunWords, (u + 1) * kRunWords) of the
// block's words w0 + pos, mod W) of one read and returns this lane's four
// output words (positions u * kRunWords + 4 * lane + v).
//   toks2, pairs: the read's staged tokens and pair ids.
//   tbl, cols:    the block's pair table and its row length in words.
//   edge:         the run's edge column (n x 4 words).
//   imr:          im_rolled in global memory, for gram_0.
//   steps, m:     grams to count (min(m, L - n + 1)) and the denominator.
//   tie4:         the tie vector's words at this lane's positions.
template <int K>
__device__ __forceinline__ uint4 encode_run(
    const uint32_t* __restrict__ toks2, const uint32_t* __restrict__ pairs,
    const uint32_t* __restrict__ tbl, int cols,
    const uint32_t* __restrict__ edge, const uint32_t* __restrict__ imr,
    int n, int A, int W, int w0, int u, int steps, int m, uint4 tie4,
    int lane) {
  RunState<K> st;
  const int pos0 = u * kRunWords + kLaneWords * lane;
#pragma unroll
  for (int v = 0; v < kLaneWords; ++v) {
#pragma unroll
    for (int q = 0; q < K; ++q) st.pl[v][q] = 0u;
    st.gram[v] = 0u;
  }
  if (steps > 0) {
    int wv[kLaneWords];
#pragma unroll
    for (int v = 0; v < kLaneWords; ++v) wv[v] = (w0 + pos0 + v) % W;
    for (int j0 = 0; j0 < n; j0 += 16) {
      const uint32_t t = tokens16(toks2, j0);
#pragma unroll
      for (int j = 0; j < 16; ++j) {  // independent loads, issued together
        if (j0 + j >= n) break;
        const int a = min(static_cast<int>((t >> (2 * j)) & 3u), A - 1);
        const uint32_t* row = imr + (static_cast<size_t>(j0 + j) * A + a) * W;
#pragma unroll
        for (int v = 0; v < kLaneWords; ++v) st.gram[v] ^= __ldg(row + wv[v]);
      }
    }
  }
  const uint32_t* tbl4 = tbl + pos0;
  uint32_t ebuf = 0u;
  for (int s0 = 0; s0 < steps; s0 += 16) {
    if ((s0 & 31) == 0) ebuf = direct_gram(edge, toks2, s0 + lane, n);
    const uint2 pw = *reinterpret_cast<const uint2*>(pairs + (s0 >> 3));
    if (s0 + 16 <= steps) {
      group16<K, false>(st, tbl4, cols, pw.x, pw.y, ebuf, s0 & 31, lane, 16);
    } else {
      group16<K, true>(st, tbl4, cols, pw.x, pw.y, ebuf, s0 & 31, lane,
                       steps - s0);
    }
  }
  uint4 out;
  out.x = majority<K>(st.pl[0], m, tie4.x);
  out.y = majority<K>(st.pl[1], m, tie4.y);
  out.z = majority<K>(st.pl[2], m, tie4.z);
  out.w = majority<K>(st.pl[3], m, tie4.w);
  return out;
}

// The tie vector's words at positions pos0 .. pos0 + 3 of w0 + pos (mod W).
__device__ __forceinline__ uint4 tie_words(const uint32_t* __restrict__ tie,
                                           int W, int w0, int pos0) {
  uint4 t;
  t.x = __ldg(tie + (w0 + pos0) % W);
  t.y = __ldg(tie + (w0 + pos0 + 1) % W);
  t.z = __ldg(tie + (w0 + pos0 + 2) % W);
  t.w = __ldg(tie + (w0 + pos0 + 3) % W);
  return t;
}

}  // namespace demeter
