"""Plain torch models of the arithmetic of the CUDA encoder and fused
kernels, held bit-exactly against ``repro`` on the CPU.

The kernels (``csrc/hdc_common.cuh``, ``csrc/fused_profile.cu``) run only
on the card, so their arithmetic is modelled here step for step, in torch
on int32 bit patterns, and each model is held against ``repro``'s oracles:

* the bit-sliced counters: grams enter 16 at a time through a carry-save
  (Harley-Seal) tree into the low four planes, whose carry ripples into
  the high planes; grams past ``m`` are masked to zero;
* the majority without unpacking: a bit-sliced comparison of the planes
  with ``m >> 1``, the tie bit where they are equal and ``m`` is even;
* the rolling word recurrence of a warp's run of 128 words,
  ``gram_{i+1}[w] = gram_i[w + 1] ^ T[p_i][w]``, with the word right of
  the run recomputed directly 32 grams at a time, runs wrapping past W;
* the search identity ``agreement = D - |a| - |b| + 2 popc(a & b)`` over
  32-word steps whose words pair up as the mma fragments take them, with
  zero pad words and rows (inert in ``a & b``), tiles of ``bb`` = 16 or
  32 reads, and prototypes in groups of 16.

Nothing on the CUDA path calls these models.  Every output is an integer:
the tolerance is exact equality.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert
from repro_torch.core import bitops, item_memory
from repro_torch.core.hd_space import HDSpace

RUN = 128          # words a warp encodes at once (32 lanes x 4)
MASK32 = 0xFFFFFFFF


def planes_for(g: int) -> int:
    return 8 if g < 2 ** 8 else (14 if g < 2 ** 14 else 20)


def csa(a, b, c):
    """Carry-save adder: (majority, parity) of three words."""
    u = a ^ b
    return (a & b) | (u & c), u ^ c


def harley_seal16(planes, xs):
    """Add 16 words (one gram each) to bit-sliced counters in place, in
    the kernel's order: pairs into ``ones``, pairs of carries into
    ``twos``, ... and the weight-16 carry rippled into planes 4 and up."""
    ones, twos, fours, eights = planes[:4]
    for k in range(0, 16, 2):
        if k & 2 == 0:
            twos_a, ones = csa(ones, xs[k], xs[k + 1])
            continue
        twos_b, ones = csa(ones, xs[k], xs[k + 1])
        if k & 4 == 0:
            fours_a, twos = csa(twos, twos_a, twos_b)
            continue
        fours_b, twos = csa(twos, twos_a, twos_b)
        if k & 8 == 0:
            eights_a, fours = csa(fours, fours_a, fours_b)
            continue
        eights_b, fours = csa(fours, fours_a, fours_b)
        carry, eights = csa(eights, eights_a, eights_b)
        for q in range(4, len(planes)):
            planes[q], carry = planes[q] ^ carry, planes[q] & carry
    planes[:4] = [ones, twos, fours, eights]


def majority_planes(planes, m, tie):
    """Bit-sliced majority: bit = count > m >> 1, or the tie bit where
    count == m >> 1 and m is even.  ``m`` is per row, ``planes`` are
    ``(rows, ...)`` words."""
    k_planes = len(planes)
    out = torch.zeros_like(planes[0])
    for r in range(planes[0].shape[0]):
        half = int(m[r]) >> 1
        if half >> k_planes:
            continue
        gt = torch.zeros_like(planes[0][r])
        eq = torch.full_like(planes[0][r], -1)
        for k in range(k_planes - 1, -1, -1):
            if (half >> k) & 1:
                eq = eq & planes[k][r]
            else:
                gt = gt | (eq & planes[k][r])
                eq = eq & ~planes[k][r]
        tie_r = torch.zeros_like(tie) if int(m[r]) & 1 else tie
        out[r] = gt | (eq & tie_r)
    return out


def counts_of(planes):
    """Integer counters ``(..., 32 W)`` from bit-sliced planes."""
    return sum(bitops.unpack_bits(p).long() << k for k, p in enumerate(planes))


def rolling_encode_model(tokens, lengths, im_rolled, tie, *, span):
    """The encoder's warp-run routine over blocks of ``span`` words.

    Block ``x`` owns words ``[x * span, x * span + span)``; its run ``u``
    covers the 128 positions ``x * span + u * 128 + i`` (mod W) and stores
    the ones inside the block.  Each gram step shifts the run left by one
    word, takes the edge word (gram_s at the word right of the run, from a
    buffer computed directly for 32 grams at a time) into the last
    position, and XORs the pair table row of ``p_s = 4 tok[s] +
    tok[s + n]``.  Tokens past L read as 0, as the kernel stages them.
    """
    n, alphabet, w = im_rolled.shape
    b, length = tokens.shape
    toks = torch.cat([tokens.long().clamp(0, alphabet - 1),
                      torch.zeros((b, 64 + n), dtype=torch.long)], 1)
    g = max(length - n + 1, 0)
    m = torch.clamp(lengths.long() - (n - 1), min=0)
    steps = torch.minimum(m, torch.tensor(g))
    k_planes = planes_for(g)
    first, last = im_rolled[0], im_rolled[n - 1]
    out = torch.zeros((b, w), dtype=torch.int32)
    rows = torch.arange(b)
    for w0 in range(0, w, span):
        own = min(span, w - w0)
        for u in range(-(-own // RUN)):
            words = (w0 + u * RUN + torch.arange(RUN)) % w
            edge_word = (w0 + (u + 1) * RUN) % w
            table = torch.stack([
                first[min(p >> 2, alphabet - 1)][(words + 1) % w]
                ^ last[min(p & 3, alphabet - 1)][words] for p in range(16)])
            gram = torch.zeros((b, RUN), dtype=torch.int32)
            if g > 0:
                for j in range(n):
                    gram ^= im_rolled[j][toks[:, j]][:, words]
            planes = [torch.zeros((b, RUN), dtype=torch.int32)
                      for _ in range(k_planes)]
            for s0 in range(0, int(steps.max()) if b else 0, 16):
                if s0 % 32 == 0:
                    ebuf = torch.zeros((b, 32), dtype=torch.int32)
                    for t in range(32):
                        for j in range(n):
                            ebuf[:, t] ^= im_rolled[j][toks[:, s0 + t + j],
                                                       edge_word]
                xs = []
                for k in range(16):
                    s = s0 + k
                    xs.append(torch.where((s < steps)[:, None], gram, 0))
                    pair = 4 * toks[:, s] + toks[:, s + n]
                    if s + n >= length:
                        pair = torch.zeros_like(pair)
                    shifted = torch.cat([gram[:, 1:],
                                         ebuf[:, s - s0 + s0 % 32, None]], 1)
                    gram = shifted ^ table[pair]
                harley_seal16(planes, xs)
            enc = majority_planes(planes, m, tie[words])
            keep = (u * RUN + torch.arange(RUN)) < own
            out[rows[:, None], words[keep][None, :]] = enc[:, keep]
    return out


def search_model(q, p, dim, *, bb=16):
    """The fused kernel's tensor-core search on packed words.

    Reads in tiles of ``bb`` = 16 or 32 rows (the rows of a tail tile past
    B zero), prototypes in groups of 16 (zero-filled past S), W padded
    with zero words to a multiple of 32; each 32-word step sums
    ``popc(a & b)`` over the word pairs ``(8 t + 2 s, 8 t + 2 s + 1)`` of
    the four mma fragments a thread supplies; agreement =
    ``dim - |a| - |b| + 2 acc``.
    """
    b, w = q.shape
    s = p.shape[0]
    wp = -(-w // 32) * 32
    qp = bitops.pad_to_multiple(q, 1, 32)
    pp = bitops.pad_to_multiple(p, 1, 32)
    pc = bitops.popcount_words(pp)
    out = torch.empty((b, s), dtype=torch.int32)
    for r0 in range(0, b, bb):
        tile = torch.zeros((bb, wp), dtype=torch.int32)
        n_rows = min(bb, b - r0)
        tile[:n_rows] = qp[r0:r0 + n_rows]
        ra = bitops.popcount_words(tile)
        for p0 in range(0, s, 16):
            grp = torch.zeros((16, wp), dtype=torch.int32)
            grp[:min(16, s - p0)] = pp[p0:p0 + 16]
            acc = torch.zeros((bb, 16), dtype=torch.int64)
            for ks in range(wp // 32):
                for t in range(4):
                    for sub in range(4):
                        for word in (8 * t + 2 * sub, 8 * t + 2 * sub + 1):
                            col = 32 * ks + word
                            acc += bitops.popcount32(
                                tile[:, None, col] & grp[None, :, col])
            agree = dim - ra[:, None] - pc[None, p0:p0 + 16] + 2 * acc[:, :min(
                16, s - p0)]
            out[r0:r0 + n_rows, p0:p0 + 16] = agree[:n_rows].to(torch.int32)
    return out


def _repro():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import item_memory as jax_im
    from repro.core.hd_space import HDSpace as Space
    from repro.kernels import ops as kops, ref
    return jnp, jax_im, Space, kops, ref


def _jax_mode() -> bool:
    """The installed jax's threefry mode (``repro`` draws its item memory
    in it, so the port's parity cases take it too); True without jax."""
    try:
        import jax
    except ImportError:
        return True
    return bool(jax.config.jax_threefry_partitionable)


def _lengths_for(ms, n):
    return np.asarray(ms, np.int32) + (n - 1) * (np.asarray(ms) > 0)


# -- the counters and the majority, alone -----------------------------------

@pytest.mark.parametrize("n_inputs,k_planes", [(16, 8), (37, 8), (255, 8),
                                               (300, 14), (16383, 14)])
def test_harley_seal_counts_equal_plain_counters(n_inputs, k_planes):
    rng = np.random.default_rng(n_inputs)
    rows = 3
    words = convert.words_to_tensor(rng.integers(
        0, 2 ** 32, (n_inputs, rows, 2), dtype=np.uint32))
    steps = torch.tensor([n_inputs, max(n_inputs - 5, 0), n_inputs // 2])
    planes = [torch.zeros((rows, 2), dtype=torch.int32)
              for _ in range(k_planes)]
    for s0 in range(0, n_inputs, 16):
        xs = [torch.where((s0 + k < steps)[:, None], words[s0 + k], 0)
              if s0 + k < n_inputs else torch.zeros((rows, 2), dtype=torch.int32)
              for k in range(16)]
        harley_seal16(planes, xs)
    bits = bitops.unpack_bits(words).long()              # (N, rows, 64)
    mask = (torch.arange(n_inputs)[:, None] < steps[None, :]).long()
    want = (bits * mask[..., None]).sum(0)
    assert torch.equal(counts_of(planes), want)


@pytest.mark.parametrize("k_planes", [8, 14])
def test_bitsliced_majority_matches_the_rule(k_planes):
    """Every count against m at plane boundaries (2^k - 1, 2^k, 2^k + 1),
    m = 0, odd and even m, and m whose half needs more planes."""
    top = 2 ** k_planes
    ms = sorted({0, 1, 2, 3} | {v for k in range(1, k_planes + 2)
                                for v in (2 ** k - 1, 2 ** k, 2 ** k + 1)}
                | {2 * top + 2})
    counts = torch.arange(top, dtype=torch.int64)
    counts = torch.cat([counts, torch.zeros(-len(counts) % 32,
                                            dtype=torch.int64)])
    w = len(counts) // 32
    planes = [bitops.pack_bits(((counts >> k) & 1).to(torch.uint8))
              for k in range(k_planes)]
    rng = np.random.default_rng(k_planes)
    tie = convert.words_to_tensor(rng.integers(0, 2 ** 32, w,
                                               dtype=np.uint32))
    tie_bits = bitops.unpack_bits(tie).long()
    for m in ms:
        got = majority_planes([p[None] for p in planes], torch.tensor([m]),
                              tie)[0]
        twice = 2 * counts
        want = torch.where(twice == m, tie_bits, (twice > m).long())
        assert torch.equal(bitops.unpack_bits(got).long(), want), m


# -- the encoder model against repro ----------------------------------------

ENCODE_MODEL_CASES = [
    # dim, n, read_len, m values (plane boundaries, 0, even, short reads)
    (1056, 5, 300, [0, 1, 2, 3, 7, 8, 9, 15, 16, 17, 31, 32, 33, 63, 64, 65,
                    127, 128, 129, 255, 256, 257, 296, 150, 0]),   # W = 33
    (512, 4, 258, [255, 254, 128, 16, 0]),       # g = 255: 8 planes, full
    (512, 4, 259, [256, 255, 17, 16, 15]),       # g = 256: 14 planes
    (2048, 16, 60, [45, 44, 16, 15, 1, 0]),      # n = 16 as on the main path
    (576, 3, 40, [38, 20, 17, 1]),               # W = 18: not a multiple of 4
]


@pytest.mark.parametrize("span", ["encoder", "fused8", "fused3"])
@pytest.mark.parametrize("dim,n,read_len,ms", ENCODE_MODEL_CASES)
def test_rolling_bitsliced_encoder_matches_repro(dim, n, read_len, ms, span):
    jnp, jax_im, Space, kops, ref = _repro()
    js = Space(dim=dim, ngram=n)
    im, tie = jax_im.make_item_memory(js), jax_im.make_tie_break(js)
    ts, mode = HDSpace(dim=dim, ngram=n), _jax_mode()
    tim = item_memory.make_item_memory(ts, partitionable=mode)
    ttie = item_memory.make_tie_break(ts, partitionable=mode)
    w = dim // 32
    rng = np.random.default_rng(dim + n + read_len)
    lens = _lengths_for(ms, n)
    lens[-1] = min(n - 2, read_len)                 # a read shorter than n
    toks = rng.integers(0, 4, (len(lens), read_len)).astype(np.int32)
    want = np.asarray(ref.hdc_encode_ref(jnp.asarray(toks), jnp.asarray(lens),
                                         jax_im.rolled(im, n), tie))
    spans = {"encoder": 256, "fused8": -(-w // 8), "fused3": -(-w // 3)}
    got = rolling_encode_model(torch.from_numpy(toks), torch.from_numpy(lens),
                               item_memory.rolled(tim, n), ttie,
                               span=spans[span])
    np.testing.assert_array_equal(convert.tensor_to_words(got), want)
    if span == "encoder":
        via_kernel = np.asarray(kops.hdc_encode(
            jnp.asarray(toks), jnp.asarray(lens), im, tie, js))
        np.testing.assert_array_equal(via_kernel, want)


def test_empty_and_short_reads_take_the_tie_vector():
    ts = HDSpace(dim=1056, ngram=5)
    tim, ttie = item_memory.make_item_memory(ts), item_memory.make_tie_break(ts)
    toks = torch.zeros((3, 20), dtype=torch.int32)
    lens = torch.tensor([0, 2, 4], dtype=torch.int32)
    got = rolling_encode_model(toks, lens, item_memory.rolled(tim, 5), ttie,
                               span=256)
    assert torch.equal(got, ttie.expand(3, -1))


# -- the search identity against repro --------------------------------------

SEARCH_MODEL_CASES = [
    # b, s, w, bb
    (21, 13, 33, 16),      # B not a multiple of 16, S not a multiple of 8
    (16, 8, 64, 16),
    (37, 130, 16, 32),     # W < 32: a single padded step; 32-row tiles
    (5, 17, 40, 16),       # B < 16: rows of the tile left empty
    (3, 1, 96, 32),
]


@pytest.mark.parametrize("b,s,w,bb", SEARCH_MODEL_CASES)
def test_tensor_core_search_identity_matches_repro(b, s, w, bb):
    jnp, _, _, _, ref = _repro()
    rng = np.random.default_rng(b * s + w)
    q = rng.integers(0, 2 ** 32, (b, w), dtype=np.uint32)
    p = rng.integers(0, 2 ** 32, (s, w), dtype=np.uint32)
    q[0] = p[-1]
    q[min(1, b - 1)] = ~p[0]
    want = np.asarray(ref.hamming_am_ref(jnp.asarray(q), jnp.asarray(p)))
    got = search_model(convert.words_to_tensor(q), convert.words_to_tensor(p),
                       32 * w, bb=bb)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0, -1] == 32 * w
