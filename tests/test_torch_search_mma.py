"""Plain torch models of the arithmetic of the two tensor-core search
kernels, held bit-exactly against ``repro`` on the CPU.

The kernels (``csrc/hamming_am.cu``, ``csrc/am_matmul.cu`` and their
shared ``csrc/mma_common.cuh``) run only on the card, so their arithmetic
is modelled here step for step, in torch on the packed words:

* the on-chip +-1 expansion of the packed ``am_matmul`` entry: thread t
  of a quad takes bits ``8 i + 7 - t`` (low fragment register) and
  ``8 i + 3 - t`` (high one) of a word, shifted to the top of byte i,
  replicated over the byte by ``prmt``'s sign mode and OR-ed with 0x01,
  which gives -1 for a set bit and +1 for a clear one (``-to_pm1`` for
  both operands, so every product is ``to_pm1``'s); the mma m16n8k32
  reads bytes i of thread t's registers as k = 4 t + i and 16 + 4 t + i,
  for the query and the prototype operand alike;
* the slab tiling both kernels share (``mma::slab``): query tiles of 256
  rows, slabs of 16 NT prototypes, 32-word steps with the rows past B or
  S and the words past W staged as zeros;
* the b1 search identity ``agreement = dim - |a| - |b| + 2 popc(a & b)``
  with ``|b|`` summed from the staged 16-byte chunks of the slab, ``|a|``
  from the query rows, and each 32-word step split into four k256 mmas
  whose words pair up as the fragments take them;
* the s8 search with the words past W skipped (a zero word would expand
  to -1s) and ``(dim + acc) / 2`` truncated toward zero.

Neither kernel splits K, so there is no partial-sum merge to model.
Nothing on the CUDA path calls these models.  Every output is an
integer: the tolerance is exact equality.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert
from repro_torch.core import bitops
from repro_torch.kernels import am_matmul, hamming_am, ops

MASK32 = 0xFFFFFFFF
STEP = 32          # words of a search step
ROWS = 256         # queries of a block's tile


def _repro():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops as kops, ref
    return jnp, kops, ref


def _u32(words: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their unsigned values in int64."""
    return words.to(torch.int64) & MASK32


# -- the on-chip +-1 expansion ----------------------------------------------

def pm1_of_top_bits(z: torch.Tensor) -> torch.Tensor:
    """``prmt.b32 d, z, 0, 0xBA98`` (each byte's top bit replicated over
    the byte) OR 0x01010101, on uint32 values held in int64."""
    out = torch.zeros_like(z)
    for i in range(4):
        top = (z >> (8 * i + 7)) & 1
        out |= (top * 0xFF) << (8 * i)
    return out | 0x01010101


def fragment_registers(words: torch.Tensor, t: int):
    """Thread t's low and high s8 fragment registers of packed words
    (the kernel shifts by multiplying by ``1 << t`` and ``16 << t``)."""
    x = _u32(words)
    return (pm1_of_top_bits((x * (1 << t)) & MASK32),
            pm1_of_top_bits((x * (16 << t)) & MASK32))


def expand_in_k_order(words: torch.Tensor) -> torch.Tensor:
    """``(..., W)`` words -> ``(..., W, 32)`` int8 -1 (set bit) / +1 (clear
    bit) in the mma's k order:
    k = 4 t + i is byte i of thread t's low register, 16 + 4 t + i of its
    high one."""
    out = torch.empty((*words.shape, 32), dtype=torch.int64)
    for t in range(4):
        lo, hi = fragment_registers(words, t)
        for i in range(4):
            out[..., 4 * t + i] = (lo >> (8 * i)) & 0xFF
            out[..., 16 + 4 * t + i] = (hi >> (8 * i)) & 0xFF
    return torch.where(out >= 128, out - 256, out).to(torch.int8)


def k_to_bit(k: int) -> int:
    t, i = (k % 16) // 4, k % 4
    return 8 * i + 7 - t if k < 16 else 8 * i + 3 - t


def test_fragment_bits_cover_every_bit_of_a_word_once():
    assert sorted(k_to_bit(k) for k in range(32)) == list(range(32))


@pytest.mark.parametrize("shape,seed", [((7, 5), 0), ((3, 33), 1),
                                        ((1, 1280), 2)])
def test_on_chip_expansion_equals_to_pm1(shape, seed):
    """Every k slot of the expanded fragments holds ``-to_pm1`` of the bit
    the kernel maps it to, bit for bit (0x01 = +1, 0xFF = -1); both
    operands are negated alike, so their products are ``to_pm1``'s."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2 ** 32, shape, dtype=np.uint32)
    words[0, 0], words[-1, -1] = 0, MASK32
    packed = convert.words_to_tensor(words)
    got = expand_in_k_order(packed)                        # (r, W, 32)
    want = ops.to_pm1(packed).reshape(*shape, 32)          # bit order
    perm = torch.tensor([k_to_bit(k) for k in range(32)])
    assert torch.equal(-got.to(torch.bfloat16), want[..., perm])
    assert set(got.unique().tolist()) <= {-1, 1}


# -- the slab tiling ----------------------------------------------------------

#: The n8 tiles a warp takes in the models: the NT ``mma::slab::pick_nt``
#: chooses at the small S of these cases on an H100 (a slab of 32).  The
#: kernels pick NT from S and the SM count; the result does not depend on
#: it, which ``test_b1_search_model_does_not_depend_on_the_slab`` checks.
MODEL_NT = 2


def _tiles(b, s, w, nt=MODEL_NT):
    """(query rows, slab rows, staged words) of every block, as the
    kernels walk them: zero rows past B / S, zero words past W."""
    protos = 16 * nt
    wp = -(-w // STEP) * STEP
    for b0 in range(0, b, ROWS):
        for s0 in range(0, s, protos):
            yield (b0, min(b, b0 + ROWS), s0, min(s, s0 + protos), protos,
                   wp)


def _stage(x, r0, r1, rows, wp):
    tile = torch.zeros((rows, wp), dtype=torch.int32)
    tile[:r1 - r0, :x.shape[1]] = x[r0:r1]
    return tile


# -- the b1 search (hamming_am) ---------------------------------------------

def b1_search_model(q: torch.Tensor, p: torch.Tensor, dim: int,
                    nt: int = MODEL_NT):
    b, w = q.shape
    s = p.shape[0]
    ra = bitops.popcount_words(q)                       # the query pass
    out = torch.empty((b, s), dtype=torch.int64)
    for b0, b1, s0, s1, protos, wp in _tiles(b, s, w, nt):
        qt = _stage(q, b0, b1, ROWS, wp)
        pt = _stage(p, s0, s1, protos, wp)
        pb = torch.zeros(protos, dtype=torch.int64)
        acc = torch.zeros((ROWS, protos), dtype=torch.int64)
        for ks in range(wp // STEP):
            step_p = pt[:, ks * STEP:(ks + 1) * STEP]
            for c in range(8):                           # |b| by chunks
                pb += bitops.popcount32(step_p[:, 4 * c:4 * c + 4]).sum(1)
            for h in range(2):                           # the four k256
                for j in range(2):
                    words = [ks * STEP + 8 * t + 4 * h + 2 * j + e
                             for t in range(4) for e in range(2)]
                    acc += bitops.popcount32(
                        qt[:, None, words] & pt[None, :, words]).sum(-1)
        agree = (dim - ra[b0:b1, None] - pb[None, :s1 - s0]
                 + 2 * acc[:b1 - b0, :s1 - s0])
        assert int(agree.abs().max()) < 2 ** 31
        out[b0:b1, s0:s1] = agree
    return out.to(torch.int32)


def _search_inputs(b, s, w, seed):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 2 ** 32, (b, w), dtype=np.uint32)
    p = rng.integers(0, 2 ** 32, (s, w), dtype=np.uint32)
    q[0] = p[0]                     # agreement dim
    q[min(1, b - 1)] = ~p[-1]       # agreement 0
    return q, p


SEARCH_CASES = [
    # b, s, w
    (5, 3, 1),           # one word: a single zero-padded step
    (17, 40, 8),         # S past one slab of 32
    (21, 13, 33),        # W = 33: a one-word last step
    (9, 45, 1001),       # W = 1,001: ragged, not a multiple of 4
    (19, 37, 1280),      # the main path's width
    (300, 70, 16),       # two query tiles, the second of 44 rows
]


@pytest.mark.parametrize("b,s,w", SEARCH_CASES)
def test_b1_search_identity_matches_repro(b, s, w):
    jnp, _, ref = _repro()
    q, p = _search_inputs(b, s, w, seed=b * s + w)
    want = np.asarray(ref.hamming_am_ref(jnp.asarray(q), jnp.asarray(p)))
    tq, tp = convert.words_to_tensor(q), convert.words_to_tensor(p)
    got = b1_search_model(tq, tp, 32 * w)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0, 0] == 32 * w and want[min(1, b - 1), -1] == 0
    np.testing.assert_array_equal(
        b1_search_model(tq, tp, 32 * w + 64).numpy(), want + 64)
    np.testing.assert_array_equal(hamming_am.hamming_am(tq, tp).numpy(), want)


@pytest.mark.parametrize("nt", [2, 3, 4, 5, 6])
def test_b1_search_model_does_not_depend_on_the_slab(nt):
    """Every NT the kernels may pick (2..6, from S and the SM count) gives
    the same agreement: S = 97 leaves a partial last slab for each."""
    q, p = _search_inputs(300, 97, 40, seed=nt)
    tq, tp = convert.words_to_tensor(q), convert.words_to_tensor(p)
    assert torch.equal(b1_search_model(tq, tp, 32 * 40, nt),
                       hamming_am.hamming_am_plain(tq, tp))


# -- the s8 search (am_matmul's packed entry) -------------------------------

def s8_search_model(q: torch.Tensor, p: torch.Tensor, dim: int):
    b, w = q.shape
    s = p.shape[0]
    out = torch.empty((b, s), dtype=torch.int64)
    for b0, b1, s0, s1, protos, wp in _tiles(b, s, w):
        qt = expand_in_k_order(_stage(q, b0, b1, ROWS, wp)).to(torch.int64)
        pt = expand_in_k_order(_stage(p, s0, s1, protos, wp)).to(torch.int64)
        acc = torch.zeros((ROWS, protos), dtype=torch.int64)
        for ks in range(wp // STEP):
            wlim = min(STEP, w - ks * STEP)             # words past W skipped
            cols = slice(ks * STEP, ks * STEP + wlim)
            acc += (qt[:, cols].reshape(ROWS, -1)
                    @ pt[:, cols].reshape(protos, -1).T)
        agree = torch.div(dim + acc[:b1 - b0, :s1 - s0], 2,
                          rounding_mode="trunc")
        out[b0:b1, s0:s1] = agree
    return out.to(torch.int32)


@pytest.mark.parametrize("b,s,w", SEARCH_CASES)
@pytest.mark.parametrize("extra", [0, 64, 7])
def test_s8_search_model_matches_repro(b, s, w, extra):
    """dim = 32 W: repro's Pallas ``am_agreement(..., "matmul")`` (interpret
    mode) where it is quick, else ``ref.am_matmul_ref``; dim = 32 W + 64
    and an odd dim: ``ref.am_matmul_ref`` on operands padded with
    ``extra`` zero columns (``d`` is the operands' width there)."""
    jnp, kops, ref = _repro()
    q, p = _search_inputs(b, s, w, seed=b * s + w + 1)
    jq, jp = jnp.asarray(q), jnp.asarray(p)
    dim = 32 * w + extra
    if extra == 0 and w <= 64:
        want = np.asarray(kops.am_agreement(jq, jp, dim, "matmul"))
    else:
        pad = [(0, 0), (0, extra)]
        want = np.asarray(ref.am_matmul_ref(
            jnp.pad(kops.to_pm1(jq), pad), jnp.pad(kops.to_pm1(jp), pad)))
    tq, tp = convert.words_to_tensor(q), convert.words_to_tensor(p)
    np.testing.assert_array_equal(s8_search_model(tq, tp, dim).numpy(), want)
    plain = am_matmul.am_matmul_packed_plain(tq, tp, dim=dim)
    np.testing.assert_array_equal(plain.numpy(), want)
    np.testing.assert_array_equal(
        ops.am_agreement(tq, tp, dim, "matmul").numpy(), want)
    if extra == 0:
        np.testing.assert_array_equal(
            want, np.asarray(ref.hamming_am_ref(jq, jp)))


def test_s8_model_with_a_zero_word_expanded_would_be_wrong():
    """The words past W must be skipped, not staged as zeros and expanded:
    a zero word expands to 32 x +1 (a clear bit), which adds 32 a pad word
    to every product of two padded rows."""
    q, p = _search_inputs(3, 4, 5, seed=3)
    tq, tp = convert.words_to_tensor(q), convert.words_to_tensor(p)
    qe = expand_in_k_order(bitops.pad_to_multiple(tq, 1, STEP)).to(
        torch.int64).reshape(3, -1)
    pe = expand_in_k_order(bitops.pad_to_multiple(tp, 1, STEP)).to(
        torch.int64).reshape(4, -1)
    padded = torch.div(32 * 5 + qe @ pe.T, 2, rounding_mode="trunc")
    exact = s8_search_model(tq, tp, 32 * 5)
    assert torch.equal(padded - exact, torch.full((3, 4), 16 * (STEP - 5)))
