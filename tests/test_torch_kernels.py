"""The port's kernel modules against ``repro``'s Pallas kernels.

On the CPU the wrappers run their plain torch versions, which must equal
``repro``'s ``ops.hdc_encode`` / ``ops.fused_agreement`` (Pallas in
interpret mode) and ``kernels.ref`` exactly.  The ``cuda`` cases hold the
CUDA kernels against those plain versions on the card and skip without
one.  Every output is an integer: the tolerance is exact equality.

The GPU machine has no JAX, so ``repro`` is imported inside the parity
tests (which skip there) and the module itself needs only torch.
"""

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import item_memory
from repro_torch.core.hd_space import HDSpace
from repro_torch.kernels import fused_profile, hdc_encoder, ops


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _reads(b, length, n, seed):
    """Tokens plus lengths that cover the tie path (even m), reads shorter
    than n (m = 0), empty padding rows and full-length reads."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 4, (b, length)).astype(np.int32)
    lens = rng.integers(0, length + 1, b).astype(np.int32)
    special = [0, n - 1, n, n + 1, length, max(length - 1, 0)]
    lens[:min(b, len(special))] = np.minimum(special[:b], length)
    return toks, lens


def _repro():
    """The JAX package's modules (skips where JAX is not installed)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import assoc_memory, item_memory as im
    from repro.core.hd_space import HDSpace as Space
    from repro.kernels import ops as kops, ref
    return jnp, assoc_memory, im, Space, kops, ref


def _torch_state(dim, n):
    ts = HDSpace(dim=dim, ngram=n)
    return ts, item_memory.make_item_memory(ts), item_memory.make_tie_break(ts)


def _state(dim, n):
    jnp, _, jax_im, Space, _, _ = _repro()
    js = Space(dim=dim, ngram=n)
    return (js, jax_im.make_item_memory(js), jax_im.make_tie_break(js),
            *_torch_state(dim, n))


def _t(a):
    return convert.words_to_tensor(np.asarray(a))


# -- kernel 1: the encoder --------------------------------------------------

ENCODER_CASES = [
    (512, 5, 8, 60),      # plain
    (1056, 8, 5, 50),     # W = 33 words: not a multiple of any tile
    (512, 3, 9, 151),     # odd length: many even m
    (512, 6, 6, 5),       # every read shorter than n
    (2048, 16, 2, 24),    # n = 16 as on the main path
]


@pytest.mark.parametrize("dim,n,b,length", ENCODER_CASES)
def test_encoder_plain_matches_repro(dim, n, b, length):
    jnp, _, jax_im, _, jax_ops, jax_ref = _repro()
    js, im, tie, ts, tim, ttie = _state(dim, n)
    toks, lens = _reads(b, length, n, seed=dim + n)
    want = np.asarray(jax_ops.hdc_encode(jnp.asarray(toks), jnp.asarray(lens),
                                         im, tie, js))
    oracle = np.asarray(jax_ref.hdc_encode_ref(
        jnp.asarray(toks), jnp.asarray(lens), jax_im.rolled(im, n), tie))
    np.testing.assert_array_equal(oracle, want)
    got = hdc_encoder.hdc_encode(torch.from_numpy(toks), torch.from_numpy(lens),
                                 item_memory.rolled(tim, n), ttie)
    np.testing.assert_array_equal(convert.tensor_to_words(got), want)
    via_ops = ops.hdc_encode(torch.from_numpy(toks), torch.from_numpy(lens),
                             tim, ttie, ts)
    np.testing.assert_array_equal(convert.tensor_to_words(via_ops), want)


def test_empty_reads_encode_to_tie_vector():
    ts, tim, ttie = _torch_state(512, 5)
    toks = np.zeros((3, 20), np.int32)
    lens = np.array([0, 2, 4], np.int32)          # m = 0 for every row
    got = ops.hdc_encode(torch.from_numpy(toks), torch.from_numpy(lens),
                         tim, ttie, ts)
    assert torch.equal(got, ttie.expand(3, -1))


def test_encoder_wrapper_counts_only_kernel_launches():
    ts, tim, ttie = _torch_state(512, 5)
    before = hdc_encoder.hdc_encode.launches
    ops.hdc_encode(torch.zeros((2, 10), dtype=torch.int32),
                   torch.full((2,), 10, dtype=torch.int32), tim, ttie, ts)
    assert hdc_encoder.hdc_encode.launches == before


def _trap_lengths(length, n):
    """Lengths whose gram counts m sit at the bit-sliced counters' plane
    boundaries (2^k - 1, 2^k, 2^k + 1), m = 0, even m, and m = g."""
    g = max(length - n + 1, 0)
    ms = {0, 1, 2, g, max(g - 1, 0)} | {
        v for k in range(1, 15) for v in (2 ** k - 1, 2 ** k, 2 ** k + 1)}
    ms = sorted(v for v in ms if v <= g)
    return np.array([v + n - 1 if v else 0 for v in ms], np.int32)


#: dim, n, read length: W = 33, 18 and 40 (not multiples of a lane's 4
#: words or a warp's 128), 150-token reads at full width, windows of 8,192
#: tokens (14 planes) and g = 255 / 256 (the 8 / 14 plane boundary).
ENCODER_TRAP_CASES = [(1056, 5, 300), (576, 3, 40), (1280, 8, 100),
                      (40960, 16, 150), (40960, 16, 8192), (512, 4, 258),
                      (512, 4, 259)]


@pytest.mark.cuda
@pytest.mark.parametrize("dim,n,b,length", ENCODER_CASES + [
    (40960, 16, 5, 300), (40960, 16, 3, 8192)] + [
    (dim, n, None, length) for dim, n, length in ENCODER_TRAP_CASES])
def test_encoder_kernel_matches_plain(cuda, dim, n, b, length):
    ts, tim, ttie = _torch_state(dim, n)
    if b is None:
        lens = _trap_lengths(length, n)
        toks = np.random.default_rng(length).integers(
            0, 4, (len(lens), length)).astype(np.int32)
    else:
        toks, lens = _reads(b, length, n, seed=dim + n)
    # the plain version on the card: the same function as on the CPU
    want = hdc_encoder.hdc_encode_plain(
        torch.from_numpy(toks).to(cuda), torch.from_numpy(lens).to(cuda),
        item_memory.rolled(tim, n).to(cuda), ttie.to(cuda)).cpu()
    before = hdc_encoder.hdc_encode.launches
    got = ops.hdc_encode(torch.from_numpy(toks).to(cuda),
                         torch.from_numpy(lens).to(cuda), tim.to(cuda),
                         ttie.to(cuda), ts)
    torch.cuda.synchronize()
    assert hdc_encoder.hdc_encode.launches == before + 1
    assert torch.equal(got.cpu(), want)


# -- kernel 2: fused encode -> search ---------------------------------------

FUSED_CASES = [
    # dim, n, b, length, s, repro tiles
    (512, 5, 16, 60, 7, {}),
    (1056, 8, 4, 50, 5, {"bw": 8}),               # W = 33
    (512, 8, 1, 40, 3, {}),                       # batch of 1
    (512, 8, 5, 6, 9, {}),                        # reads shorter than n
    (512, 5, 8, 40, 387, {"bs": 128}),            # odd S, multi-chunk
    (512, 5, 21, 41, 129, {"bs": 128}),           # partial tail tile
]


def _protos(ts_dim, s, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2 ** 32, (s, ts_dim // 32), dtype=np.uint32)


@pytest.mark.parametrize("dim,n,b,length,s,tiles", FUSED_CASES)
def test_fused_plain_matches_repro(dim, n, b, length, s, tiles):
    jnp, jax_am, _, _, jax_ops, _ = _repro()
    js, im, tie, ts, tim, ttie = _state(dim, n)
    toks, lens = _reads(b, length, n, seed=s)
    protos = _protos(dim, s, seed=b)
    want = np.asarray(jax_ops.fused_agreement(
        jnp.asarray(toks), jnp.asarray(lens), im, tie, jnp.asarray(protos),
        js, **tiles))
    q = jax_ops.hdc_encode(jnp.asarray(toks), jnp.asarray(lens), im, tie, js)
    np.testing.assert_array_equal(
        np.asarray(jax_am.agreement_matmul(q, jnp.asarray(protos), dim)), want)
    got = ops.fused_agreement(torch.from_numpy(toks), torch.from_numpy(lens),
                              tim, ttie, _t(protos), ts)
    np.testing.assert_array_equal(got.numpy(), want)


def test_fused_tile_plan_checks_shared_memory():
    # full width: a 16-row encoded tile (80 KB) and its row popcounts, then
    # the larger of the encode scratch and 16 warps' 4-stage prototype
    # rings (16 x 4 x 16 x 32 words = 128 KB)
    plan = ops.fused_tile_plan(256, 9766, 1280, bb=16, cluster=4, ngram=16,
                               alphabet=4, read_len=150)
    assert plan["smem_bytes"] == (16 * 1280 + 16 + 16 * 4 * 16 * 32) * 4
    assert plan["tiles"] == 16 and plan["splits"] == 2
    assert plan["blocks"] == 128
    assert plan["w_pad"] == 1280
    assert plan["proto_bytes_per_call"] == 16 * 9766 * 1280 * 4
    # 32-row tiles: 2-stage rings; with cluster 1 the encode scratch (the
    # pair table of all 1,280 words) no longer fits beside the tile
    plan = ops.fused_tile_plan(256, 9766, 1280, bb=32, cluster=8, ngram=16,
                               read_len=150)
    assert plan["smem_bytes"] == (32 * 1280 + 32 + 16 * 2 * 16 * 32) * 4
    assert plan["splits"] == 2 and plan["blocks"] == 128
    with pytest.raises(ValueError, match="shared memory"):
        ops.fused_tile_plan(256, 10, 1280, bb=32, cluster=1, ngram=16,
                            read_len=150)
    with pytest.raises(ValueError, match="2-bit"):
        ops.fused_tile_plan(256, 10, 16, alphabet=5)
    with pytest.raises(ValueError, match="bb must be one of"):
        ops.fused_tile_plan(256, 10, 16, bb=3)
    with pytest.raises(ValueError, match="cluster must be one of"):
        ops.fused_tile_plan(256, 10, 16, cluster=16)


@pytest.mark.cuda
@pytest.mark.parametrize("dim,n,b,length,s,tiles", FUSED_CASES + [
    (40960, 16, 37, 151, 1001, {}),
    (40960, 16, 253, 150, 1001, {}),              # B, S at no tile multiple
    (1056, 5, None, 300, 13, {}),                 # plane-boundary m, W = 33
    (576, 3, None, 40, 130, {})])                 # W = 18
@pytest.mark.parametrize("bb,cluster", [(16, 1), (16, 2), (16, 4), (16, 8),
                                        (32, 4), (32, 8), (32, 2)])
def test_fused_kernel_matches_plain(cuda, dim, n, b, length, s, tiles, bb,
                                    cluster):
    if fused_profile.smem_bytes(bb, cluster, length, n, 4,
                                dim // 32) > fused_profile.MAX_SMEM_BYTES:
        pytest.skip("tiling does not fit shared memory at this width")
    ts, tim, ttie = _torch_state(dim, n)
    if b is None:
        lens = _trap_lengths(length, n)
        toks = np.random.default_rng(length).integers(
            0, 4, (len(lens), length)).astype(np.int32)
        b = len(lens)
    else:
        toks, lens = _reads(b, length, n, seed=s)
    protos = _t(_protos(dim, s, seed=b))
    # the plain version on the card: the same function as on the CPU
    want = fused_profile.fused_profile_plain(
        torch.from_numpy(toks).to(cuda), torch.from_numpy(lens).to(cuda),
        item_memory.rolled(tim, n).to(cuda), ttie.to(cuda), protos.to(cuda),
        dim=dim).cpu()
    before = fused_profile.fused_profile.launches
    got = ops.fused_agreement(
        torch.from_numpy(toks).to(cuda), torch.from_numpy(lens).to(cuda),
        tim.to(cuda), ttie.to(cuda), protos.to(cuda), ts, bb=bb,
        cluster=cluster)
    torch.cuda.synchronize()
    assert fused_profile.fused_profile.launches == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_shared_memory_formula_matches_the_source(cuda):
    """The tilings are validated on the host before any build, so the
    shared-memory formulas are kept in Python too; they must agree."""
    fus = fused_profile._lib()
    enc = hdc_encoder._lib()
    for length, n in ((150, 16), (8192, 16), (7, 3), (300, 5)):
        for bb, cluster, w in ((16, 4, 1280), (16, 8, 1280), (16, 1, 33),
                               (16, 8, 16), (32, 8, 1280), (32, 2, 1280),
                               (16, 1, 1280), (32, 1, 18)):
            assert fus.fused_profile_smem_bytes(bb, cluster, length, n, 4, w) \
                == fused_profile.smem_bytes(bb, cluster, length, n, 4, w)
        assert enc.hdc_encode_smem_bytes(length, n, 4) \
            == hdc_encoder.smem_bytes(length, n)
