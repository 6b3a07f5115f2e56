"""Every alphabet through the port's encode kernels and kernel backends.

``repro``'s Pallas encode kernels take any alphabet (they loop over the
symbols).  The port's CUDA kernels stage 2-bit symbols up to A = 4 and
take the wide path above it: 16-bit symbols and the pair table split into
its two separable halves, in shared memory where they fit, else read
from global memory.  On the CPU the wrappers run their plain versions,
held here against ``repro.kernels.ref``, and whole ``cuda_fused``,
``cuda_packed`` and ``cuda_matmul`` sessions are held against ``repro``'s
``reference`` session, at A in {1, 2, 3, 5, 8, 20, 300}.  The ``cuda``
cases hold each kernel against its plain version on the card, with the
tables in shared memory and in global memory.  Every output is an
integer: the tolerance is exact equality.

The GPU machine has no JAX, so ``repro`` is imported inside the parity
tests (which skip there) and the module itself needs only torch.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert
from repro_torch.core import item_memory
from repro_torch.core.hd_space import HDSpace
from repro_torch.kernels import autotune, fused_profile, hdc_encoder, ops
from repro_torch.pipeline import ArraySource, ProfilerConfig, ProfilingSession

ALPHABETS = [1, 2, 3, 5, 8, 20, 300]
SPACE = dict(dim=512, ngram=5, z_threshold=3.0)
CONFIG = dict(window=1024, batch_size=16)
BACKENDS = ("cuda_fused", "cuda_packed", "cuda_matmul")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _repro():
    """The JAX package's modules (skips where JAX is not installed)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import item_memory as jax_im
    from repro.core.hd_space import HDSpace as JaxSpace
    from repro.kernels import ref
    return jnp, jax_im, JaxSpace, ref


def _jax_mode() -> bool:
    """The installed jax's threefry mode (``repro`` draws its item memory
    in it, so the port's parity cases take it too); True without jax."""
    try:
        import jax
    except ImportError:
        return True
    return bool(jax.config.jax_threefry_partitionable)


def _community(alphabet):
    """Three genomes of symbols in [0, A) and 41 reads of 150 symbols from
    the first and third, with reads shorter than n and an empty one, made
    from a seed with numpy (a partial tail batch at batch size 16)."""
    rng = np.random.default_rng(1000 + alphabet)
    genomes = {f"sp{i}": rng.integers(0, alphabet, 5000).astype(np.int32)
               for i in range(3)}
    names = list(genomes)
    toks = np.zeros((41, 150), np.int32)
    for r in range(len(toks)):
        g = genomes[names[2 * (r % 2)]]
        s = int(rng.integers(0, len(g) - 150))
        toks[r] = g[s:s + 150]
    lens = np.full(len(toks), 150, np.int32)
    lens[:4] = [0, 4, 5, 77]
    return genomes, toks, lens


def _reads(alphabet, b, length, n, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, alphabet, (b, length)).astype(np.int32)
    lens = rng.integers(0, length + 1, b).astype(np.int32)
    special = [length, 0, min(n, length)]
    lens[:min(b, 3)] = special[:b]
    return toks, lens


@pytest.fixture(scope="module")
def repro_reports():
    """``repro``'s ``reference`` prototypes and report per alphabet,
    computed once each."""
    cache = {}

    def get(alphabet):
        if alphabet not in cache:
            _repro()
            from repro.core.hd_space import HDSpace as JaxSpace
            from repro.pipeline import ArraySource as JaxArraySource
            from repro.pipeline import ProfilerConfig as JaxConfig
            from repro.pipeline import ProfilingSession as JaxSession
            genomes, toks, lens = _community(alphabet)
            s = JaxSession(JaxConfig(
                space=JaxSpace(**SPACE, alphabet_size=alphabet), **CONFIG))
            db = s.build_refdb(genomes)
            cache[alphabet] = (np.asarray(db.prototypes),
                               s.profile(JaxArraySource(toks, lens)).to_dict())
        return cache[alphabet]
    return get


@pytest.mark.parametrize("alphabet", ALPHABETS)
def test_encoder_plain_matches_repro_ref(alphabet):
    jnp, jax_im, JaxSpace, ref = _repro()
    dim, n = 1056, 5                              # W = 33
    js = JaxSpace(dim=dim, ngram=n, alphabet_size=alphabet)
    ts = HDSpace(dim=dim, ngram=n, alphabet_size=alphabet)
    toks, lens = _reads(alphabet, 7, 90, n, seed=alphabet)
    im, tie = jax_im.make_item_memory(js), jax_im.make_tie_break(js)
    want = np.asarray(ref.hdc_encode_ref(
        jnp.asarray(toks), jnp.asarray(lens), jax_im.rolled(im, n), tie))
    tim = item_memory.make_item_memory(ts, partitionable=_jax_mode())
    ttie = item_memory.make_tie_break(ts, partitionable=_jax_mode())
    got = hdc_encoder.hdc_encode(torch.from_numpy(toks),
                                 torch.from_numpy(lens),
                                 item_memory.rolled(tim, n), ttie)
    np.testing.assert_array_equal(convert.tensor_to_words(got), want)


@pytest.mark.parametrize("alphabet", ALPHABETS)
def test_fused_plain_matches_repro_ref(alphabet):
    jnp, jax_im, JaxSpace, ref = _repro()
    dim, n = 512, 4
    js = JaxSpace(dim=dim, ngram=n, alphabet_size=alphabet)
    ts = HDSpace(dim=dim, ngram=n, alphabet_size=alphabet)
    toks, lens = _reads(alphabet, 9, 60, n, seed=7 * alphabet)
    protos = np.random.default_rng(alphabet).integers(
        0, 2 ** 32, (13, dim // 32), dtype=np.uint32)
    im, tie = jax_im.make_item_memory(js), jax_im.make_tie_break(js)
    q = ref.hdc_encode_ref(jnp.asarray(toks), jnp.asarray(lens),
                           jax_im.rolled(im, n), tie)
    want = np.asarray(ref.hamming_am_ref(q, jnp.asarray(protos)))
    got = ops.fused_agreement(
        torch.from_numpy(toks), torch.from_numpy(lens),
        item_memory.make_item_memory(ts, partitionable=_jax_mode()),
        item_memory.make_tie_break(ts, partitionable=_jax_mode()),
        convert.words_to_tensor(protos), ts)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("alphabet", ALPHABETS)
def test_kernel_backend_sessions_match_repro_reference(repro_reports,
                                                       alphabet, backend):
    """A session over any alphabet is built, profiles, and its prototypes
    and report equal ``repro``'s ``reference`` session's."""
    want_protos, want = repro_reports(alphabet)
    genomes, toks, lens = _community(alphabet)
    s = ProfilingSession(ProfilerConfig(
        space=HDSpace(**SPACE, alphabet_size=alphabet), backend=backend,
        threefry_partitionable=_jax_mode(), **CONFIG), device="cpu")
    db = s.build_refdb(genomes)
    np.testing.assert_array_equal(convert.tensor_to_words(db.prototypes),
                                  want_protos)
    assert s.profile(ArraySource(toks, lens)).to_dict() == want
    if alphabet > 1:         # A = 1: every genome is the same symbol
        assert want["unmapped_reads"] < want["total_reads"]


def test_wide_tables_are_the_shifted_separable_halves():
    """Row a of F is imr[0][a] shifted left by one word, row A + b of G is
    imr[n-1][b]; both wrap mod W over the W + 256 word stride."""
    ts = HDSpace(dim=1056, ngram=5, alphabet_size=7)      # W = 33
    imr = item_memory.rolled(item_memory.make_item_memory(ts), 5)
    fg = hdc_encoder.wide_tables(imr)
    wx = hdc_encoder.wide_table_stride(33)
    assert wx % 4 == 0 and wx >= 33 + 256 and fg.shape == (14, wx)
    for x in (0, 31, 32, 33, 34, 200, wx - 1):
        assert torch.equal(fg[:7, x], imr[0][:, (x + 1) % 33])
        assert torch.equal(fg[7:, x], imr[4][:, x % 33])


def test_wide_shared_memory_places_the_tables():
    """At the main path's width (D = 40,960, n = 16, 150-token reads) the
    tables sit in shared memory beside a 16-row tile at cluster 2 up to
    A = 20; at cluster 1 (1,280 words a block) and at A = 300 they are
    read from global memory, and the tile still fits."""
    w, n = 1280, 16
    for a in (5, 8, 20):
        assert fused_profile.shared_tables(16, 2, 150, n, a, w)
    assert not fused_profile.shared_tables(16, 1, 150, n, 20, w)
    assert not fused_profile.shared_tables(16, 8, 150, n, 300, w)
    for bb in fused_profile.BATCH_TILES:
        for cl in fused_profile.CLUSTER_SIZES:
            smem = fused_profile.check_tiles(bb, cl, 150, n, 300, w)
            assert smem == fused_profile.smem_bytes(bb, cl, 150, n, 300, w,
                                                    False)
    # the encoder: 256 windows of 8,192 symbols hold their tables up to
    # about 80 symbols, then read them from global memory
    assert hdc_encoder.shared_tables(8192, n, 20)
    assert not hdc_encoder.shared_tables(8192, n, 300)
    assert hdc_encoder.smem_bytes(8192, n, 300, False) \
        <= hdc_encoder.MAX_SMEM_BYTES
    # the 2-bit path is what it was: 16 pair-table rows, whatever A <= 4
    for a in (1, 2, 3, 4):
        assert hdc_encoder.smem_bytes(150, n, a) == hdc_encoder.smem_bytes(
            150, n)


def test_alphabet_range_is_checked():
    for a in (0, 2 ** 16 + 1):
        with pytest.raises(ValueError, match="alphabets of 1 to 65536"):
            ProfilingSession(ProfilerConfig(
                space=HDSpace(**SPACE, alphabet_size=a),
                backend="cuda_fused"), device="cpu")
    ProfilingSession(ProfilerConfig(
        space=HDSpace(**SPACE, alphabet_size=2 ** 16), backend="cuda_packed"),
        device="cpu")


def test_autotune_key_carries_the_wide_alphabet():
    base = autotune.cache_key(256, 1280, 9780, 40960, 150, "cpu")
    assert autotune.cache_key(256, 1280, 9780, 40960, 150, "cpu",
                              alphabet=4) == base
    wide = autotune.cache_key(256, 1280, 9780, 40960, 150, "cpu",
                              alphabet=20)
    assert wide == base + "|A20"
    space = HDSpace(dim=40960, ngram=16, alphabet_size=20)
    kept = autotune.feasible_tiles(space, 150, "cpu")
    assert {"bb": 16, "cluster": 1} in kept      # tables from global memory


# -- on the card: each kernel against its plain version ----------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dim,n,b,length", [
    (40960, 16, 9, 300), (40960, 16, 2, 8192), (1056, 5, 37, 151),
    (576, 3, 5, 2000)])
@pytest.mark.parametrize("alphabet", [5, 8, 20, 300])
def test_encoder_kernel_matches_plain(cuda, alphabet, dim, n, b, length):
    ts = HDSpace(dim=dim, ngram=n, alphabet_size=alphabet)
    imr = item_memory.rolled(item_memory.make_item_memory(ts, device=cuda),
                             n).contiguous()
    tie = item_memory.make_tie_break(ts, device=cuda)
    toks, lens = _reads(alphabet, b, length, n, seed=dim + alphabet)
    t, l_ = torch.from_numpy(toks).to(cuda), torch.from_numpy(lens).to(cuda)
    before = hdc_encoder.hdc_encode.launches
    got = hdc_encoder.hdc_encode(t, l_, imr, tie)
    torch.cuda.synchronize()
    assert hdc_encoder.hdc_encode.launches == before + 1
    assert torch.equal(got, hdc_encoder.hdc_encode_plain(t, l_, imr, tie))


@pytest.mark.cuda
@pytest.mark.parametrize("dim,n,b,length,s", [
    (40960, 16, 37, 151, 301), (1056, 5, 19, 300, 13)])
@pytest.mark.parametrize("alphabet", [5, 8, 20, 300])
@pytest.mark.parametrize("bb,cluster", [(16, 1), (16, 2), (16, 8), (32, 2),
                                        (32, 1)])
def test_fused_kernel_matches_plain(cuda, alphabet, dim, n, b, length, s, bb,
                                    cluster):
    try:
        fused_profile.check_tiles(bb, cluster, length, n, alphabet,
                                  dim // 32)
    except ValueError:
        pytest.skip("the tile does not fit shared memory at this width")
    ts = HDSpace(dim=dim, ngram=n, alphabet_size=alphabet)
    imr = item_memory.rolled(item_memory.make_item_memory(ts, device=cuda),
                             n).contiguous()
    tie = item_memory.make_tie_break(ts, device=cuda)
    toks, lens = _reads(alphabet, b, length, n, seed=s + alphabet)
    t, l_ = torch.from_numpy(toks).to(cuda), torch.from_numpy(lens).to(cuda)
    protos = convert.words_to_tensor(np.random.default_rng(s).integers(
        0, 2 ** 32, (s, dim // 32), dtype=np.uint32), cuda)
    before = fused_profile.fused_profile.launches
    got = fused_profile.fused_profile(t, l_, imr, tie, protos, dim=dim,
                                      bb=bb, cluster=cluster)
    torch.cuda.synchronize()
    assert fused_profile.fused_profile.launches == before + 1
    assert torch.equal(got, fused_profile.fused_profile_plain(
        t, l_, imr, tie, protos, dim=dim))
