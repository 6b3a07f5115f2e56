"""The port's baseline profilers (``repro_torch.baselines``) against
``repro.baselines``, on the CPU.

Exact: table hashes and masks, ``memory_bytes``, ``hits`` and
``category`` of Kraken2-, MetaCache- and CLARK-like profilers on
``tests/test_baselines.py``'s community, with minimizer subsampling, with
reads shorter than k or empty, and at 64 species (species 63 is the
``int64`` sign bit).  Bracken's ``estimate`` (float32 in both): counts
exact, floats within rtol 1e-6.  The port keeps 64-bit words as
``int64`` bit patterns, so these cases also hold its wrapping products,
logical shifts and sign-flipped ordering against numpy's ``uint64``.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro import baselines as jb
from repro.genomics import kmers as jax_kmers
from repro.genomics import synth as jax_synth
from repro_torch import baselines as tb
from repro_torch.baselines import kmer_table
from repro_torch.core.hd_space import HDSpace
from repro_torch.genomics import kmers
from repro_torch.pipeline import ProfilerConfig, ProfilingSession

SPEC = jax_synth.CommunitySpec(num_species=6, genome_len=20_000,
                               homology_fraction=0.0, strain_snp_rate=0.0,
                               read_error_rate=0.0, seed=11)
PROFILERS = {
    "kraken2": (lambda: jb.Kraken2Like(k=21),
                lambda: tb.Kraken2Like(k=21, device="cpu")),
    "kraken2_subsample4": (lambda: jb.Kraken2Like(k=21, subsample=4),
                           lambda: tb.Kraken2Like(k=21, subsample=4,
                                                  device="cpu")),
    "metacache": (lambda: jb.MetaCacheLike(),
                  lambda: tb.MetaCacheLike(device="cpu")),
    "metacache_k21_sketch4": (
        lambda: jb.MetaCacheLike(k=21, window=64, sketch=4),
        lambda: tb.MetaCacheLike(k=21, window=64, sketch=4, device="cpu")),
    "clark": (lambda: jb.ClarkLike(k=21),
              lambda: tb.ClarkLike(k=21, device="cpu")),
}


@pytest.fixture(scope="module")
def community():
    return jax_synth.make_sample(SPEC, num_reads=300, present=[0, 2, 4])


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def _assert_same(jp, tp, toks, lens):
    assert np.array_equal(jp.table.hashes, _u64(tp.table.hashes))
    assert np.array_equal(jp.table.masks, _u64(tp.table.masks))
    assert jp.memory_bytes() == tp.memory_bytes()
    jh, jc = jp.classify_reads(toks, lens)
    th, tc = tp.classify_reads(toks, lens)
    assert th.dtype == torch.bool and tc.dtype == torch.int32
    np.testing.assert_array_equal(th.numpy(), jh)
    np.testing.assert_array_equal(tc.numpy(), jc)
    return jh, jc, th, tc


@pytest.mark.parametrize("name", list(PROFILERS))
def test_profiler_matches_repro(community, name):
    genomes, toks, lens, _, _ = community
    jp, tp = (f() for f in PROFILERS[name])
    jp.build(genomes)
    tp.build(genomes)
    jh, jc, th, tc = _assert_same(jp, tp, toks, lens)
    assert (jc == 1).mean() > 0.5            # the reads really classify
    glens = np.array([len(g) for g in genomes.values()])
    want = jb.bracken_like.estimate_abundance(jh, jc, glens)
    got = tb.bracken_like.estimate_abundance(th, tc, glens)
    np.testing.assert_array_equal(got.unique_counts.numpy(),
                                  np.asarray(want.unique_counts))
    for field in ("abundance", "multi_counts", "unmapped_fraction",
                  "multi_fraction"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)),
                                   rtol=1e-6, err_msg=field)


@pytest.mark.parametrize("name", ["kraken2", "metacache", "clark"])
def test_short_and_empty_reads(community, name):
    """Reads of length 0, shorter than k, exactly k and one past it, and a
    padded batch narrower than k."""
    genomes, toks, lens, _, _ = community
    toks, lens = toks[:40].copy(), lens[:40].copy()
    lens[:8] = [0, 1, 5, 15, 16, 20, 21, 22]
    jp, tp = (f() for f in PROFILERS[name])
    jp.build(genomes)
    tp.build(genomes)
    _assert_same(jp, tp, toks, lens)
    _assert_same(jp, tp, toks[:, :12], np.minimum(lens, 12))


@pytest.mark.parametrize("name", ["kraken2", "metacache", "clark"])
def test_sixty_four_species_sign_bit(name):
    rng = np.random.default_rng(5)
    genomes = {f"s{i}": rng.integers(0, 4, 600).astype(np.int32)
               for i in range(64)}
    # species 63 shares a stretch with species 0, so a mask holds bit 63
    # beside another bit (and CLARK drops it)
    genomes["s63"][:200] = genomes["s0"][:200]
    jp, tp = (f() for f in PROFILERS[name])
    jp.build(genomes)
    tp.build(genomes)
    lens = np.full(64, 150, np.int32)
    toks = np.stack([g[100:250] for g in genomes.values()])
    jh, _, _, _ = _assert_same(jp, tp, toks, lens)
    masks = _u64(tp.table.masks)
    assert (masks >> np.uint64(63)).any()
    assert jh[63, 63]


@pytest.mark.parametrize("cls", [tb.Kraken2Like, tb.MetaCacheLike,
                                 tb.ClarkLike])
def test_sixty_five_species_raise(cls):
    rng = np.random.default_rng(6)
    genomes = {f"s{i}": rng.integers(0, 4, 100).astype(np.int32)
               for i in range(65)}
    with pytest.raises(ValueError, match="up to 64 species"):
        cls(device="cpu").build(genomes)
    if cls is not tb.MetaCacheLike:       # repro's MetaCacheLike does not
        with pytest.raises(ValueError, match="up to 64 species"):
            getattr(jb, cls.__name__)().build(genomes)


def test_clark_discards_shared_kmers():
    rng = np.random.default_rng(0)
    shared = rng.integers(0, 4, 2000).astype(np.int32)
    g = {"a": shared, "b": shared.copy()}   # fully homologous
    jp, tp = jb.ClarkLike(k=21).build(g), tb.ClarkLike(k=21,
                                                      device="cpu").build(g)
    assert len(jp.table.hashes) == 0 and tp.table.keys.numel() == 0
    assert jp.memory_bytes() == tp.memory_bytes() == 0
    # repro's lookup indexes the empty table (IndexError); the port's
    # leaves every read unmapped.
    toks = np.stack([shared[i:i + 150] for i in range(0, 1500, 300)])
    hits, cat = tp.classify_reads(toks, np.full(len(toks), 150, np.int32))
    assert not hits.any() and (cat == 0).all()


def test_uint64_arithmetic_at_the_top_bit():
    """splitmix64's wrapping products and logical shifts, and the sign-flip
    order, on words with the top bit set."""
    x = np.array([0, 1, 2 ** 63 - 1, 2 ** 63, 2 ** 63 + 1, 2 ** 64 - 1,
                  0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9], np.uint64)
    got = kmers.splitmix64_t(torch.from_numpy(x.view(np.int64)))
    np.testing.assert_array_equal(_u64(got), jax_kmers.splitmix64(x))
    keys = kmers.order_key(torch.from_numpy(x.view(np.int64)))
    order = torch.argsort(keys).numpy()
    np.testing.assert_array_equal(x[order], np.sort(x))
    votes = kmer_table.masks_to_votes(torch.tensor(
        [[kmers.as_int64(1 << 63 | 5), 0, 1]]), 64)[0].numpy()
    assert votes[0] == 2 and votes[2] == 1 and votes[63] == 1 \
        and votes.sum() == 4


def test_pack_kmers_batched_matches_numpy(community):
    _, toks, lens, _, _ = community
    for k in (16, 21, 31):
        h, valid = kmers.read_kmer_hashes_t(
            torch.from_numpy(toks[:20]), torch.from_numpy(lens[:20]), k)
        for i in range(20):
            want = jax_kmers.read_kmer_hashes(toks[i], int(lens[i]), k)
            np.testing.assert_array_equal(_u64(h[i][valid[i]]), want)


def test_memory_ordering_demeter_smallest(community):
    """The paper's memory ordering, on the port: Demeter's RefDB below
    MetaCache's sketches below Kraken2's table, by over 10x."""
    genomes, *_ = community
    k = tb.Kraken2Like(k=21, device="cpu").build(genomes)
    m = tb.MetaCacheLike(device="cpu").build(genomes)
    dm = ProfilingSession(ProfilerConfig(
        space=HDSpace(dim=4096, ngram=16), window=4096), device="cpu")
    db = dm.build_refdb(genomes)
    assert db.memory_bytes() < m.memory_bytes() < k.memory_bytes()
    assert k.memory_bytes() / db.memory_bytes() > 10


def test_baselines_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this case checks the no-GPU error")
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        tb.Kraken2Like()
