"""The port's main path as a whole against ``repro``, on the CPU.

The same config and synthetic community go through ``repro``'s
``reference``, ``pallas_fused``, ``pallas_matmul`` and ``pallas_packed``
(Pallas in interpret mode) sessions and the port's ``reference``,
``reference_packed``, ``cuda_matmul``, ``cuda_packed`` and ``cuda_fused``
sessions (their kernels' plain torch versions on the CPU).  Prototypes,
``ProfileReport.to_dict()``, fingerprints and the RefDB store must agree
exactly.  ``pallas_matmul`` and ``pallas_packed`` profile against the
``reference`` RefDB (``refdb=``), so their interpret-mode work is the
query path alone.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import assoc_memory as jax_am
from repro.core import classifier as jax_cls
from repro.core import item_memory as jax_im
from repro.core.hd_space import HDSpace as JaxSpace
from repro.genomics import synth as jax_synth
from repro.pipeline import ArraySource as JaxArraySource
from repro.pipeline import ProfilerConfig as JaxConfig
from repro.pipeline import ProfilingSession as JaxSession
from repro.pipeline import refdb_store as jax_store
from repro_torch import convert
from repro_torch.core import assoc_memory, classifier, item_memory
from repro_torch.core.hd_space import HDSpace
from repro_torch.genomics import synth
from repro_torch.pipeline import (ArraySource, ProfilerConfig,
                                  ProfilingSession, available_backends,
                                  refdb_store)

SPACE = dict(dim=512, ngram=5, z_threshold=3.0)
SPEC = dict(num_species=4, genome_len=6_000, seed=11)
CONFIG = dict(window=1024, batch_size=16)
PORT_BACKENDS = ("reference", "reference_packed", "cuda_matmul",
                 "cuda_packed", "cuda_fused")
#: The port's unfused kernel backends and their ``repro`` twins.
TWINS = {"cuda_matmul": "pallas_matmul", "cuda_packed": "pallas_packed"}


def _jax_config(backend, **kw):
    return JaxConfig(space=JaxSpace(**SPACE), backend=backend,
                     **{**CONFIG, **kw})


def _config(backend, **kw):
    return ProfilerConfig(space=HDSpace(**SPACE), backend=backend,
                          **{**CONFIG, **kw})


@pytest.fixture(scope="module")
def community():
    """Genomes plus 61 reads: 150-bp reads (m = 146 is even at n = 5, so
    the tie path runs), reads shorter than n, empty reads, and a read
    count that leaves a partial tail batch."""
    genomes, toks, lens, _, _ = synth.make_sample(
        synth.CommunitySpec(**SPEC), num_reads=61, present=[0, 2])
    jg, jt, jl, _, _ = jax_synth.make_sample(
        jax_synth.CommunitySpec(**SPEC), num_reads=61, present=[0, 2])
    assert all(np.array_equal(genomes[k], jg[k]) for k in jg)
    assert np.array_equal(toks, jt) and np.array_equal(lens, jl)
    lens = lens.copy()
    lens[:6] = [0, 3, 4, 5, 77, 149]
    return genomes, toks, lens


@pytest.fixture(scope="module")
def jax_runs(community):
    genomes, toks, lens = community
    out = {}
    for backend in ("reference", "pallas_fused"):
        s = JaxSession(_jax_config(backend))
        db = s.build_refdb(genomes)
        out[backend] = (np.asarray(db.prototypes),
                        s.profile(JaxArraySource(toks, lens)).to_dict())
    ref_db = JaxSession(_jax_config("reference")).build_refdb(genomes)
    for backend in TWINS.values():
        s = JaxSession(_jax_config(backend))
        out[backend] = (None, s.profile(JaxArraySource(toks, lens),
                                        refdb=ref_db).to_dict())
    return out


@pytest.fixture(scope="module")
def port_runs(community):
    genomes, toks, lens = community
    out = {}
    for backend in PORT_BACKENDS:
        s = ProfilingSession(_config(backend), device="cpu")
        db = s.build_refdb(genomes)
        out[backend] = (convert.tensor_to_words(db.prototypes),
                        s.profile(ArraySource(toks, lens)).to_dict())
    return out


def test_registry():
    assert set(PORT_BACKENDS) <= set(available_backends())


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_prototypes_match_repro(jax_runs, port_runs, backend):
    want = jax_runs["reference"][0]
    np.testing.assert_array_equal(jax_runs["pallas_fused"][0], want)
    np.testing.assert_array_equal(port_runs[backend][0], want)


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_report_matches_repro(jax_runs, port_runs, backend):
    want = jax_runs["reference"][1]
    assert jax_runs["pallas_fused"][1] == want
    assert port_runs[backend][1] == want
    assert want["multi_reads"] + want["unmapped_reads"] < want["total_reads"]


@pytest.mark.parametrize("backend", sorted(TWINS))
def test_unfused_backends_match_their_repro_twins(jax_runs, port_runs,
                                                  backend):
    assert port_runs[backend][1] == jax_runs[TWINS[backend]][1]
    np.testing.assert_array_equal(port_runs[backend][0],
                                  jax_runs["reference"][0])


@pytest.mark.parametrize("backend", sorted(TWINS))
def test_unfused_batches_carry_queries(community, backend):
    genomes, toks, lens = community
    s = ProfilingSession(_config(backend), device="cpu")
    s.build_refdb(genomes)
    res = s.classify_batch(toks[:16], lens[:16])
    assert res.queries is not None and res.queries.shape == (16, 16)
    again = s.classify_queries(s.encode_reads(toks[:16], lens[:16]))
    assert torch.equal(res.classification.hits, again.hits)
    assert torch.equal(res.classification.category, again.category)


def test_fused_batches_carry_no_queries(community):
    genomes, toks, lens = community
    s = ProfilingSession(_config("cuda_fused"), device="cpu")
    s.build_refdb(genomes)
    seen = []
    s.profile(ArraySource(toks, lens), on_batch=seen.append)
    assert seen and all(b.queries is None for b in seen)
    assert sum(b.num_valid for b in seen) == len(toks)
    ref = ProfilingSession(_config("reference"), device="cpu")
    ref.adopt_refdb(s.refdb)
    assert ref.classify_batch(toks[:4], lens[:4]).queries is not None


@pytest.mark.parametrize("kw", [
    {}, {"stride": 512}, {"stride": 1024}, {"batch_size": 7},
    {"backend_options": {"bb": 4, "cluster": 2}},
    {"window": 4096, "space": dict(dim=40960, ngram=16)},
])
def test_fingerprints_match_repro(kw):
    kw = dict(kw)
    space = {**SPACE, **kw.pop("space", {})}
    j = JaxConfig(space=JaxSpace(**space), backend="pallas_fused",
                  **{**CONFIG, **kw})
    t = ProfilerConfig(space=HDSpace(**space), backend="pallas_fused",
                       **{**CONFIG, **kw})
    assert t.space.fingerprint() == j.space.fingerprint()
    assert t.fingerprint() == j.fingerprint()
    assert t.refdb_fingerprint() == j.refdb_fingerprint()
    assert t.to_json() == j.to_json()


def test_cache_path_matches_repro(tmp_path, community):
    genomes = community[0]
    j = JaxSession(_jax_config("reference"))
    t = ProfilingSession(_config("reference"), device="cpu")
    assert t.refdb_cache_path(tmp_path, genomes) == \
        j.refdb_cache_path(tmp_path, genomes)


def test_refdb_store_cross_loads(tmp_path, community):
    genomes = community[0]
    jdb = JaxSession(_jax_config("reference")).build_refdb(genomes)
    jax_store.save(tmp_path / "jax.npz", jdb, refdb_fingerprint="f")
    tdb = refdb_store.load(tmp_path / "jax.npz", device="cpu")
    np.testing.assert_array_equal(convert.tensor_to_words(tdb.prototypes),
                                  np.asarray(jdb.prototypes))
    np.testing.assert_array_equal(tdb.proto_species.numpy(),
                                  np.asarray(jdb.proto_species))
    np.testing.assert_array_equal(tdb.genome_lengths.numpy(),
                                  np.asarray(jdb.genome_lengths))
    assert tdb.species_names == jdb.species_names
    refdb_store.save(tmp_path / "torch.npz", tdb, refdb_fingerprint="f")
    back = jax_store.load(tmp_path / "torch.npz")
    for field in ("prototypes", "proto_species", "genome_lengths"):
        a, b = np.asarray(getattr(back, field)), np.asarray(getattr(jdb, field))
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert back.species_names == jdb.species_names
    assert refdb_store.manifest(tmp_path / "torch.npz") == \
        jax_store.manifest(tmp_path / "jax.npz")


def test_session_cache_round_trip_through_repro_store(tmp_path, community):
    genomes, toks, lens = community
    j = JaxSession(_jax_config("reference"))
    j.build_or_load_refdb(genomes, cache_dir=tmp_path)
    t = ProfilingSession(_config("cuda_fused"), device="cpu")
    t.build_or_load_refdb(genomes, cache_dir=tmp_path)
    assert t.refdb_loaded_from_cache
    assert t.profile(ArraySource(toks, lens)).to_dict() == \
        j.profile(JaxArraySource(toks, lens)).to_dict()


def test_from_repro_state_round_trips(community):
    js = JaxSpace(**SPACE)
    jdb = jax_am.build_refdb(community[0], js, window=1024, batch_size=16)
    im, tie = jax_im.make_item_memory(js), jax_im.make_tie_break(js)
    tim, ttie, tdb = convert.from_repro_state(
        np.asarray(im), np.asarray(tie), np.asarray(jdb.prototypes),
        np.asarray(jdb.proto_species), np.asarray(jdb.genome_lengths),
        jdb.species_names, device="cpu")
    ts = HDSpace(**SPACE)
    assert torch.equal(tim, item_memory.make_item_memory(ts))
    assert torch.equal(ttie, item_memory.make_tie_break(ts))
    back = convert.to_repro_state(tim, ttie, tdb)
    np.testing.assert_array_equal(back["im"], np.asarray(im))
    np.testing.assert_array_equal(back["tie"], np.asarray(tie))
    np.testing.assert_array_equal(back["prototypes"], np.asarray(jdb.prototypes))
    np.testing.assert_array_equal(back["proto_species"],
                                  np.asarray(jdb.proto_species))
    np.testing.assert_array_equal(back["genome_lengths"],
                                  np.asarray(jdb.genome_lengths))
    assert back["species_names"] == jdb.species_names


def test_threshold_truncates_like_repro():
    """D = 40,960, z = 4: T = 20884.77, compared as int32 20884."""
    space = JaxSpace()
    scores = np.array([[20883, 20884, 20885, -2 ** 31]], np.int32)
    want = jax_cls.from_scores(scores, space.threshold_bits)
    got = classifier.from_scores(torch.from_numpy(scores),
                                 HDSpace().threshold_bits)
    np.testing.assert_array_equal(got.hits.numpy(), np.asarray(want.hits))
    np.testing.assert_array_equal(got.category.numpy(),
                                  np.asarray(want.category))
    assert got.hits.tolist() == [[False, True, True, False]]


def test_species_scores_drop_padding_like_repro():
    rng = np.random.default_rng(3)
    agree = rng.integers(0, 512, (5, 9)).astype(np.int32)
    species = np.array([0, 0, 1, 1, 1, 3, 3, 4, 4], np.int32)  # 2 absent,
    want = np.asarray(jax_cls.partial_scores(agree, species, 4))  # 4 = pad
    got = classifier.partial_scores(torch.from_numpy(agree),
                                    torch.from_numpy(species), 4)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:, 2] == classifier.NO_SCORE).all()


@pytest.mark.parametrize("options,match", [
    ({"bb": 3}, "power of two"),
    ({"bb": 0}, "positive int"),
    ({"bb": 64}, "power of two up to 32"),
    ({"bb": True}, "must be an integer"),
    ({"cluster": 3}, "must be one of"),
    ({"cluster": "four"}, "must be an integer"),
    ({"bs": 128}, "unknown option"),
    ({"bb": 8}, "at least 16"),            # below one tensor-core tile
])
def test_cuda_fused_tile_validation_is_friendly(options, match):
    with pytest.raises(ValueError, match=match):
        ProfilingSession(_config("cuda_fused", batch_size=7,
                                 backend_options=options), device="cpu")


@pytest.mark.parametrize("bb", [16, 32])
def test_cuda_fused_takes_batches_smaller_than_a_tile(jax_runs, community,
                                                      bb):
    """A batch of 7 reads fills part of one tile; the rows past it are
    left idle, and the report is still ``repro``'s."""
    genomes, toks, lens = community
    s = ProfilingSession(_config("cuda_fused", batch_size=7,
                                 backend_options={"bb": bb}), device="cpu")
    s.build_refdb(genomes)
    assert s.profile(ArraySource(toks, lens)).to_dict() == \
        jax_runs["reference"][1]


@pytest.mark.parametrize("backend", ["cuda_matmul", "cuda_packed",
                                     "cuda_fused"])
def test_cuda_backends_refuse_alphabets_above_four(backend):
    """The encode kernels stage 2-bit symbols: a session over a larger
    alphabet is refused when it is built, on every device."""
    space = HDSpace(**SPACE, alphabet_size=5)
    with pytest.raises(ValueError, match="alphabets of 1 to 4"):
        ProfilingSession(ProfilerConfig(space=space, backend=backend),
                         device="cpu")
    ProfilingSession(ProfilerConfig(space=HDSpace(**SPACE, alphabet_size=4),
                                    backend=backend), device="cpu")
    ProfilingSession(ProfilerConfig(space=space, backend="reference"),
                     device="cpu")


def test_cuda_fused_shared_memory_limit_is_checked_at_construction():
    space = dataclasses.replace(HDSpace(), z_threshold=4.0)
    with pytest.raises(ValueError, match="shared memory"):
        ProfilingSession(ProfilerConfig(space=space, backend="cuda_fused",
                                        backend_options={"bb": 32,
                                                         "cluster": 1}),
                         device="cpu")
    ProfilingSession(ProfilerConfig(space=space, backend="cuda_fused"),
                     device="cpu")


def test_cuda_fused_agreement_plain_on_cpu():
    s = ProfilingSession(_config("cuda_fused"), device="cpu")
    rng = np.random.default_rng(0)
    q = convert.words_to_tensor(rng.integers(0, 2 ** 32, (3, 16),
                                             dtype=np.uint32))
    p = convert.words_to_tensor(rng.integers(0, 2 ** 32, (5, 16),
                                             dtype=np.uint32))
    assert torch.equal(s.backend.agreement(q, p),
                       assoc_memory.agreement_packed_chunked(q, p, 512))


def test_cuda_fused_agreement_matches_repro():
    """``cuda_fused.agreement`` (``am_matmul``'s plain version on the CPU)
    equals ``repro``'s ``pallas_fused.agreement`` (Pallas ``am_matmul`` in
    interpret mode)."""
    from repro.pipeline import resolve_backend as jax_resolve

    rng = np.random.default_rng(12)
    q = rng.integers(0, 2 ** 32, (9, 16), dtype=np.uint32)
    p = rng.integers(0, 2 ** 32, (130, 16), dtype=np.uint32)
    q[0] = p[3]
    want = np.asarray(jax_resolve("pallas_fused", _jax_config(
        "pallas_fused")).agreement(q, p))
    s = ProfilingSession(_config("cuda_fused"), device="cpu")
    got = s.backend.agreement(convert.words_to_tensor(q),
                              convert.words_to_tensor(p))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0, 3] == SPACE["dim"]


def test_option_less_backends_reject_options():
    with pytest.raises(ValueError, match="reference takes no options"):
        ProfilingSession(_config("reference", backend_options={"bb": 4}),
                         device="cpu")


@pytest.mark.parametrize("backend", sorted(TWINS))
def test_unfused_backends_take_no_options(backend):
    with pytest.raises(ValueError, match=f"{backend} takes no options"):
        ProfilingSession(_config(backend, backend_options={"bb": 4}),
                         device="cpu")
