"""The port's tile autotuner (``repro_torch.kernels.autotune``), on the CPU.

The cache cases of ``tests/test_autotune.py`` (round trip, no re-measure
on a hit, ``force``, corrupt cache, environment override, distinct keys);
the shared-memory filter against ``fused_profile.smem_bytes``; the
read-length trap (a pick tuned on 150-token reads must not be launched on
a 2,048-token cohort it does not fit); explicit tiles beat autotune with
one warning; tuned sessions and services equal ``repro``'s reports; and
``-m cuda`` cases for tuned-session parity on the card.  ``repro`` is
imported inside the fixture that uses it, so the ``-m cuda`` cases collect
on a machine without JAX.
"""

import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from repro_torch.core.hd_space import HDSpace
from repro_torch.genomics import synth
from repro_torch.kernels import autotune, fused_profile, ops
from repro_torch.pipeline import (ArraySource, ProfilerConfig,
                                  ProfilingSession, SyntheticSource)
from repro_torch.pipeline import fused as fused_backend
from repro_torch.serve import ProfilingService

SP = HDSpace(dim=512, ngram=8, z_threshold=3.0)
FULL = HDSpace()                                  # D = 40,960, n = 16


def _tune(path, **kw):
    kw.setdefault("batch", 8)
    kw.setdefault("num_prototypes", 20)
    kw.setdefault("read_len", 64)
    kw.setdefault("trials", 1)
    kw.setdefault("device", "cpu")
    return autotune.tune(SP, path=path, **kw)


def _key(read_len=64, **kw):
    return autotune.cache_key(kw.get("b", 8), SP.num_words,
                              kw.get("s", 20), SP.dim, read_len, "cpu")


# -- cache behaviour --------------------------------------------------------

def test_cache_round_trip(tmp_path):
    p = tmp_path / "cache.json"
    tiles, cached = _tune(p)
    assert not cached and set(tiles) == {"bb", "cluster"}
    data = json.loads(p.read_text())
    entry = data[_key()]
    assert entry["tiles"] == tiles
    assert entry["swept"] == len(autotune.feasible_tiles(SP, 64, "cpu"))
    assert set(entry["times_s"]) == {f"bb{t['bb']}/cluster{t['cluster']}"
                                     for t in autotune.candidate_tiles()}
    assert entry["read_len_bucket"] == 64


def test_same_key_reuses_without_remeasuring(tmp_path, monkeypatch):
    p = tmp_path / "cache.json"
    tiles, _ = _tune(p)

    def boom(*a, **k):
        raise AssertionError("cache hit must not re-measure")

    monkeypatch.setattr(autotune, "_time_tiles", boom)
    tiles2, cached = _tune(p)
    assert cached and tiles2 == tiles
    tiles3, cached = _tune(p, read_len=40)          # same bucket, 64
    assert cached and tiles3 == tiles


def test_force_remeasures_and_updates_cache(tmp_path):
    p = tmp_path / "cache.json"
    _tune(p)
    tiles2, cached = _tune(p, force=True)
    assert not cached and set(tiles2) == {"bb", "cluster"}
    assert json.loads(p.read_text())[_key()]["tiles"] == tiles2


def test_corrupt_cache_is_an_empty_cache(tmp_path):
    p = tmp_path / "cache.json"
    p.write_text("{not json")
    assert autotune.load_cache(p) == {}
    tiles, cached = _tune(p)                  # tunes + rewrites atomically
    assert not cached and json.loads(p.read_text())
    p.write_text(json.dumps({_key(): {"tiles": {"bb": "x"}}}))
    tiles, cached = _tune(p)                  # malformed entry: a miss
    assert not cached
    p.write_text("[1, 2]")
    assert autotune.load_cache(p) == {}


def test_env_var_overrides_cache_location(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "e.json"))
    assert autotune.cache_path() == tmp_path / "e.json"
    assert autotune.cache_path(tmp_path / "x.json") == tmp_path / "x.json"
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_CACHE")
    default = autotune.cache_path()
    assert default.name == "autotune.json"
    assert default.parent.name == "repro_torch"     # never repro's file


def test_repros_env_var_is_not_read(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_CACHE", raising=False)
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "jax.json"))
    assert autotune.cache_path() != tmp_path / "jax.json"


def test_distinct_shapes_get_distinct_keys():
    keys = {autotune.cache_key(*a, "cpu") for a in
            [(8, 8, 20, 256, 64), (16, 8, 20, 256, 64), (8, 16, 20, 512, 64),
             (8, 8, 40, 256, 64), (8, 8, 20, 256, 256),
             (8, 8, 20, 256, 2048)]}
    assert len(keys) == 6
    assert autotune.cache_key(8, 8, 20, 256, 150, "cpu") == \
        autotune.cache_key(8, 8, 20, 256, 256, "cpu")
    assert autotune.cache_key(8, 8, 20, 256, 150, "cpu").startswith(
        "cpu|cpu|")


@pytest.mark.parametrize("length,bucket", [(0, 16), (1, 16), (16, 16),
                                           (17, 32), (150, 256),
                                           (256, 256), (1500, 2048),
                                           (4096, 4096), (4097, 8192)])
def test_read_len_bucket(length, bucket):
    assert autotune.read_len_bucket(length) == bucket


def test_cli_smoke_on_the_cpu(tmp_path):
    env = {**os.environ, "PYTHONPATH": os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.kernels.autotune", "--smoke",
         "--device", "cpu", "--trials", "1", "--out",
         str(tmp_path / "c.json")], env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    doc = json.loads(out.stdout)
    assert doc["cached"] is False and doc["key"].endswith("|L1024")
    assert doc["entry"]["tiles"] == doc["tiles"]


# -- feasibility filter -------------------------------------------------------

@pytest.mark.parametrize("read_len", [150, 256, 1024, 2048, 4096, 8192])
def test_shared_memory_filter_matches_smem_bytes(read_len):
    """At full width a candidate is kept iff ``smem_bytes`` at the read
    length's bucket fits the block limit."""
    kept = autotune.feasible_tiles(FULL, read_len, "cpu")
    bucket = autotune.read_len_bucket(read_len)
    want = [t for t in autotune.candidate_tiles()
            if fused_profile.smem_bytes(
                t["bb"], t["cluster"], bucket, FULL.ngram,
                FULL.alphabet_size, FULL.num_words)
            <= fused_profile.MAX_SMEM_BYTES]
    assert kept == want
    assert {"bb": 16, "cluster": 2} in kept        # bb 16 / cluster 2 fits up to 8192


def test_filter_drops_wide_tiles_at_long_reads():
    at_256 = autotune.feasible_tiles(FULL, 150, "cpu")
    at_2048 = autotune.feasible_tiles(FULL, 1500, "cpu")
    assert {"bb": 32, "cluster": 2} in at_256
    assert {"bb": 32, "cluster": 2} not in at_2048
    assert len(at_2048) < len(at_256) == len(autotune.candidate_tiles()) - 1


def test_no_feasible_tiling_is_an_error(tmp_path):
    with pytest.raises(ValueError, match="no fused_profile tiling fits"):
        autotune.tune(FULL, batch=16, num_prototypes=4, read_len=20_000,
                      path=tmp_path / "c.json", device="cpu")


# -- the read-length trap ---------------------------------------------------

def _checked_fused_agreement(monkeypatch):
    """Make every fused launch check its tiling at the batch's real read
    length first, as the CUDA launch does (the CPU plain path skips it)."""
    real = ops.fused_agreement
    seen = []

    def checked(tokens, lengths, im, tie, prototypes, space, **tiles):
        fused_profile.check_tiles(tiles["bb"], tiles["cluster"],
                                  tokens.shape[1], space.ngram,
                                  space.alphabet_size, space.num_words)
        seen.append((tokens.shape[1], dict(tiles)))
        return real(tokens, lengths, im, tie, prototypes, space, **tiles)

    monkeypatch.setattr(ops, "fused_agreement", checked)
    return seen


def _poison(path, batch, s, read_len):
    """A cache entry for ``read_len`` holding bb 32 / cluster 2."""
    cache = autotune.load_cache(path)
    cache[autotune.cache_key(batch, FULL.num_words, s, FULL.dim, read_len,
                             "cpu")] = {"tiles": {"bb": 32, "cluster": 2}}
    autotune.save_cache(cache, path)


def test_pick_tuned_at_150_never_runs_a_2048_cohort(tmp_path, monkeypatch):
    """A cached pick of bb 32 / cluster 2, tuned at L = 150 (bucket 256),
    fits 256-token cohorts; the first 2,048-token cohort is tuned at its
    own bucket and launches a tiling that fits it."""
    cache = tmp_path / "c.json"
    _poison(cache, 16, 6, 150)
    monkeypatch.setattr(autotune, "_time_tiles",
                        lambda tiles, *a: 1.0 / tiles["cluster"])
    seen = _checked_fused_agreement(monkeypatch)
    cfg = ProfilerConfig(space=FULL, window=8192, batch_size=16,
                         backend="cuda_fused", backend_options={
                             "autotune": True, "autotune_cache": str(cache)})
    rng = np.random.default_rng(3)
    genomes = {f"g{i}": rng.integers(0, 4, 16_000, dtype=np.int32)
               for i in range(3)}
    session = ProfilingSession(cfg, device="cpu")
    session.build_refdb(genomes)
    assert session.refdb.num_prototypes == 6
    g = genomes["g1"]
    reads = [(g[100:250], 150), (g[2000:3500], 1500)]
    service = ProfilingService(session, max_active=2)
    hs = []
    for t, n in reads:                      # one cohort at each width
        hs.append(service.submit(ArraySource(np.stack([t] * 3),
                                             np.full(3, n))))
        service.run_until_idle()
    assert [h.result(timeout=0).total_reads for h in hs] == [3, 3]
    assert [h.result(timeout=0).mapped_reads for h in hs] == [3, 3]
    widths = sorted({(w, t["bb"], t["cluster"]) for w, t in seen})
    assert widths == [(256, 32, 2), (2048, 16, 8)]   # first fastest
    entry = autotune.load_cache(cache)[autotune.cache_key(
        16, FULL.num_words, 6, FULL.dim, 2048, "cpu")]
    assert entry["swept"] == len(autotune.feasible_tiles(FULL, 2048, "cpu"))


@pytest.mark.parametrize("read_len", [16, 64, 150, 256, 512, 1024, 1500,
                                      2048, 3000, 4096])
def test_tuned_tiles_fit_every_bucket_up_to_4096(tmp_path, monkeypatch,
                                                 read_len):
    """Whatever the cache holds (bb 32 / cluster 2 under every key), the
    tiles a tuned backend resolves fit reads of up to its bucket."""
    cache = tmp_path / "c.json"
    for n in (16, 32, 64, 128, 256, 512, 1024, 2048, 4096):
        _poison(cache, 16, 100, n)
    monkeypatch.setattr(autotune, "_time_tiles", lambda *a: 1.0)
    cfg = ProfilerConfig(space=FULL, window=8192, batch_size=16,
                         backend="cuda_fused", backend_options={
                             "autotune": True, "autotune_cache": str(cache)})
    backend = fused_backend.CudaFusedBackend(cfg, device="cpu")
    tiles = backend._resolve_tiles(100, read_len)
    bucket = autotune.read_len_bucket(read_len)
    fused_profile.check_tiles(tiles["bb"], tiles["cluster"], bucket,
                              FULL.ngram, FULL.alphabet_size,
                              FULL.num_words)
    assert backend._resolve_tiles(100, read_len) == tiles   # memoized


# -- explicit tiles beat autotune ----------------------------------------------

def test_explicit_tiles_override_autotune_with_one_warning(tmp_path,
                                                           monkeypatch):
    monkeypatch.setattr(fused_backend, "_warned_autotune_override", False)
    cfg = ProfilerConfig(space=SP, window=256, batch_size=8,
                         backend="cuda_fused", backend_options={
                             "autotune": True, "bb": 32,
                             "autotune_cache": str(tmp_path / "c.json")})
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        b1 = fused_backend.CudaFusedBackend(cfg, device="cpu")
        b2 = fused_backend.CudaFusedBackend(cfg, device="cpu")
    msgs = [str(x.message) for x in w if "override autotune" in str(x.message)]
    assert len(msgs) == 1 and "['bb']" in msgs[0]
    for b in (b1, b2):
        assert b._resolve_tiles(20, 150) == {"bb": 32, "cluster": 2}
    assert not (tmp_path / "c.json").exists()       # the tuner never ran


def test_autotune_options_are_validated():
    from repro_torch.pipeline.options import OptionError

    for opts, msg in (({"autotune": "yes"}, "autotune"),
                      ({"autotune_cache": ""}, "non-empty path")):
        cfg = ProfilerConfig(space=SP, backend="cuda_fused",
                             backend_options=opts)
        with pytest.raises(OptionError, match=msg):
            fused_backend.CudaFusedBackend(cfg, device="cpu")


# -- tuned-config parity through the pipeline ---------------------------------

@pytest.fixture(scope="module")
def pipeline_setup(tmp_path_factory):
    from repro.core.hd_space import HDSpace as JaxSpace
    from repro.pipeline import ArraySource as JaxArraySource
    from repro.pipeline import ProfilerConfig as JaxConfig
    from repro.pipeline import ProfilingSession as JaxSession

    space = dict(dim=512, ngram=8, z_threshold=3.0)
    spec = synth.CommunitySpec(num_species=3, genome_len=4_000, seed=5)
    sample = SyntheticSource(spec, num_reads=24, present=[0, 1])
    cache = str(tmp_path_factory.mktemp("tuner") / "tuner.json")
    js = JaxSession(JaxConfig(space=JaxSpace(**space), window=256,
                              batch_size=8))
    js.build_refdb(sample.genomes)
    expected = js.profile(JaxArraySource(sample.tokens,
                                         sample.lengths)).to_json()

    def cfg(backend, **kw):
        return ProfilerConfig(space=HDSpace(**space), window=256,
                              batch_size=8, backend=backend, **kw)

    return cfg, sample, cache, expected


def test_tuned_session_parity_and_cache_reuse(pipeline_setup):
    cfg, sample, cache, expected = pipeline_setup
    opts = {"autotune": True, "autotune_cache": cache}
    s = ProfilingSession(cfg("cuda_fused", backend_options=opts),
                         device="cpu")
    s.build_refdb(sample.genomes)
    assert s.profile(sample).to_json() == expected
    assert os.path.exists(cache), "first profiled batch persists the sweep"
    tuned = dict(s.backend.tiles)
    s2 = ProfilingSession(cfg("cuda_fused", backend_options=opts),
                          device="cpu")
    s2.build_refdb(sample.genomes)
    assert s2.profile(sample).to_json() == expected
    assert s2.backend.tiles == tuned


def test_tuned_service_parity(pipeline_setup):
    cfg, sample, cache, expected = pipeline_setup
    s = ProfilingSession(cfg("cuda_fused", backend_options={
        "autotune": True, "autotune_cache": cache}), device="cpu")
    s.build_refdb(sample.genomes)
    service = ProfilingService(s, max_active=2)
    h = service.submit(sample)
    service.run_until_idle()
    assert h.result(timeout=60).to_json() == expected


# -- on the card --------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("read_len", [150, 2048])
def test_tuned_session_parity_on_the_card(tmp_path, read_len):
    """On the card: the tuner measures every feasible tiling, and a tuned
    cuda_fused session reports what the reference backend does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    spec = synth.CommunitySpec(num_species=3, genome_len=40_000, seed=5,
                               read_len=read_len)
    sample = SyntheticSource(spec, num_reads=96, present=[0, 1])
    space = HDSpace(dim=8192, ngram=16)
    reports = []
    for backend, opts in (("reference", {}),
                          ("cuda_fused", {"autotune": True,
                                          "autotune_cache":
                                          str(tmp_path / "c.json")})):
        s = ProfilingSession(ProfilerConfig(
            space=space, window=4096, batch_size=32, backend=backend,
            backend_options=opts), device="cuda")
        s.build_refdb(sample.genomes)
        reports.append(s.profile(sample).to_dict())
    assert reports[0] == reports[1]
    entry = next(iter(autotune.load_cache(tmp_path / "c.json").values()))
    assert entry["swept"] == len(autotune.feasible_tiles(space, read_len))
    assert all(t > 0 for t in entry["times_s"].values())
