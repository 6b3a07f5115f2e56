"""The port's ``sharded`` backend and the shard-composable species max.

The cases of ``tests/test_sharded.py`` on ``repro_torch``: sharded reports
equal ``repro``'s single-device ``reference`` report for the same config,
on a process group of one rank (in this process, gloo) and on 2 and 4
gloo ranks (each its own process, spawned here), with a prototype count
that does not divide the ranks (padding in play).  ``repro``'s own
multi-device path (``tests/test_mesh_subprocess.py``) is not the oracle:
single-device ``repro`` is.  Plus padding, placement, per-rank bytes, the
option errors and passthrough, the ``merge_scores`` property, serving
over a sharded database, and the ``profile_run`` flags ``--shards`` /
``--mesh`` (their conflicts, and a two-rank run under torchrun).
"""

import dataclasses
import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.core import classifier as jax_cls
from repro.core.hd_space import HDSpace as JaxSpace
from repro.pipeline import ArraySource as JaxArraySource
from repro.pipeline import ProfilerConfig as JaxConfig
from repro.pipeline import ProfilingSession as JaxSession
from repro_torch import convert
from repro_torch.core import classifier
from repro_torch.core.assoc_memory import RefDB
from repro_torch.core.hd_space import HDSpace
from repro_torch.distributed import sharding
from repro_torch.genomics import synth
from repro_torch.launch import profile_run
from repro_torch.pipeline import (ProfilerConfig, ProfilingSession,
                                  SyntheticSource, available_backends,
                                  pad_refdb, per_device_bytes, place_refdb,
                                  resolve_backend)

SP = dict(dim=512, ngram=5, z_threshold=3.0)
SPEC = synth.CommunitySpec(num_species=4, genome_len=6_000, seed=11)
REPO = pathlib.Path(__file__).resolve().parent.parent


#: The installed jax's threefry mode: ``repro`` draws its item memory in
#: it, so the port's configs take it too.
MODE = bool(jax.config.jax_threefry_partitionable)


def _config(**kw):
    kw.setdefault("space", HDSpace(**SP))
    kw.setdefault("threefry_partitionable", MODE)
    kw.setdefault("window", 1024)
    kw.setdefault("batch_size", 16)
    return ProfilerConfig(**kw)


@pytest.fixture(scope="module")
def sample():
    return SyntheticSource(SPEC, num_reads=64, present=[0, 2])


@pytest.fixture(scope="module")
def repro_reference(sample):
    """``repro``'s single-device ``reference`` session and report."""
    s = JaxSession(JaxConfig(space=JaxSpace(**SP), window=1024,
                             batch_size=16))
    s.build_refdb(sample.genomes)
    return s, s.profile(JaxArraySource(sample.tokens,
                                       sample.lengths)).to_dict()


@pytest.fixture(scope="module")
def reference(sample):
    s = ProfilingSession(_config(), device="cpu")
    s.build_refdb(sample.genomes)
    return s


# -- one rank (the process group of this process) ----------------------------

def test_registered():
    assert "sharded" in available_backends()
    assert sharding.PROFILE_RULES == {"reads": None, "protos": "shard",
                                      "hd_words": None, "species": None}


@pytest.mark.parametrize("base", ["reference", "reference_packed",
                                  "cuda_fused", "pcm_sim", "racetrack_sim"])
def test_report_bit_identical_on_one_rank(sample, repro_reference, base):
    s = ProfilingSession(_config(backend="sharded",
                                 backend_options={"base": base}),
                         device="cpu")
    s.build_refdb(sample.genomes)
    assert s.backend.num_shards == 1
    assert s.profile(sample).to_dict() == repro_reference[1]
    fused = base == "cuda_fused"
    assert hasattr(s.backend, "tokens_species_scores") == fused


@pytest.mark.parametrize("base,options", [
    ("pcm_sim", {"preset": "pcm", "seed": 3}),
    ("racetrack_sim", {"shift_fault_rate": 0.5, "read_sigma": 0.2}),
])
def test_substrate_base_device_options_pass_through(sample, base, options):
    """``sharded`` over a substrate backend forwards the device options:
    on one rank (no padding, the same banks) the noisy report equals the
    unsharded backend's, and a misspelled device knob fails with the
    base's own error."""
    un = ProfilingSession(_config(backend=base, backend_options=options),
                          device="cpu")
    un.build_refdb(sample.genomes)
    s = ProfilingSession(_config(backend="sharded", backend_options={
        "base": base, **options}), device="cpu")
    s.build_refdb(sample.genomes)
    assert s.backend.base.substrate == un.backend.substrate
    assert s.profile(sample).to_dict() == un.profile(sample).to_dict()
    with pytest.raises(ValueError, match=f"{base} got unknown option"):
        resolve_backend("sharded", _config(
            backend="sharded", backend_options={"base": base,
                                                "read_sigmaa": 0.1}),
            device="cpu")


def test_agreement_protocol_surface_matches(sample, repro_reference,
                                            reference):
    """The Backend-protocol primitive (per-prototype counts) is exact,
    including a ragged prototype count."""
    jsess = repro_reference[0]
    db = reference.refdb
    q = reference.encode_reads(sample.tokens[:8], sample.lengths[:8])
    sharded = resolve_backend("sharded", _config(backend="sharded"),
                              device="cpu")
    jq = jsess.encode_reads(sample.tokens[:8], sample.lengths[:8])
    for s_take in (db.prototypes.shape[0], 7):       # even and ragged
        want = np.asarray(jsess.backend.agreement(
            jq, jsess.refdb.prototypes[:s_take]))
        got = sharded.agreement(q, db.prototypes[:s_take])
        np.testing.assert_array_equal(got.numpy(), want)


def test_fused_species_scores_matches_tail(sample, repro_reference,
                                           reference):
    jsess = repro_reference[0]
    db = reference.refdb
    q = reference.encode_reads(sample.tokens[:8], sample.lengths[:8])
    sharded = resolve_backend("sharded", _config(backend="sharded"),
                              device="cpu")
    got = sharded.species_scores(q, db.prototypes, db.proto_species,
                                 db.num_species)
    jq = jsess.encode_reads(sample.tokens[:8], sample.lengths[:8])
    jdb = jsess.refdb
    want = np.asarray(jax_cls.partial_scores(
        jsess.backend.agreement(jq, jdb.prototypes), jdb.proto_species,
        jdb.num_species))
    np.testing.assert_array_equal(got.numpy(), want)


def test_sharded_shares_refdb_cache_with_reference(tmp_path, sample):
    """backend/backend_options are excluded from the cache key: the
    sharded backend loads the database reference built, then places it."""
    s1 = ProfilingSession(_config(), device="cpu")
    s1.build_or_load_refdb(sample.genomes, cache_dir=tmp_path)
    s2 = ProfilingSession(_config(backend="sharded"), device="cpu")
    s2.build_or_load_refdb(sample.genomes, cache_dir=tmp_path)
    assert s2.refdb_loaded_from_cache
    assert len(list(tmp_path.glob("refdb_*.npz"))) == 1


# -- placement + padding ----------------------------------------------------

def test_pad_refdb_tags_padding_out_of_range(reference):
    db = reference.refdb
    padded = pad_refdb(db, 8)
    s = db.prototypes.shape[0]
    assert padded.prototypes.shape[0] % 8 == 0
    assert (padded.proto_species[s:] == db.num_species).all()
    assert (padded.prototypes[s:] == 0).all()
    # idempotent once divisible
    assert pad_refdb(padded, 8) is padded


def _first_rows(db, rows):
    return dataclasses.replace(db, prototypes=db.prototypes[:rows],
                               proto_species=db.proto_species[:rows])


def test_place_refdb_preserves_values(reference):
    db = reference.refdb
    placed = place_refdb(db, sharding.make_profile_mesh(1, device="cpu"))
    assert torch.equal(placed.prototypes, db.prototypes)
    assert placed.species_names == db.species_names
    # two ranks of five: each keeps its 3 padded rows
    mesh = sharding.ProfileMesh(size=2, rank=1, backend="gloo")
    tail = place_refdb(_first_rows(db, 5), mesh)
    assert tail.prototypes.shape[0] == 3
    assert torch.equal(tail.prototypes[:2], db.prototypes[3:5])
    assert tail.proto_species.tolist()[2] == db.num_species


def test_per_device_bytes():
    db = RefDB(prototypes=torch.zeros((10, 16), dtype=torch.int32),
               proto_species=torch.zeros(10, dtype=torch.int32),
               genome_lengths=torch.zeros(3, dtype=torch.int32),
               num_species=3, species_names=("a", "b", "c"))
    assert per_device_bytes(db, 1) == db.memory_bytes()
    # 10 rows over 4 shards pads to 12 -> 3 rows/device
    assert per_device_bytes(db, 4) == 3 * 16 * 4 + 3 * 4 + 3 * 4


def test_option_validation():
    with pytest.raises(ValueError, match="base"):
        resolve_backend("sharded", _config(
            backend="sharded", backend_options={"base": "sharded"}),
            device="cpu")
    with pytest.raises(ValueError, match="shards"):
        resolve_backend("sharded", _config(
            backend="sharded", backend_options={"shards": -1}), device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        resolve_backend("sharded", _config(
            backend="sharded", backend_options={"base": "no_such"}),
            device="cpu")
    with pytest.raises(ValueError, match="num_shards"):
        resolve_backend("sharded", _config(
            backend="sharded", backend_options={"shards": 10_000}),
            device="cpu")
    # passthrough: the base's own schema judges its options
    with pytest.raises(ValueError, match="'bb' must be one of|power of two"):
        resolve_backend("sharded", _config(
            backend="sharded", backend_options={"base": "cuda_fused",
                                                "bb": 3}), device="cpu")
    with pytest.raises(ValueError, match="reference takes no options"):
        resolve_backend("sharded", _config(
            backend="sharded", backend_options={"bb": 16}), device="cpu")
    b = resolve_backend("sharded", _config(
        backend="sharded", backend_options={"base": "cuda_fused",
                                            "bb": 32}), device="cpu")
    assert b.base.tiles["bb"] == 32


# -- the associative per-shard merge (property-tested) ----------------------

def _check_merge_case(rng, num_species, n_protos, b, n_pad, cuts):
    """One instance of the property: shard-then-merge == ``repro``'s
    reduce-global."""
    ps = np.sort(rng.integers(0, num_species, n_protos)).astype(np.int32)
    agree = rng.integers(0, 513, (b, n_protos)).astype(np.int32)
    ps_p = np.concatenate([ps, np.full(n_pad, num_species, np.int32)])
    agree_p = np.concatenate(
        [agree, rng.integers(0, 513, (b, n_pad)).astype(np.int32)], axis=1)
    want = np.asarray(jax_cls.partial_scores(agree, ps, num_species))
    bounds = [0, *sorted(cuts), n_protos + n_pad]
    partials = [classifier.partial_scores(
        torch.from_numpy(agree_p[:, lo:hi]), torch.from_numpy(ps_p[lo:hi]),
        num_species)
        for lo, hi in zip(bounds[:-1], bounds[1:]) if lo < hi]
    if not partials:
        return
    np.testing.assert_array_equal(
        classifier.merge_scores(*partials).numpy(), want)


def test_merge_property_deterministic():
    """Seeded sweep of the property (runs without hypothesis): uneven
    shards, empty shards, absent species, padding rows."""
    rng = np.random.default_rng(0)
    for _ in range(40):
        num_species = int(rng.integers(1, 7))
        n_protos = int(rng.integers(1, 41))
        b = int(rng.integers(1, 6))
        n_pad = int(rng.integers(0, 8))
        n_cuts = int(rng.integers(0, 5))
        cuts = rng.integers(0, n_protos + n_pad + 1, n_cuts).tolist()
        _check_merge_case(rng, num_species, n_protos, b, n_pad, cuts)


def test_merge_property_hypothesis():
    """Concatenating prototype shards then reducing == merging per-shard
    partial reductions -- for uneven shard sizes and padded rows."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @settings(deadline=None, max_examples=60)
    @given(st.data())
    def check(data):
        rng = np.random.default_rng(data.draw(st.integers(0, 2**31)))
        num_species = data.draw(st.integers(1, 6))
        n_protos = data.draw(st.integers(1, 40))
        n_pad = data.draw(st.integers(0, 7))
        cuts = data.draw(st.lists(
            st.integers(0, n_protos + n_pad), max_size=4))
        _check_merge_case(rng, num_species, n_protos,
                          data.draw(st.integers(1, 5)), n_pad, cuts)

    check()


def test_no_score_is_the_reduction_fill_and_merge_identity():
    """partial_scores fills species absent from a shard with NO_SCORE
    (what repro's segment_max emits), and NO_SCORE never wins a merge."""
    agree = torch.tensor([[7], [3]], dtype=torch.int32)
    sc = classifier.partial_scores(agree, torch.tensor([0],
                                                       dtype=torch.int32), 3)
    want = np.asarray(jax_cls.partial_scores(np.array([[7], [3]], np.int32),
                                             np.array([0], np.int32), 3))
    np.testing.assert_array_equal(sc.numpy(), want)
    assert (sc[:, 1:] == classifier.NO_SCORE).all()
    assert classifier.NO_SCORE == jax_cls.NO_SCORE
    merged = classifier.merge_scores(
        sc, torch.full_like(sc, classifier.NO_SCORE))
    assert torch.equal(merged, sc)                    # identity


def test_merge_is_order_invariant():
    a = torch.tensor([[1, -5], [3, 2]], dtype=torch.int32)
    b = torch.tensor([[0, 7], [-1, 2]], dtype=torch.int32)
    c = torch.tensor([[2, 2], [2, 2]], dtype=torch.int32)
    lhs = classifier.merge_scores(classifier.merge_scores(a, b), c)
    rhs = classifier.merge_scores(a, classifier.merge_scores(c, b))
    assert torch.equal(lhs, rhs)


# -- serving over one sharded RefDB ----------------------------------------

def test_service_shares_sharded_refdb(sample, repro_reference):
    """Many concurrent requests over one sharded, placed database come
    back equal to ``repro``'s sequential reference run."""
    from repro_torch.serve import ProfilingService
    s = ProfilingSession(_config(backend="sharded"), device="cpu")
    s.build_refdb(sample.genomes)
    service = ProfilingService(s, max_active=4)
    handles = [service.submit((sample.tokens, sample.lengths))
               for _ in range(3)]
    service.run_until_idle()
    for h in handles:
        assert h.result(timeout=5).to_dict() == repro_reference[1]


# -- the profile_run flags ----------------------------------------------------

FLAGS = ["--synthetic", "--dim", "512", "--ngram", "5", "--window", "1024",
         "--device", "cpu"]


@pytest.mark.parametrize("argv,match", [
    (["--shards", "2", "--mesh", "3"], "--mesh 3 conflicts with --shards 2"),
    (["--shards", "1", "--backend-option", "shards=2"],
     "--shards 1 conflicts with --backend-option shards=2"),
    (["--backend", "cuda_packed", "--shards", "1", "--backend-option",
      "base=reference"], "--backend cuda_packed conflicts with "
                         "--backend-option base=reference"),
    (["--backend", "cuda_fused", "--shards", "1", "--backend-option",
      "bb=four"], "'bb' must be an integer"),
    (["--shards", "3"], "num_shards must equal the world size 1"),
])
def test_profile_run_shard_flag_conflicts(capsys, argv, match):
    with pytest.raises(SystemExit) as e:
        profile_run.main([*FLAGS, *argv])
    assert e.value.code == 2
    assert match in capsys.readouterr().err


def test_profile_run_shards_one_rank_equals_unsharded(tmp_path, capsys):
    """``--shards 1`` wraps the backend (its options ride through) and
    writes the unsharded run's report."""
    plain, wrapped = tmp_path / "plain.json", tmp_path / "wrapped.json"
    profile_run.main([*FLAGS, "--backend", "cuda_fused", "--json",
                      str(plain)])
    profile_run.main([*FLAGS, "--backend", "cuda_fused", "--mesh", "1",
                      "--backend-option", "bb=32", "--json", str(wrapped)])
    out = capsys.readouterr().out
    assert "backend sharded | build " in out
    assert json.loads(wrapped.read_text()) == json.loads(plain.read_text())


# -- several ranks, each its own process ------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(snippet: str, world: int, timeout: int = 600) -> list[dict]:
    """Run ``snippet`` on ``world`` gloo ranks (one process each, the
    group made from the environment as torchrun makes it); each prints a
    JSON object on its last line."""
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port()),
           "WORLD_SIZE": str(world), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", snippet], env={**env, "RANK": str(r),
                                              "LOCAL_RANK": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=timeout)
        assert p.returncode == 0, err[-3000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    return outs


_RANK_PARITY = """
import json, tempfile
import torch.distributed as dist
from repro_torch.core.hd_space import HDSpace
from repro_torch.genomics import synth
from repro_torch.pipeline import ProfilerConfig, ProfilingSession, SyntheticSource

MODE = {mode}
sp = HDSpace(dim=512, ngram=5, z_threshold=3.0)
sample = SyntheticSource(synth.CommunitySpec(num_species=5, genome_len=6_000,
                                             seed=11), num_reads=64,
                         present=[0, 2])
out = {"reports": {}}
for base in ("reference", "reference_packed", "cuda_fused", "pcm_sim"):
    s = ProfilingSession(ProfilerConfig(
        space=sp, window=1024, batch_size=16, backend="sharded",
        backend_options={"base": base}, threefry_partitionable=MODE),
        device="cpu")
    db = s.build_refdb(sample.genomes)
    out["shards"] = s.backend.num_shards
    out["rows"] = db.num_prototypes
    out["reports"][base] = s.profile(sample).to_dict()
with tempfile.TemporaryDirectory() as d:
    if dist.get_rank() == 0:
        ProfilingSession(ProfilerConfig(space=sp, window=1024, batch_size=16,
                                        threefry_partitionable=MODE),
                         device="cpu").build_or_load_refdb(sample.genomes,
                                                           cache_dir=d)
    s2 = ProfilingSession(ProfilerConfig(space=sp, window=1024, batch_size=16,
                                         backend="sharded",
                                         threefry_partitionable=MODE),
                          device="cpu")
    if dist.get_rank() == 0:
        s2.build_or_load_refdb(sample.genomes, cache_dir=d)
        out["loaded"] = s2.refdb_loaded_from_cache
    else:
        s2.build_refdb(sample.genomes)
    out["cache_report"] = s2.profile(sample).to_dict()
print(json.dumps(out))
"""


@pytest.mark.parametrize("world", [2, 4])
def test_multi_rank_report_parity(world):
    """Reports equal ``repro``'s single-device reference on 2 and 4 ranks,
    for 30 prototypes, which 4 does not divide (padding in play), on four
    bases (``pcm_sim`` at its ideal default, as ``tests/test_sharded.py``
    runs it); a database loaded from the store is placed the same way."""
    sample5 = SyntheticSource(synth.CommunitySpec(
        num_species=5, genome_len=6_000, seed=11), num_reads=64,
        present=[0, 2])
    j = JaxSession(JaxConfig(space=JaxSpace(**SP), window=1024,
                             batch_size=16))
    jdb = j.build_refdb(sample5.genomes)
    want = j.profile(JaxArraySource(sample5.tokens,
                                    sample5.lengths)).to_dict()
    s = jdb.prototypes.shape[0]
    assert s == 30
    for rank, out in enumerate(_run_ranks(
            _RANK_PARITY.replace("{mode}", str(MODE)), world)):
        assert out["shards"] == world
        assert out["rows"] == -(-s // world)
        for base, rep in out["reports"].items():
            assert rep == want, (world, rank, base)
        assert out["cache_report"] == want
        if rank == 0:
            assert out["loaded"]


_RANK_ROWS = """
import json
from repro_torch import convert
from repro_torch.core.hd_space import HDSpace
from repro_torch.genomics import synth
from repro_torch.pipeline import ProfilerConfig, ProfilingSession, SyntheticSource

MODE = {mode}
sample = SyntheticSource(synth.CommunitySpec(num_species=4, genome_len=6_000,
                                             seed=11), num_reads=8,
                         present=[0, 2])
s = ProfilingSession(ProfilerConfig(space=HDSpace(dim=512, ngram=5,
                                                  z_threshold=3.0),
                                    window=1024, batch_size=8,
                                    backend="sharded",
                                    threefry_partitionable=MODE),
                     device="cpu")
db = s.build_refdb(sample.genomes)
print(json.dumps({"rank": s.backend.mesh.rank,
                  "rows": convert.tensor_to_words(db.prototypes).tolist(),
                  "species": db.proto_species.tolist()}))
"""


def test_ranks_actually_distribute(reference):
    """Each rank holds its own half of the prototype rows (the capacity
    claim, not just numerical parity): rank r's rows are rows
    [r S/2, (r + 1) S/2) of the single-device build."""
    full = convert.tensor_to_words(reference.refdb.prototypes)
    species = reference.refdb.proto_species.tolist()
    outs = _run_ranks(_RANK_ROWS.replace("{mode}", str(MODE)), 2)
    half = -(-full.shape[0] // 2)
    for out in outs:
        r = out["rank"]
        rows = np.asarray(out["rows"], np.uint32)
        assert rows.shape == (half, full.shape[1])
        np.testing.assert_array_equal(rows, full[r * half:(r + 1) * half])
        assert out["species"] == species[r * half:(r + 1) * half]


def test_profile_run_under_torchrun(tmp_path):
    """``torchrun --nproc-per-node 2 -m repro_torch.launch.profile_run
    --shards 2``: rank 0 prints the report and the per-device line, and
    writes the unsharded run's report."""
    sharded, plain = tmp_path / "sharded.json", tmp_path / "plain.json"
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.profile_run",
         *FLAGS, "--shards", "2", "--json", str(sharded)],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("backend sharded | build ") == 1
    assert "sharded 2 ways (reference base): " in proc.stdout
    assert "MB per device" in proc.stdout
    profile_run.main([*FLAGS, "--json", str(plain)])
    assert json.loads(sharded.read_text()) == json.loads(plain.read_text())
