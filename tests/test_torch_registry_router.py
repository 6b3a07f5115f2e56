"""The port's RefDB registry and tenant router against ``repro``, on the CPU.

The cases of ``tests/test_registry_router.py`` on the port (``device="cpu"``,
the CUDA backends' kernels run their plain torch versions): requests
admitted before a hot-swap equal a sequential run on the old version,
later ones the new; quotas, deltas, versioned persistence, gc and the
stop/submit race.  Plus: ``apply_delta`` against
``repro.core.assoc_memory.apply_delta`` on the same RefDB (equal arrays),
a registry root written by ``repro``'s ``RefDBRegistry`` served by the
port's ``RefDBRegistry.open`` with equal reports, and the registry's
encoder resolved from the database's backend.
"""

import threading
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.core import assoc_memory as jax_am
from repro.core.hd_space import HDSpace as JaxSpace
from repro.pipeline import ArraySource as JaxArraySource
from repro.pipeline import ProfilerConfig as JaxConfig
from repro.pipeline import ProfilingSession as JaxSession
from repro.serve import RefDBRegistry as JaxRegistry
from repro_torch import convert
from repro_torch.core import assoc_memory
from repro_torch.core.hd_space import HDSpace
from repro_torch.genomics import synth
from repro_torch.kernels import hdc_encoder
from repro_torch.pipeline import (ArraySource, ProfilerConfig,
                                  ProfilingSession, SyntheticSource)
from repro_torch.serve import (RefDBRegistry, RouterClosed,
                               ServiceOverloaded, TenantRouter)

SPACE = dict(dim=512, ngram=8, z_threshold=3.0)
SP = HDSpace(**SPACE)
SPEC = synth.CommunitySpec(num_species=4, genome_len=6_000, seed=11)


#: The installed jax's threefry mode: ``repro`` draws its item memory in
#: it, so the port's configs take it too.
MODE = bool(jax.config.jax_threefry_partitionable)


def _config(**kw):
    kw.setdefault("space", SP)
    kw.setdefault("threefry_partitionable", MODE)
    kw.setdefault("window", 1024)
    kw.setdefault("batch_size", 16)
    return ProfilerConfig(**kw)


def _registry(root, **kw):
    return RefDBRegistry(root=root, device="cpu", **kw)


def _build(genomes):
    return assoc_memory.build_refdb(genomes, SP, window=1024, device="cpu",
                                    partitionable=MODE)


@pytest.fixture(scope="module")
def sample():
    return SyntheticSource(SPEC, num_reads=144, present=[0, 2])


@pytest.fixture(scope="module")
def extra():
    """One genuinely new species for add-deltas."""
    rng = np.random.default_rng(99)
    return {"sp_new": rng.integers(0, 4, 6_000, dtype=np.int32)}


def _slices(sample, n):
    return [ArraySource(sample.tokens[i::n], sample.lengths[i::n])
            for i in range(n)]


def _same_db(a, b):
    for field in ("prototypes", "proto_species", "genome_lengths"):
        np.testing.assert_array_equal(np.asarray(getattr(a, field)),
                                      np.asarray(getattr(b, field)))
    assert a.num_species == b.num_species
    assert a.species_names == b.species_names


def _sequential(cfg, db):
    s = ProfilingSession(cfg, device="cpu")
    s.adopt_refdb(db)
    return s


# -- zero-downtime swap, bit for bit -----------------------------------------

@pytest.mark.parametrize("backend", ["reference", "cuda_fused",
                                     "cuda_packed"])
def test_swap_under_traffic_bit_exact(tmp_path, sample, extra, backend):
    """Admitted-before requests run on v1 exactly; admitted-after on v2."""
    cfg = _config(backend=backend)
    reg = _registry(tmp_path / backend)
    snap1 = reg.create("food", sample.genomes, cfg)
    router = TenantRouter(reg)
    router.add_tenant("acme", database="food", max_active=8, max_queue=8)

    srcs = _slices(sample, 6)
    pre = [router.submit(s, tenant="acme") for s in srcs[:3]]
    snap2 = reg.apply_delta("food", add=extra)      # auto hot-swap
    assert router.serving_version("food") == snap2.version == 2
    post = [router.submit(s, tenant="acme") for s in srcs[3:]]
    router.run_until_idle()

    seq1, seq2 = _sequential(cfg, snap1.db), _sequential(cfg, snap2.db)
    for h, src in zip(pre, srcs[:3]):
        assert h.version == 1
        assert h.result(timeout=300).to_json() == seq1.profile(src).to_json()
    for h, src in zip(post, srcs[3:]):
        assert h.version == 2
        assert h.result(timeout=300).to_json() == seq2.profile(src).to_json()
        assert "sp_new" in h.result(timeout=0).species_names
    assert ("food", 1) in router.retired            # old version drained
    router.close()


@pytest.mark.parametrize("backend", ["reference", "cuda_fused"])
def test_swap_under_live_worker_traffic(tmp_path, sample, extra, backend):
    """Same contract with two background pump workers racing the swap."""
    cfg = _config(backend=backend)
    reg = _registry(tmp_path / "r")
    reg.create("food", sample.genomes, cfg)
    router = TenantRouter(reg)
    router.add_tenant("acme", database="food", max_active=2, max_queue=2)

    srcs = _slices(sample, 8)
    handles = []
    router.start(2)
    try:
        for i, src in enumerate(srcs):
            if i == len(srcs) // 2:
                reg.apply_delta("food", add=extra)
            handles.append(router.submit(src, tenant="acme",
                                         block=True, timeout=300))
        reports = [h.result(timeout=300) for h in handles]
    finally:
        router.stop()
    sessions = {}
    for h, src, rep in zip(handles, srcs, reports):
        if h.version not in sessions:
            sessions[h.version] = _sequential(
                cfg, reg.snapshot("food", h.version).db)
        assert rep.to_json() == sessions[h.version].profile(src).to_json()
    assert {h.version for h in handles} == {1, 2}
    router.close()


# -- per-tenant quotas --------------------------------------------------------

def test_quota_overflow_isolated(tmp_path, sample):
    cfg = _config(backend="reference")
    reg = _registry(tmp_path / "r")
    reg.create("food", sample.genomes, cfg)
    router = TenantRouter(reg)
    router.add_tenant("small", database="food", max_active=1, max_queue=0)
    router.add_tenant("big", database="food", max_active=4, max_queue=4)

    srcs = _slices(sample, 6)
    h0 = router.submit(srcs[0], tenant="small")
    with pytest.raises(ServiceOverloaded, match="small"):
        router.submit(srcs[1], tenant="small")
    big = [router.submit(s, tenant="big") for s in srcs[2:6]]
    router.run_until_idle()
    for h in [h0, *big]:
        assert h.result(timeout=300).total_reads > 0
    h1 = router.submit(srcs[1], tenant="small")
    router.run_until_idle()
    assert h1.result(timeout=300).total_reads > 0
    router.close()


def test_unknown_tenant_and_duplicate_registration(tmp_path, sample):
    cfg = _config(backend="reference")
    reg = _registry(tmp_path / "r")
    reg.create("food", sample.genomes, cfg)
    router = TenantRouter(reg)
    router.add_tenant("a", database="food")
    with pytest.raises(KeyError, match="nope"):
        router.submit(_slices(sample, 1)[0], tenant="nope")
    with pytest.raises(ValueError, match="already registered"):
        router.add_tenant("a", database="food")
    router.close()


# -- delta correctness --------------------------------------------------------

def test_add_delta_matches_fresh_build(tmp_path, sample, extra):
    reg = _registry(tmp_path / "r")
    reg.create("food", sample.genomes, _config())
    snap2 = reg.apply_delta("food", add=extra)
    _same_db(snap2.db, _build({**sample.genomes, **extra}))
    assert snap2.parent_version == 1
    assert snap2.delta == {"added": ["sp_new"], "removed": []}


def test_remove_delta_matches_fresh_build(tmp_path, sample):
    reg = _registry(tmp_path / "r")
    reg.create("food", sample.genomes, _config())
    victim = list(sample.genomes)[1]
    snap2 = reg.apply_delta("food", remove=[victim])
    _same_db(snap2.db, _build(
        {k: v for k, v in sample.genomes.items() if k != victim}))
    assert snap2.delta == {"added": [], "removed": [victim]}


def test_genome_refresh_is_one_delta(tmp_path, sample):
    reg = _registry(tmp_path / "r")
    reg.create("food", sample.genomes, _config())
    name = list(sample.genomes)[0]
    rng = np.random.default_rng(7)
    refreshed = {name: rng.integers(0, 4, 6_000, dtype=np.int32)}
    snap2 = reg.apply_delta("food", add=refreshed, remove=[name])
    rest = {k: v for k, v in sample.genomes.items() if k != name}
    _same_db(snap2.db, _build({**rest, **refreshed}))


def test_delta_rejects_bad_names(tmp_path, sample, extra):
    reg = _registry(tmp_path / "r")
    reg.create("food", sample.genomes, _config())
    with pytest.raises(KeyError):
        reg.apply_delta("food", remove=["no_such_species"])
    with pytest.raises(ValueError, match="collide|already"):
        reg.apply_delta("food", add={list(sample.genomes)[0]:
                                     extra["sp_new"]})
    with pytest.raises(ValueError):
        reg.apply_delta("food", remove=list(sample.genomes))  # remove all
    with pytest.raises(ValueError, match="empty delta"):
        reg.apply_delta("food")
    assert reg.current("food").version == 1          # nothing published


def test_apply_delta_core_roundtrip(sample, extra):
    db = _build(sample.genomes)
    addition = _build(extra)
    out = assoc_memory.apply_delta(db, add=addition,
                                   remove=[list(sample.genomes)[2]])
    ps = out.proto_species.numpy()
    assert (np.diff(ps) >= 0).all()
    assert out.num_species == db.num_species         # -1 +1
    assert "sp_new" in out.species_names
    assert list(sample.genomes)[2] not in out.species_names


@pytest.mark.parametrize("remove,with_add", [
    ((), True), (("species_01",), False), (("species_01",), True),
    (("species_00", "species_03"), False),
    (("species_00", "species_03"), True)])
def test_apply_delta_matches_repro(sample, extra, remove, with_add):
    """The port's deltas equal ``repro``'s on the same RefDB, array for
    array (surviving rows byte-identical, species ids remapped alike)."""
    genomes = sample.genomes
    assert set(remove) <= set(genomes)
    jspace = JaxSpace(**SPACE)
    jdb = jax_am.build_refdb(genomes, jspace, window=1024)
    jadd = jax_am.build_refdb(extra, jspace, window=1024) if with_add \
        else None
    want = jax_am.apply_delta(jdb, add=jadd, remove=remove)
    db, add = _build(genomes), (_build(extra) if with_add else None)
    got = assoc_memory.apply_delta(db, add=add, remove=remove)
    np.testing.assert_array_equal(convert.tensor_to_words(got.prototypes),
                                  np.asarray(want.prototypes))
    np.testing.assert_array_equal(got.proto_species.numpy(),
                                  np.asarray(want.proto_species))
    np.testing.assert_array_equal(got.genome_lengths.numpy(),
                                  np.asarray(want.genome_lengths))
    assert (got.num_species, got.species_names) == \
        (want.num_species, want.species_names)
    assert got.prototypes.device == db.prototypes.device


def test_apply_delta_checks_widths_and_empties(sample):
    db = _build(sample.genomes)
    wide = assoc_memory.build_refdb(
        {"w": np.zeros(3_000, np.int32)}, HDSpace(dim=1024, ngram=8),
        window=1024, device="cpu")
    with pytest.raises(ValueError, match="packed width mismatch"):
        assoc_memory.apply_delta(db, add=wide)
    with pytest.raises(KeyError, match="unknown species"):
        assoc_memory.remove_species(db, ["nope"])
    assert assoc_memory.remove_species(db, []) is db


# -- the registry's encoder ---------------------------------------------------

def test_registry_encodes_through_the_database_backend(tmp_path, sample,
                                                       monkeypatch):
    """A ``cuda_*`` database is encoded by the backend's encoder (the
    encoder kernel's wrapper; its plain version on the CPU), and the
    prototypes equal the reference build."""
    calls = []
    real = hdc_encoder.hdc_encode

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(hdc_encoder, "hdc_encode", counted)
    reg = _registry(None)
    snap = reg.create("food", sample.genomes, _config(backend="cuda_fused"))
    assert len(calls) == len(sample.genomes)         # one batch a genome
    _same_db(snap.db, _build(sample.genomes))
    reg.apply_delta("food", add={"x": sample.genomes["species_00"]})
    assert len(calls) == len(sample.genomes) + 1


def test_registry_defaults_to_cuda():
    import torch

    if torch.cuda.is_available():
        assert RefDBRegistry().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            RefDBRegistry()
    assert RefDBRegistry(device="cpu").device.type == "cpu"


# -- versioned persistence ----------------------------------------------------

def test_registry_reopen_resumes_versioning(tmp_path, sample, extra):
    root = tmp_path / "r"
    reg = _registry(root)
    reg.create("food", sample.genomes, _config())
    snap2 = reg.apply_delta("food", add=extra)

    back = RefDBRegistry.open(root, device="cpu")
    assert back.databases() == ("food",)
    cur = back.current("food")
    assert cur.version == 2
    _same_db(cur.db, snap2.db)
    snap3 = back.apply_delta("food", remove=["sp_new"])
    assert snap3.version == 3 and snap3.parent_version == 2
    _same_db(snap3.db, _build(sample.genomes))


def test_repro_registry_root_serves_in_the_port(tmp_path, sample, extra):
    """A root written by ``repro``'s registry (create + delta) opens in the
    port's, which serves it with reports equal to ``repro``'s."""
    root = tmp_path / "shared"
    jcfg = JaxConfig(space=JaxSpace(**SPACE), window=1024, batch_size=16)
    jreg = JaxRegistry(root=root)
    jreg.create("food", sample.genomes, jcfg)
    jsnap = jreg.apply_delta("food", add=extra)
    js = JaxSession(jcfg)
    js.adopt_refdb(jsnap.db)
    srcs = _slices(sample, 3)
    want = [js.profile(JaxArraySource(s.tokens, s.lengths)).to_dict()
            for s in srcs]

    reg = RefDBRegistry.open(root, device="cpu", threefry_partitionable=MODE)
    cur = reg.current("food")
    assert cur.version == 2 and cur.parent_version == 1
    assert cur.delta == {"added": ["sp_new"], "removed": []}
    np.testing.assert_array_equal(convert.tensor_to_words(cur.db.prototypes),
                                  np.asarray(jsnap.db.prototypes))
    router = TenantRouter(reg, backend="cuda_fused")
    router.add_tenant("acme", database="food")
    hs = [router.submit(s, tenant="acme") for s in srcs]
    router.run_until_idle()
    assert [h.result(timeout=0).to_dict() for h in hs] == want
    router.close()


def test_registry_snapshot_history(tmp_path, sample, extra):
    reg = _registry(tmp_path / "r")
    snap1 = reg.create("food", sample.genomes, _config())
    reg.apply_delta("food", add=extra)
    assert reg.versions("food") == (1, 2)
    _same_db(reg.snapshot("food", 1).db, snap1.db)   # old version retained
    with pytest.raises(KeyError):
        reg.snapshot("food", 9)
    with pytest.raises(KeyError):
        reg.current("nope")


def test_registry_rejects_bad_database_names(tmp_path, sample):
    reg = _registry(tmp_path / "r")
    for bad in ("", "../evil", "a/b", ".hidden"):
        with pytest.raises(ValueError):
            reg.create(bad, sample.genomes, _config())


def test_install_is_idempotent_and_checks_fingerprint(tmp_path, sample):
    cfg = _config(backend="reference")
    reg = _registry(tmp_path / "r")
    reg.create("food", sample.genomes, cfg)
    mirror = _registry(None)
    snap = reg.current("food")
    a = mirror.install("food", snap, config=cfg)
    b = mirror.install("food", snap, config=cfg)
    assert a is b                       # idempotent per version
    other = _config(space=HDSpace(dim=256, ngram=5, z_threshold=3.0))
    with pytest.raises(ValueError, match="fingerprint"):
        mirror.install("food", snap, config=other)


# -- gc dry-run + recovery paths ---------------------------------------------

def test_gc_dry_run_previews_without_deleting(tmp_path, sample, extra):
    reg = _registry(tmp_path / "r")
    reg.create("food", sample.genomes, _config())
    reg.apply_delta("food", add=extra)
    reg.apply_delta("food", remove=["sp_new"])
    preview = reg.gc("food", keep_last=1, dry_run=True)
    assert preview.dry_run
    assert preview.collected == (("food", 1), ("food", 2))
    assert preview.reclaimed_bytes > 0
    assert reg.versions("food") == (1, 2, 3)         # nothing deleted
    assert reg.snapshot("food", 1).path.exists()
    swept = reg.gc("food", keep_last=1)
    assert not swept.dry_run
    assert swept.collected == preview.collected
    assert swept.reclaimed_bytes == preview.reclaimed_bytes
    assert reg.versions("food") == (3,)


def test_reopen_after_gc_resumes_chain(tmp_path, sample, extra):
    root = tmp_path / "r"
    reg = _registry(root)
    reg.create("food", sample.genomes, _config())
    snap2 = reg.apply_delta("food", add=extra)
    assert reg.gc("food", keep_last=1).collected == (("food", 1),)

    back = RefDBRegistry.open(root, device="cpu")
    assert back.versions("food") == (2,)
    _same_db(back.current("food").db, snap2.db)
    snap3 = back.apply_delta("food", remove=["sp_new"])
    assert snap3.version == 3 and snap3.parent_version == 2
    _same_db(snap3.db, _build(sample.genomes))


def test_publish_while_reader_pins_old_version(tmp_path, sample, extra):
    reg = _registry(tmp_path / "r")
    snap1 = reg.create("food", sample.genomes, _config())
    reg.pin("food", 1)                               # long-lived reader
    reg.apply_delta("food", add=extra)
    assert reg.gc("food", keep_last=1).collected == ()
    _same_db(reg.snapshot("food", 1).db, snap1.db)   # reader unharmed
    reg.release("food", 1)
    assert reg.gc("food", keep_last=1).collected == (("food", 1),)


# -- stop/submit race: closed admissions fail clean, never hang --------------

def test_submit_after_stop_raises_router_closed(tmp_path, sample):
    reg = _registry(tmp_path / "r")
    reg.create("food", sample.genomes, _config(backend="reference"))
    router = TenantRouter(reg)
    router.add_tenant("acme", database="food", max_active=4, max_queue=4)
    router.start(1)
    h = router.submit(_slices(sample, 2)[0], tenant="acme")
    router.stop()                                    # drains h first
    assert h.result(timeout=0).total_reads > 0
    with pytest.raises(RouterClosed, match="stopped"):
        router.submit(_slices(sample, 2)[1], tenant="acme")
    router.close()


def test_stop_wakes_quota_blocked_submit(tmp_path, sample):
    reg = _registry(tmp_path / "r")
    reg.create("food", sample.genomes, _config(backend="reference"))
    router = TenantRouter(reg)
    router.add_tenant("acme", database="food", max_active=1, max_queue=0)
    srcs = _slices(sample, 2)
    router.submit(srcs[0], tenant="acme")    # fills the quota; no workers
    outcome: dict = {}

    def blocked():
        try:
            outcome["handle"] = router.submit(srcs[1], tenant="acme",
                                              block=True, timeout=300)
        except BaseException as e:           # noqa: BLE001 - recorded
            outcome["error"] = e

    t = threading.Thread(target=blocked)
    t.start()
    time.sleep(0.2)                          # let it block on the quota
    router.stop(drain=False)
    t.join(timeout=10)
    assert not t.is_alive()                  # bounded: woke well before 300s
    assert isinstance(outcome.get("error"), RouterClosed)
    router.close()


def test_stop_drain_races_live_submitters(tmp_path, sample):
    reg = _registry(tmp_path / "r")
    reg.create("food", sample.genomes, _config(backend="cuda_fused"))
    router = TenantRouter(reg)
    router.add_tenant("acme", database="food", max_active=2, max_queue=32)
    srcs = _slices(sample, 8)
    admitted, closed = [], []

    def submitter():
        for src in srcs:
            try:
                admitted.append(router.submit(src, tenant="acme",
                                              block=True, timeout=300))
            except RouterClosed:
                closed.append(src)

    router.start(2)
    t = threading.Thread(target=submitter)
    t.start()
    time.sleep(0.05)                         # land mid-stream
    router.stop(drain=True)
    t.join(timeout=30)
    assert not t.is_alive()
    assert len(admitted) + len(closed) == len(srcs)
    for h in admitted:                       # drain finished all admitted
        assert h.result(timeout=0).total_reads > 0
    router.close()


# -- shared backend across swaps ---------------------------------------------

def test_swap_reuses_backend_instance(tmp_path, sample, extra):
    """Hot-swap must not rebuild the backend (item memory, tuned tiles)."""
    reg = _registry(tmp_path / "r")
    reg.create("food", sample.genomes, _config(backend="cuda_fused"))
    router = TenantRouter(reg)
    router.add_tenant("a", database="food")
    before = router._dbs["food"].current.session.backend
    reg.apply_delta("food", add=extra)
    after = router._dbs["food"].current.session.backend
    assert after is before
    assert after.device.type == "cpu"        # the registry's device
    router.close()
