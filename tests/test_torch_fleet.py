"""The port's fleet serving against ``repro``'s sequential reports.

The nine cases of ``tests/test_fleet.py`` on ``repro_torch.serve.fleet``:
a 3-host fleet (every host in this process, on the CPU here) survives a
host killed mid-request -- affected requests are rerouted to surviving
replicas -- and a fleet-wide hot-swap is two-phase (no host serves the
new version before every host has it pinned; the old version becomes
gc-eligible at the source only after every host drained it); tenant
affinity and least-load routing, resumable replication across downtime
and source gc, the non-replayable-source failure, and the merged metrics
snapshot with its ``host`` labels.  Every port report is held against
``repro``'s sequential ``reference`` report on the same database version
and reads: exact equality.  ``cuda_fused`` runs its kernels' plain
versions on the CPU.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.core.hd_space import HDSpace as JaxSpace
from repro.pipeline import ArraySource as JaxArraySource
from repro.pipeline import ProfilerConfig as JaxConfig
from repro.pipeline import ProfilingSession as JaxSession
from repro.serve import RefDBRegistry as JaxRegistry
from repro_torch.core.hd_space import HDSpace
from repro_torch.genomics import synth
from repro_torch.kernels import hdc_encoder
from repro_torch.pipeline import (ArraySource, IterableSource,
                                  ProfilerConfig, SyntheticSource)
from repro_torch.serve import (FleetController, HostDown, HostState,
                               NoHealthyHosts, RefDBRegistry)

SP = dict(dim=512, ngram=5, z_threshold=3.0)
SPEC = synth.CommunitySpec(num_species=4, genome_len=6_000, seed=11)


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
    return SyntheticSource(SPEC, num_reads=144, present=[0, 2])


@pytest.fixture(scope="module")
def extra():
    rng = np.random.default_rng(99)
    return {"sp_new": rng.integers(0, 4, 6_000, dtype=np.int32)}


@pytest.fixture(scope="module")
def repro_seq(sample, extra):
    """``repro``'s sequential ``reference`` report of slice ``i`` of ``n``
    on database version 1 (the sample's genomes) or 2 (plus ``extra``)."""
    jcfg = JaxConfig(space=JaxSpace(**SP), window=1024, batch_size=16)
    reg = JaxRegistry(root=None)
    reg.create("food", sample.genomes, jcfg)
    reg.apply_delta("food", add=extra)
    sessions, cache = {}, {}

    def report(version, n, i):
        key = (version, n, i)
        if key not in cache:
            if version not in sessions:
                s = JaxSession(jcfg)
                s.adopt_refdb(reg.snapshot("food", version).db)
                sessions[version] = s
            cache[key] = sessions[version].profile(JaxArraySource(
                sample.tokens[i::n], sample.lengths[i::n])).to_dict()
        return cache[key]
    return report


def _slices(sample, n):
    return [ArraySource(sample.tokens[i::n], sample.lengths[i::n])
            for i in range(n)]


def _registry(sample, cfg):
    reg = RefDBRegistry(root=None, device="cpu")
    reg.create("food", sample.genomes, cfg)
    return reg


# -- routing -----------------------------------------------------------------

def test_routing_spreads_and_reports_bit_exact(sample, repro_seq):
    cfg = _config(backend="reference")
    reg = _registry(sample, cfg)
    fleet = FleetController(reg, hosts=3)
    fleet.add_tenant("a", "food", max_active=1, max_queue=8)
    fleet.add_tenant("b", "food", max_active=1, max_queue=8)
    srcs = _slices(sample, 6)
    with fleet:
        handles = [fleet.submit(s, tenant="ab"[i % 2]) for i, s in
                   enumerate(srcs)]
        reports = [h.result(timeout=300) for h in handles]
    fleet.close()
    for i, (h, rep) in enumerate(zip(handles, reports)):
        assert h.version == 1
        assert rep.to_dict() == repro_seq(1, 6, i)
    # least-outstanding routing spreads load past the affinity home
    assert len({h.host for h in handles}) > 1


def test_tenant_affinity_on_idle_fleet(sample):
    """With no load anywhere, a tenant always lands on its ring home."""
    cfg = _config(backend="reference")
    reg = _registry(sample, cfg)
    fleet = FleetController(reg, hosts=3)
    fleet.add_tenant("acme", "food", max_active=4, max_queue=16)
    homes = set()
    with fleet:
        for src in _slices(sample, 4):
            h = fleet.submit(src, tenant="acme")
            h.result(timeout=300)       # fleet idle again before the next
            homes.add(h.host)
    fleet.close()
    assert len(homes) == 1


def test_unknown_tenant_and_no_healthy_hosts(sample):
    cfg = _config(backend="reference")
    reg = _registry(sample, cfg)
    fleet = FleetController(reg, hosts=2)
    fleet.add_tenant("a", "food")
    src = _slices(sample, 1)[0]
    with pytest.raises(KeyError, match="nope"):
        fleet.submit(src, tenant="nope")
    fleet.kill_host("host0")
    fleet.kill_host("host1")
    with pytest.raises(NoHealthyHosts):
        fleet.submit(src, tenant="a")
    fleet.close()


# -- acceptance: mid-flight host kill, rerouted and bit-exact ----------------

@pytest.mark.parametrize("backend", ["reference", "cuda_fused"])
def test_kill_host_reroutes_bit_exact(sample, repro_seq, backend):
    """Requests on the killed host fail over to survivors; every report
    (rerouted ones included) equals ``repro``'s sequential run.

    Submitted before the pumps start, so the victim's requests are
    provably in flight (queued, not done) when the host dies."""
    cfg = _config(backend=backend)
    reg = _registry(sample, cfg)
    fleet = FleetController(reg, hosts=3)
    fleet.add_tenant("acme", "food", max_active=2, max_queue=16)
    srcs = _slices(sample, 6)
    handles = [fleet.submit(s, tenant="acme") for s in srcs]
    by_host: dict[str, int] = {}
    for h in handles:
        by_host[h.host] = by_host.get(h.host, 0) + 1
    victim = max(by_host, key=by_host.get)
    moved = fleet.kill_host(victim)
    assert moved                       # the busiest host had live work
    with fleet:                        # survivors pump; victim stays down
        reports = [h.result(timeout=300) for h in handles]
    for i, (h, rep) in enumerate(zip(handles, reports)):
        assert rep.to_dict() == repro_seq(1, 6, i)
        assert h.host != victim        # nothing still claims the dead host
    rerouted = [h for h in handles if h.rerouted]
    assert {h.request_id for h in rerouted} == set(moved)
    assert all(len(h.attempts) == 2 for h in rerouted)
    assert fleet.host(victim).state is HostState.DOWN
    fleet.close()


def test_kill_host_nonreplayable_source_fails_clean(sample):
    """An IterableSource cannot be re-submitted: its handle raises
    HostDown instead of silently returning a partial report."""
    cfg = _config(backend="reference")
    reg = _registry(sample, cfg)
    fleet = FleetController(reg, hosts=2)
    fleet.add_tenant("acme", "food", max_active=2, max_queue=16)
    stream = IterableSource(
        iter([(sample.tokens[:16], sample.lengths[:16])]))
    h = fleet.submit(stream, tenant="acme")
    fleet.kill_host(h.host)
    with pytest.raises(HostDown, match="not replayable"):
        h.result(timeout=300)
    fleet.close()


# -- acceptance: fleet-wide two-phase swap -----------------------------------

@pytest.mark.parametrize("backend", ["reference", "cuda_fused"])
def test_fleet_swap_two_phase_invariants(sample, extra, repro_seq, backend):
    """No host serves v2 before every host has it pinned; v1 is only
    gc-eligible at the source after every host drained it.  Replication
    copies snapshots: the hosts never launch (or run) the encoder."""
    cfg = _config(backend=backend)
    reg = _registry(sample, cfg)
    fleet = FleetController(reg, hosts=3)
    fleet.add_tenant("acme", "food", max_active=4, max_queue=16)
    srcs = _slices(sample, 4)
    phases = []

    def on_phase(phase):
        phases.append(phase)
        if phase != "prepared":
            return
        for replica in fleet.hosts():
            # prepared: v2 resident + pinned on every mirror...
            assert 2 in replica.registry.versions("food")
            assert replica.registry.pins("food").get(2, 0) >= 1
            # ...but every router still admits against v1
            assert replica.router.serving_version("food") == 1

    with fleet:
        pre = [fleet.submit(s, tenant="acme") for s in srcs[:2]]
        snap2 = reg.apply_delta("food", add=extra)
        fleet.fleet_swap("food", version=snap2.version, on_phase=on_phase)
        for replica in fleet.hosts():
            assert replica.router.serving_version("food") == 2
            assert replica.registry.snapshot("food", 2).db.prototypes \
                is snap2.db.prototypes          # shared, not re-encoded
        post = [fleet.submit(s, tenant="acme") for s in srcs[2:]]
        for h in pre + post:
            h.result(timeout=300)
        # v1 still source-pinned until every host reports drained; a gc
        # sweep right now must refuse it no matter the keep policy
        assert reg.gc("food", keep_last=1).collected == ()
        fleet.wait_retired("food", 1, timeout=300)
    assert phases == ["prepared", "flipped"]
    assert 1 not in reg.pins("food")
    swept = reg.gc("food", keep_last=1)
    assert swept.collected == (("food", 1),)
    for i, h in enumerate(pre):
        assert h.version == 1
        assert h.result(timeout=0).to_dict() == repro_seq(1, 4, i)
    for i, h in enumerate(post, start=2):
        assert h.version == 2
        assert h.result(timeout=0).to_dict() == repro_seq(2, 4, i)
    fleet.close()


# -- replication: resumable across downtime and source gc --------------------

def test_down_host_resyncs_on_revive_past_gcd_versions(sample, extra,
                                                       repro_seq):
    """A host that missed a publish (and whose missed version the source
    then gc'd) revives straight onto the fleet's serving version."""
    cfg = _config(backend="reference")
    reg = _registry(sample, cfg)
    fleet = FleetController(reg, hosts=3)
    fleet.kill_host("host2")        # down before it ever mirrors anything
    fleet.add_tenant("acme", "food", max_active=4, max_queue=16)
    with fleet:
        snap2 = reg.apply_delta("food", add=extra)
        fleet.fleet_swap("food", version=snap2.version)  # 2 live hosts
        fleet.wait_retired("food", 1, timeout=300)
        assert reg.gc("food", keep_last=1).collected == (("food", 1),)
        fleet.revive_host("host2")
        replica = fleet.host("host2")
        assert replica.state is HostState.HEALTHY
        # the mirror chain skips gc'd v1: only v2 was left to pull
        assert replica.registry.versions("food") == (2,)
        assert replica.router.serving_version("food") == 2
        assert replica.lag("food") == 0
        h = replica.submit(_slices(sample, 1)[0], tenant="acme")
        fleet.run_until_idle()
        assert h.result(timeout=300).to_dict() == repro_seq(2, 1, 0)
    fleet.close()


def test_install_is_idempotent_and_checks_fingerprint(sample):
    cfg = _config(backend="reference")
    reg = _registry(sample, cfg)
    mirror = RefDBRegistry(root=None, device="cpu")
    snap = reg.current("food")
    before = hdc_encoder.hdc_encode.launches
    a = mirror.install("food", snap, config=cfg)
    b = mirror.install("food", snap, config=cfg)
    assert a is b                       # idempotent per version
    assert a.db.prototypes is snap.db.prototypes
    assert hdc_encoder.hdc_encode.launches == before
    other = _config(space=HDSpace(dim=256, ngram=5, z_threshold=3.0))
    with pytest.raises(ValueError, match="fingerprint"):
        mirror.install("food", snap, config=other)


# -- fleet observability ------------------------------------------------------

def test_fleet_metrics_snapshot_has_host_labels(sample):
    cfg = _config(backend="reference")
    reg = _registry(sample, cfg)
    fleet = FleetController(reg, hosts=3)
    fleet.add_tenant("acme", "food", max_active=4, max_queue=16)
    with fleet:
        for src in _slices(sample, 3):
            fleet.submit(src, tenant="acme")
        fleet.run_until_idle()
        merged = fleet.metrics_snapshot()
    fleet.close()
    snap = merged.snapshot()
    installs = snap["counters"]["refdb_installs_total"]["series"]
    hosts = {s["labels"]["host"] for s in installs}
    assert hosts == {"host0", "host1", "host2"}   # every mirror synced
    gauges = snap["gauges"]
    assert gauges["fleet_healthy_hosts"]["series"][0]["value"] == 3.0
    lag = {s["labels"]["host"]: s["value"]
           for s in gauges["fleet_replication_lag_versions"]["series"]}
    assert lag == {"host0": 0.0, "host1": 0.0, "host2": 0.0}
    assert "fleet_outstanding_reads" in gauges
    assert snap["counters"]["fleet_requests_total"]["series"]
    # every per-host series carries its host label
    for kind in ("counters", "gauges", "histograms"):
        for name, metric in snap.get(kind, {}).items():
            if name.startswith("fleet_") and name != "fleet_outstanding_reads" \
                    and name != "fleet_replication_lag_versions":
                continue
            for series in metric["series"]:
                assert "host" in series["labels"], (name, series)


def test_serve_fleet_cli_smoke(tmp_path):
    """``serve_fleet --smoke --check`` on the CPU: the auto-picked host
    kill, the fleet swap and every report equal to a sequential run, and
    the metrics JSON with ``host`` labels on the per-host series."""
    import json
    import os
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parent.parent
    out = tmp_path / "fleet.json"
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_fleet", "--smoke",
         "--check", "--device", "cpu", "--backend", "cuda_fused",
         "--metrics-json", str(out)],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "check OK: all 12 reports bit-identical" in proc.stdout
    assert "killed host" in proc.stdout and "fleet swap v1 -> v2" in proc.stdout
    doc = json.loads(out.read_text())
    assert doc["hosts"] == 3 and doc["schema"] == 1
    installs = doc["metrics"]["counters"]["refdb_installs_total"]["series"]
    assert {s["labels"]["host"] for s in installs} == {"host0", "host1",
                                                       "host2"}
    assert "fleet_healthy_hosts" in doc["metrics"]["gauges"]
