"""The port's observability layer against ``repro.obs``, on the CPU.

The metrics and trace cases of ``tests/test_obs.py`` that do not involve
the fleet (``pcm_sim`` with device noise among them), on the port; the
same Prometheus text and JSON
snapshot as ``repro``'s for the same recorded samples; the same metric
names, kinds, help, buckets and label keys from the same serving traffic;
metrics on and off give equal reports and equal kernel launch counts; and
the opt-in ``torch_trace``.  ``repro`` is imported inside the cases that
hold the port against it, so the ``-m cuda`` case collects on a machine
without JAX.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs
from repro_torch.core.assoc_memory import build_refdb
from repro_torch.core.hd_space import HDSpace
from repro_torch.genomics import synth
from repro_torch.kernels import fused_profile, hdc_encoder
from repro_torch.pipeline import (ArraySource, ProfilerConfig,
                                  ProfilingSession, SyntheticSource)
from repro_torch.serve import (ProfilingService, RefDBRegistry,
                               ServiceOverloaded, TenantRouter)

SPACE = dict(dim=512, ngram=8, z_threshold=3.0)
SP = HDSpace(**SPACE)
SPEC = synth.CommunitySpec(num_species=4, genome_len=6_000, seed=11)


def _jax_mode() -> bool:
    """The installed jax's threefry mode (``repro`` draws its item memory
    in it, so the port's parity cases take it too); True without jax."""
    try:
        import jax
    except ImportError:
        return True
    return bool(jax.config.jax_threefry_partitionable)


def _config(**kw):
    kw.setdefault("space", SP)
    kw.setdefault("threefry_partitionable", _jax_mode())
    kw.setdefault("window", 1024)
    kw.setdefault("batch_size", 16)
    return ProfilerConfig(**kw)


@pytest.fixture(scope="module")
def sample():
    return SyntheticSource(SPEC, num_reads=96, present=[0, 2])


@pytest.fixture(scope="module")
def refdb(sample):
    return build_refdb(sample.genomes, SP, window=1024, device="cpu",
                       partitionable=_jax_mode())


@pytest.fixture(scope="module")
def extra():
    rng = np.random.default_rng(99)
    return {"sp_new": rng.integers(0, 4, 6_000, dtype=np.int32)}


def _slices(sample, n):
    return [ArraySource(sample.tokens[i::n], sample.lengths[i::n])
            for i in range(n)]


def _session(refdb, backend="reference", **kw):
    s = ProfilingSession(_config(backend=backend), device="cpu", **kw)
    s.adopt_refdb(refdb)
    return s


# -- histogram bucket + percentile math --------------------------------------

def test_histogram_boundaries_and_overflow():
    state = obs.HistogramState((1.0, 2.0, 4.0))
    for v in (0.5, 1.0, 2.0, 4.0, 5.0):     # bounds inclusive (le)
        state.observe(v)
    assert state.counts == [2, 1, 1, 1]     # last slot = overflow
    assert state.count == 5
    assert state.sum == pytest.approx(12.5)
    assert state.percentile(100) == 4.0


def test_histogram_percentile_interpolates_within_bucket():
    state = obs.HistogramState((10.0,))
    state.observe(3.0)                      # one sample, bucket [0, 10]
    assert state.percentile(50) == pytest.approx(5.0)
    state = obs.HistogramState((1.0, 2.0))
    for _ in range(2):
        state.observe(1.5)
    for _ in range(2):
        state.observe(0.5)
    assert state.percentile(50) == pytest.approx(1.0)
    assert state.percentile(100) == pytest.approx(2.0)


def test_histogram_empty_and_bad_args():
    state = obs.HistogramState((1.0,))
    assert math.isnan(state.percentile(50))
    assert math.isnan(state.mean)
    with pytest.raises(ValueError):
        state.percentile(101)
    with pytest.raises(ValueError):
        obs.HistogramState(())
    with pytest.raises(ValueError):
        obs.HistogramState((2.0, 1.0))      # not ascending


def test_histogram_merge():
    a = obs.HistogramState((1.0, 2.0))
    b = obs.HistogramState((1.0, 2.0))
    a.observe(0.5)
    b.observe(1.5)
    b.observe(9.0)
    a.merge(b)
    assert a.counts == [1, 1, 1]
    assert a.count == 3
    assert a.sum == pytest.approx(11.0)
    with pytest.raises(ValueError):
        a.merge(obs.HistogramState((1.0,)))


def test_registry_merge_from_and_merged():
    a = obs.MetricsRegistry()
    b = obs.MetricsRegistry()
    a.counter("reads_total").inc(3, tenant="acme")
    b.counter("reads_total").inc(2, tenant="acme")
    a.histogram("lat_seconds", buckets=(0.1, 1.0)).observe(0.05)
    b.histogram("lat_seconds", buckets=(0.1, 1.0)).observe(5.0)
    b.gauge("queue_depth").set(7)

    fleet = obs.MetricsRegistry.merged({"h0": a, "h1": b})
    snap = fleet.snapshot()
    reads = {s["labels"]["host"]: s["value"]
             for s in snap["counters"]["reads_total"]["series"]}
    assert reads == {"h0": 3.0, "h1": 2.0}
    assert all(s["labels"]["tenant"] == "acme"
               for s in snap["counters"]["reads_total"]["series"])
    hosts = {s["labels"]["host"]
             for s in snap["histograms"]["lat_seconds"]["series"]}
    assert hosts == {"h0", "h1"}
    [g] = snap["gauges"]["queue_depth"]["series"]
    assert g["labels"] == {"host": "h1"} and g["value"] == 7.0

    total = obs.MetricsRegistry()
    total.merge_from(a)
    total.merge_from(b)
    snap2 = total.snapshot()
    assert snap2["counters"]["reads_total"]["series"][0]["value"] == 5.0
    [h] = snap2["histograms"]["lat_seconds"]["series"]
    assert h["counts"] == [1, 0, 1]


def test_registry_get_or_create_and_kind_conflicts():
    reg = obs.MetricsRegistry()
    h = reg.histogram("x_seconds", buckets=(1.0, 2.0))
    assert reg.histogram("x_seconds", buckets=(1.0, 2.0)) is h
    with pytest.raises(ValueError, match="different buckets"):
        reg.histogram("x_seconds", buckets=(1.0,))
    reg.counter("x_total")
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("x_total")
    with pytest.raises(ValueError):
        reg.counter("x_total").inc(-1)      # counters only go up


def test_snapshot_and_prometheus_exposition():
    reg = obs.MetricsRegistry()
    reg.counter("reads_total").inc(3, tenant="acme")
    lat = reg.histogram("lat_seconds", buckets=(0.1, 1.0))
    lat.observe(0.05, backend="reference")
    lat.observe(5.0, backend="reference")
    snap = reg.snapshot()
    assert snap["counters"]["reads_total"]["series"][0] == {
        "labels": {"tenant": "acme"}, "value": 3.0}
    [series] = snap["histograms"]["lat_seconds"]["series"]
    assert series["labels"] == {"backend": "reference"}
    assert series["counts"] == [1, 0, 1]
    assert series["p50"] is not None
    text = reg.to_prometheus()
    assert 'reads_total{tenant="acme"} 3' in text
    assert 'lat_seconds_bucket{backend="reference",le="+Inf"} 2' in text
    assert 'lat_seconds_count{backend="reference"} 2' in text


def _record(mod):
    """The same samples into a fresh registry of ``repro.obs`` or the
    port's ``obs``: every instrument kind, default and custom buckets,
    label escaping, overflow and an empty series."""
    reg = mod.MetricsRegistry()
    reg.counter("serve_reads_classified_total", "Reads classified.").inc(
        48, tenant="acme", database="food")
    reg.counter("odd_total", 'help with "quotes"').inc(
        2.5, label='a"b\\c\nd')
    reg.gauge("serve_queue_depth", "Queue.").set(3, tenant="acme")
    reg.gauge("serve_queue_depth").dec(1, tenant="acme")
    lat = reg.histogram("serve_batch_seconds", "Cohort time.", unit="s")
    for v in (0.0001, 0.0003, 0.004, 0.2, 150.0):
        lat.observe(v, backend="cuda_fused")
    fill = reg.histogram("serve_cohort_fill_ratio", "Fill.",
                         buckets=mod.RATIO_BUCKETS)
    for v in (0.05, 0.5, 1.0):
        fill.observe(v)
    reg.histogram("never_seconds", "Empty.", buckets=(0.5, 1.5))
    reg.histogram("custom", buckets=mod.exponential_buckets(1, 2, 4)) \
        .observe(3)
    return reg


def test_prometheus_text_and_snapshot_equal_repros():
    from repro import obs as jax_obs

    mine, theirs = _record(obs), _record(jax_obs)
    assert mine.to_prometheus() == theirs.to_prometheus()
    assert mine.to_json() == theirs.to_json()
    assert obs.TIME_BUCKETS_S == jax_obs.TIME_BUCKETS_S
    assert obs.RATIO_BUCKETS == jax_obs.RATIO_BUCKETS
    assert obs.linear_buckets(0, 0.5, 3) == jax_obs.linear_buckets(0, 0.5, 3)


def test_null_registry_is_inert():
    null = obs.NULL_METRICS
    assert not null.enabled
    c = null.counter("whatever_total")
    c.inc(5)
    assert c.value() == 0.0 and not c.enabled
    null.histogram("h").observe(1.0)
    assert math.isnan(null.histogram("h").percentile(50))
    assert null.instruments() == ()


def test_globals_enable_and_disable():
    assert not obs.metrics().enabled and not obs.tracer().enabled
    reg = obs.enable_metrics()
    rec = obs.enable_tracing(sample=3)
    try:
        assert obs.resolve_metrics(None) is reg
        assert obs.resolve_tracer(None) is rec
        own = obs.MetricsRegistry()
        assert obs.resolve_metrics(own) is own
    finally:
        obs.disable()
    assert obs.metrics() is obs.NULL_METRICS
    assert obs.tracer() is obs.NULL_TRACER


# -- trace assembly -----------------------------------------------------------

def _timeline(*marks):
    tl = obs.RequestTimeline()
    for name, t in marks:
        tl.mark(name, at=t)
    return tl


def test_trace_children_tile_root_exactly():
    tl = _timeline(("submitted", 1.0), ("started", 1.5),
                   ("first_execute", 2.0), ("accumulate", 3.0),
                   ("finalize", 3.25), ("finished", 4.0))
    trace = obs.assemble_trace("r-0", tl, state="done")
    assert [s.name for s in trace.spans] == [
        "request", "admission", "schedule", "execute", "accumulate",
        "finalize"]
    children = trace.spans[1:]
    assert sum(s.duration_s for s in children) == trace.duration_s == 3.0
    assert all(s.parent_id == 0 for s in children)
    assert trace.span("schedule").duration_s == pytest.approx(0.5)


def test_trace_of_request_cancelled_while_queued():
    tl = _timeline(("submitted", 1.0), ("finished", 2.0))
    trace = obs.assemble_trace("r-1", tl, state="cancelled")
    assert trace.state == "cancelled"
    assert [s.name for s in trace.spans] == ["request", "admission"]
    assert trace.duration_s == pytest.approx(1.0)


def test_trace_stops_at_last_phase_reached():
    tl = _timeline(("submitted", 1.0), ("started", 2.0),
                   ("first_execute", 2.5), ("finished", 3.0))
    trace = obs.assemble_trace("r-2", tl, state="failed")
    assert [s.name for s in trace.spans] == [
        "request", "admission", "schedule", "execute"]
    assert sum(s.duration_s for s in trace.spans[1:]) == trace.duration_s


def test_timeline_first_wins_except_accumulate():
    tl = _timeline(("submitted", 1.0), ("submitted", 9.0),
                   ("accumulate", 2.0), ("accumulate", 3.0))
    assert tl.at("submitted") == 1.0
    assert tl.at("accumulate") == 3.0       # latest cohort demux
    with pytest.raises(ValueError, match="unknown timeline mark"):
        tl.mark("warp")
    with pytest.raises(ValueError, match="no marks"):
        obs.assemble_trace("r-3", obs.RequestTimeline())


def test_trace_recorder_keeps_first_n():
    rec = obs.TraceRecorder(sample=2)
    for i in range(4):
        tl = _timeline(("submitted", float(i)), ("finished", i + 1.0))
        rec.record(f"r-{i}", tl)
    assert rec.full
    assert [t.trace_id for t in rec.traces()] == ["r-0", "r-1"]
    null = obs.NULL_TRACER
    assert null.record("r", _timeline(("submitted", 0.0))) is None
    assert null.traces() == () and not null.enabled


def test_trace_dicts_equal_repros():
    from repro import obs as jax_obs

    marks = (("submitted", 1.0), ("started", 1.5), ("first_execute", 2.0),
             ("accumulate", 3.0), ("finished", 4.0))
    mine = obs.assemble_trace("r", _timeline(*marks)).to_dict()
    tl = jax_obs.RequestTimeline()
    for name, t in marks:
        tl.mark(name, at=t)
    theirs = jax_obs.assemble_trace("r", tl).to_dict()
    for t in (mine, theirs):                # anchored on each wall clock
        for s in t["spans"]:
            s.pop("start_unix")
    assert mine == theirs


# -- bit-exactness: metrics on == metrics off --------------------------------

@pytest.mark.parametrize("backend", ["reference", "cuda_fused",
                                     "cuda_packed"])
def test_metrics_do_not_perturb_results(sample, refdb, backend):
    off = _session(refdb, backend)
    reg = obs.MetricsRegistry()
    on = _session(refdb, backend, metrics=reg)
    src = _slices(sample, 1)[0]
    assert on.profile(src).to_json() == off.profile(src).to_json()
    assert reg.counter("session_classify_batches_total").total() > 0
    assert reg.histogram("session_classify_batch_seconds").merged().count > 0
    path = "encode_classify" if backend != "cuda_fused" \
        else "tokens_agreement"
    assert reg.counter("session_classify_batches_total").value(
        backend=backend, path=path) == -(-len(src.tokens) // 16)
    assert reg.counter("session_host_transfers_total").value(
        backend=backend) == 2 * -(-len(src.tokens) // 16)


def test_pcm_sim_metrics_bit_exact_with_device_noise(sample, refdb):
    """The stats read (ADC clips counted) gives the same result as the
    plain read, with device noise on, and the device metrics are set
    under repro's names."""
    cfg = _config(backend="pcm_sim",
                  backend_options={"preset": "pcm", "seed": 3})
    src = _slices(sample, 1)[0]
    off = ProfilingSession(cfg, device="cpu")
    off.adopt_refdb(refdb)
    rep_off = off.profile(src).to_json()
    reg = obs.enable_metrics()              # backends resolve the global
    try:
        on = ProfilingSession(cfg, device="cpu")
        on.adopt_refdb(refdb)
        rep_on = on.profile(src).to_json()
    finally:
        obs.disable()
    assert rep_on == rep_off
    assert reg.counter("pcm_program_events_total").total() >= 1
    assert reg.counter("pcm_reads_total").total() == -(-len(src.tokens)
                                                       // 16)
    assert reg.counter("pcm_adc_clips_total").total() >= 0
    stuck = reg.gauge("pcm_stuck_cells")
    assert len(stuck.labelsets()) == 4      # {pos,neg} x {on,off}
    assert all(stuck.value(**ls) > 0 for ls in stuck.labelsets())


def _service_run(sample, refdb, backend, metrics):
    s = _session(refdb, backend, metrics=metrics)
    service = ProfilingService(s, max_active=4, metrics=metrics,
                               buckets=(64, 256))
    hs = [service.submit(x) for x in _slices(sample, 4)]
    service.run_until_idle()
    return [h.result(timeout=0).to_dict() for h in hs]


def _counts():
    return (hdc_encoder.hdc_encode.launches,
            fused_profile.fused_profile.launches)


def test_service_metrics_on_equals_off_with_equal_launches(sample, refdb):
    """Reports and kernel launch counts do not depend on metrics (on the
    CPU the wrappers run their plain versions and count no launch)."""
    before = _counts()
    off = _service_run(sample, refdb, "cuda_fused", None)
    mid = _counts()
    reg = obs.MetricsRegistry()
    on = _service_run(sample, refdb, "cuda_fused", reg)
    after = _counts()
    assert on == off
    assert [m - b for m, b in zip(mid, before)] == \
        [a - m for a, m in zip(after, mid)]
    assert reg.counter("serve_reads_classified_total").total() == \
        sum(r["total_reads"] for r in on)


@pytest.mark.cuda
def test_service_metrics_on_equals_off_on_the_card(sample):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    db = build_refdb(sample.genomes, SP, window=1024, device="cuda")
    runs = []
    for metrics in (None, obs.MetricsRegistry()):
        s = ProfilingSession(_config(backend="cuda_fused"), device="cuda",
                             metrics=metrics)
        s.adopt_refdb(db)
        service = ProfilingService(s, max_active=4, metrics=metrics,
                                   buckets=(64, 256))
        torch.cuda.synchronize()
        fused_profile.fused_profile.launches = 0
        hs = [service.submit(x) for x in _slices(sample, 4)]
        service.run_until_idle()
        torch.cuda.synchronize()
        runs.append(([h.result(timeout=0).to_dict() for h in hs],
                     fused_profile.fused_profile.launches))
    assert runs[0] == runs[1]
    assert runs[0][1] > 0


# -- the same instruments as repro from the same traffic ----------------------

def _schema(reg):
    out = {}
    for inst in reg.instruments():
        keys = {tuple(sorted(ls)) for ls in inst.labelsets()}
        out[inst.name] = (inst.kind, inst.help, inst.unit,
                          getattr(inst, "buckets", None), keys)
    return out


def test_metric_names_labels_and_buckets_match_repro(tmp_path, sample,
                                                     extra):
    """One registry create + delta, a router with two tenants and one
    quota rejection, and a service: both packages register the same
    instruments with the same kinds, help, units, buckets and label
    keys."""
    from repro import obs as jax_obs
    from repro.core.hd_space import HDSpace as JaxSpace
    from repro.pipeline import ArraySource as JaxArraySource
    from repro.pipeline import ProfilerConfig as JaxConfig
    from repro.serve import RefDBRegistry as JaxRegistry
    from repro.serve import TenantRouter as JaxRouter

    def drive(mod_obs, Registry, Router, Config, Space, Source, root, kw):
        reg = mod_obs.MetricsRegistry()
        registry = Registry(root=root, metrics=reg, **kw)
        cfg = Config(space=Space(**SPACE), window=1024, batch_size=16)
        registry.create("food", sample.genomes, cfg)
        router = Router(registry, metrics=reg)
        router.add_tenant("acme", database="food", max_active=2,
                          max_queue=0)
        router.add_tenant("tiny", database="food", max_active=1,
                          max_queue=0)
        srcs = [Source(sample.tokens[i::4], sample.lengths[i::4])
                for i in range(4)]
        hs = [router.submit(s, tenant="acme") for s in srcs[:2]]
        router.submit(srcs[2], tenant="tiny")
        with pytest.raises(Exception, match="quota full"):
            router.submit(srcs[3], tenant="tiny")
        registry.apply_delta("food", add=extra)
        router.run_until_idle()
        for h in hs:
            h.result(timeout=300)
        router.step()
        registry.gc("food", keep_last=1)
        router.close()
        return _schema(reg)

    mine = drive(obs, RefDBRegistry, TenantRouter, ProfilerConfig, HDSpace,
                 ArraySource, tmp_path / "port", {"device": "cpu"})
    theirs = drive(jax_obs, JaxRegistry, JaxRouter, JaxConfig, JaxSpace,
                   JaxArraySource, tmp_path / "repro", {})
    assert mine == theirs
    assert {"serve_reads_classified_total", "serve_cohort_padding_rows_total",
            "session_classify_batches_total", "router_hot_swap_seconds",
            "refdb_build_seconds"} <= set(mine)


def test_service_instruments_match_repro(sample, refdb):
    from repro import obs as jax_obs
    from repro.core.assoc_memory import build_refdb as jax_build
    from repro.core.hd_space import HDSpace as JaxSpace
    from repro.pipeline import ArraySource as JaxArraySource
    from repro.pipeline import ProfilerConfig as JaxConfig
    from repro.pipeline import ProfilingSession as JaxSession
    from repro.serve import ProfilingService as JaxService

    jreg = jax_obs.MetricsRegistry()
    js = JaxSession(JaxConfig(space=JaxSpace(**SPACE), window=1024,
                              batch_size=16), metrics=jreg)
    js.adopt_refdb(jax_build(sample.genomes, JaxSpace(**SPACE),
                             window=1024))
    jservice = JaxService(js, max_active=4, metrics=jreg,
                          obs_labels={"tenant": "t"})
    hs = [jservice.submit(JaxArraySource(sample.tokens[i::4],
                                         sample.lengths[i::4]))
          for i in range(4)]
    jservice.run_until_idle()
    want = [h.result(timeout=0).to_dict() for h in hs]

    reg = obs.MetricsRegistry()
    service = ProfilingService(_session(refdb, metrics=reg), max_active=4,
                               metrics=reg, obs_labels={"tenant": "t"})
    hs = [service.submit(x) for x in _slices(sample, 4)]
    service.run_until_idle()
    assert [h.result(timeout=0).to_dict() for h in hs] == want
    assert _schema(reg) == _schema(jreg)
    for name in ("serve_reads_classified_total",
                 "serve_cohort_padding_rows_total",
                 "session_host_transfers_total"):
        assert reg.counter(name).total() == jreg.counter(name).total()


# -- service + router end to end ---------------------------------------------

def test_service_metrics_and_traces_end_to_end(sample, refdb):
    session = _session(refdb)
    reg = obs.MetricsRegistry()
    rec = obs.TraceRecorder(sample=8)
    service = ProfilingService(session, max_active=2, max_queue=8,
                               metrics=reg, tracer=rec)
    srcs = _slices(sample, 4)
    handles = [service.submit(s) for s in srcs]
    service.run_until_idle()
    reads = sum(h.result(timeout=0).total_reads for h in handles)

    assert reg.counter("serve_requests_total").value(state="done") == 4
    assert reg.counter("serve_reads_classified_total").total() == reads
    assert reg.histogram("serve_admission_wait_seconds").merged().count == 4
    assert reg.histogram("serve_batch_seconds").merged().count > 0
    fill = reg.histogram("serve_cohort_fill_ratio",
                         buckets=obs.RATIO_BUCKETS).merged()
    assert fill.count > 0 and fill.sum <= fill.count
    assert reg.gauge("serve_queue_depth").value() == 0
    assert reg.gauge("serve_active_requests").value() == 0

    traces = rec.traces()
    assert len(traces) == 4
    for trace in traces:
        assert trace.state == "done"
        assert sum(s.duration_s for s in trace.spans[1:]) \
            == pytest.approx(trace.duration_s)
    by_id = {t.trace_id: t for t in traces}
    for h in handles:
        assert by_id[h.request_id].duration_s \
            == pytest.approx(h.latency_s)
        assert h.queue_wait_s + h.service_s == pytest.approx(h.latency_s)


def test_cancelled_and_failed_requests_still_trace(sample, refdb):
    session = _session(refdb)
    reg = obs.MetricsRegistry()
    rec = obs.TraceRecorder(sample=8)
    service = ProfilingService(session, max_active=1, max_queue=8,
                               metrics=reg, tracer=rec)
    srcs = _slices(sample, 3)
    h_done = service.submit(srcs[0])
    service.run_until_idle()
    h_done.result(timeout=0)
    h_cancel = service.submit(srcs[1])
    assert h_cancel.cancel()                # still queued: cancellable
    h_fail = service.submit(srcs[2])
    service.fail_all(RuntimeError("injected"))
    service.run_until_idle()
    states = {t.trace_id: t.state for t in rec.traces()}
    assert states[h_cancel.request_id] == "cancelled"
    assert states[h_fail.request_id] == "failed"
    for h in (h_cancel, h_fail):
        trace = [t for t in rec.traces()
                 if t.trace_id == h.request_id][0]
        assert [s.name for s in trace.spans] == ["request", "admission"]
    assert reg.counter("serve_requests_total").value(state="cancelled") == 1
    assert reg.counter("serve_requests_total").value(state="failed") == 1


def test_router_and_registry_metrics_touchpoints(tmp_path, sample, extra):
    reg = obs.MetricsRegistry()
    registry = RefDBRegistry(root=tmp_path / "r", metrics=reg, device="cpu")
    registry.create("food", sample.genomes, _config(backend="cuda_fused"))
    router = TenantRouter(registry, metrics=reg)
    router.add_tenant("acme", database="food", max_active=2, max_queue=0)
    router.add_tenant("tiny", database="food", max_active=1, max_queue=0)

    srcs = _slices(sample, 4)
    handles = [router.submit(s, tenant="acme") for s in srcs[:2]]
    router.submit(srcs[2], tenant="tiny")
    with pytest.raises(ServiceOverloaded):
        router.submit(srcs[3], tenant="tiny")
    registry.apply_delta("food", add=extra)         # auto hot-swap
    router.run_until_idle()
    reads = sum(h.result(timeout=300).total_reads for h in handles)
    router.step()                                   # final prune pass
    router.close()

    assert reg.counter("router_requests_total").value(tenant="acme") == 2
    assert reg.counter("router_quota_rejections_total") \
              .value(tenant="tiny") == 1
    assert reg.counter("router_reads_completed_total") \
              .value(tenant="acme") == reads
    assert reg.gauge("router_serving_version").value(database="food") == 2
    assert reg.histogram("router_hot_swap_seconds").merged().count == 1
    assert reg.histogram("router_drain_seconds").merged().count == 1
    assert reg.counter("refdb_publishes_total").value(database="food") == 2
    assert reg.gauge("refdb_current_version").value(database="food") == 2
    builds = reg.histogram("refdb_build_seconds")
    assert builds.count(database="food", kind="create") == 1
    assert builds.count(database="food", kind="delta") == 1


# -- registry garbage collection ---------------------------------------------

def _three_versions(tmp_path, sample, extra, metrics=None):
    registry = RefDBRegistry(root=tmp_path / "r", metrics=metrics,
                             device="cpu")
    registry.create("food", sample.genomes, _config())
    registry.apply_delta("food", add=extra)
    registry.apply_delta("food", remove=["sp_new"])
    assert registry.versions("food") == (1, 2, 3)
    return registry


def test_gc_keep_last_and_reclaimed_bytes(tmp_path, sample, extra):
    reg = obs.MetricsRegistry()
    registry = _three_versions(tmp_path, sample, extra, metrics=reg)
    result = registry.gc("food", keep_last=1)
    assert result.collected == (("food", 1), ("food", 2))
    assert result.reclaimed_bytes > 0
    assert registry.versions("food") == (3,)
    assert not list((tmp_path / "r" / "food").glob("v0001.npz"))
    assert reg.counter("refdb_gc_versions_total").total() == 2
    assert reg.counter("refdb_gc_reclaimed_bytes_total").total() \
        == result.reclaimed_bytes
    assert registry.gc("food", keep_last=1).collected == ()
    with pytest.raises(ValueError):
        registry.gc("food", keep_last=0)


def test_gc_refuses_pinned_versions(tmp_path, sample, extra):
    registry = _three_versions(tmp_path, sample, extra)
    registry.pin("food", 1)
    result = registry.gc("food", keep_last=1)
    assert result.collected == (("food", 2),)       # v1 pinned, v3 current
    assert registry.versions("food") == (1, 3)
    registry.release("food", 1)
    assert registry.gc("food", keep_last=1).collected == (("food", 1),)
    with pytest.raises(KeyError):
        registry.pin("food", 99)


def test_gc_max_age_is_a_further_filter(tmp_path, sample, extra):
    registry = _three_versions(tmp_path, sample, extra)
    assert registry.gc("food", keep_last=1,
                       max_age_s=3600).collected == ()
    assert registry.versions("food") == (1, 2, 3)
    assert registry.gc("food", keep_last=1,
                       max_age_s=0).collected == (("food", 1), ("food", 2))


def test_gc_never_collects_what_a_live_router_serves(tmp_path, sample,
                                                     extra):
    registry = RefDBRegistry(root=tmp_path / "r", device="cpu")
    registry.create("food", sample.genomes, _config(backend="reference"))
    router = TenantRouter(registry)
    router.add_tenant("acme", database="food")
    assert registry.pins("food") == {1: 1}          # served -> pinned
    srcs = _slices(sample, 2)
    h = router.submit(srcs[0], tenant="acme")
    registry.apply_delta("food", add=extra)         # swap; v1 drains
    assert registry.gc("food", keep_last=1).collected == ()
    router.run_until_idle()
    h.result(timeout=300)
    router.step()                                   # retire drained v1
    assert registry.pins("food") == {2: 1}
    assert registry.gc("food", keep_last=1).collected == (("food", 1),)
    router.close()


# -- the opt-in torch.profiler capture ----------------------------------------

def test_torch_trace_is_a_no_op_without_a_directory(tmp_path):
    with obs.torch_trace(None):
        x = torch.ones(3).sum()
    assert float(x) == 3.0
    assert list(tmp_path.iterdir()) == []


def test_torch_trace_writes_a_chrome_trace(tmp_path, sample, refdb):
    with obs.torch_trace(tmp_path / "prof"):
        _session(refdb, "cuda_fused").profile(_slices(sample, 4)[0])
    trace = tmp_path / "prof" / "trace.json"
    assert trace.exists() and trace.stat().st_size > 0
