"""The port's ProfilingService against ``repro``'s, on the CPU.

The cases of ``tests/test_profiler_service.py`` run on the port's
``cuda_fused`` (its kernels' plain torch versions on the CPU) and
``reference`` backends: every served report equals a sequential
``ProfilingSession.profile`` of the same reads, bit for bit.  One parity
case sends the same requests through ``repro``'s service (backend
``reference``) and the port's; their ``to_dict()`` reports are equal.
Plus the launch counter under racing threads and the
``repro_torch.launch.serve_profiler`` CLI in a child process.
"""

import os
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from repro.core.hd_space import HDSpace as JaxSpace
from repro.genomics import synth as jax_synth
from repro.pipeline import ArraySource as JaxArraySource
from repro.pipeline import ProfilerConfig as JaxConfig
from repro.pipeline import ProfilingSession as JaxSession
from repro.serve import ProfilingService as JaxService
from repro_torch.core.hd_space import HDSpace
from repro_torch.genomics import synth
from repro_torch.kernels import _build
from repro_torch.pipeline import (ArraySource, ProfilerConfig,
                                  ProfilingSession, SyntheticSource)
from repro_torch.serve import (ProfileRequest, ProfilingService,
                               RequestState, ServiceOverloaded)

SPACE = dict(dim=512, ngram=8, z_threshold=3.0)
SP = HDSpace(**SPACE)
SPEC = dict(num_species=4, genome_len=6_000, seed=11)
BACKENDS = ("cuda_fused", "reference")
ROOT = pathlib.Path(__file__).resolve().parent.parent


def _config(**kw):
    kw.setdefault("space", SP)
    kw.setdefault("window", 1024)
    kw.setdefault("batch_size", 16)
    return ProfilerConfig(**kw)


@pytest.fixture(scope="module")
def sample():
    return SyntheticSource(synth.CommunitySpec(**SPEC), num_reads=192,
                           present=[0, 2])


@pytest.fixture(scope="module")
def refdb(sample):
    return ProfilingSession(_config(), device="cpu").build_refdb(
        sample.genomes)


def _session(refdb, backend="reference", **kw):
    s = ProfilingSession(_config(backend=backend, **kw), device="cpu")
    s.refdb = refdb          # every backend shares the one database
    return s


def _slices(sample, n):
    """n disjoint read slices, each its own request source."""
    return [ArraySource(sample.tokens[i::n], sample.lengths[i::n])
            for i in range(n)]


# -- concurrent == sequential, bit for bit ---------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_concurrent_requests_match_sequential(sample, refdb, backend):
    session = _session(refdb, backend)
    sources = _slices(sample, 8)
    sequential = [session.profile(src) for src in sources]

    service = ProfilingService(session, max_active=8)
    handles = [service.submit(src) for src in sources]
    service.run_until_idle()
    for h, want in zip(handles, sequential):
        assert h.state is RequestState.DONE
        got = h.result(timeout=0)
        assert got.to_json() == want.to_json()
        np.testing.assert_array_equal(got.abundance, want.abundance)


@pytest.mark.parametrize("backend", BACKENDS)
def test_mixed_read_lengths_bucket_into_shared_cohorts(sample, refdb,
                                                       backend):
    """Requests with different read widths interleave via length buckets
    (cohorts padded to 64 and 256 tokens, zero-length rows past the live
    reads)."""
    session = _session(refdb, backend)
    short = ArraySource(sample.tokens[:40, :64],
                        np.minimum(sample.lengths[:40], 64))
    long = ArraySource(sample.tokens[40:80], sample.lengths[40:80])
    want = [session.profile(short), session.profile(long)]

    service = ProfilingService(session, max_active=2, buckets=(64, 256))
    hs = [service.submit(short), service.submit(long)]
    service.run_until_idle()
    for h, w in zip(hs, want):
        assert h.result(timeout=0).to_json() == w.to_json()


def test_service_matches_repro_service(sample):
    """The same requests through ``repro``'s service (``reference``) and
    the port's (``reference`` and ``cuda_fused``): equal reports."""
    jspec = jax_synth.CommunitySpec(**SPEC)
    jax_sample = jax_synth.make_sample(jspec, num_reads=192, present=[0, 2])
    assert np.array_equal(jax_sample[1], sample.tokens)
    jcfg = JaxConfig(space=JaxSpace(**SPACE), window=1024, batch_size=16)
    js = JaxSession(jcfg)
    js.build_refdb(jax_sample[0])
    jservice = JaxService(js, max_active=8, buckets=(64, 256))
    srcs = [(sample.tokens[i::6, :64 if i % 2 else 150],
             np.minimum(sample.lengths[i::6], 64 if i % 2 else 150))
            for i in range(6)]
    jh = [jservice.submit(JaxArraySource(t, ln)) for t, ln in srcs]
    jservice.run_until_idle()
    want = [h.result(timeout=0).to_dict() for h in jh]
    for backend in BACKENDS:
        s = ProfilingSession(_config(backend=backend), device="cpu")
        s.build_refdb(sample.genomes)
        service = ProfilingService(s, max_active=8, buckets=(64, 256))
        hs = [service.submit(ArraySource(t, ln)) for t, ln in srcs]
        service.run_until_idle()
        assert [h.result(timeout=0).to_dict() for h in hs] == want, backend


# -- lifecycle -------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_streaming_snapshots_grow_to_final(sample, refdb, backend):
    session = _session(refdb, backend)
    src = ArraySource(sample.tokens, sample.lengths)
    service = ProfilingService(session, max_active=1)
    h = service.submit(ProfileRequest(source=src, request_id="stream-me"))
    assert h.request_id == "stream-me"
    assert h.snapshot().total_reads == 0            # queued: empty report

    counts = []
    while service.step():
        counts.append(h.snapshot().total_reads)
    assert counts == sorted(counts)                 # monotone growth
    assert h.state is RequestState.DONE
    final = h.result(timeout=0)
    assert final.total_reads == len(sample.tokens)
    assert final.to_json() == h.snapshot().to_json()


@pytest.mark.parametrize("backend", BACKENDS)
def test_cancellation_mid_stream(sample, refdb, backend):
    session = _session(refdb, backend)
    sources = _slices(sample, 2)
    want = session.profile(sources[0])
    service = ProfilingService(session, max_active=2)
    keep, kill = (service.submit(s) for s in sources)
    service.step()                                  # first cohort only
    assert kill.cancel()
    assert not kill.cancel()                        # idempotent: already dead
    service.run_until_idle()
    assert kill.state is RequestState.CANCELLED
    with pytest.raises(RuntimeError, match="cancelled"):
        kill.result(timeout=0)
    assert keep.result(timeout=0).to_json() == want.to_json()


@pytest.mark.parametrize("backend", BACKENDS)
def test_backpressure_bounds_admission(sample, refdb, backend):
    service = ProfilingService(_session(refdb, backend), max_active=2,
                               max_queue=1)
    srcs = _slices(sample, 4)
    for s in srcs[:3]:                              # 2 active + 1 queued
        service.submit(s)
    with pytest.raises(ServiceOverloaded, match="admission queue full"):
        service.submit(srcs[3])
    with pytest.raises(TimeoutError):
        service.submit(srcs[3], block=True, timeout=0.05)


@pytest.mark.parametrize("backend", BACKENDS)
def test_blocking_submit_admits_once_capacity_frees(sample, refdb, backend):
    service = ProfilingService(_session(refdb, backend), max_active=1,
                               max_queue=0)
    srcs = _slices(sample, 2)
    first = service.submit(srcs[0])
    got = {}

    def late_submit():
        got["h"] = service.submit(srcs[1], block=True, timeout=10)

    t = threading.Thread(target=late_submit)
    t.start()
    service.run_until_idle()                        # finishes first -> slot
    t.join(timeout=10)
    assert not t.is_alive() and "h" in got
    service.run_until_idle()
    assert first.state is got["h"].state is RequestState.DONE


@pytest.mark.parametrize("backend", BACKENDS)
def test_zero_read_request_completes_with_empty_report(sample, refdb,
                                                       backend):
    service = ProfilingService(_session(refdb, backend), max_active=2)
    empty = ArraySource(np.empty((0, 150), np.int32), np.empty(0, np.int32))
    h = service.submit(empty)
    service.run_until_idle()
    rep = h.result(timeout=0)
    assert h.state is RequestState.DONE
    assert rep.total_reads == 0
    assert float(np.sum(rep.abundance)) == 0.0


@pytest.mark.parametrize("backend", BACKENDS)
def test_source_failure_is_isolated(sample, refdb, backend):
    class Boom(ArraySource):
        def batches(self, batch_size):
            yield from super().batches(batch_size)
            raise OSError("disk vanished")

    session = _session(refdb, backend)
    good_src = ArraySource(sample.tokens[:48], sample.lengths[:48])
    want = session.profile(good_src)
    service = ProfilingService(session, max_active=2)
    bad = service.submit(Boom(sample.tokens[48:96], sample.lengths[48:96]))
    good = service.submit(good_src)
    service.run_until_idle()
    assert bad.state is RequestState.FAILED
    with pytest.raises(OSError, match="disk vanished"):
        bad.result(timeout=0)
    assert good.result(timeout=0).to_json() == want.to_json()


@pytest.mark.parametrize("backend", BACKENDS)
def test_background_worker_serves_submissions(sample, refdb, backend):
    session = _session(refdb, backend)
    sources = _slices(sample, 4)
    sequential = [session.profile(s) for s in sources]
    with ProfilingService(session, max_active=2) as service:
        handles = [service.submit(s, block=True, timeout=30)
                   for s in sources]
        reports = [h.result(timeout=60) for h in handles]
    for got, want in zip(reports, sequential):
        assert got.to_json() == want.to_json()


@pytest.mark.parametrize("backend", BACKENDS)
def test_oversize_read_fails_only_its_request(sample, refdb, backend):
    """A read longer than the largest bucket is that tenant's problem."""
    session = _session(refdb, backend)
    good_src = ArraySource(sample.tokens[:48, :60],
                           np.minimum(sample.lengths[:48], 60))
    want = session.profile(good_src)
    service = ProfilingService(session, max_active=2, buckets=(64,))
    giant = service.submit(ArraySource(
        np.zeros((3, 500), np.int32), np.full(3, 500, np.int32)))
    good = service.submit(good_src)
    service.run_until_idle()
    assert giant.state is RequestState.FAILED
    with pytest.raises(ValueError, match="exceeds the largest bucket"):
        giant.result(timeout=0)
    assert good.result(timeout=0).to_json() == want.to_json()


@pytest.mark.parametrize("backend", BACKENDS)
def test_worker_death_fails_live_requests(sample, refdb, backend):
    session = _session(refdb, backend)

    def boom(*a, **kw):
        raise RuntimeError("backend exploded")

    session.classify_batch = boom
    service = ProfilingService(session, max_active=2).start()
    try:
        h = service.submit(ArraySource(sample.tokens[:32],
                                       sample.lengths[:32]))
        with pytest.raises(RuntimeError, match="backend exploded"):
            h.result(timeout=30)
        assert h.state is RequestState.FAILED
        deadline = time.monotonic() + 10
        while service.error is None and time.monotonic() < deadline:
            time.sleep(0.01)
        with pytest.raises(RuntimeError, match="worker died"):
            service.submit(ArraySource(sample.tokens[:8],
                                       sample.lengths[:8]))
    finally:
        service.stop(timeout=5)


def test_failed_kernel_launch_fails_the_cohort_without_a_fallback(
        sample, refdb):
    """A cohort whose fused launch raises fails its requests; the service
    never retries it on another path."""
    session = _session(refdb, "cuda_fused")
    calls = []

    def refused(*a, **kw):
        calls.append(1)
        raise RuntimeError("fused_profile: kernel launch failed")

    session.backend.tokens_agreement = refused
    service = ProfilingService(session, max_active=2)
    hs = [service.submit(s) for s in _slices(sample, 2)]
    with pytest.raises(RuntimeError, match="launch failed"):
        service.step()
    service.fail_all(RuntimeError("fused_profile: kernel launch failed"))
    assert calls == [1]
    for h in hs:
        assert h.state is RequestState.FAILED


@pytest.mark.parametrize("backend", BACKENDS)
def test_submit_request_id_precedence(sample, refdb, backend):
    service = ProfilingService(_session(refdb, backend))
    src = ArraySource(sample.tokens[:8], sample.lengths[:8])
    a = service.submit(ProfileRequest(source=src, request_id="inner"),
                       request_id="outer")
    b = service.submit(ProfileRequest(source=src), request_id="outer")
    c = service.submit(ProfileRequest(source=src))
    assert (a.request_id, b.request_id) == ("inner", "outer")
    assert c.request_id.startswith("req-")
    service.run_until_idle()


@pytest.mark.parametrize("backend", BACKENDS)
def test_service_requires_refdb(backend):
    with pytest.raises(ValueError, match="no RefDB"):
        ProfilingService(ProfilingSession(_config(backend=backend),
                                          device="cpu"))


# -- launch counters under racing pump threads -------------------------------

def test_launch_counter_survives_racing_threads():
    """Pumps launch from several threads; no increment may be lost."""
    def fake():
        pass

    fake.launches = 0
    per, threads = 5_000, 8
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=lambda: [
            _build.count_launch(fake) for _ in range(per)])
            for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert fake.launches == per * threads


# -- the serve_profiler CLI ---------------------------------------------------

@pytest.mark.parametrize("extra", [[], ["--tenants", "2", "--workers", "2"]],
                         ids=["service", "router"])
def test_serve_profiler_smoke_cli(extra):
    """``--smoke`` implies ``--check``: every served report is checked
    against a sequential run, and a mismatch exits non-zero."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_profiler",
         "--smoke", "--device", "cpu", "--backend", "cuda_fused", *extra],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "check OK" in out.stdout
    if extra:
        assert "versions [1, 2]" in out.stdout


def test_serve_profiler_without_a_gpu_is_a_cli_error():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    from repro_torch.launch import serve_profiler

    with pytest.raises(SystemExit) as e:
        serve_profiler.main(["--smoke"])
    assert e.value.code == 2
