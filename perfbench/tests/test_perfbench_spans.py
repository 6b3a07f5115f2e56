"""The readers of the program's own spans (``perfbench/spans.py`` and the
three metrics that read it) on a hand-made trace: every number checked by
hand, a species-max kernel the kernel-name reader does not know, an idle
gap under nested spans that counts once, and the source's thread."""

import json

import pytest

from perfbench import paths, spans, trace

NEW = ("species_max_span_ms_per_kread", "profile_host_idle_ms_per_batch",
       "refdb_window_s")


def _x(cat, name, ts, dur, tid=7, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": args}


def _span(name, ts, dur, tid=7):
    """A span as the program records it: an operator range over host
    work alone, else an annotation."""
    host = ("profile.next_batch", "profile.accumulate", "source.batch")
    cat = "cpu_op" if name in host else "user_annotation"
    return _x(cat, "repro_torch." + name, ts, dur, tid=tid)


def _launch(ts, corr, tid=7):
    return _x("cuda_runtime", "cudaLaunchKernel", ts, 5, tid=tid,
              correlation=corr)


# Times in microseconds.  Two batches; the device is busy 2000-6700.
EVENTS = [
    _x("user_annotation", trace.WINDOW, 1000, 10000),
    _span("profile", 1050, 9900),
    # batch 1
    _x("user_annotation", trace.call_name(4096, 150, 4096 * 135, 4096),
       1090, 2920),
    _span("classify_batch", 1100, 2900),
    _span("to_device", 1100, 100),
    _span("tokens_agreement", 1200, 2700),
    _span("species_scores", 1500, 200),
    _span("threshold", 1700, 100),
    _launch(1300, 1),
    _launch(1550, 2),
    _launch(1600, 3),
    _launch(1750, 4),
    _span("profile.d2h", 4000, 2800),
    _span("profile.accumulate", 6800, 700),
    _span("profile.next_batch", 7500, 500),
    # batch 2: no kernels
    _x("user_annotation", trace.call_name(4096, 150, 904 * 135, 904),
       7990, 420),
    _span("classify_batch", 8000, 400),
    _span("to_device", 8000, 100),
    _span("profile.d2h", 8400, 100),
    _span("profile.finalize", 8500, 2400),
    # the source's thread: its spans are not the main thread's idle and
    # hold no species max
    _span("source.batch", 1550, 750, tid=8),
    _launch(1600, 5, tid=8),
    _span("source.batch", 7600, 500, tid=8),
    # device work
    _x("kernel", "void fused_profile_kernel<1, 2>(int const*)", 2000, 2000,
       correlation=1),
    _x("kernel", "void at::native::_scatter_gather_elementwise_kernel"
       "<128, 8>(int)", 4000, 2000, correlation=2),
    _x("kernel", "segment_max_kernel", 6000, 500, correlation=3),
    _x("kernel", "elementwise_kernel", 6500, 100, correlation=4),
    _x("gpu_memcpy", "Memcpy DtoH", 6600, 100),
    _x("kernel", "other_thread_kernel", 6650, 50, correlation=5),
]


def _write(tmp_path, events):
    p = tmp_path / "trace.json"
    p.write_text(json.dumps({"traceEvents": events}))
    return p


@pytest.fixture
def ctx(tmp_path, monkeypatch):
    monkeypatch.setattr(paths, "cache_dir", lambda: tmp_path)
    p = _write(tmp_path, EVENTS)
    return {"trace": trace.read(str(p))}


def test_gaps_of_the_hand_made_trace(ctx):
    assert ctx["trace"].gaps() == [(pytest.approx(0.001),
                                    pytest.approx(0.002)),
                                   (pytest.approx(0.0067),
                                    pytest.approx(0.011))]


def test_species_max_reads_every_kernel_under_its_span(ctx):
    """The scatter (2.0 ms) and a kernel of another name (0.5 ms), over
    5,000 reads; not the threshold's kernel, not another thread's."""
    got = paths.metric("species_max_span_ms_per_kread").read(ctx)
    assert got == pytest.approx(2.5 / 5.0)
    # the kernel-name reader sees the scatter alone
    assert paths.metric("species_max_ms_per_kread").read(ctx) == \
        pytest.approx(2.0 / 5.0)


def test_host_idle_counts_each_idle_instant_once(ctx):
    """Gap 1.0-2.0 ms: under classify_batch from 1.1 ms, to_device 0.1
    and tokens_agreement 0.5 innermost, not species_scores' 0.2 and
    threshold's 0.1 nested in it (the classifier's), and not their sum.
    Gap 6.7-11.0 ms: d2h 0.1, accumulate 0.7, next_batch 0.5, batch 2 0.4,
    d2h 0.1, finalize 2.4 (the bare profile and the stretch's last 0.05
    ms are not the session's).  4.8 ms over 2 batches."""
    got = paths.metric("profile_host_idle_ms_per_batch").read(ctx)
    assert got == pytest.approx(4.8 / 2)


def test_idle_split_by_innermost_span(ctx):
    sp = spans.load(ctx)
    assert spans.load(ctx) is sp    # one parse for all the readers
    split = sp.idle_by_span(ctx["trace"].gaps())
    want = {"(no span)": 100, "repro_torch.profile": 100,
            "repro_torch.to_device": 200,
            "repro_torch.tokens_agreement": 500,
            "repro_torch.species_scores": 200, "repro_torch.threshold": 100,
            "repro_torch.profile.d2h": 200,
            "repro_torch.profile.accumulate": 700,
            "repro_torch.profile.next_batch": 500,
            "repro_torch.classify_batch": 300,
            "repro_torch.profile.finalize": 2400}
    assert split == {k: pytest.approx(v * 1e-6) for k, v in want.items()}
    assert sum(split.values()) == pytest.approx(0.001 + 0.0043)
    assert "repro_torch.source.batch" not in split


def test_summary_of_a_stretch(ctx, tmp_path):
    s = spans.summary(str(tmp_path / "trace.json"))
    assert s["batches"] == 2
    assert s["idle_s"] == pytest.approx(0.0053)
    assert s["idle_share_under_a_span"] == pytest.approx(1 - 0.1 / 5.3)
    assert s["idle_share_under_host_spans"] == pytest.approx(4.8 / 5.3)
    assert s["device_s_by_span"]["repro_torch.species_scores"] == \
        pytest.approx(0.0025)
    assert s["device_s_by_span"]["repro_torch.classify_batch"] == \
        pytest.approx(0.0046)
    assert s["device_s_by_span"]["repro_torch.source.batch"] == \
        pytest.approx(0.00005)
    # the source: 0.75 + 0.5 ms, of which 0.45 (before the first kernel)
    # and 0.5 while the card idles, and 0.4 while the main thread waits
    assert s["source_batch_s"] == pytest.approx(0.00125)
    assert s["source_batch_idle_s"] == pytest.approx(0.00095)
    assert s["source_batch_in_next_batch_s"] == pytest.approx(0.0004)


def test_span_readers_report_nothing_without_the_programs_spans(
        tmp_path, monkeypatch):
    """A program without spans (the parent of the change that added them)
    gives no reading, and no error."""
    monkeypatch.setattr(paths, "cache_dir", lambda: tmp_path)
    p = _write(tmp_path, [e for e in EVENTS
                          if not e["name"].startswith(spans.PREFIX)])
    ctx = {"trace": trace.read(str(p))}
    for name in NEW[:2]:
        assert paths.metric(name).read(ctx) is None
        assert paths.metric(name).read({"trace": None}) is None
    assert spans.summary(str(p))["batches"] == 2


def test_refdb_window_reads_the_build_histogram():
    from repro_torch.obs import MetricsRegistry

    read = paths.metric("refdb_window_s").read
    reg = MetricsRegistry()
    assert read({"registry": None}) is None
    assert read({"registry": reg}) is None
    h = reg.histogram("refdb_build_stage_seconds")
    h.observe(1.0, stage="encode")
    assert read({"registry": reg}) is None
    h.observe(0.25, stage="window")
    h.observe(0.5, stage="window")
    assert read({"registry": reg}) == pytest.approx(0.75)


def test_the_new_metrics_are_listed_for_both_profile_cells():
    bench = paths.benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        m = entries[name]
        assert m["source"] == "program_span"
        assert {"afs31.profile", "afs20.profile"} <= set(m["workloads"])
        assert callable(paths.metric(name).read)
