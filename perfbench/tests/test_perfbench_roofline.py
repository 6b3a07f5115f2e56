"""The work counts and least times against hand-worked values, and the
trace reader on a hand-made trace."""

import json

import pytest

from perfbench import paths, roofline, trace


def test_peak_rates():
    # 64 x 132 x 1.98e9; 0.471 x 65,536 x 132 x 1.98e9 (PERF.md, chip_smoke)
    assert roofline.INT32_OPS_PER_S == pytest.approx(16.727e12, rel=1e-4)
    assert roofline.B1_OPS_PER_S == pytest.approx(8.0676e15, rel=1e-4)


def test_fused_least_time_at_the_afs20_shapes():
    """chip_smoke's bound at B = 256, L = 150, S = 9,780: 0.0254 ms, by
    the search's operations."""
    grams = 256 * (150 - 16 + 1)
    t = roofline.fused_least_s(256, 150, grams, 9780, 40960)
    assert t == pytest.approx(2 * 256 * 9780 * 40960 / 8.06757e15,
                              rel=1e-4)
    assert t * 1e3 == pytest.approx(0.0254, abs=5e-5)
    # the encode: 34,560 grams x 1,280 words x 3 ops = 7.9 us; bytes 13 us
    enc = grams * 1280 * 3 / roofline.INT32_OPS_PER_S
    assert enc == pytest.approx(7.93e-6, rel=1e-2) and enc < t


def test_fused_least_time_at_the_cell_batch():
    """Batch 4,096: afs20 0.406 ms (search); afs31 (S = 121,117) 5.04 ms."""
    g = 4096 * 135
    assert roofline.fused_least_s(4096, 150, g, 9780, 40960) * 1e3 == \
        pytest.approx(0.4064, rel=1e-3)
    assert roofline.fused_least_s(4096, 150, g, 121117, 40960) * 1e3 == \
        pytest.approx(5.033, rel=1e-3)


def test_fused_least_time_at_the_cells():
    """The cells' D = 40,000 at batch 4,096: afs20 (S = 29,300) 1.190 ms
    and afs31 (S = 121,117) 4.919 ms, by the search."""
    g = 4096 * 135
    assert roofline.fused_least_s(4096, 150, g, 29300, 40000) * 1e3 == \
        pytest.approx(1.1901, rel=1e-3)
    assert roofline.fused_least_s(4096, 150, g, 121117, 40000) * 1e3 == \
        pytest.approx(4.9194, rel=1e-3)


def test_fused_least_time_by_bytes():
    """Few reads against many prototypes: the AM's bytes bound it."""
    t = roofline.fused_least_s(1, 150, 135, 121117, 40960)
    am = 121117 * 1280 * 4
    assert t == pytest.approx((am + 600 + 4 + 121117 * 4) / 3.35e12)


def _event(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": args.pop("tid", 7), "args": args}


@pytest.fixture
def chrome(tmp_path):
    call = trace.call_name(4096, 150, 4096 * 135, 4096)
    ev = [
        _event("user_annotation", trace.WINDOW, 1000, 10000),
        _event("user_annotation", call, 1100, 3000),
        _event("cuda_runtime", "cudaLaunchKernel", 1200, 10, correlation=1),
        _event("cuda_runtime", "cudaLaunchKernelExC", 1300, 10,
               correlation=2),
        _event("cuda_runtime", "cudaLaunchKernel", 1400, 10, correlation=3),
        _event("kernel", "row_popcount_kernel", 1500, 100, correlation=1),
        _event("kernel", "void fused_profile_kernel<1, 2>(int const*)",
               1600, 2000, correlation=2),
        _event("kernel", "void at::native::_scatter_gather_elementwise_"
               "kernel<128, 8>(int)", 3600, 1000, correlation=3),
        _event("gpu_memcpy", "Memcpy DtoH", 4700, 300),
        _event("cpu_op", "aten::copy_", 4600, 500),
        _event("cpu_op", "aten::to", 4550, 600),
        # before the stretch: clipped away
        _event("kernel", "fused_profile_kernel", 100, 500, correlation=9),
    ]
    p = tmp_path / "trace.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    return trace.read(str(p))


def test_trace_busy_gaps_and_attribution(chrome):
    assert chrome.window_s == pytest.approx(0.010)
    # device busy: 1500-4600 (3.1 ms) and 4700-5000 (0.3 ms)
    assert chrome.busy_s() == pytest.approx(0.0034)
    assert len(chrome.kernels) == 3
    assert all(k.call["B"] == 4096 for k in chrome.kernels)
    assert chrome.kernel_time("scatter_gather") == pytest.approx(0.001)
    bd = chrome.breakdown()
    assert bd["device_ops"][0][0] == "fused_profile_kernel"
    gaps = dict(bd["idle_gaps"])
    # aten::to (the top-level op, 4.55-5.15 ms) covers the gap at
    # 4.6-4.7 ms and the first 0.15 ms of the one after 5.0 ms
    assert gaps["aten::to"] == pytest.approx(0.00025)
    assert "aten::copy_" not in gaps
    assert sum(gaps.values()) == pytest.approx(0.010 - 0.0034)


def test_metric_readers_on_the_trace(chrome):
    ctx = {"trace": chrome, "prototypes": 9780,
           "config": paths.config("afs20")}
    roof = paths.metric("fused_profile_roofline").read(ctx)
    # afs20's D = 40,000: 2 x 4,096 x 9,780 x 40,000 b1 ops, 0.3972 ms
    assert roof == pytest.approx(100 * 0.39724e-3 / 2.1e-3, rel=1e-3)
    assert paths.metric("species_max_ms_per_kread").read(ctx) == \
        pytest.approx(1.0 / 4.096)
    assert paths.metric("device_idle_pct").read(ctx) == \
        pytest.approx(66.0)
    assert paths.metric("device_idle_pct").read({"trace": None}) is None


def test_roofline_reader_finds_nothing_without_the_kernel(tmp_path):
    ev = [_event("user_annotation", trace.WINDOW, 0, 100),
          _event("kernel", "other_kernel", 10, 20)]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    ctx = {"trace": trace.read(str(p)), "prototypes": 10,
           "config": paths.config("afs20")}
    assert paths.metric("fused_profile_roofline").read(ctx) is None
    assert paths.metric("species_max_ms_per_kread").read(ctx) is None
