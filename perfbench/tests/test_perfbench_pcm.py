"""The cell ``afs20-pcm.profile``: it loads by name and reports its
metrics, the crossbar roofline counts the work by hand, and a tiny run on
the CPU is correct while a chunked read whose chunks all draw with the
first tiles' keys, and the controls, are not."""

import copy
import time

import pytest

from perfbench import control_pcm, harness, paths, roofline_crossbar

CELL = "afs20-pcm.profile"
METRICS = {"crossbar_read_ms_per_kread", "crossbar_read_roofline",
           "crossbar_program_s"}


def tiny():
    """``(workload, config)`` of the cell at a size a CPU run holds (the
    pcm preset kept)."""
    wl = copy.deepcopy(paths.workload(CELL))
    wl["params"].update(samples=2, reads_per_sample=160, read_len=40,
                        check_batches=2, check_reads=24, check_per_launch=4)
    cfg = paths.config(wl["config"])
    cfg.update(window=256, stride=256, batch_size=64, num_species=4,
               genome_len=3000)
    cfg["space"] = dict(cfg["space"], dim=2048, ngram=8)
    return wl, cfg


def _run(trace=False):
    wl, cfg = tiny()
    return harness.run_cell(CELL, 2 ** 31 + 777, 1.0, trace, device="cpu",
                            t_process=time.perf_counter(), workload=wl,
                            config=cfg)


def test_the_cell_loads_and_reports_its_metrics():
    bench = paths.benchmark()
    wl, cfg = paths.workload(CELL), paths.config("afs20-pcm")
    assert wl["mix"] == "profile_pcm" and wl["chips"] == 1
    assert cfg["backend"] == "pcm_sim"
    assert cfg["backend_options"] == {"preset": "pcm"}
    afs20 = paths.config("afs20")
    for key in ("space", "window", "stride", "batch_size", "num_species",
                "genome_len", "homology_fraction", "strain_snp_rate",
                "read_error_rate", "reduced"):
        assert cfg[key] == afs20[key], key
    assert set(harness.end_to_end_names(bench, CELL)) == {
        "setup_s", "profile_reads_per_s"}
    assert METRICS <= set(harness.per_layer_names(bench, CELL))
    for other in ("afs20.profile", "afs31.profile"):
        assert not METRICS & set(harness.per_layer_names(bench, other))
    assert wl["params"]["reads_per_sample"] == 4 * cfg["batch_size"]


def test_roofline_counts_the_cells_read_by_hand():
    # B 4,096; 29,300 prototypes -> S_pad 29,440; D 40,000 -> T 157,
    # D_pad 40,192
    w = roofline_crossbar.read_work(4096, 29_300, 40_000)
    assert w["flops"] == 2 * 2 * 4096 * 29_440 * 40_192 == 19_386_408_632_320
    assert w["draws"] == 2 * 157 * 4096 * 29_440 == 37_864_079_360
    assert w["bytes"] == (2 * 157 * 29_440 * 256 * 4 + 4096 * 1250 * 4
                          + 4096 * 29_300 * 4)
    assert roofline_crossbar.FP32_OPS_PER_S == pytest.approx(66.9e12,
                                                             rel=1e-3)
    # products 290 ms bound the read; the draws 170 ms, the bytes 3 ms
    assert roofline_crossbar.read_least_s(4096, 29_300, 40_000) == \
        pytest.approx(0.2898, rel=1e-3)
    assert w["draws"] * 75 / 16.73e12 == pytest.approx(0.1697, rel=1e-3)


def test_sound_tiny_run_is_correct():
    out, _ = _run()
    assert out["correct"], out["checks"]
    assert {"score_far", "score_near_share", "proto_words",
            "report_counts"} <= set(out["checks"])
    assert set(out["metrics"]) == {"setup_s", "profile_reads_per_s"}


def test_traced_tiny_run_reads_the_programming_time():
    """On the CPU the trace has no kernels: the span readers report
    nothing, the programming time is read."""
    out, _ = _run(trace=True)
    assert out["correct"], out["checks"]
    assert out["metrics"]["crossbar_program_s"]["value"] > 0
    assert "crossbar_read_roofline" not in out["metrics"]


def test_noise_restarting_in_every_chunk_is_not_correct(monkeypatch):
    """A read in chunks of row tiles whose every chunk draws with the
    first chunk's keys (the tile offset dropped) is caught by the sampled
    scores."""
    import types

    import numpy as np

    from repro_torch.accel import crossbar

    span = 3                          # the tiny cell's 8 tiles in 3 chunks
    monkeypatch.setattr(crossbar, "BLOCK_BYTES", 4 * 64 * 256 * span)
    out, _ = _run()
    assert out["correct"], out["checks"]           # chunks alone are sound
    split = crossbar.threefry.split

    def restarting(key, n, **kw):
        return split(key, n, **kw)[np.arange(n) % span]

    monkeypatch.setattr(crossbar, "threefry", types.SimpleNamespace(
        split=restarting, key=crossbar.threefry.key))
    out, _ = _run()
    assert not out["correct"]
    c = out["checks"]
    assert c["score_far"]["value"] > 0 or \
        c["score_near_share"]["value"] > c["score_near_share"]["limit"]


def test_controls_are_not_correct():
    wl, cfg = tiny()
    r = control_pcm.readings(CELL, 11, 0.5, "cpu", workload=wl, config=cfg)
    assert r["program"]["score_far"] == 0
    assert r["program"]["score_near_share"] <= 1e-3
    for side in control_pcm.CONTROLS:
        assert r[side]["score_far"] > 0 or \
            r[side]["score_near_share"] > 1e-3, side
