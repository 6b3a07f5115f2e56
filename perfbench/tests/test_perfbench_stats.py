"""The rate as all the work over all the time, on synthetic numbers."""

import types

import numpy as np
import pytest

from perfbench import harness, paths


class _Clock:
    """A perf_counter that moves only when a call runs."""

    def __init__(self):
        self.t = 100.0

    def perf_counter(self):
        return self.t


def test_profile_rate_is_all_reads_over_all_time(monkeypatch):
    """Calls of 0.3, 0.5 and 0.4 s of 1,000 reads each over a window of
    1 s: three whole calls, 3,000 reads in 1.2 s."""
    mix = paths.mix("profile")
    clock = _Clock()
    monkeypatch.setattr(mix, "time", types.SimpleNamespace(
        perf_counter=clock.perf_counter))
    monkeypatch.setattr(harness, "time", types.SimpleNamespace(
        perf_counter=clock.perf_counter))
    durations = iter([0.3, 0.5, 0.4, 9.9])

    class Session:
        space = types.SimpleNamespace(ngram=16)

        def classify_batch(self, tokens, lengths, **kw):
            raise AssertionError("not reached")

        def profile(self, src):
            clock.t += next(durations)
            return "report"

    run = harness.Run("c", {"params": {"reads_per_sample": 1000,
                                       "read_len": 150,
                                       "rate_metric": "rate"}}, {}, 1, 1.0,
                      False, "cpu", 0.0)
    st = mix.State(types.SimpleNamespace(session=Session()),
                   [np.zeros((1000, 150), np.int32)])
    mix.window(run, st)
    assert run.attempted == 3
    assert run.metrics["rate"] == pytest.approx(3000 / 1.2)
    assert run.t_first == 100.0
