"""Fault tolerance: heartbeats, failure detection, restart, stragglers.

At thousand-node scale the framework must assume *some* worker is always
unhealthy.  The pieces here are host-side and deterministic, so they are
fully unit-testable on CPU:

* :class:`HeartbeatRegistry` — workers ping; the coordinator marks workers
  dead after ``timeout`` and triggers a restart decision.
* :class:`StragglerMonitor` — per-step duration tracking with a robust
  (median + k*MAD) deadline; repeated offenders are reported for
  replacement (on TPU pods the practical mitigation is rescheduling the
  slice; we surface the decision, the scheduler acts).
* :func:`run_with_restarts` — the crash-safe training driver: steps are a
  pure function of (state, step_index), data order is derived from the
  step index, so resume-from-checkpoint replays identically.

A copy of :mod:`repro.distributed.fault_tolerance` (host code, numpy
only): its decisions equal ``repro``'s on the same timings.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable

import numpy as np


class HeartbeatRegistry:
    def __init__(self, workers: Iterable[str], timeout: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout = timeout
        self.clock = clock
        self.last_seen = {w: clock() for w in workers}

    def ping(self, worker: str) -> None:
        self.last_seen[worker] = self.clock()

    def dead_workers(self) -> list[str]:
        now = self.clock()
        return [w for w, t in self.last_seen.items()
                if now - t > self.timeout]

    def healthy(self) -> bool:
        return not self.dead_workers()


@dataclasses.dataclass
class StragglerReport:
    worker: str
    step: int
    duration: float
    deadline: float


class StragglerMonitor:
    """Flags workers whose step time exceeds median + k * MAD."""

    def __init__(self, k: float = 5.0, window: int = 32,
                 min_samples: int = 8):
        self.k = k
        self.window = window
        self.min_samples = min_samples
        self.history: list[float] = []
        self.offenders: dict[str, int] = {}

    def deadline(self) -> float:
        if len(self.history) < self.min_samples:
            return float("inf")
        h = np.asarray(self.history[-self.window:])
        med = float(np.median(h))
        mad = float(np.median(np.abs(h - med))) + 1e-9
        return med + self.k * mad

    def observe(self, worker: str, step: int, duration: float
                ) -> StragglerReport | None:
        dl = self.deadline()
        self.history.append(duration)
        if duration > dl:
            self.offenders[worker] = self.offenders.get(worker, 0) + 1
            return StragglerReport(worker, step, duration, dl)
        return None

    def should_replace(self, worker: str, strikes: int = 3) -> bool:
        return self.offenders.get(worker, 0) >= strikes


@dataclasses.dataclass
class RestartStats:
    restarts: int = 0
    completed_steps: int = 0
    resumed_from: list[int] = dataclasses.field(default_factory=list)


def run_with_restarts(*, init_fn, step_fn, save_fn, restore_fn,
                      total_steps: int, checkpoint_every: int,
                      max_restarts: int = 10) -> tuple[object, RestartStats]:
    """Crash-safe driver: (re)loads the newest checkpoint and replays.

    step_fn(state, i) may raise (simulated node failure); the driver
    restores and continues.  Determinism contract: step_fn derives its
    batch from ``i`` alone, so a replayed step is bit-identical.
    """
    stats = RestartStats()
    attempt = 0
    while True:
        try:
            restored = restore_fn()
            if restored is None:
                state, start = init_fn(), 0
            else:
                state, start = restored
                stats.resumed_from.append(start)
            for i in range(start, total_steps):
                state = step_fn(state, i)
                stats.completed_steps = i + 1
                if (i + 1) % checkpoint_every == 0:
                    save_fn(state, i + 1)
            return state, stats
        except Exception:
            attempt += 1
            stats.restarts += 1
            if attempt > max_restarts:
                raise
