"""Noise-sweep evaluation harness: accuracy vs device non-ideality.

Counterpart of :mod:`repro.accel.sweep`; sessions run on ``device``
(``None``: ``cuda``).

Reproduces the shape of the paper's robustness argument (and of
Karunaratne et al.'s accuracy-vs-noise curves for in-memory HDC): run the
*same* profiling workload through ``pcm_sim`` while stepping one device
knob — read noise, programming noise, drift horizon, stuck-at rate, ADC
resolution — and record profiling accuracy at every point.

The RefDB is built once on the digital path (every backend's ``encode``
is bit-exact, so the database is shared; only the programmed-array +
search non-idealities vary) and each sweep point gets a fresh
:class:`~repro_torch.pipeline.session.ProfilingSession` whose config differs
only in ``backend_options`` — which is exactly what makes the sweep a
family of honestly fingerprinted, cache-friendly runs rather than ad-hoc
parameter pokes.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.eval import ProfileMetrics, score_profile
from repro_torch.pipeline.config import ProfilerConfig
from repro_torch.pipeline.report import ProfileReport
from repro_torch.pipeline.session import ProfilingSession
from repro_torch.pipeline.source import ArraySource

#: Device/geometry knobs a sweep may step (declared option names of the
#: substrate backends; ``levels`` and ``shift_fault_rate`` are
#: substrate-specific — the backend's schema rejects them elsewhere).
SWEEPABLE = ("read_sigma", "prog_sigma", "drift_t_s", "stuck_on_rate",
             "stuck_off_rate", "adc_bits", "seed", "levels",
             "shift_fault_rate")

#: Backends the sweep can drive; anything else is forced to ``pcm_sim``.
_SUBSTRATE_BACKENDS = ("pcm_sim", "racetrack_sim")


@dataclasses.dataclass(frozen=True)
class SweepPoint:
    """Accuracy of one profiling run at one device setting."""

    knob: str
    value: float
    metrics: ProfileMetrics
    unmapped_frac: float
    report: ProfileReport

    def row(self) -> str:
        return (f"{self.knob}={self.value:g} {self.metrics.row()} "
                f"unmapped={self.unmapped_frac:.3f}")


def noise_sweep(genomes: dict[str, np.ndarray], tokens: np.ndarray,
                lengths: np.ndarray, true_abundance: np.ndarray, *,
                config: ProfilerConfig, knob: str = "read_sigma",
                levels: Sequence[float] = (0.0, 0.02, 0.05, 0.1, 0.2),
                refdb=None, device=None) -> list[SweepPoint]:
    """Profile one sample at every ``knob`` level; return accuracy points.

    Args:
      genomes: reference genomes (step 2 input; encoded once, digitally).
      tokens / lengths: the query read sample.
      true_abundance: ground-truth abundance for scoring.
      config: base config; its backend is kept if it is a substrate
        backend (``pcm_sim`` / ``racetrack_sim``), else forced to
        ``pcm_sim``; existing ``backend_options`` (e.g. a preset) are
        kept, with ``knob`` overridden per level.
      knob: one of :data:`SWEEPABLE`.
      levels: values to step ``knob`` through.
      refdb: prebuilt reference database; pass one to share a single
        build across several sweeps (the prototypes are identical at
        every level and for every knob).
      device: where every session runs (``None``: ``cuda``).
    """
    if knob not in SWEEPABLE:
        raise ValueError(f"unknown sweep knob {knob!r}; one of {SWEEPABLE}")
    backend = (config.backend if config.backend in _SUBSTRATE_BACKENDS
               else "pcm_sim")
    base = dataclasses.replace(config, backend=backend)

    if refdb is None:
        # Step 2 once: the digital prototypes are identical at every level
        # (the builder strips the device options and any noise-aware flag —
        # the reference backend takes no options, and a sweep compares
        # device settings against one shared database).
        builder = ProfilingSession(dataclasses.replace(
            base, backend="reference", backend_options=(),
            noise_aware_refdb=False), device=device)
        refdb = builder.build_refdb(genomes)

    points: list[SweepPoint] = []
    for raw in levels:
        level = int(raw) if knob in ("adc_bits", "seed") else float(raw)
        cfg = base.with_options(**{knob: level})
        session = ProfilingSession(cfg, device=device)
        report = session.profile(ArraySource(tokens, lengths), refdb=refdb)
        points.append(SweepPoint(
            knob=knob, value=float(level),
            metrics=score_profile(report.abundance, true_abundance),
            unmapped_frac=report.unmapped_reads / max(report.total_reads, 1),
            report=report))
    return points
