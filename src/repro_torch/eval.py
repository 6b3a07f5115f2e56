"""Profiling accuracy metrics (paper §4.1: precision / recall / L1).

Counterpart of :mod:`repro.eval`, copied (it is numpy only) so the port
imports nothing of ``repro``.

Presence calls compare estimated abundance against ground truth at a
detection threshold; precision = TP/(TP+FP), recall = TP/(TP+FN) over
species presence, exactly the Fig. 2/3 metrics.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ProfileMetrics:
    precision: float
    recall: float
    f1: float
    l1_error: float          # sum |est - truth| over species (0..2)
    tp: int
    fp: int
    fn: int

    def row(self) -> str:
        return (f"precision={self.precision:.3f} recall={self.recall:.3f} "
                f"f1={self.f1:.3f} l1={self.l1_error:.3f}")


def score_profile(est_abundance: np.ndarray, true_abundance: np.ndarray,
                  detect_threshold: float = 0.01) -> ProfileMetrics:
    est = np.asarray(est_abundance, np.float64)
    tru = np.asarray(true_abundance, np.float64)
    called = est >= detect_threshold
    present = tru > 0
    tp = int((called & present).sum())
    fp = int((called & ~present).sum())
    fn = int((~called & present).sum())
    precision = tp / (tp + fp) if tp + fp else 0.0
    recall = tp / (tp + fn) if tp + fn else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall else 0.0)
    return ProfileMetrics(precision=precision, recall=recall, f1=f1,
                          l1_error=float(np.abs(est - tru).sum()),
                          tp=tp, fp=fp, fn=fn)


def read_level_accuracy(hits: np.ndarray, category: np.ndarray,
                        truth: np.ndarray) -> float:
    """Fraction of reads whose hit set contains the true species."""
    r = len(truth)
    correct = hits[np.arange(r), truth]
    return float(correct.mean())
