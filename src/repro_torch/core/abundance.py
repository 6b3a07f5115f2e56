"""Demeter step 5: species-level relative abundance estimation.

Counterpart of :mod:`repro.core.abundance`'s ``split_multi_counts``: the
host-side float64 numpy split of multi-mapped reads, so the port's
abundance matches ``repro``'s exactly.  Uniquely-mapped reads go to their
species directly; multi-mapped reads are split across their candidate
species proportionally to ``unique_count[s] / genome_length[s]``, with a
uniform split when no candidate has unique support.
"""

from __future__ import annotations

import numpy as np


def split_multi_counts(unique_counts: np.ndarray, multi_hits: np.ndarray,
                       genome_lengths: np.ndarray) -> np.ndarray:
    """Phase 2 on the host, exactly: split multi-mapped reads by unique
    coverage rate.

    The single source of truth for the streaming pipeline's end-of-run
    split — :class:`~repro_torch.pipeline.report.ProfileAccumulator` calls
    this with the *global* unique counts so the result never depends on
    how the stream was batched.  Pure float64 numpy: bit-stable across
    backends and devices.

    Args:
      unique_counts: ``(S,)`` int unique-read counts (phase 1, global).
      multi_hits: ``(R, S)`` bool hit mask of the multi-mapped reads.
      genome_lengths: ``(S,)`` reference genome lengths.

    Returns:
      ``(S,)`` float64 fractional multi-mapped mass per species.
    """
    lens = np.maximum(np.asarray(genome_lengths, np.float64), 1.0)
    rate = np.asarray(unique_counts, np.float64) / lens
    m = np.asarray(multi_hits, bool)
    w = m * rate[None, :]
    mass = w.sum(axis=-1, keepdims=True)
    # Fallback: uniform split over hit species when no unique support.
    uniform = m / np.maximum(m.sum(axis=-1, keepdims=True), 1)
    w = np.where(mass > 0, w / np.maximum(mass, 1e-30), uniform)
    return w.sum(axis=0)
