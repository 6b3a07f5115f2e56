"""Demeter step 5: species-level relative abundance estimation.

Counterpart of :mod:`repro.core.abundance`: ``split_multi_counts``, the
host-side float64 numpy split of multi-mapped reads, so the port's
abundance matches ``repro``'s exactly; and :func:`estimate`, the one-shot
float32 estimate on the hit masks' device (``repro``'s jitted
``estimate``, which the Bracken-like baseline uses).  Uniquely-mapped
reads go to their species directly; multi-mapped reads are split across
their candidate species proportionally to ``unique_count[s] /
genome_length[s]``, with a uniform split when no candidate has unique
support.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import classifier


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


@dataclasses.dataclass(frozen=True)
class AbundanceResult:
    abundance: torch.Tensor        # (S,) float32 -- sums to 1 over mapped
    unique_counts: torch.Tensor    # (S,) int32
    multi_counts: torch.Tensor     # (S,) float32 -- fractional multi mass
    unmapped_fraction: torch.Tensor  # () float32
    multi_fraction: torch.Tensor     # () float32


def estimate(hits: torch.Tensor, category: torch.Tensor,
             genome_lengths: torch.Tensor) -> AbundanceResult:
    """Estimate relative abundance from per-read hit masks, in float32 on
    the hits' device (``repro.core.abundance.estimate``).

    Args:
      hits: ``(R, S)`` bool hit mask from step 4.
      category: ``(R,)`` int read category (UNMAPPED/UNIQUE/MULTI).
      genome_lengths: ``(S,)`` int reference genome lengths.
    """
    dev = hits.device
    category = torch.as_tensor(category, device=dev)
    lens = torch.as_tensor(genome_lengths, device=dev).to(torch.float32)
    f32 = torch.float32
    unique = (category == classifier.UNIQUE)[:, None] & hits
    unique_counts = unique.sum(dim=0).to(torch.int32)

    # Phase 2: proportional split of multi-mapped reads.
    rate = unique_counts.to(f32) / torch.clamp_min(lens, 1.0)
    multi_rows = ((category == classifier.MULTI)[:, None] & hits).to(f32)
    w = multi_rows * rate[None, :]
    row_mass = w.sum(dim=-1, keepdim=True)
    # Fallback: uniform split over hit species when no unique support.
    uniform = multi_rows / torch.clamp_min(
        multi_rows.sum(dim=-1, keepdim=True), 1.0)
    w = torch.where(row_mass > 0, w / torch.clamp_min(row_mass, 1e-30),
                    uniform)
    multi_counts = w.sum(dim=0)

    mapped = unique_counts.to(f32) + multi_counts
    total_mapped = torch.clamp_min(mapped.sum(), 1e-30)
    return AbundanceResult(
        abundance=mapped / total_mapped,
        unique_counts=unique_counts,
        multi_counts=multi_counts,
        unmapped_fraction=(category == classifier.UNMAPPED).to(f32).mean(),
        multi_fraction=(category == classifier.MULTI).to(f32).mean(),
    )
