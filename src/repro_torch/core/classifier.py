"""Demeter step 4: multi-species classification per read.

Counterpart of :mod:`repro.core.classifier`.  A read may match one, many
or no species:

    0 = unmapped   (no species above threshold)
    1 = unique     (exactly one)
    2 = multi      (more than one)

``partial_scores`` reduces per-prototype agreement to per-species maxima
over any subset of the prototypes, ``merge_scores`` merges such partials
(elementwise max) and ``from_scores`` thresholds and categorizes once.
``from_agreement`` is ``from_scores(partial_scores(...))``.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch import obs
from repro_torch.core import assoc_memory

UNMAPPED, UNIQUE, MULTI = 0, 1, 2

#: Score of a species with no prototype in a shard: the identity of the
#: max-merge, so empty segments never win against any real agreement.
NO_SCORE = torch.iinfo(torch.int32).min


@dataclasses.dataclass(frozen=True)
class ReadClassification:
    """Per-read classification outcome for a batch of R reads, S species."""
    hits: torch.Tensor        # (R, S) bool -- agreement >= T
    scores: torch.Tensor      # (R, S) int32 -- best agreement per species
    category: torch.Tensor    # (R,) int32 -- UNMAPPED / UNIQUE / MULTI

    @property
    def num_hits(self) -> torch.Tensor:
        return self.hits.sum(dim=-1)


def partial_scores(agreement: torch.Tensor, proto_species: torch.Tensor,
                   num_species: int) -> torch.Tensor:
    """Per-species max over *any subset* of the prototypes -> ``(R, S)``."""
    return assoc_memory.species_scores(agreement, proto_species, num_species)


def merge_scores(*partials: torch.Tensor) -> torch.Tensor:
    """Merge per-shard partial score matrices: elementwise max."""
    return functools.reduce(torch.maximum, partials)


def threshold_int32(threshold_bits: float) -> int:
    """The threshold as ``repro`` compares it: cast to int32, truncating.

    ``repro`` compares ``scores >= jnp.asarray(threshold_bits, int32)``,
    so a fractional threshold (20884.77 at D=40,960, z=4) becomes 20884.
    """
    return int(threshold_bits)


def from_scores(scores: torch.Tensor, threshold_bits: float
                ) -> ReadClassification:
    """Threshold merged ``(R, S)`` species scores and categorize reads
    (the span ``repro_torch.threshold`` under a running profiler)."""
    with obs.span("repro_torch.threshold"):
        hits = scores >= threshold_int32(threshold_bits)
        n = hits.sum(dim=-1)
        category = torch.where(n == 0, UNMAPPED,
                               torch.where(n == 1, UNIQUE, MULTI))
        return ReadClassification(hits=hits, scores=scores,
                                  category=category.to(torch.int32))


def from_agreement(agreement: torch.Tensor, proto_species: torch.Tensor,
                   num_species: int, threshold_bits: float
                   ) -> ReadClassification:
    """Classify from a precomputed ``(R, S_protos)`` agreement matrix."""
    return from_scores(partial_scores(agreement, proto_species, num_species),
                       threshold_bits)
