"""Bracken-style abundance redistribution on top of any classifier.

Counterpart of :mod:`repro.baselines.bracken_like`.  Bracken reassigns
reads classified at higher/ambiguous ranks down to species using the
unique-assignment distribution -- with a flat species taxonomy this is
exactly Demeter's step-5 proportional split, so we reuse the shared
estimator; Kraken2+Bracken in the benchmarks is ``Kraken2Like`` + this
redistribution.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import abundance as abundance_mod


def estimate_abundance(hits, category, genome_lengths
                       ) -> abundance_mod.AbundanceResult:
    """(R,S) hits + categories -> AbundanceResult (shared step-5 math), in
    float32 on the hits' device (numpy hits: the CPU)."""
    hits = torch.as_tensor(hits)
    dev = hits.device
    return abundance_mod.estimate(
        hits, torch.as_tensor(category).to(dev),
        torch.as_tensor(np.asarray(genome_lengths)).to(dev))
