"""Kraken2-style baseline: exact k-mer hash lookups + per-read voting.

Counterpart of :mod:`repro.baselines.kraken2_like`, faithful to Kraken2's
classification logic at species rank with a flat taxonomy: every k-mer of
the read votes for the species containing it; the read is assigned to the
max-vote species (ties -> multi-assignment, matching LCA semantics
flattened to species level); reads with fewer than ``min_hits`` voting
k-mers stay unclassified.  Minimizer database subsampling is exposed as
``subsample``.  The table lives on ``device`` (``None``: ``cuda``) and a
batch of reads is classified in one pass over its ``(R, L - k + 1)``
hashes.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.baselines import kmer_table
from repro_torch.device import resolve_device


class Kraken2Like:
    name = "kraken2-like"

    def __init__(self, k: int = 21, subsample: int = 1, min_hits: int = 2,
                 *, device: str | torch.device | None = None):
        self.k = k
        self.subsample = subsample
        self.min_hits = min_hits
        self.device = resolve_device(device)
        self.table: kmer_table.KmerTable | None = None

    def build(self, genomes: dict[str, np.ndarray]) -> "Kraken2Like":
        self.table = kmer_table.build_table(genomes, self.k,
                                            subsample=self.subsample,
                                            device=self.device)
        return self

    def memory_bytes(self) -> int:
        assert self.table is not None
        return self.table.memory_bytes()

    def classify_reads(self, tokens, lengths
                       ) -> tuple[torch.Tensor, torch.Tensor]:
        """Returns (hits (R,S) bool, category (R,) int32) on the device."""
        assert self.table is not None, "call build() first"
        return kmer_table.classify(self.table, tokens, lengths,
                                   self.min_hits)
