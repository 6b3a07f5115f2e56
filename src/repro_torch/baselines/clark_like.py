"""CLARK-style baseline: voting restricted to *discriminative* k-mers.

Counterpart of :mod:`repro.baselines.clark_like`.  CLARK discards any
k-mer shared by more than one target; classification then uses only
species-unique k-mers, which makes unique assignments very precise but
loses reads falling entirely in homologous regions.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.baselines import kmer_table
from repro_torch.device import resolve_device


class ClarkLike:
    name = "clark-like"

    def __init__(self, k: int = 21, min_hits: int = 2, *,
                 device: str | torch.device | None = None):
        self.k = k
        self.min_hits = min_hits
        self.device = resolve_device(device)
        self.table: kmer_table.KmerTable | None = None

    def build(self, genomes: dict[str, np.ndarray]) -> "ClarkLike":
        t = kmer_table.build_table(genomes, self.k, device=self.device)
        # Keep only k-mers whose mask has exactly one set bit (int64 wraps
        # as uint64 does: the sign bit alone minus one clears it).
        m = t.masks
        discriminative = (m & (m - 1)) == 0
        self.table = kmer_table.KmerTable(
            keys=t.keys[discriminative], masks=m[discriminative],
            num_species=t.num_species, k=t.k)
        return self

    def memory_bytes(self) -> int:
        assert self.table is not None
        return self.table.memory_bytes()

    def classify_reads(self, tokens, lengths
                       ) -> tuple[torch.Tensor, torch.Tensor]:
        assert self.table is not None, "call build() first"
        return kmer_table.classify(self.table, tokens, lengths,
                                   self.min_hits)
