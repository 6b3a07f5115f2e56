"""MetaCache-style baseline: context-aware minhash sketching.

Counterpart of :mod:`repro.baselines.metacache_like`.  MetaCache sketches
genome windows with minhash (the ``sketch`` smallest k-mer hashes per
window) and classifies reads by matching read sketches against window
sketches, accumulating votes per species.  This keeps the database much
smaller than Kraken2's while staying the accuracy reference in the
paper's comparisons.

``repro`` sketches one window or read at a time (``np.partition`` then
``np.unique``); here every window of a genome, and every read of a batch,
is a row of one sort in ``uint64`` order: a row's sketch is its first
``min(count, sketch)`` sorted hashes (the ``sketch`` smallest, duplicates
included, or all of them when there are no more), made unique.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.baselines import kmer_table
from repro_torch.device import resolve_device
from repro_torch.genomics import kmers

#: Order key that sorts after every hash (padding of short rows).
_PAD = (1 << 63) - 1


def sketch_rows(keys: torch.Tensor, valid: torch.Tensor, sketch: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Each row's sketch: ``(N, n)`` order keys with the mask of real ones
    -> ``(N, min(n, sketch))`` sorted keys and the mask of the sketch's
    unique members."""
    count = valid.sum(dim=1, keepdim=True)
    srt = torch.sort(torch.where(valid, keys, _PAD), dim=1).values
    srt = srt[:, :sketch]
    col = torch.arange(srt.shape[1], device=keys.device)[None, :]
    keep = col < count
    keep[:, 1:] &= srt[:, 1:] != srt[:, :-1]
    return srt, keep


class MetaCacheLike:
    name = "metacache-like"

    def __init__(self, k: int = 16, window: int = 128, sketch: int = 16,
                 min_hits: int = 2, *,
                 device: str | torch.device | None = None):
        self.k = k
        self.window = window
        self.sketch = sketch
        self.min_hits = min_hits
        self.device = resolve_device(device)
        self.table: kmer_table.KmerTable | None = None

    def build(self, genomes: dict[str, np.ndarray]) -> "MetaCacheLike":
        num_species = len(genomes)
        if num_species > 64:
            raise ValueError("bitmask substrate supports up to 64 species")
        keys, species = [], []
        for s, toks in enumerate(genomes.values()):
            t = torch.from_numpy(np.asarray(toks, np.int32)).to(self.device)
            h = kmers.order_key(kmers.splitmix64_t(
                kmers.pack_kmers_t(t, self.k)))
            n = h.numel()
            if n == 0:
                continue
            # Window w holds k-mers [w * window, (w + 1) * window).
            nw = -(-n // self.window)
            pad = nw * self.window - n
            rows = torch.nn.functional.pad(h, (0, pad), value=_PAD)
            valid = torch.arange(nw * self.window, device=self.device) < n
            srt, keep = sketch_rows(rows.reshape(nw, self.window),
                                    valid.reshape(nw, self.window),
                                    self.sketch)
            keys.append(torch.unique(srt[keep]))
            species.append(s)
        self.table = kmer_table.merge_masks(keys, species, num_species,
                                            self.k, self.device)
        return self

    def memory_bytes(self) -> int:
        assert self.table is not None
        return self.table.memory_bytes()

    def classify_reads(self, tokens, lengths
                       ) -> tuple[torch.Tensor, torch.Tensor]:
        assert self.table is not None, "call build() first"
        t = self.table
        h, valid = kmer_table.read_hashes(tokens, lengths, self.k,
                                          self.device)
        srt, keep = sketch_rows(kmers.order_key(h), valid, self.sketch)
        masks = torch.where(keep, t.lookup_keys(srt), 0)
        hits = kmer_table.top_vote_hits(
            kmer_table.masks_to_votes(masks, t.num_species), self.min_hits)
        return hits, kmer_table.categorize(hits)
