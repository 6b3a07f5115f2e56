"""Shared substrate for the k-mer-table baselines (Kraken2/CLARK-like).

Counterpart of :mod:`repro.baselines.kmer_table`: a sorted table mapping
64-bit k-mer hashes to species bitmasks -- the "humongous hash table"
working structure the paper identifies as the bottleneck of SOTA
profilers (§2.2) -- held on the device.  ``memory_bytes()`` counts the
same bytes as ``repro``'s (8 a hash, 8 a mask).

Words are ``int64`` tensors with ``repro``'s ``uint64`` bits
(:mod:`repro_torch.genomics.kmers`).  The table stores each hash as its
order key (sign bit flipped), so that ``torch.searchsorted`` over the
keys finds ``repro``'s ``uint64`` order; :attr:`KmerTable.hashes` gives
the hashes back.  Species ``s`` is bit ``s`` of a mask (species 63 is the
sign bit).  Lookups and votes run for a whole batch of reads at once
(:func:`classify`), where ``repro`` loops over reads.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import classifier
from repro_torch.device import resolve_device
from repro_torch.genomics import kmers

#: Largest ``(reads x k-mers x species)`` block :func:`masks_to_votes`
#: expands at once.
_VOTE_BLOCK = 1 << 25


def species_bit(s: int) -> int:
    """Species ``s``'s mask bit as an ``int64`` value."""
    if not 0 <= s < 64:
        raise ValueError("bitmask substrate supports up to 64 species")
    return kmers.as_int64(1 << s)


@dataclasses.dataclass
class KmerTable:
    keys: torch.Tensor        # (T,) int64 order keys, ascending (unique)
    masks: torch.Tensor       # (T,) int64 species bitmask
    num_species: int
    k: int

    @property
    def hashes(self) -> torch.Tensor:
        """``(T,)`` hashes (``int64`` bits) in ``uint64`` ascending order."""
        return kmers.order_key(self.keys)

    def memory_bytes(self) -> int:
        return (self.keys.numel() * self.keys.element_size()
                + self.masks.numel() * self.masks.element_size())

    def lookup_masks(self, read_hashes: torch.Tensor) -> torch.Tensor:
        """Species bitmask for each hash (0 when absent), any shape."""
        return self.lookup_keys(kmers.order_key(read_hashes))

    def lookup_keys(self, q: torch.Tensor) -> torch.Tensor:
        """:meth:`lookup_masks` of hashes given as order keys."""
        q = q.to(self.keys.device).contiguous()
        if self.keys.numel() == 0:
            return torch.zeros_like(q)
        idx = torch.searchsorted(self.keys, q)
        idx = torch.clamp_max(idx, self.keys.numel() - 1)
        found = self.keys[idx] == q
        return torch.where(found, self.masks[idx], 0)


def merge_masks(keys: list[torch.Tensor], species: list[int],
                num_species: int, k: int, device: torch.device) -> KmerTable:
    """Union of per-species hash sets -> a :class:`KmerTable`.

    Each of ``keys`` holds one species' order keys, unique; the masks of a
    key present in several species are OR-ed as a sum of their single
    bits, which is exact because no species adds its bit twice
    (``repro``'s ``np.bitwise_or.reduceat`` over the same sets).
    """
    if num_species > 64:
        raise ValueError("bitmask substrate supports up to 64 species")
    all_k = torch.cat(keys) if keys else torch.empty(0, dtype=torch.int64,
                                                      device=device)
    all_m = torch.cat([torch.full_like(h, species_bit(s))
                       for s, h in zip(species, keys)]) if keys else all_k
    uniq, inv = torch.unique(all_k, sorted=True, return_inverse=True)
    masks = torch.zeros_like(uniq).index_add_(0, inv, all_m)
    return KmerTable(keys=uniq, masks=masks, num_species=num_species, k=k)


def build_table(genomes: dict[str, np.ndarray], k: int, *,
                subsample: int = 1,
                device: str | torch.device | None = None) -> KmerTable:
    """Union of per-species k-mer hash sets with species bitmasks, built
    on ``device`` (``None``: ``cuda``).

    ``subsample > 1`` keeps only hashes < 2^64/subsample (minimizer-style
    database shrinking, as Kraken2's minimizers do).
    """
    num_species = len(genomes)
    if num_species > 64:
        raise ValueError("bitmask substrate supports up to 64 species")
    dev = resolve_device(device)
    limit = kmers.as_int64(((1 << 64) - 1) // subsample) ^ kmers.SIGN
    per_species = []
    for toks in genomes.values():
        t = torch.from_numpy(np.asarray(toks, np.int32)).to(dev)
        key = kmers.order_key(kmers.splitmix64_t(kmers.pack_kmers_t(t, k)))
        if subsample > 1:
            key = key[key <= limit]
        per_species.append(torch.unique(key))
    return merge_masks(per_species, list(range(num_species)), num_species,
                       k, dev)


def masks_to_votes(masks: torch.Tensor, num_species: int) -> torch.Tensor:
    """``(..., H)`` bitmasks -> ``(..., S)`` int64 per-species vote counts
    (a mask of 0 votes for no species)."""
    shifts = torch.arange(num_species, device=masks.device)
    lead = masks.shape[:-1]
    flat = masks.reshape(int(np.prod(lead)), masks.shape[-1])
    rows = max(1, _VOTE_BLOCK // max(1, flat.shape[-1] * num_species))
    out = torch.empty((flat.shape[0], num_species), dtype=torch.int64,
                      device=masks.device)
    for r0 in range(0, flat.shape[0], rows):
        blk = flat[r0:r0 + rows]
        out[r0:r0 + rows] = ((blk[..., None] >> shifts) & 1).sum(dim=1)
    return out.reshape(lead + (num_species,))


def categorize(hits: torch.Tensor) -> torch.Tensor:
    """``(R, S)`` hits -> ``(R,)`` int32 UNMAPPED / UNIQUE / MULTI."""
    n = hits.sum(dim=1)
    return torch.where(n == 0, classifier.UNMAPPED,
                       torch.where(n == 1, classifier.UNIQUE,
                                   classifier.MULTI)).to(torch.int32)


def top_vote_hits(votes: torch.Tensor, min_hits: int) -> torch.Tensor:
    """Per read: the species with the most votes (ties: all of them), when
    that count reaches ``min_hits``; else none."""
    top = votes.max(dim=1, keepdim=True).values
    return (votes == top) & (top >= min_hits)


def read_hashes(tokens, lengths, k: int, device: torch.device
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(R, L)`` padded reads (numpy or tensors) -> their k-mer hashes and
    the mask of real k-mers, on ``device``."""
    t = torch.as_tensor(np.asarray(tokens, np.int32) if not isinstance(
        tokens, torch.Tensor) else tokens).to(device)
    n = torch.as_tensor(np.asarray(lengths, np.int64) if not isinstance(
        lengths, torch.Tensor) else lengths).to(device)
    return kmers.read_kmer_hashes_t(t, n, k)


def classify(table: KmerTable, tokens, lengths, min_hits: int
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Every k-mer of every read votes for the species containing it
    (Kraken2- and CLARK-like): ``(hits (R, S) bool, category (R,)
    int32)`` on the table's device."""
    h, valid = read_hashes(tokens, lengths, table.k, table.keys.device)
    masks = torch.where(valid, table.lookup_masks(h), 0)
    hits = top_vote_hits(masks_to_votes(masks, table.num_species), min_hits)
    return hits, categorize(hits)
