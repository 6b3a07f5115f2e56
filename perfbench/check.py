"""The comparisons that decide ``correct``, shared by the traffic drivers.

Each returns one number that has a limit of its own (the ``checks`` of the
result line).  The reference (:mod:`perfbench.reference.hdc`) works from
the inputs the benchmark made: the genomes, the reads, the space's seed.
Two of its stages follow the program's own state, because re-deriving it
would take longer than the window: the species max runs over the
program's prototypes (121,117 of them for ``afs31``), of which a sample
stratified by species and by the build's encode launches is re-encoded
from the genomes by :func:`proto_words`; and step 5 of a profile call
runs over the program's own per-read hits (themselves held to the
program's scores and threshold on every read, and to the reference's
scores on a sample).
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import hdc


class Reference:
    """The reference's view of one configuration on one device."""

    def __init__(self, config: dict, genomes: np.ndarray, device: str,
                 precision: str = "float32"):
        self.config = config
        self.space = config["space"]
        self.device = device
        self.precision = precision
        self.im, self.tie = hdc.item_memory(self.space)
        self.threshold = hdc.threshold(self.space)
        self.genomes = genomes
        self.starts = [hdc.window_starts(genomes.shape[1], config["window"],
                                         config["stride"])
                       for _ in range(genomes.shape[0])]
        self.rows, lo = [], 0
        for st in self.starts:
            self.rows.append((lo, lo + len(st)))
            lo += len(st)
        self.num_prototypes = lo

    def encode(self, tokens: np.ndarray, lengths: np.ndarray
               ) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(tokens).astype(np.int64))
        return hdc.encode(t.to(self.device),
                          torch.from_numpy(np.asarray(lengths, np.int64))
                          .to(self.device),
                          self.im, self.tie, self.space["ngram"])

    def scores(self, tokens: np.ndarray, lengths: np.ndarray,
               prototypes: torch.Tensor) -> torch.Tensor:
        """Steps 3-4 for reads, grouped by length so that no row pays for
        a longer one's grams."""
        lengths = np.asarray(lengths)
        out = torch.empty((len(lengths), len(self.rows)), dtype=torch.int32,
                          device=self.device)
        for n in np.unique(lengths):
            idx = np.flatnonzero(lengths == n)
            q = self.encode(tokens[idx][:, :max(int(n), 1)], lengths[idx])
            out[torch.from_numpy(idx).to(self.device)] = hdc.species_scores(
                q, prototypes.to(self.device), self.rows, self.precision)
        return out

    def window(self, row: int) -> np.ndarray:
        s = next(i for i, (lo, hi) in enumerate(self.rows) if lo <= row < hi)
        start = self.starts[s][row - self.rows[s][0]]
        return self.genomes[s, start:start + self.config["window"]]


def build_strata(ref: Reference, batch: int) -> list[tuple[int, int]]:
    """Prototype rows ``[lo, hi)`` of each encode launch of the build: a
    genome's windows are encoded ``batch`` at a time, genome by genome."""
    return [(b, min(hi, b + batch)) for lo, hi in ref.rows
            for b in range(lo, hi, batch)]


def proto_words(ref: Reference, prototypes: torch.Tensor,
                rng: np.random.Generator, per_launch: int) -> int:
    """Words of a seeded sample of the program's prototypes that differ
    from the reference's encode of the same windows.  The sample holds
    ``per_launch`` rows of every encode launch of the build (so of every
    species), the first and the last prototype."""
    if prototypes.shape[0] != ref.num_prototypes:
        return int(prototypes.numel())
    picks = [np.array([0, ref.num_prototypes - 1])]
    for lo, hi in build_strata(ref, ref.config["batch_size"]):
        picks.append(lo + rng.choice(hi - lo, min(per_launch, hi - lo),
                                     replace=False))
    picks = np.unique(np.concatenate(picks))
    wins = [ref.window(int(r)) for r in picks]
    width = max(len(w) for w in wins)
    toks = np.zeros((len(wins), width), np.int64)
    for i, w in enumerate(wins):
        toks[i, :len(w)] = w
    want = ref.encode(toks, np.array([len(w) for w in wins]))
    got = prototypes[torch.from_numpy(picks).to(prototypes.device)]
    return int((got.to(want.device) != want).sum())


def rows_differ(got: torch.Tensor, want: torch.Tensor) -> int:
    """Rows of two ``(R, ...)`` tensors that differ anywhere."""
    if got.shape != want.shape:
        return max(got.shape[0], want.shape[0])
    g, w = got.to(want.device), want
    return int((g != w).reshape(len(g), -1).any(1).sum())


def chain(scores: torch.Tensor, hits: torch.Tensor, category: torch.Tensor,
          threshold: int) -> tuple[int, int]:
    """Reads whose hits are not their scores at the threshold, and reads
    whose category is not that of their hits."""
    return (rows_differ(hits, scores >= threshold),
            rows_differ(category.to(torch.int32), hdc.category_of(hits)))


def report_diff(got, want: dict) -> tuple[int, float]:
    """``(integer fields that differ, largest gap of a float field)``
    between a program ``ProfileReport`` and the reference's; a field's
    gap is its largest difference over the reference's largest value."""
    ints = [(got.total_reads, want["total_reads"]),
            (got.unmapped_reads, want["unmapped_reads"]),
            (got.multi_reads, want["multi_reads"])]
    ints += list(zip(np.asarray(got.unique_counts).tolist(),
                     np.asarray(want["unique_counts"]).tolist()))
    counts = sum(int(a != b) for a, b in ints)
    if len(got.unique_counts) != len(want["unique_counts"]):
        return counts + 1, 1.0
    gap = 0.0
    for key in ("multi_counts", "abundance"):
        a = np.asarray(getattr(got, key), np.float64)
        b = np.asarray(want[key], np.float64)
        if a.shape != b.shape:
            return counts, 1.0
        if a.size:
            gap = max(gap, float(np.abs(a - b).max()
                                 / max(float(np.abs(b).max()), 1e-30)))
    return counts, gap
