"""Profiling output: :class:`ProfileReport` and its streaming accumulator.

Counterpart of :mod:`repro.pipeline.report` (numpy only, so the two
packages' reports compare with ``to_dict()``).

Step 5 of the pipeline (abundance estimation) is exact-streaming: unique
counts accumulate online, multi-read hit masks are retained compactly
(packed bits) and split once at the end with the *global* unique-coverage
rates.  :class:`ProfileAccumulator` owns that state so any driver — the
:class:`~repro_torch.pipeline.session.ProfilingSession` facade, a serving loop,
a future sharded reducer — can feed it batch classifications and finalize
once.

This module is dependency-light (numpy only) on purpose.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np


@dataclasses.dataclass(frozen=True)
class ProfileReport:
    """Final output of a profiling run."""
    species_names: tuple[str, ...]
    abundance: np.ndarray          # (S,) relative abundance over mapped reads
    unique_counts: np.ndarray      # (S,)
    multi_counts: np.ndarray       # (S,) fractional
    total_reads: int
    unmapped_reads: int
    multi_reads: int

    def top(self, k: int = 10) -> list[tuple[str, float]]:
        order = np.argsort(-self.abundance)[:k]
        return [(self.species_names[i], float(self.abundance[i])) for i in order]

    # -- derived abundance summary (core.abundance semantics) ---------------
    @property
    def mapped_reads(self) -> int:
        return self.total_reads - self.unmapped_reads

    @property
    def unmapped_fraction(self) -> float:
        """Fraction of reads the AM search mapped to no species."""
        return self.unmapped_reads / self.total_reads if self.total_reads \
            else 0.0

    @property
    def multi_fraction(self) -> float:
        """Fraction of reads that hit more than one species (split in
        phase 2 by :func:`repro_torch.core.abundance.split_multi_counts`)."""
        return self.multi_reads / self.total_reads if self.total_reads \
            else 0.0

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> dict:
        """JSON-primitive dict: the machine-readable run artifact shared by
        ``profile_run --json`` and ``ProfilingService`` report snapshots.

        ``mapped_reads`` / ``unmapped_fraction`` / ``multi_fraction`` are
        derived from the stored counts — :meth:`from_dict` recomputes
        rather than trusts them, so the round-trip stays exact.
        """
        return {
            "species_names": list(self.species_names),
            "abundance": [float(x) for x in self.abundance],
            "unique_counts": [int(x) for x in self.unique_counts],
            "multi_counts": [float(x) for x in self.multi_counts],
            "total_reads": int(self.total_reads),
            "unmapped_reads": int(self.unmapped_reads),
            "multi_reads": int(self.multi_reads),
            "mapped_reads": int(self.mapped_reads),
            "unmapped_fraction": float(self.unmapped_fraction),
            "multi_fraction": float(self.multi_fraction),
        }

    def to_json(self, indent: int | None = None) -> str:
        return json.dumps(self.to_dict(), sort_keys=True, indent=indent)

    @classmethod
    def from_dict(cls, d: dict) -> "ProfileReport":
        return cls(
            species_names=tuple(d["species_names"]),
            abundance=np.asarray(d["abundance"], np.float64),
            unique_counts=np.asarray(d["unique_counts"], np.int64),
            multi_counts=np.asarray(d["multi_counts"], np.float64),
            total_reads=int(d["total_reads"]),
            unmapped_reads=int(d["unmapped_reads"]),
            multi_reads=int(d["multi_reads"]),
        )

    @classmethod
    def from_json(cls, s: str) -> "ProfileReport":
        return cls.from_dict(json.loads(s))


class ProfileAccumulator:
    """Streaming abundance estimation (paper step 5) over read batches.

    ``add`` ingests the per-read hit mask and category of one batch;
    ``finalize`` performs the single end-of-stream pass that splits
    multi-mapped reads with the global unique-coverage rates.
    """

    UNMAPPED, UNIQUE, MULTI = 0, 1, 2

    def __init__(self, num_species: int):
        self.num_species = num_species
        self.unique_counts = np.zeros(num_species, np.int64)
        self._multi_hit_rows: list[np.ndarray] = []
        self.total_reads = 0
        self.unmapped_reads = 0
        self.multi_reads = 0

    def add(self, hits: np.ndarray, category: np.ndarray) -> None:
        """Ingest one batch: ``hits (R, S)`` bool, ``category (R,)`` int."""
        hits = np.asarray(hits)
        cat = np.asarray(category)
        self.total_reads += len(cat)
        self.unmapped_reads += int((cat == self.UNMAPPED).sum())
        uniq = hits[cat == self.UNIQUE]
        if len(uniq):
            self.unique_counts += uniq.sum(axis=0)
        m = hits[cat == self.MULTI]
        if len(m):
            self._multi_hit_rows.append(np.packbits(m, axis=-1))
            self.multi_reads += len(m)

    def finalize(self, genome_lengths: np.ndarray,
                 species_names: tuple[str, ...]) -> ProfileReport:
        """Split multi-mapped reads with the global unique rates and report.

        Non-destructive: may be called repeatedly as the stream grows (the
        serving layer snapshots in-flight requests this way).  All retained
        multi-read rows are concatenated into one pass so the result
        depends only on the multi reads and their order — never on how the
        stream happened to be cut into batches (a service interleaving a
        request's reads into shared cohorts reproduces a sequential run's
        report bit-for-bit).
        """
        from repro_torch.core.abundance import split_multi_counts

        s = self.num_species
        multi_counts = np.zeros(s, np.float64)
        if self._multi_hit_rows:
            packed = np.concatenate(self._multi_hit_rows, axis=0)
            m = np.unpackbits(packed, axis=-1, count=s).astype(bool)
            multi_counts = split_multi_counts(self.unique_counts, m,
                                              genome_lengths)

        mapped = self.unique_counts + multi_counts
        denom = max(mapped.sum(), 1e-30)
        return ProfileReport(
            species_names=tuple(species_names),
            abundance=(mapped / denom).astype(np.float64),
            unique_counts=self.unique_counts.astype(np.int64),
            multi_counts=multi_counts,
            total_reads=self.total_reads,
            unmapped_reads=self.unmapped_reads,
            multi_reads=self.multi_reads,
        )
