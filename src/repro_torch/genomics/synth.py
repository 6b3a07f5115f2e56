"""Synthetic food-community generator (reference genomes + sample reads).

Stands in for the AFS20/AFS31 reference databases and the PRJEB34001 /
PRJNA271645 calibrator-sausage samples used by the paper, which are not
available offline.  The generator reproduces the properties that matter
for profiling difficulty:

* a set of reference genomes, optionally with *homologous* shared regions
  between related species (drives multi-mapped reads, the case that
  distinguishes Demeter's step 4/5 from winner-take-all HDC);
* strain-level divergence (SNP rate vs the reference) between the sampled
  organism and its reference genome;
* Illumina-style short reads with a per-base error rate and a ground-truth
  abundance profile.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class CommunitySpec:
    """Knobs for the synthetic community."""
    num_species: int = 8
    genome_len: int = 100_000
    homology_fraction: float = 0.05   # fraction of genome shared with a sibling
    strain_snp_rate: float = 0.002    # divergence sample-vs-reference
    read_len: int = 150
    read_error_rate: float = 0.002    # sequencing error per base
    seed: int = 7


def make_reference_genomes(spec: CommunitySpec) -> dict[str, np.ndarray]:
    """Generate the reference database (the AFS analogue)."""
    rng = np.random.default_rng(spec.seed)
    genomes: dict[str, np.ndarray] = {}
    prev: np.ndarray | None = None
    for s in range(spec.num_species):
        g = rng.integers(0, 4, spec.genome_len, dtype=np.int32)
        if prev is not None and spec.homology_fraction > 0:
            # Splice a shared block from the previous species (homology).
            h = int(spec.genome_len * spec.homology_fraction)
            if h > 0:
                src = rng.integers(0, spec.genome_len - h + 1)
                dst = rng.integers(0, spec.genome_len - h + 1)
                g[dst:dst + h] = prev[src:src + h]
        genomes[f"species_{s:02d}"] = g
        prev = g
    return genomes


def mutate(genome: np.ndarray, snp_rate: float, rng: np.random.Generator
           ) -> np.ndarray:
    """Apply i.i.d. substitutions (strain divergence / sequencing error)."""
    if snp_rate <= 0:
        return genome
    g = genome.copy()
    n_mut = rng.binomial(len(g), snp_rate)
    pos = rng.choice(len(g), size=n_mut, replace=False)
    g[pos] = (g[pos] + rng.integers(1, 4, n_mut)) % 4
    return g


def sample_reads(genomes: dict[str, np.ndarray], abundance: np.ndarray,
                 num_reads: int, spec: CommunitySpec,
                 rng: np.random.Generator | None = None
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Draw reads from the community with the given abundance profile.

    Returns:
      tokens:  (num_reads, read_len) int32
      lengths: (num_reads,) int32 (all == read_len)
      truth:   (num_reads,) int32 ground-truth species index
    """
    rng = rng or np.random.default_rng(spec.seed + 1)
    names = list(genomes.keys())
    abundance = np.asarray(abundance, np.float64)
    abundance = abundance / abundance.sum()
    strains = {n: mutate(genomes[n], spec.strain_snp_rate, rng) for n in names}

    truth = rng.choice(len(names), size=num_reads, p=abundance).astype(np.int32)
    tokens = np.empty((num_reads, spec.read_len), np.int32)
    for i, s in enumerate(truth):
        g = strains[names[s]]
        start = rng.integers(0, len(g) - spec.read_len + 1)
        read = g[start:start + spec.read_len]
        tokens[i] = mutate(read, spec.read_error_rate, rng)
    lengths = np.full(num_reads, spec.read_len, np.int32)
    return tokens, lengths, truth


def make_sample(spec: CommunitySpec, num_reads: int,
                present: list[int] | None = None,
                ) -> tuple[dict[str, np.ndarray], np.ndarray, np.ndarray,
                           np.ndarray, np.ndarray]:
    """Convenience: genomes + a food sample where only ``present`` species occur.

    Returns (genomes, tokens, lengths, truth, true_abundance). Absent
    species have zero abundance — the profiler must not report them
    (precision) and must find every present one (recall).
    """
    rng = np.random.default_rng(spec.seed + 2)
    genomes = make_reference_genomes(spec)
    s = spec.num_species
    present = present if present is not None else list(range(0, s, 2))
    ab = np.zeros(s)
    ab[present] = rng.dirichlet(np.ones(len(present))) + 0.05
    ab = ab / ab.sum()
    tokens, lengths, truth = sample_reads(genomes, ab, num_reads, spec, rng)
    return genomes, tokens, lengths, truth, ab
