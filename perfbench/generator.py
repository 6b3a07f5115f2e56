"""The benchmark's one traffic and community generator, driven by data.

A vectorised copy of ``repro_torch.genomics.synth``'s recipe (the paper's
AFS databases and calibrator-sausage reads stand-ins): random reference
genomes with a homologous block spliced from the previous species, strain
SNPs between a sample's organism and its reference, and Illumina-style
reads with a per-base error rate.  Everything is drawn from one
``numpy.random.Generator`` seeded by the run's ``--seed``, in a few bulk
calls, so a 1 Gbp community is made in seconds.  Symbols are ``uint8``
(A = 4); the reads are handed to the program as ``int32``.

What differs from ``synth`` (the results are another draw of the same
distribution, not ``synth``'s bytes): substitutions are placed with
replacement (a position drawn twice is substituted once), and reads are
gathered from all strains at once.
"""

from __future__ import annotations

import numpy as np

ALPHABET = 4


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent generator for one purpose (``stream``) of a run's
    seed; seeds may exceed 32 bits."""
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), stream])


def random_symbols(rng: np.random.Generator, shape) -> np.ndarray:
    """Uniform symbols in [0, 4) as uint8, four to a random byte."""
    n = int(np.prod(shape))
    raw = rng.integers(0, 256, -(-n // 4), dtype=np.uint8)
    sym = np.empty((len(raw), 4), np.uint8)
    for k in range(4):
        np.bitwise_and(raw >> (2 * k), 3, out=sym[:, k])
    return sym.reshape(-1)[:n].reshape(shape)


def substitute(seq: np.ndarray, rate: float, rng: np.random.Generator
               ) -> None:
    """In place: i.i.d. substitutions at ``rate`` per symbol, each to one
    of the other three symbols."""
    if rate <= 0 or seq.size == 0:
        return
    flat = seq.reshape(-1)
    n = rng.binomial(flat.size, rate)
    pos = rng.integers(0, flat.size, n)
    flat[pos] = (flat[pos] + rng.integers(1, ALPHABET, n, dtype=np.uint8)) \
        % ALPHABET


def genomes(seed: int, num_species: int, genome_len: int,
            homology: float) -> np.ndarray:
    """The reference database: ``(num_species, genome_len)`` uint8.

    Species ``s > 0`` carries a block of ``homology * genome_len`` symbols
    copied from species ``s - 1`` (after that one's own splice), which is
    what makes reads multi-map.
    """
    rng = rng_for(seed, 1)
    g = random_symbols(rng, (num_species, genome_len))
    h = int(genome_len * homology)
    if h > 0:
        for s in range(1, num_species):
            src, dst = rng.integers(0, genome_len - h + 1, 2)
            g[s, dst:dst + h] = g[s - 1, src:src + h]
    return g


def strains(seed: int, refs: np.ndarray, snp_rate: float) -> np.ndarray:
    """The organisms in the samples: each reference with its strain SNPs."""
    out = refs.copy()
    substitute(out, snp_rate, rng_for(seed, 2))
    return out


def abundance(rng: np.random.Generator, num_species: int,
              present_fraction: float) -> np.ndarray:
    """A sample's profile: a random subset of the species, Dirichlet
    weights plus 0.05 each (``synth.make_sample``'s), the rest absent."""
    k = max(1, round(num_species * present_fraction))
    present = rng.choice(num_species, k, replace=False)
    ab = np.zeros(num_species)
    ab[present] = rng.dirichlet(np.ones(k)) + 0.05
    return ab / ab.sum()


def reads(rng: np.random.Generator, orgs: np.ndarray, ab: np.ndarray,
          num_reads: int, read_len: int, error_rate: float
          ) -> tuple[np.ndarray, np.ndarray]:
    """``num_reads`` reads of ``read_len`` drawn from ``orgs`` at the
    abundances ``ab``, with sequencing errors; ``(tokens int32 (R, L),
    truth int32 (R,))``."""
    num_species, glen = orgs.shape
    truth = rng.choice(num_species, num_reads, p=ab).astype(np.int32)
    start = rng.integers(0, glen - read_len + 1, num_reads)
    toks = orgs[truth[:, None], start[:, None] + np.arange(read_len)]
    substitute(toks, error_rate, rng)
    return toks.astype(np.int32), truth
