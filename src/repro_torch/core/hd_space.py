"""Step 1 of Demeter: definition of the hyperdimensional space.

Counterpart of :mod:`repro.core.hd_space`; :meth:`HDSpace.fingerprint`
gives the same string, so RefDB cache keys agree across the packages.

The paper fixes the HD space in four stages (dimension+sparsity, atomic
vectors, encoding mechanism, similarity metric+threshold).  ``HDSpace`` is
the immutable record of those choices; everything downstream (encoder,
associative memory, classifier, kernels) takes it as input, so a profile
run is reproducible from the config alone.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Literal

from repro_torch.core import bitops

SimilarityMetric = Literal["hamming", "dot"]
Encoding = Literal["ngram"]


@dataclasses.dataclass(frozen=True)
class HDSpace:
    """Immutable HD-space configuration (paper Fig. 1, step 1).

    Attributes:
      dim: HD dimensionality D. The paper's sweet spot is 40,000; we default
        to 40,960 (= 1280 uint32 words, 128-lane aligned) for TPU layouts.
      ngram: N of the N-gram encoder (k-mer length in DNA terms).
      alphabet_size: number of atomic item-memory vectors (4 for DNA).
      density: expected bit density of atomic vectors (0.5 = paper's DDR).
      metric: similarity metric for step 4.
      z_threshold: classification threshold in standard deviations above
        the random-agreement mean D/2 (sigma = sqrt(D)/2 for hamming
        agreement between random vectors). Using sigma units makes T
        transferable across D; the absolute paper-style threshold is
        ``threshold_bits``.
      seed: base PRNG seed; item memory and tie-break vectors derive
        deterministically from it.
    """

    dim: int = 40960
    ngram: int = 16
    alphabet_size: int = 4
    density: float = 0.5
    encoding: Encoding = "ngram"
    metric: SimilarityMetric = "hamming"
    z_threshold: float = 4.0
    seed: int = 0x5EED

    def __post_init__(self) -> None:
        bitops.num_words(self.dim)  # validates dim % 32 == 0
        if self.ngram < 1:
            raise ValueError("ngram must be >= 1")
        if self.ngram > self.num_words:
            raise ValueError(
                f"ngram={self.ngram} exceeds the number of words {self.num_words}; "
                "the word-roll permutation would alias")
        if not 0.0 < self.density < 1.0:
            raise ValueError("density must be in (0, 1)")

    @property
    def num_words(self) -> int:
        return bitops.num_words(self.dim)

    @property
    def mean_agreement(self) -> float:
        """Expected agreement (matching bits) of two random HD vectors."""
        return self.dim / 2.0

    @property
    def sigma_agreement(self) -> float:
        """Std-dev of the agreement between two random HD vectors."""
        return (self.dim ** 0.5) / 2.0

    @property
    def threshold_bits(self) -> float:
        """Absolute agreement threshold T (paper Eq. 2) implied by z_threshold."""
        return self.mean_agreement + self.z_threshold * self.sigma_agreement

    def fingerprint(self) -> str:
        """Stable hash identifying the space (used to key RefDB artifacts)."""
        payload = json.dumps(dataclasses.asdict(self), sort_keys=True)
        return hashlib.sha256(payload.encode()).hexdigest()[:16]
