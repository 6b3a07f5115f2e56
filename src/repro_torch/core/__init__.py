"""Demeter core on torch: the counterparts of :mod:`repro.core`.

  1. HD space        -> hd_space.HDSpace
  2. HD-RefDB build  -> assoc_memory.build_refdb
  3. read conversion -> encoder.encode
  4. classification  -> classifier.from_agreement
  5. abundance       -> abundance.split_multi_counts

``threefry`` reproduces the ``jax.random`` draws of the item memory.
"""

from repro_torch.core.hd_space import HDSpace
from repro_torch.core.assoc_memory import RefDB, RefDBBuilder, build_refdb
from repro_torch.core.classifier import (MULTI, NO_SCORE, UNIQUE, UNMAPPED,
                                         ReadClassification, from_agreement,
                                         from_scores, merge_scores,
                                         partial_scores)

__all__ = [
    "HDSpace", "RefDB", "RefDBBuilder", "build_refdb", "ReadClassification",
    "from_agreement", "from_scores", "merge_scores", "partial_scores",
    "NO_SCORE", "UNMAPPED", "UNIQUE", "MULTI",
]
