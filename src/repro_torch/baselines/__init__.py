"""Baseline profilers the paper compares against (software reproductions).

Counterpart of :mod:`repro.baselines`: Kraken2Like (exact k-mer votes),
MetaCacheLike (windowed minhash), ClarkLike (discriminative k-mers), plus
Bracken-style abundance redistribution.  All share the
``classify_reads() -> (hits, category)`` contract, with ``repro``'s
results bit for bit; here the tables live on the device and every read of
a batch is classified in one pass.
"""

from repro_torch.baselines.kraken2_like import Kraken2Like
from repro_torch.baselines.metacache_like import MetaCacheLike
from repro_torch.baselines.clark_like import ClarkLike
from repro_torch.baselines import bracken_like

__all__ = ["Kraken2Like", "MetaCacheLike", "ClarkLike", "bracken_like"]
