"""DNA alphabet utilities: sequences <-> int32 token arrays."""

from __future__ import annotations

import numpy as np

BASES = "ACGT"
A, C, G, T = 0, 1, 2, 3
ALPHABET_SIZE = 4

_LUT = np.full(256, 0, np.int32)
for i, b in enumerate(BASES):
    _LUT[ord(b)] = i
    _LUT[ord(b.lower())] = i
# Ambiguity code 'N' (and anything unknown) deterministically maps to A;
# the HDC encoder is robust to the induced noise (paper §2.3 robustness).

_COMP = np.array([T, G, C, A], np.int32)


def seq_to_tokens(seq: str) -> np.ndarray:
    """ASCII DNA string -> int32 tokens in [0, 4)."""
    raw = np.frombuffer(seq.encode("ascii"), np.uint8)
    return _LUT[raw]


def tokens_to_seq(tokens: np.ndarray) -> str:
    return "".join(BASES[t] for t in np.asarray(tokens))


def reverse_complement(tokens: np.ndarray) -> np.ndarray:
    return _COMP[np.asarray(tokens)[::-1]]
