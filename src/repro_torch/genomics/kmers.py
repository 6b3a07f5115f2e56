"""Shared k-mer machinery for the baseline profilers (numpy, host-side)."""

from __future__ import annotations

import numpy as np


def pack_kmers(tokens: np.ndarray, k: int) -> np.ndarray:
    """All k-mers of a token sequence packed base-4 into uint64 (k <= 31)."""
    if k > 31:
        raise ValueError("k must be <= 31 to fit uint64")
    t = np.asarray(tokens, np.uint64)
    if len(t) < k:
        return np.empty(0, np.uint64)
    win = np.lib.stride_tricks.sliding_window_view(t, k)
    weights = (np.uint64(4) ** np.arange(k, dtype=np.uint64))
    return (win * weights[None, :]).sum(axis=1, dtype=np.uint64)


def splitmix64(x: np.ndarray) -> np.ndarray:
    """Deterministic 64-bit mix (hash) of packed k-mers."""
    x = np.asarray(x, np.uint64).copy()
    x += np.uint64(0x9E3779B97F4A7C15)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def read_kmer_hashes(tokens: np.ndarray, length: int, k: int) -> np.ndarray:
    """Hashes of the k-mers of one (possibly padded) read."""
    return splitmix64(pack_kmers(tokens[:length], k))
