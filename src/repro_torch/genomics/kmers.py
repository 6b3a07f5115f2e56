"""Shared k-mer machinery for the baseline profilers.

The numpy functions are copies of :mod:`repro.genomics.kmers` (host side,
one sequence).  Their torch twins (:func:`pack_kmers_t`,
:func:`splitmix64_t`, :func:`read_kmer_hashes_t`) run on any device over a
batch of padded reads at once.  torch has no usable ``uint64`` (no
shifts or sorting on the CPU), so they hold each 64-bit word as the
``int64`` with the same bits: sums and products wrap mod 2**64 exactly as
``uint64``'s do, and right shifts are masked to be logical.  To sort or
compare such words in ``uint64`` order, flip the sign bit first
(:func:`order_key`).
"""

from __future__ import annotations

import numpy as np
import torch

#: ``INT64_MIN``: the sign bit, flipped by :func:`order_key`.
SIGN = -(1 << 63)


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


def as_int64(value: int) -> int:
    """A ``uint64`` value as the Python int of the ``int64`` with the same
    bits."""
    value &= (1 << 64) - 1
    return value - (1 << 64) if value >= 1 << 63 else value


def order_key(h: torch.Tensor) -> torch.Tensor:
    """``int64`` words -> keys whose signed order is the words' ``uint64``
    order (the sign bit flipped; its own inverse)."""
    return h ^ SIGN


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of ``int64`` words (torch's ``>>`` is
    arithmetic)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def pack_kmers_t(tokens: torch.Tensor, k: int) -> torch.Tensor:
    """:func:`pack_kmers` over the last axis of ``(..., L)`` tokens:
    ``(..., L - k + 1)`` ``int64`` words (no columns when ``L < k``)."""
    if k > 31:
        raise ValueError("k must be <= 31 to fit uint64")
    t = tokens.to(torch.int64)
    n = t.shape[-1] - k + 1
    if n <= 0:
        return t.new_zeros(t.shape[:-1] + (0,))
    out = t[..., :n].clone()
    for j in range(1, k):
        out += t[..., j:j + n] * (4 ** j)
    return out


def splitmix64_t(x: torch.Tensor) -> torch.Tensor:
    """:func:`splitmix64` on ``int64`` words (any device)."""
    x = x + as_int64(0x9E3779B97F4A7C15)
    x = (x ^ _shr(x, 30)) * as_int64(0xBF58476D1CE4E5B9)
    x = (x ^ _shr(x, 27)) * as_int64(0x94D049BB133111EB)
    return x ^ _shr(x, 31)


def read_kmer_hashes_t(tokens: torch.Tensor, lengths: torch.Tensor, k: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Hashes of every k-mer of ``(R, L)`` padded reads: ``(R, L - k + 1)``
    ``int64`` words and the mask of those that lie inside their read
    (k-mer ``j`` of read ``i`` is real iff ``j + k <= lengths[i]``)."""
    h = splitmix64_t(pack_kmers_t(tokens, k))
    j = torch.arange(h.shape[-1], device=h.device)
    valid = j[None, :] + k <= lengths.to(h.device)[:, None].to(torch.int64)
    return h, valid
