"""Shared k-mer machinery for the baseline profilers.

:func:`pack_kmers_t`, :func:`splitmix64_t` and :func:`read_kmer_hashes_t`
are the torch twins of ``pack_kmers``, ``splitmix64`` and
``read_kmer_hashes`` in :mod:`repro.genomics.kmers` (host side, one
sequence): they run on any device over a batch of padded reads at
once.  torch has no usable ``uint64`` (no shifts or sorting on the CPU),
so they hold each 64-bit word as the ``int64`` with the same bits: sums
and products wrap mod 2**64 exactly as ``uint64``'s do, and right shifts
are masked to be logical.  To sort or compare such words in ``uint64``
order, flip the sign bit first (:func:`order_key`).
"""

from __future__ import annotations

import torch

#: ``INT64_MIN``: the sign bit, flipped by :func:`order_key`.
SIGN = -(1 << 63)


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
    """All k-mers packed base-4 (``k <= 31``) over the last axis of
    ``(..., L)`` tokens: ``(..., L - k + 1)`` ``int64`` words (no columns
    when ``L < k``)."""
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
    """The deterministic 64-bit mix (hash) of packed k-mers on ``int64``
    words (any device)."""
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
