"""Packed-bit utilities for binary hyperdimensional vectors (torch).

Counterpart of :mod:`repro.core.bitops`.  A binary HD vector of dimension
``D`` (``D % 32 == 0``) is stored as ``W = D // 32`` words, LSB-first
within each word: bit ``d`` lives at ``words[d // 32] >> (d % 32) & 1``.

The words are ``int32`` tensors carrying the bit patterns of ``repro``'s
``uint32`` words, because torch's CPU ``uint32`` has no right shift and no
comparisons.  Bit ``k`` is ``(w >> k) & 1``: the arithmetic shift only
copies the sign bit into bits the ``& 1`` drops.  Torch has no popcount
op, so :func:`popcount_words` counts with SWAR arithmetic in ``int64``.

``rho`` (the HDC permutation) rotates whole words, as in ``repro``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import threefry

WORD_BITS = 32


def num_words(dim: int) -> int:
    """Number of 32-bit words holding a ``dim``-bit HD vector."""
    if dim % WORD_BITS != 0:
        raise ValueError(f"HD dimension must be a multiple of {WORD_BITS}, got {dim}")
    return dim // WORD_BITS


def pad_to_multiple(x: torch.Tensor, axis: int, multiple: int,
                    fill=0) -> torch.Tensor:
    """Pad ``x`` along ``axis`` up to the next multiple of ``multiple``."""
    axis = axis % x.ndim
    pad = (-x.shape[axis]) % multiple
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_full(shape, fill)], dim=axis)


def to_int32_words(x: torch.Tensor) -> torch.Tensor:
    """Values in ``[0, 2**32)`` (any integer dtype) -> int32 bit patterns."""
    x = x.to(torch.int64)
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack ``(..., D)`` {0,1} bits into ``(..., D//32)`` int32 words."""
    d = bits.shape[-1]
    w = num_words(d)
    grouped = bits.to(torch.int64).reshape(*bits.shape[:-1], w, WORD_BITS)
    weights = torch.ones(WORD_BITS, dtype=torch.int64, device=bits.device) \
        << torch.arange(WORD_BITS, device=bits.device)
    return to_int32_words((grouped * weights).sum(dim=-1))


def unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """Unpack ``(..., W)`` int32 words into ``(..., W*32)`` uint8 bits."""
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=words.device)
    bits = (words.to(torch.int32)[..., None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1],
                        words.shape[-1] * WORD_BITS).to(torch.uint8)


def popcount32(words: torch.Tensor) -> torch.Tensor:
    """Per-word set-bit count of int32 bit patterns -> int64 (SWAR)."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def popcount_words(words: torch.Tensor) -> torch.Tensor:
    """Total number of set bits along the trailing word axis -> int32."""
    return popcount32(words).sum(dim=-1).to(torch.int32)


def rho(words: torch.Tensor, k: int = 1) -> torch.Tensor:
    """Apply the HDC permutation ``rho**k`` (rotate by ``k`` words)."""
    return torch.roll(words, k, dims=-1)


def random_packed(k, shape: tuple[int, ...], dim: int, density: float = 0.5,
                  *, partitionable: bool | None = None,
                  device: str | torch.device = "cpu") -> torch.Tensor:
    """Random packed HD vectors with the given bit density.

    ``k`` is a :func:`repro_torch.core.threefry.key`.  ``density == 0.5``
    uses raw PRNG words; other densities threshold per-bit float32
    uniforms and pack -- the same draws as ``repro.core.bitops``.
    ``partitionable=None`` takes :data:`threefry.PARTITIONABLE`.
    """
    if partitionable is None:
        partitionable = threefry.PARTITIONABLE
    w = num_words(dim)
    if density == 0.5:
        words = threefry.random_bits(k, shape + (w,),
                                     partitionable=partitionable)
        return torch.from_numpy(words.view(np.int32).copy()).to(device)
    u = threefry.uniform(k, shape + (dim,), partitionable=partitionable)
    bits = torch.from_numpy((u < np.float32(density)).astype(np.uint8))
    return pack_bits(bits).to(device)
