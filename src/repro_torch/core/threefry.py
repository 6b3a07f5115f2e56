"""Threefry-2x32 and the two ``jax.random`` paths the item memory takes.

``repro`` draws its item memory and tie-break vector from
``jax.random.key(seed)`` through ``jax.random.bits`` (density 0.5) or
``jax.random.uniform`` (any other density).  The port must reproduce
those words exactly, or it could neither query a RefDB that ``repro``
built nor build one ``repro`` can query.  This module re-implements that
arithmetic in numpy ``uint32`` (wrapping arithmetic, host side; the item
memory is a few KB):

* :func:`threefry2x32` -- the 20-round Threefry-2x32 block function with
  rotations ``(13, 15, 26, 6)`` / ``(17, 29, 16, 24)`` and key-schedule
  parity ``0x1BD11BDA``;
* :func:`key` -- ``jax.random.key(seed)`` under JAX's default 32-bit
  mode: the key words are ``(0, seed mod 2**32)``;
* :func:`random_bits` -- ``jax.random.bits(key, shape, uint32)``;
* :func:`uniform` -- ``jax.random.uniform(key, shape, float32)``.

Which words ``random_bits`` yields depends on JAX's
``jax_threefry_partitionable`` flag (True from jax 0.5 on, False on the
0.4 line), so both modes are implemented:

* partitionable: counter ``i`` (the flat index) is hashed as the pair
  ``(hi32(i), lo32(i))`` and the word is ``out0 ^ out1``;
* original: counters ``0 .. size-1`` are split in two halves that form
  the pairs, and the word sequence is ``concat(out0, out1)``.

The partitionable mode is the default, as in current JAX; a session
takes its mode from ``ProfilerConfig.threefry_partitionable``.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)

#: ``jax_threefry_partitionable``'s default from jax 0.5 on.
PARTITIONABLE = True


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(k0, k1, x0: np.ndarray, x1: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 (20 rounds) of the counter pairs ``(x0, x1)``."""
    ks = (np.uint32(k0), np.uint32(k1),
          np.uint32(k0) ^ np.uint32(k1) ^ _PARITY)
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for step in range(5):
        for r in _ROTATIONS[step % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(step + 1) % 3]
        x1 = x1 + ks[(step + 2) % 3] + np.uint32(step + 1)
    return x0, x1


def key(seed: int) -> tuple[np.uint32, np.uint32]:
    """The key words of ``jax.random.key(seed)`` (default 32-bit mode)."""
    return np.uint32(0), np.uint32(int(seed) & 0xFFFFFFFF)


def random_bits(k: tuple[np.uint32, np.uint32], shape: tuple[int, ...], *,
                partitionable: bool = PARTITIONABLE) -> np.ndarray:
    """``jax.random.bits(key, shape, dtype=uint32)`` as numpy ``uint32``."""
    size = int(np.prod(shape, dtype=np.int64))
    if size >= 2 ** 32:
        raise NotImplementedError("more than 2**32 random words")
    with np.errstate(over="ignore"):
        if partitionable:
            lo = np.arange(size, dtype=np.uint32)
            b0, b1 = threefry2x32(k[0], k[1], np.zeros_like(lo), lo)
            return (b0 ^ b1).reshape(shape)
        counts = np.arange(size + (size % 2), dtype=np.uint32)
        counts[size:] = 0                  # odd sizes pad one zero counter
        half = len(counts) // 2
        b0, b1 = threefry2x32(k[0], k[1], counts[:half], counts[half:])
        return np.concatenate([b0, b1])[:size].reshape(shape)


def uniform(k: tuple[np.uint32, np.uint32], shape: tuple[int, ...], *,
            partitionable: bool = PARTITIONABLE) -> np.ndarray:
    """``jax.random.uniform(key, shape)`` (float32 in ``[0, 1)``).

    The 23 high bits of each random word become the mantissa of a float
    in ``[1, 2)``, from which 1 is subtracted -- JAX's construction.
    """
    bits = random_bits(k, shape, partitionable=partitionable)
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
    return np.maximum(np.float32(0.0), floats - np.float32(1.0))
