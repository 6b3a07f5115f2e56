"""A frozen NumPy copy of the Threefry-2x32 draw behind the item memory.

Demeter's item memory and tie vector are ``jax.random.bits(key(seed),
shape, uint32)`` words in JAX's partitionable threefry mode (the default
from jax 0.5 on): counter ``i`` is hashed as the pair ``(0, i)`` under the
key ``(0, seed mod 2**32)`` and the word is ``out0 ^ out1``.  The block
function is Threefry-2x32 with 20 rounds, rotations (13, 15, 26, 6) /
(17, 29, 16, 24) and key-schedule parity 0x1BD11BDA (Salmon et al.,
"Parallel random numbers: as easy as 1, 2, 3", SC 2011).

Written for the benchmark's reference and kept apart from the program's
own copy, so a change there cannot move the reference with it.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(key: tuple[int, int], x0: np.ndarray, x1: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    k = [np.uint32(key[0]), np.uint32(key[1])]
    k.append(k[0] ^ k[1] ^ np.uint32(_PARITY))
    with np.errstate(over="ignore"):
        x0 = x0.astype(np.uint32) + k[0]
        x1 = x1.astype(np.uint32) + k[1]
        for step in range(5):
            for r in _ROTATIONS[step % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + k[(step + 1) % 3]
            x1 = x1 + k[(step + 2) % 3] + np.uint32(step + 1)
    return x0, x1


def random_words(seed: int, count: int) -> np.ndarray:
    """``count`` uint32 words of ``jax.random.bits(jax.random.key(seed),
    (count,), uint32)``, partitionable mode."""
    i = np.arange(count, dtype=np.uint32)
    o0, o1 = threefry2x32((0, int(seed) & 0xFFFFFFFF), np.zeros_like(i), i)
    return o0 ^ o1
