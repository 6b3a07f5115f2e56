"""Threefry-2x32 and the ``jax.random`` paths ``repro`` takes.

``repro`` draws its item memory and tie-break vector from
``jax.random.key(seed)`` through ``jax.random.bits`` (density 0.5) or
``jax.random.uniform`` (any other density), and its device model
(``repro.accel``) draws programming noise, fault maps and read noise
through ``fold_in``, ``split``, ``uniform`` and ``normal``.  The port must
reproduce those draws, or it could neither query a RefDB that ``repro``
built nor simulate the device ``repro`` simulates.

One implementation does the arithmetic, in torch on ``int64`` tensors
holding 32-bit words (any device; the plain versions of the Threefry
kernel, :mod:`repro_torch.kernels.threefry`), each function drawing one
row of ``m`` values for each of ``N`` keys:

* :func:`threefry2x32_t` -- the 20-round Threefry-2x32 block function with
  rotations ``(13, 15, 26, 6)`` / ``(17, 29, 16, 24)`` and key-schedule
  parity ``0x1BD11BDA``;
* :func:`bits_rows`, :func:`uniform_rows`, :func:`normal_rows`, and
  :func:`erf_inv` (XLA's float32 ``ErfInv``).

The key-level functions run it on the host and hand back numpy: a key is
a pair of ``uint32`` words, draws are ``uint32`` or ``float32`` arrays.

* :func:`key` -- ``jax.random.key(seed)`` under JAX's default 32-bit
  mode: the key words are ``(0, seed mod 2**32)``;
* :func:`fold_in` -- ``jax.random.fold_in(key, data)``: the key is the
  Threefry pair of the counters ``(0, data)``;
* :func:`split` -- ``jax.random.split(key, num)``;
* :func:`random_bits` -- ``jax.random.bits(key, shape, uint32)``;
* :func:`uniform` -- ``jax.random.uniform(key, shape, float32, minval,
  maxval)``;
* :func:`normal` -- ``jax.random.normal(key, shape, float32)``.

Bits and uniforms are exact.  ``normal`` is ``sqrt(2) * erf_inv(u)`` with
``u = uniform(key, shape, nextafter(-1, 0), 1)``, and ``erf_inv`` is
Giles' single-precision polynomial as XLA writes it (``w = -log1p(-x
x)``, two branches split at ``w < 5``, Horner steps as fused
multiply-adds).  Here each fused step is computed in float64 and rounded
once to float32, and ``log1p`` is the host's or the card's, not XLA's,
so a normal may differ from ``jax.random.normal``'s by a few ulp
(``tests/test_torch_random.py`` states the measured gap).

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
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_M32 = 0xFFFFFFFF

#: ``jax_threefry_partitionable``'s default from jax 0.5 on.
PARTITIONABLE = True


def key(seed: int) -> tuple[np.uint32, np.uint32]:
    """The key words of ``jax.random.key(seed)`` (default 32-bit mode)."""
    return np.uint32(0), np.uint32(int(seed) & _M32)


def _hash(k, x0, x1):
    """:func:`threefry2x32_t` of the counters (ints or ``int64`` tensors)
    under the key pair ``k``."""
    return threefry2x32_t(int(k[0]) & _M32, int(k[1]) & _M32, x0, x1)


def _row(draw, k, shape: tuple[int, ...], **kw) -> np.ndarray:
    """One row of ``draw`` (:func:`bits_rows` and kin) under the key pair
    ``k``, shaped ``shape``."""
    size = int(np.prod(shape, dtype=np.int64))
    keys = torch.tensor([[int(k[0]), int(k[1])]], dtype=torch.int64)
    return draw(keys, size, **kw)[0].numpy().reshape(shape)


def random_bits(k: tuple[np.uint32, np.uint32], shape: tuple[int, ...], *,
                partitionable: bool = PARTITIONABLE) -> np.ndarray:
    """``jax.random.bits(key, shape, dtype=uint32)`` as numpy ``uint32``."""
    return _row(bits_rows, k, shape,
                partitionable=partitionable).astype(np.uint32)


def fold_in(k: tuple[np.uint32, np.uint32], data: int
            ) -> tuple[np.uint32, np.uint32]:
    """``jax.random.fold_in(key, data)`` (``data`` taken mod ``2**32``).

    The same in both threefry modes: jax hashes the counter pair
    ``(0, data)`` (``threefry_seed(data)``) under ``key``.
    """
    o0, o1 = _hash(k, 0, int(data) & _M32)
    return np.uint32(o0), np.uint32(o1)


def split(k: tuple[np.uint32, np.uint32], num: int, *,
          partitionable: bool = PARTITIONABLE) -> np.ndarray:
    """``jax.random.split(key, num)`` as a ``(num, 2)`` uint32 array.

    Partitionable: key ``i`` is the pair hashed from the counters
    ``(0, i)``.  Original: the counters ``0 .. 2 num - 1`` are hashed as
    the halves ``(i, num + i)`` and the words ``concat(out0, out1)`` are
    read off two at a time.
    """
    i = torch.arange(num, dtype=torch.int64)
    if partitionable:
        o = torch.stack(_hash(k, torch.zeros_like(i), i), dim=1)
    else:
        o = torch.cat(_hash(k, i, i + num)).reshape(num, 2)
    return o.numpy().astype(np.uint32)


def uniform(k: tuple[np.uint32, np.uint32], shape: tuple[int, ...], *,
            minval: float = 0.0, maxval: float = 1.0,
            partitionable: bool = PARTITIONABLE) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``:
    ``max(minval, floats * (maxval - minval) + minval)`` in float32, the
    multiply-add fused as XLA fuses it (see :func:`uniform_rows`)."""
    return _row(uniform_rows, k, shape, minval=minval, maxval=maxval,
                partitionable=partitionable)


def normal(k: tuple[np.uint32, np.uint32], shape: tuple[int, ...], *,
           partitionable: bool = PARTITIONABLE) -> np.ndarray:
    """``jax.random.normal(key, shape, float32)`` (within a few ulp; see
    the module note)."""
    return _row(normal_rows, k, shape, partitionable=partitionable)


# -- torch: N independent rows, one per key (the kernel's plain version) -----

#: ``nextafter(-1, 0)`` in float32: the low end of ``normal``'s uniforms.
NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
SQRT2_F32 = float(np.float32(np.sqrt(2.0)))
#: XLA's ``ErfInv`` (float32) coefficients, highest degree first: for
#: ``w < 5`` on ``w - 2.5``, else on ``sqrt(w) - 3``.
ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                -4.39150654e-06, 0.00021858087, -0.00125372503,
                -0.00417768164, 0.246640727, 1.50140941)
ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                -0.00367342844, 0.00573950773, -0.0076224613,
                0.00943887047, 1.00167406, 2.83297682)


def _rotl_t(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _M32


def threefry2x32_t(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                   x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 (20 rounds) of the counter pairs ``(x0, x1)``: 32-bit
    words held in ``int64`` tensors, broadcast together, or in Python ints
    (one pair, as :func:`fold_in` hashes it)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    for step in range(5):
        for r in _ROTATIONS[step % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl_t(x1, r) ^ x0
        x0 = (x0 + ks[(step + 1) % 3]) & _M32
        x1 = (x1 + ks[(step + 2) % 3] + (step + 1)) & _M32
    return x0, x1


def bits_rows(keys: torch.Tensor, m: int, *,
              partitionable: bool = PARTITIONABLE) -> torch.Tensor:
    """``jax.random.bits(key_i, (m,), uint32)`` for each of the ``(N, 2)``
    keys: an ``(N, m)`` ``int64`` tensor of words in ``[0, 2**32)``, on
    the keys' device."""
    if m >= 2 ** 32:
        raise NotImplementedError("more than 2**32 random words a key")
    keys = keys.to(torch.int64) & _M32
    k0, k1 = keys[:, :1], keys[:, 1:]
    dev = keys.device
    if partitionable:
        lo = torch.arange(m, dtype=torch.int64, device=dev)[None, :]
        b0, b1 = threefry2x32_t(k0, k1, torch.zeros_like(lo), lo)
        return b0 ^ b1
    half = (m + 1) // 2
    x0 = torch.arange(half, dtype=torch.int64, device=dev)
    x1 = x0 + half
    x1 = torch.where(x1 < m, x1, 0)[None, :]      # odd m: one zero counter
    b0, b1 = threefry2x32_t(k0, k1, x0[None, :], x1)
    return torch.cat([b0, b1], dim=1)[:, :m]


def uniform_rows(keys: torch.Tensor, m: int, *, minval: float = 0.0,
                 maxval: float = 1.0,
                 partitionable: bool = PARTITIONABLE) -> torch.Tensor:
    """``jax.random.uniform(key_i, (m,), float32, minval, maxval)`` for
    each key: ``(N, m)`` float32.

    ``floats * (maxval - minval) + minval`` is one fused multiply-add, as
    XLA compiles it on the host (an unfused product differs in the last
    bit for ranges that are not powers of two).  At the default
    ``[0, 1)`` and at ``normal``'s range of exactly 2 the product is exact
    and the two agree.
    """
    bits = bits_rows(keys, m, partitionable=partitionable)
    lo, hi = np.float32(minval), np.float32(maxval)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(
        torch.float32) - 1.0
    floats = _fma_f32(floats, float(hi - lo), float(lo))
    return torch.clamp_min(floats, float(lo))


def _fma_f32(a: torch.Tensor, b, c: float) -> torch.Tensor:
    """``fmaf(a, b, c)`` for float32 ``a``, ``b`` (a tensor or a float32
    value) and ``c``: the product is exact in float64, so one rounding of
    the float64 sum to float32 is the fused result (but for the rare sum
    that float64 rounds onto a float32 halfway point)."""
    b = b.double() if isinstance(b, torch.Tensor) else float(np.float32(b))
    return (a.double() * b + float(np.float32(c))).float()


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``ErfInv``: Giles' polynomial, ``w = -log1p(-x x)``,
    ``w < 5`` on ``w - 2.5``, else on ``sqrt(w) - 3``; ``+-inf`` at
    ``+-1``."""
    w = -torch.log1p(-x * x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(small, ERFINV_SMALL[0], ERFINV_LARGE[0]).to(torch.float32)
    for cs, cl in zip(ERFINV_SMALL[1:], ERFINV_LARGE[1:]):
        p = torch.where(small, _fma_f32(p, w, cs), _fma_f32(p, w, cl))
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal_rows(keys: torch.Tensor, m: int, *,
                partitionable: bool = PARTITIONABLE) -> torch.Tensor:
    """``jax.random.normal(key_i, (m,), float32)`` for each key: ``(N, m)``
    float32, ``sqrt(2) * erf_inv(uniform(key, lo=nextafter(-1, 0),
    hi=1))``."""
    u = uniform_rows(keys, m, minval=NORMAL_LO, maxval=1.0,
                     partitionable=partitionable)
    return SQRT2_F32 * erf_inv(u)
