"""Packed associative-memory search: XOR + popcount agreement.

Replaces the TPU kernel ``repro/kernels/hamming_am.py::_kernel``
(launched by ``hamming_am``) with CUDA C++ for ``sm_90a``
(``csrc/hamming_am.cu``).

* What bounds it on the card: operations -- ``B * S * W`` word XOR +
  popcount + add against ``(B + S) * W * 4`` input bytes; ``__popc``
  issues at a quarter of the 32-bit integer rate.
* What the design does about it: a block owns a 64 x 64 output tile and
  walks W in 32-word chunks staged in shared memory; each thread keeps a
  4 x 4 register tile of popcount sums, so every staged word is used four
  times from registers.  B, S and W may be ragged: the edges are staged
  as zero words, and nothing is padded in device memory.

:func:`hamming_am` launches the kernel for CUDA tensors and counts the
launch in ``hamming_am.launches``; for CPU tensors it runs
:func:`hamming_am_plain`, the plain torch version of the same function.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import assoc_memory
from repro_torch.kernels import _build

#: Prototype rows one block covers (``kBN`` in the source); the grid's
#: second axis holds at most 65,535 blocks.
BLOCK_S = 64


def hamming_am_plain(q_packed: torch.Tensor, p_packed: torch.Tensor, *,
                     dim: int | None = None) -> torch.Tensor:
    """Plain torch version: ``dim - popcount(q ^ p)``, chunked over
    prototypes (the same function as ``repro.kernels.ref.hamming_am_ref``
    with ``dim`` defaulting to ``32 * W``)."""
    dim = 32 * q_packed.shape[-1] if dim is None else dim
    return assoc_memory.agreement_packed_chunked(q_packed, p_packed, dim)


def _lib():
    lib = _build.library("hamming_am")
    if not getattr(lib, "_typed", False):
        lib.hamming_am_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.hamming_am_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def _check(q, p) -> None:
    for name, t in (("q_packed", q), ("p_packed", p)):
        if t.device != q.device:
            raise ValueError(f"hamming_am: {name} is on {t.device}, "
                             f"q_packed on {q.device}")
        if t.dtype != torch.int32:
            raise ValueError(f"hamming_am: {name} must be int32 bit "
                             f"patterns, got {t.dtype}")
        if t.ndim != 2 or not t.is_contiguous():
            raise ValueError(f"hamming_am: {name} must be a contiguous "
                             f"2-d tensor, got shape {tuple(t.shape)}")
    if q.shape[1] != p.shape[1]:
        raise ValueError(f"hamming_am: q_packed {tuple(q.shape)} and "
                         f"p_packed {tuple(p.shape)} differ in W")
    if -(-p.shape[0] // BLOCK_S) > 65535:
        raise ValueError(f"hamming_am: at most {65535 * BLOCK_S} "
                         f"prototypes per launch, got {p.shape[0]}")


def hamming_am(q_packed: torch.Tensor, p_packed: torch.Tensor, *,
               dim: int | None = None) -> torch.Tensor:
    """Agreement of every packed query with every packed prototype.

    Args:
      q_packed: ``(B, W)`` int32 packed query HD vectors.
      p_packed: ``(S, W)`` int32 packed prototypes.
      dim: the logical HD dimension (defaults to ``32 * W``).

    Returns:
      ``(B, S)`` int32 ``dim - hamming(q, p)``.
    """
    if q_packed.device.type == "cpu":
        return hamming_am_plain(q_packed, p_packed, dim=dim)
    if q_packed.device.type != "cuda":
        raise ValueError(f"hamming_am: unsupported device {q_packed.device}")
    _check(q_packed, p_packed)
    (b, w), s = q_packed.shape, p_packed.shape[0]
    dim = 32 * w if dim is None else dim
    out = torch.empty((b, s), dtype=torch.int32, device=q_packed.device)
    if b == 0 or s == 0:
        return out
    with torch.cuda.device(q_packed.device):
        err = _lib().hamming_am_launch(
            *map(_build.ptr, (q_packed, p_packed, out)), b, s, w, dim,
            _build.current_stream())
    if err != 0:
        raise RuntimeError(f"hamming_am: kernel launch failed with CUDA "
                           f"error {err} (B={b}, S={s}, W={w})")
    hamming_am.launches += 1
    return out


hamming_am.launches = 0
