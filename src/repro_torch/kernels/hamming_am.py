"""Packed associative-memory search on the tensor cores.

Replaces the TPU kernel ``repro/kernels/hamming_am.py::_kernel``
(launched by ``hamming_am``) with CUDA C++ for ``sm_90a``
(``csrc/hamming_am.cu``): ``agreement = dim - popcount(q ^ p)``.

* What bounds it on the card: operations -- ``B * S * D`` bit
  agreements, counted as ``2 B S D``, at the rate measured on the H100 for
  ``mma.sync`` m16n8k256 b1 ``.and.popc``.
* What the design does about it: the search runs as that ``mma``, with
  ``agreement = dim - |a| - |b| + 2 popc(a & b)``.  A block owns every
  query of a 256-row tile and a slab of prototypes (:func:`slab_protos`)
  and walks W in 32-word steps, so each prototype word is read once a
  launch; ``|b|`` comes from the staged slab, ``|a|`` from a small pass
  over the queries.  B, S and W may be ragged: the edges are staged as
  zero words, and nothing is padded in device memory.

:func:`hamming_am` launches the kernel for CUDA tensors and counts the
launch in ``hamming_am.launches``; for CPU tensors it runs
:func:`hamming_am_plain`, the plain torch version of the same function.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import assoc_memory
from repro_torch.kernels import _build, _search


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
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.hamming_am_launch.restype = ctypes.c_int
        lib.hamming_am_slab_protos.argtypes = [ctypes.c_int] * 2
        lib.hamming_am_slab_protos.restype = ctypes.c_int
        lib._typed = True
    return lib


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
    _search.check_packed(q_packed, p_packed, "hamming_am")
    (b, w), s = q_packed.shape, p_packed.shape[0]
    dim = 32 * w if dim is None else dim
    out = torch.empty((b, s), dtype=torch.int32, device=q_packed.device)
    if b == 0 or s == 0:
        return out
    row_pc = torch.empty(b, dtype=torch.int32, device=q_packed.device)
    with torch.cuda.device(q_packed.device):
        err = _lib().hamming_am_launch(
            *map(_build.ptr, (q_packed, p_packed, row_pc, out)), b, s, w,
            dim, _build.current_stream())
    if err != 0:
        raise RuntimeError(f"hamming_am: kernel launch failed with CUDA "
                           f"error {err} (B={b}, S={s}, W={w})")
    _build.count_launch(hamming_am)
    return out


hamming_am.launches = 0


def slab_protos(b: int, s: int) -> int:
    """Prototypes one block of the launch at ``(b, s)`` covers on the
    current card: ``16 NT``, with NT chosen by ``mma::slab::pick_nt``
    (the same slab width as ``am_matmul``'s entries: ``am_matmul.plan``)."""
    return _lib().hamming_am_slab_protos(b, s)
