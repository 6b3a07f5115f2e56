"""+-1 associative-memory search on the tensor cores.

Replaces the TPU kernel ``repro/kernels/am_matmul.py::_kernel``
(launched by ``am_matmul``) with CUDA C++ for ``sm_90a``
(``csrc/am_matmul.cu``): ``agreement = (dim + Q_hat @ P_hat.T) / 2`` over
the {-1, +1} bf16 expansions of the packed vectors.

* What bounds it on the card: bytes.  The bf16 prototype operand is 16x
  the packed AM (801 MB at the main path's S = 9,780, D = 40,960) and is
  read from device memory on every call; the ``2 * B * S * D`` flop take
  less time at the dense bf16 tensor rate.
* What the design does about it: ``mma.sync`` m16n8k16 bf16 -> fp32 on
  128 x 128 output tiles, fed by ``ldmatrix`` from a 3-deep ``cp.async``
  ring of 64-wide K tiles, so the loads stay in flight behind the tensor
  cores; each prototype tile is streamed once per 128 queries.  B, S and
  K may be ragged: the edges are zero-filled in shared memory (zeros are
  inert in the +-1 dot), and nothing is padded in device memory.

The result is exact in any summation order: every partial sum is an
integer of magnitude at most K < 2**24, exact in fp32.

:func:`am_matmul` launches the kernel for CUDA tensors and counts the
launch in ``am_matmul.launches``; for CPU tensors it runs
:func:`am_matmul_plain`, the plain torch version of the same function.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: Prototype rows one block covers (``kBN`` in the source); the grid's
#: second axis holds at most 65,535 blocks.
BLOCK_S = 128


def am_matmul_plain(q_pm: torch.Tensor, p_pm: torch.Tensor, *,
                    dim: int | None = None) -> torch.Tensor:
    """Plain torch version in full float32 (the same function as
    ``repro.kernels.ref.am_matmul_ref``, with ``dim`` defaulting to the
    operands' width).  On CUDA this needs TF32 off to be exact for
    arbitrary inputs; for +-1 and 0 entries TF32 rounds nothing."""
    dim = q_pm.shape[-1] if dim is None else dim
    s = q_pm.to(torch.float32) @ p_pm.to(torch.float32).T
    return ((dim + s) * 0.5).to(torch.int32)


def _lib():
    lib = _build.library("am_matmul")
    if not getattr(lib, "_typed", False):
        lib.am_matmul_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.am_matmul_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def _check(q, p) -> None:
    for name, t in (("q_pm", q), ("p_pm", p)):
        if t.device != q.device:
            raise ValueError(f"am_matmul: {name} is on {t.device}, "
                             f"q_pm on {q.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"am_matmul: {name} must be bfloat16, "
                             f"got {t.dtype}")
        if t.ndim != 2 or not t.is_contiguous():
            raise ValueError(f"am_matmul: {name} must be a contiguous "
                             f"2-d tensor, got shape {tuple(t.shape)}")
    if q.shape[1] != p.shape[1]:
        raise ValueError(f"am_matmul: q_pm {tuple(q.shape)} and p_pm "
                         f"{tuple(p.shape)} differ in D")
    if -(-p.shape[0] // BLOCK_S) > 65535:
        raise ValueError(f"am_matmul: at most {65535 * BLOCK_S} "
                         f"prototypes per launch, got {p.shape[0]}")


def am_matmul(q_pm: torch.Tensor, p_pm: torch.Tensor, *,
              dim: int | None = None) -> torch.Tensor:
    """Agreement between +-1-encoded queries and prototypes.

    Args:
      q_pm: ``(B, D)`` bf16 in {-1, +1} (or 0 in pad columns).
      p_pm: ``(S, D)`` bf16 likewise.
      dim: the logical HD dimension (defaults to D).

    Returns:
      ``(B, S)`` int32 ``int((dim + q_pm @ p_pm.T) / 2)``.
    """
    if q_pm.device.type == "cpu":
        return am_matmul_plain(q_pm, p_pm, dim=dim)
    if q_pm.device.type != "cuda":
        raise ValueError(f"am_matmul: unsupported device {q_pm.device}")
    _check(q_pm, p_pm)
    (b, k), s = q_pm.shape, p_pm.shape[0]
    dim = k if dim is None else dim
    out = torch.empty((b, s), dtype=torch.int32, device=q_pm.device)
    if b == 0 or s == 0:
        return out
    with torch.cuda.device(q_pm.device):
        err = _lib().am_matmul_launch(
            *map(_build.ptr, (q_pm, p_pm, out)), b, s, k, dim,
            _build.current_stream())
    if err != 0:
        raise RuntimeError(f"am_matmul: kernel launch failed with CUDA "
                           f"error {err} (B={b}, S={s}, D={k})")
    am_matmul.launches += 1
    return out


am_matmul.launches = 0
