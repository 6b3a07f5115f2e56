"""+-1 associative-memory search on the tensor cores.

Replaces the TPU kernel ``repro/kernels/am_matmul.py::_kernel``
(launched by ``am_matmul``) with CUDA C++ for ``sm_90a``
(``csrc/am_matmul.cu`` with ``csrc/wgmma_common.cuh``):
``agreement = (dim + Q_hat @ P_hat.T) / 2`` over the {-1, +1} expansions
of the packed vectors.  Both entries run ``wgmma`` in one block shape:
four consumer warpgroups own the 256 queries of a query tile and a
producer warpgroup fills an ``mbarrier`` ring of shared-memory stages
with a slab of N prototypes (:func:`plan`; N = 80 at the main path's
shapes), so each prototype byte is read from device memory once a
launch.

:func:`am_matmul_packed` (the search path's entry, ``ops.am_agreement(...,
"matmul")``) takes the packed ``(B, W)`` / ``(S, W)`` int32 words.

* What bounds it on the card: operations -- ``2 B S D`` products and
  adds at the int8 tensor rate; the packed AM is 1/16 of its bf16
  expansion, so bytes no longer bound it.
* What the design does about it: ``wgmma`` m64nNk32 s8.  The producer
  brings 16 packed words of every row a stage (TMA where W % 4 == 0 and
  the bases are 16-byte aligned, else ``cp.async`` word by word) and
  expands the slab's words once a block into +-1 bytes in shared memory
  (the 128-byte-swizzled K-major layout ``wgmma`` reads); the consumers
  expand their own query rows straight into the A fragment in registers.
  Words past W expand to 0, so they add nothing.  No +-1 matrix reaches
  device memory.

:func:`am_matmul` (the TPU kernel's own interface) takes +-1 bf16
``(B, D)`` / ``(S, D)`` operands: ``wgmma`` m64nNk16 bf16 -> fp32 from
shared-memory descriptors, 64-element stages brought by TMA with the
128-byte swizzle (plain loads into the same layout where D % 8 != 0 or a
base is not 16-byte aligned); bound by the bytes of its bf16 prototype
operand.  No path calls it.

Both are exact: every partial sum is an integer of magnitude at most D.
B, S and W (or D) may be ragged, and nothing is padded in device memory.

Each launches its kernel for CUDA tensors and counts the launch in its
own ``.launches``; for CPU tensors it runs its plain torch version
(:func:`am_matmul_packed_plain`, :func:`am_matmul_plain`).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _search

#: The bf16 entry takes at most 65,535 x BLOCK_S prototypes a launch
#: (``am_matmul_launch`` refuses more).
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
        lib.am_matmul_packed_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.am_matmul_packed_launch.restype = ctypes.c_int
        lib.am_matmul_plan.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.am_matmul_plan.restype = ctypes.c_int
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
    _build.count_launch(am_matmul)
    return out


am_matmul.launches = 0


def am_matmul_packed_plain(q_packed: torch.Tensor, p_packed: torch.Tensor, *,
                           dim: int | None = None) -> torch.Tensor:
    """Plain torch version: ``am_matmul_plain(to_pm1(q), to_pm1(p), dim)``
    over all ``32 W`` bits (``dim`` defaults to ``32 W``; with another
    ``dim`` it differs from ``hamming_am``, as ``repro``'s
    ``am_agreement(..., "matmul")`` does)."""
    from repro_torch.kernels import ops   # ops imports this module

    return am_matmul_plain(ops.to_pm1(q_packed), ops.to_pm1(p_packed),
                           dim=32 * q_packed.shape[-1] if dim is None
                           else dim)


def am_matmul_packed(q_packed: torch.Tensor, p_packed: torch.Tensor, *,
                     dim: int | None = None) -> torch.Tensor:
    """Agreement of the +-1 expansions of packed queries and prototypes.

    Args:
      q_packed: ``(B, W)`` int32 packed query HD vectors.
      p_packed: ``(S, W)`` int32 packed prototypes.
      dim: the logical HD dimension (defaults to ``32 * W``).

    Returns:
      ``(B, S)`` int32 ``int((dim + to_pm1(q) @ to_pm1(p).T) / 2)``.
    """
    if q_packed.device.type == "cpu":
        return am_matmul_packed_plain(q_packed, p_packed, dim=dim)
    if q_packed.device.type != "cuda":
        raise ValueError(f"am_matmul_packed: unsupported device "
                         f"{q_packed.device}")
    _search.check_packed(q_packed, p_packed, "am_matmul_packed")
    (b, w), s = q_packed.shape, p_packed.shape[0]
    dim = 32 * w if dim is None else dim
    out = torch.empty((b, s), dtype=torch.int32, device=q_packed.device)
    if b == 0 or s == 0:
        return out
    with torch.cuda.device(q_packed.device):
        err = _lib().am_matmul_packed_launch(
            *map(_build.ptr, (q_packed, p_packed, out)), b, s, w, dim,
            _build.current_stream())
    if err != 0:
        raise RuntimeError(f"am_matmul_packed: kernel launch failed with "
                           f"CUDA error {err} (B={b}, S={s}, W={w})")
    _build.count_launch(am_matmul_packed)
    return out


am_matmul_packed.launches = 0


def plan(b: int, s: int, k: int, *, packed: bool = True) -> dict:
    """The tiling of a launch of the packed (``k`` = W words) or the bf16
    (``k`` = D elements) entry at ``(b, s)`` on the current card:
    ``rows`` and ``protos`` a block, ring ``stages``, ``blocks``, dynamic
    shared memory a block (``smem``, bytes), the card's ``sms``,
    ``tma``: whether ``k`` lets the stages come by TMA (given 16-byte
    aligned bases; else they are staged without it), and ``step``: the
    words (packed) or elements (bf16) of a row a stage."""
    out = (ctypes.c_int * 8)()
    err = _lib().am_matmul_plan(int(packed), b, s, k, out)
    if err != 0:
        raise RuntimeError(f"am_matmul_plan failed with CUDA error {err}")
    keys = ("rows", "protos", "stages", "blocks", "smem", "sms", "tma",
            "step")
    return {key: (bool(v) if key == "tma" else int(v))
            for key, v in zip(keys, out)}
