"""``jax.random``'s Threefry draws on the card (``csrc/threefry.cu``).

A kernel the port adds with no Pallas counterpart: ``repro``'s device
model (``repro/accel``) draws its programming noise, fault maps and read
noise with ``jax.random`` outside any kernel, at 408.9 M values a bank at
the main path's width.  :func:`threefry_draw` draws ``m`` values for each
of ``N`` keys -- the words of ``jax.random.bits``, ``uniform`` or
``normal`` -- in either ``jax_threefry_partitionable`` mode:

* What bounds it on the card: integer operations (a Threefry pair is
  ~72 32-bit operations: 20 rounds of add / rotate / xor and the key
  injections), against the bytes of the output.
* What the design does about it: one thread a Threefry pair, rotates as
  funnel shifts, coalesced stores, and the read-noise epilogue
  (``normal * scale / divisor`` added into the partial counts) so the
  noise never takes a tensor of its own.

Bits and uniforms equal ``jax.random``'s exactly; normals equal the plain
version's to the ulp gap ``chip_smoke.py`` measures (the card's
``log1pf`` in both; the plain version's fused steps are emulated in
float64) and ``jax.random.normal``'s to a few ulp
(:mod:`repro_torch.core.threefry`).

For CPU tensors the wrapper runs the plain version
(:func:`threefry_draw_plain`, built on :mod:`repro_torch.core.threefry`);
for CUDA tensors it launches the kernel and counts the launch in
``threefry_draw.launches``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core import bitops, threefry
from repro_torch.kernels import _build

EPILOGUES = {"bits": 0, "uniform": 1, "normal": 2}


def keys_tensor(keys, device) -> torch.Tensor:
    """A key pair or an ``(N, 2)`` array of them (uint32 words) -> an
    ``(N, 2)`` int32 tensor of the same bits on ``device``."""
    a = np.ascontiguousarray(np.asarray(keys, np.uint32).reshape(-1, 2))
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def _check(keys: torch.Tensor, m: int, epilogue: str, scale, inner: int,
           out) -> None:
    if epilogue not in EPILOGUES:
        raise ValueError(f"threefry: unknown epilogue {epilogue!r}; one of "
                         f"{sorted(EPILOGUES)}")
    if keys.dim() != 2 or keys.shape[1] != 2 or keys.dtype != torch.int32:
        raise ValueError(f"threefry: keys must be (N, 2) int32, got "
                         f"{tuple(keys.shape)} {keys.dtype}")
    if not 0 < m < 2 ** 32:
        raise ValueError(f"threefry: m = {m} must be in [1, 2**32)")
    if (scale is not None or out is not None) and epilogue != "normal":
        raise ValueError("threefry: scale and out take the normal epilogue")
    if isinstance(scale, torch.Tensor):
        if m % inner or scale.numel() != keys.shape[0] * (m // inner):
            raise ValueError(
                f"threefry: scale of {scale.numel()} values does not give "
                f"one to each {inner} of {keys.shape[0]} x {m}")
    if out is not None and (out.numel() != keys.shape[0] * m
                            or out.dtype != torch.float32):
        raise ValueError(f"threefry: out must hold {keys.shape[0]} x {m} "
                         f"float32 values, got {out.numel()} {out.dtype}")


def _range(epilogue: str, minval: float, maxval: float) -> tuple[float, float]:
    """float32 ``(lo, hi - lo)`` of the uniform the epilogue draws."""
    if epilogue == "normal":
        minval, maxval = threefry.NORMAL_LO, 1.0
    lo, hi = np.float32(minval), np.float32(maxval)
    return float(lo), float(hi - lo)


def threefry_draw_plain(keys: torch.Tensor, m: int, *, epilogue: str,
                        partitionable: bool = threefry.PARTITIONABLE,
                        minval: float = 0.0, maxval: float = 1.0,
                        scale=None, inner: int = 1, divisor: float = 1.0,
                        out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain torch version of :func:`threefry_draw` (any device)."""
    _check(keys, m, epilogue, scale, inner, out)
    if epilogue == "bits":
        return bitops.to_int32_words(
            threefry.bits_rows(keys, m, partitionable=partitionable))
    if epilogue == "uniform":
        return threefry.uniform_rows(keys, m, minval=minval, maxval=maxval,
                                     partitionable=partitionable)
    v = threefry.normal_rows(keys, m, partitionable=partitionable)
    n = keys.shape[0]
    if isinstance(scale, torch.Tensor):
        v = (scale.reshape(n, m // inner, 1).to(torch.float32)
             * v.reshape(n, m // inner, inner)).reshape(n, m)
    elif scale is not None:
        v = float(np.float32(scale)) * v
    if divisor != 1.0:
        v = v / torch.tensor(np.float32(divisor), device=v.device)
    if out is None:
        return v
    return out.add_(v.reshape(out.shape))


def _lib():
    lib = _build.library("threefry")
    if not getattr(lib, "_typed", False):
        lib.threefry_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.threefry_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def threefry_draw(keys: torch.Tensor, m: int, *, epilogue: str,
                  partitionable: bool = threefry.PARTITIONABLE,
                  minval: float = 0.0, maxval: float = 1.0, scale=None,
                  inner: int = 1, divisor: float = 1.0,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """Draw ``m`` values for each of the ``(N, 2)`` int32 ``keys``.

    Args:
      epilogue: ``"bits"`` (``(N, m)`` int32 words), ``"uniform"``
        (float32 on ``[minval, maxval)``) or ``"normal"`` (float32).
      partitionable: the ``jax_threefry_partitionable`` mode to reproduce.
      scale: normal only: a float, or a float32 tensor of ``N * m /
        inner`` values, one to each ``inner`` consecutive values of a row
        (the read noise's ``std`` a read), multiplied into the normal.
      divisor: normal only: divides the scaled value.
      out: normal only: ``N * m`` float32 values the draw is added into
        (in place; returned).

    Returns:
      ``(N, m)`` values, or ``out``.
    """
    if keys.device.type == "cpu":
        return threefry_draw_plain(
            keys, m, epilogue=epilogue, partitionable=partitionable,
            minval=minval, maxval=maxval, scale=scale, inner=inner,
            divisor=divisor, out=out)
    if keys.device.type != "cuda":
        raise ValueError(f"threefry: unsupported device {keys.device}")
    _check(keys, m, epilogue, scale, inner, out)
    n = keys.shape[0]
    keys = keys.contiguous()
    scale_t = None
    if scale is not None:
        if isinstance(scale, torch.Tensor):
            scale_t = scale.to(device=keys.device,
                               dtype=torch.float32).contiguous()
        else:
            scale_t = torch.full((n,), float(np.float32(scale)),
                                 dtype=torch.float32, device=keys.device)
            inner = m
    if out is not None:
        if out.device != keys.device or not out.is_contiguous():
            raise ValueError("threefry: out must be contiguous on the keys' "
                             "device")
        dst = out
    else:
        dst = torch.empty((n, m), device=keys.device,
                          dtype=torch.int32 if epilogue == "bits"
                          else torch.float32)
    lo, rng = _range(epilogue, minval, maxval)
    with torch.cuda.device(keys.device):
        err = _lib().threefry_launch(
            _build.ptr(keys), n, m, int(bool(partitionable)),
            EPILOGUES[epilogue], lo, rng,
            None if scale_t is None else _build.ptr(scale_t), inner,
            float(np.float32(divisor)), int(out is not None),
            _build.ptr(dst), _build.current_stream())
    if err != 0:
        raise RuntimeError(f"threefry: kernel launch failed with CUDA error "
                           f"{err} (N={n}, m={m}, {epilogue})")
    _build.count_launch(threefry_draw)
    return dst


threefry_draw.launches = 0
