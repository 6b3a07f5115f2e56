"""The crossbar read's per-chunk epilogue on the card
(``csrc/crossbar_adc.cu``): read noise, ADC and the sum over row tiles.

A kernel the port adds with no Pallas counterpart: ``repro``'s crossbar
(``repro/accel/crossbar.py``) draws its read noise with ``jax.random`` and
leaves the ADC and the sums to XLA.  After each chunk's tile products, the
port's read (:mod:`repro_torch.accel.crossbar`) hands the chunk's ``(t, B,
S)`` float32 partial counts to :func:`crossbar_adc`, which adds each
tile's noise ``std[t, b] * normal / divisor`` (``jax.random.normal`` of
the tile's key), quantizes with the ADC, sums the codes over the tiles
and writes or adds the sum into a ``(B, S)`` output:

* What bounds it on the card: integer operations, ~75 a draw (the
  Threefry pair and the normal's bit work): 9.2 ms for a 17-tile chunk at
  4,096 x 29,440, whose bytes take 2.7 ms.
* What the design does about it: one pass over the counts, the draws in
  registers with the Threefry kernel's own code, a fixed counter a thread
  walking the chunk's tiles; so the draws are its only costly work, where
  the plain version passes through the counts seven times.

At a lossless ADC the result equals :func:`crossbar_adc_plain`'s bit for
bit in both ``jax_threefry_partitionable`` modes (whole codes sum exactly
in any order); at a lossy one the kernel sums the scaled codes in tile
order, ``torch.sum`` in its own, and the two may differ in the last bit.

For CPU tensors the wrapper runs :func:`crossbar_adc_plain`; for CUDA
tensors it launches the kernel and counts the launch in
``crossbar_adc.launches``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import threefry as threefry_kernel


def adc_codes(count: torch.Tensor, step: float) -> torch.Tensor:
    """``round(count / step)`` in place (``count`` is consumed); a step of
    exactly one count divides nothing."""
    if step != 1.0:
        count = count.div_(torch.tensor(np.float32(step),
                                        device=count.device))
    return count.round_()


def crossbar_adc_plain(counts: torch.Tensor, keys: torch.Tensor,
                       std: torch.Tensor | None, divisor: float, *,
                       levels: int, step: float, partitionable: bool,
                       out: torch.Tensor | None = None,
                       clips: torch.Tensor | None = None) -> torch.Tensor:
    """Plain torch version of :func:`crossbar_adc` (any device; on the card
    the noise is the Threefry kernel's read-noise epilogue).  ``counts``
    is consumed."""
    _check(counts, keys, std, out, clips)
    t, b, s = counts.shape
    if std is not None and counts.numel():
        threefry_kernel.threefry_draw(
            keys, b * s, epilogue="normal", partitionable=partitionable,
            scale=std.contiguous(), inner=s, divisor=divisor, out=counts)
    code = adc_codes(counts, step)
    if clips is not None:
        clips += ((code < 0) | (code > levels)).sum()
    code.clamp_(0, levels)
    if step != 1.0:
        code.mul_(np.float32(step).item())
    part = code.sum(dim=0)
    return part if out is None else out.add_(part)


def _check(counts, keys, std, out, clips) -> None:
    if counts.dim() != 3 or counts.dtype != torch.float32:
        raise ValueError(f"crossbar_adc: counts must be (t, B, S) float32, "
                         f"got {tuple(counts.shape)} {counts.dtype}")
    t, b, s = counts.shape
    if tuple(keys.shape) != (t, 2) or keys.dtype != torch.int32:
        raise ValueError(f"crossbar_adc: keys must be ({t}, 2) int32, got "
                         f"{tuple(keys.shape)} {keys.dtype}")
    if std is not None and (tuple(std.shape) != (t, b)
                            or std.dtype != torch.float32):
        raise ValueError(f"crossbar_adc: std must be ({t}, {b}) float32, "
                         f"got {tuple(std.shape)} {std.dtype}")
    if out is not None and (tuple(out.shape) != (b, s)
                            or out.dtype != torch.float32):
        raise ValueError(f"crossbar_adc: out must be ({b}, {s}) float32, "
                         f"got {tuple(out.shape)} {out.dtype}")
    if clips is not None and (clips.numel() != 1
                              or clips.dtype != torch.int64):
        raise ValueError("crossbar_adc: clips must be one int64 value")


def _lib():
    lib = _build.library("crossbar_adc")
    if not getattr(lib, "_typed", False):
        lib.crossbar_adc_launch.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3
            + [ctypes.c_int] * 2 + [ctypes.c_float] * 5
            + [ctypes.c_int, ctypes.c_void_p])
        lib.crossbar_adc_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def crossbar_adc(counts: torch.Tensor, keys: torch.Tensor,
                 std: torch.Tensor | None, divisor: float, *, levels: int,
                 step: float, partitionable: bool,
                 out: torch.Tensor | None = None,
                 clips: torch.Tensor | None = None) -> torch.Tensor:
    """Noise, ADC and tile sum of one chunk of a read event's row tiles.

    Args:
      counts: ``(t, B, S)`` float32 partial counts of the chunk's tiles
        (consumed by the plain version; the kernel only reads them).
      keys: ``(t, 2)`` int32 key words, one a tile.
      std: ``(t, B)`` float32 noise std a tile and query, or None for a
        read without noise; ``divisor`` divides the scaled normal.
      levels, step: the ADC's top code and the counts a code stands for.
      partitionable: the ``jax_threefry_partitionable`` mode to draw in.
      out: ``(B, S)`` float32 the chunk's sum is added into, or None for
        the event's first chunk (a new tensor holds the sum).
      clips: an int64 device scalar the codes outside ``[0, levels]`` are
        added into, or None.

    Returns:
      ``out``, or the new ``(B, S)`` sum.
    """
    if counts.device.type == "cpu":
        return crossbar_adc_plain(counts, keys, std, divisor, levels=levels,
                                  step=step, partitionable=partitionable,
                                  out=out, clips=clips)
    if counts.device.type != "cuda":
        raise ValueError(f"crossbar_adc: unsupported device {counts.device}")
    _check(counts, keys, std, out, clips)
    t, b, s = counts.shape
    if b * s >= 2 ** 31:
        raise ValueError(f"crossbar_adc: B x S = {b * s} must be below "
                         f"2**31")
    args = [counts, keys] + ([] if std is None else [std]) + \
        [x for x in (out, clips) if x is not None]
    for x in args:
        if x.device != counts.device or not x.is_contiguous():
            raise ValueError("crossbar_adc: every tensor must be contiguous "
                             "on the counts' device")
    overwrite = out is None
    if overwrite:
        out = (torch.empty if t else torch.zeros)(
            (b, s), dtype=torch.float32, device=counts.device)
    lo, rng = threefry_kernel._range("normal", 0.0, 1.0)
    with torch.cuda.device(counts.device):
        err = _lib().crossbar_adc_launch(
            _build.ptr(counts), _build.ptr(keys),
            None if std is None else _build.ptr(std), _build.ptr(out),
            None if clips is None else _build.ptr(clips), t, b, s,
            int(bool(partitionable)), int(std is not None), lo, rng,
            float(np.float32(divisor)), float(levels),
            float(np.float32(step)), int(overwrite), _build.current_stream())
    if err != 0:
        raise RuntimeError(f"crossbar_adc: kernel launch failed with CUDA "
                           f"error {err} (t={t}, B={b}, S={s})")
    _build.count_launch(crossbar_adc)
    return out


crossbar_adc.launches = 0
