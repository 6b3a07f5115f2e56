"""The Demeter n-gram encoder kernel (bind + bundle + majority).

Replaces the TPU kernel ``repro/kernels/hdc_encoder.py::_kernel``
(launched by ``hdc_encode``) with CUDA C++ for ``sm_90a``
(``csrc/hdc_encoder.cu``).

* What bounds it on the card: operations.  Every gram costs ``n`` item
  memory lookups + XORs and 32 counter updates per word; the output is
  one 4-byte word per (read, word) and the inputs are tokens.
* What the design does about it: one thread owns one (read, word) pair
  with its 32 counters in registers; a block stages its slice of the
  rolled item memory and its reads' tokens in shared memory, so the
  gram loop touches no global memory.

:func:`hdc_encode` launches the kernel for CUDA tensors and counts the
launch in ``hdc_encode.launches``; for CPU tensors it runs
:func:`hdc_encode_plain`, the plain torch version of the same function.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import bitops
from repro_torch.core.encoder import (binarize_majority, encode_grams,
                                      num_grams, valid_grams)
from repro_torch.kernels import _build

MAX_SMEM_BYTES = 232448
#: Elements of one gram chunk's unpacked bits in the plain version.
_PLAIN_CHUNK_ELEMS = 2 ** 28


def hdc_encode_plain(tokens: torch.Tensor, lengths: torch.Tensor,
                     im_rolled: torch.Tensor, tie: torch.Tensor
                     ) -> torch.Tensor:
    """Plain torch encoder: materialized grams + masked bundle + majority.

    The same function as ``repro.kernels.ref.hdc_encode_ref``, with the
    grams materialized a chunk at a time to bound memory.
    """
    n, _, w = im_rolled.shape
    b, length = tokens.shape
    g = num_grams(length, n)
    m = valid_grams(lengths, n)
    counts = torch.zeros((b, 32 * w), dtype=torch.int32, device=tokens.device)
    step = max(1, _PLAIN_CHUNK_ELEMS // max(1, b * 32 * w))
    toks = tokens.long()
    for s in range(0, g, step):
        e = min(s + step, g)
        grams = encode_grams(toks[:, s:e + n - 1], im_rolled)  # (b, e-s, w)
        valid = torch.arange(s, e, device=tokens.device)[None, :] < m[:, None]
        bits = bitops.unpack_bits(grams) * valid[..., None]
        counts += bits.sum(dim=1, dtype=torch.int32)
    return binarize_majority(counts, m, tie)


def _lib():
    lib = _build.library("hdc_encoder")
    if not getattr(lib, "_typed", False):
        lib.hdc_encode_launch.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.hdc_encode_launch.restype = ctypes.c_int
        lib.hdc_encode_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.hdc_encode_smem_bytes.restype = ctypes.c_longlong
        lib._typed = True
    return lib


def _check(tokens, lengths, im_rolled, tie) -> None:
    dev = tokens.device
    for name, t, nd in (("tokens", tokens, 2), ("lengths", lengths, 1),
                        ("im_rolled", im_rolled, 3), ("tie", tie, 1)):
        if t.device != dev:
            raise ValueError(f"hdc_encode: {name} is on {t.device}, "
                             f"tokens on {dev}")
        if t.dtype != torch.int32:
            raise ValueError(f"hdc_encode: {name} must be int32, got {t.dtype}")
        if t.ndim != nd or not t.is_contiguous():
            raise ValueError(f"hdc_encode: {name} must be a contiguous "
                             f"{nd}-d tensor, got shape {tuple(t.shape)}")
    b, w = tokens.shape[0], im_rolled.shape[2]
    if lengths.shape != (b,) or tie.shape != (w,):
        raise ValueError(
            f"hdc_encode: shapes tokens {tuple(tokens.shape)}, lengths "
            f"{tuple(lengths.shape)}, im_rolled {tuple(im_rolled.shape)}, "
            f"tie {tuple(tie.shape)} do not agree")
    if im_rolled.shape[1] > 256:
        raise ValueError("hdc_encode: the kernel stages tokens as bytes; "
                         "alphabets above 256 symbols are not supported")


def hdc_encode(tokens: torch.Tensor, lengths: torch.Tensor,
               im_rolled: torch.Tensor, tie: torch.Tensor) -> torch.Tensor:
    """Encode a batch of symbol sequences into packed HD vectors.

    Args:
      tokens: ``(B, L)`` int32 symbol ids in [0, alphabet).
      lengths: ``(B,)`` int32 true lengths.
      im_rolled: ``(N, alphabet, W)`` int32 -- ``item_memory.rolled``.
      tie: ``(W,)`` int32 tie-break vector.

    Returns:
      ``(B, W)`` int32 packed HD vectors.
    """
    if tokens.device.type == "cpu":
        return hdc_encode_plain(tokens, lengths, im_rolled, tie)
    if tokens.device.type != "cuda":
        raise ValueError(f"hdc_encode: unsupported device {tokens.device}")
    _check(tokens, lengths, im_rolled, tie)
    n, alphabet, w = im_rolled.shape
    b, length = tokens.shape
    lib = _lib()
    smem = lib.hdc_encode_smem_bytes(length, n, alphabet)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"hdc_encode: reads of {length} tokens with n={n} need {smem} "
            f"bytes of shared memory per block, above {MAX_SMEM_BYTES}")
    out = torch.empty((b, w), dtype=torch.int32, device=tokens.device)
    if b == 0:
        return out
    with torch.cuda.device(tokens.device):
        err = lib.hdc_encode_launch(
            *map(_build.ptr, (tokens, lengths, im_rolled, tie, out)),
            b, length, n, alphabet, w, _build.current_stream())
    if err != 0:
        raise RuntimeError(f"hdc_encode: kernel launch failed with CUDA "
                           f"error {err} (B={b}, L={length}, W={w})")
    hdc_encode.launches += 1
    return out


hdc_encode.launches = 0
