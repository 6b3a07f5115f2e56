"""The Demeter n-gram encoder kernel (bind + bundle + majority).

Replaces the TPU kernel ``repro/kernels/hdc_encoder.py::_kernel``
(launched by ``hdc_encode``) with CUDA C++ for ``sm_90a``
(``csrc/hdc_encoder.cu``, ``csrc/hdc_common.cuh``).

* What bounds it on the card: integer issue.  The bind and the bundling
  are 32-bit XOR and logic work over every (read, word, gram); on
  compute capability 9.0 those issue at 64 a clock per SM (~16.7 T/s at
  1.98 GHz), while the output is one 4-byte word per (read, word).
* What the design does about it: ~6 instructions per word-gram instead
  of ~140.  A warp encodes 128 consecutive words of one read with the
  rolling word recurrence (one pair-table load, one shuffle and four XORs
  a gram per lane), counts with bit-sliced carry-save (Harley-Seal)
  counters instead of 32 separate ones, and decides the majority with a
  bit-sliced comparison, never unpacking a counter.

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
#: Most grams a read may have (the kernel keeps at most 20 counter planes).
MAX_GRAMS = 2 ** 20 - 1
#: Largest alphabet the kernel takes (tokens are staged as 2-bit symbols).
MAX_ALPHABET = 4
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


def _round16(words: int) -> int:
    return -(-words // 4) * 4


def staged_words(read_len: int) -> tuple[int, int]:
    """Words of one read's staged tokens (16 a word) and pair ids (8 a
    word) in shared memory (``tok_words`` / ``pair_words`` in C)."""
    return (_round16((read_len + 31) // 16 + 2),
            _round16(read_len // 8 + 2))


def smem_bytes(read_len: int, n: int) -> int:
    """Shared memory of one block (``hdc_encode_smem_bytes`` in C): the
    pair table of 2 runs of 128 words (16 rows), the runs' ``(n, 4)``
    edge columns, and 4 reads' staged tokens and pair ids."""
    tw, pw = staged_words(read_len)
    return (16 * 256 + _round16(2 * n * 4) + 4 * tw + 4 * pw) * 4


def check_shape(name: str, read_len: int, n: int, alphabet: int) -> None:
    """Raise ``ValueError`` for what the encode kernels do not take."""
    if not 1 <= alphabet <= MAX_ALPHABET:
        raise ValueError(f"{name}: the kernel stages tokens as 2-bit "
                         f"symbols; alphabets of 1 to {MAX_ALPHABET} symbols "
                         f"are supported, got {alphabet}")
    if n < 1:
        raise ValueError(f"{name}: n must be positive, got {n}")
    if read_len - n + 1 > MAX_GRAMS:
        raise ValueError(f"{name}: reads of {read_len} tokens have more than "
                         f"{MAX_GRAMS} grams")


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
    n, alphabet = im_rolled.shape[:2]
    check_shape("hdc_encode", tokens.shape[1], n, alphabet)


def hdc_encode(tokens: torch.Tensor, lengths: torch.Tensor,
               im_rolled: torch.Tensor, tie: torch.Tensor) -> torch.Tensor:
    """Encode a batch of symbol sequences into packed HD vectors.

    Args:
      tokens: ``(B, L)`` int32 symbol ids in [0, alphabet), alphabet <= 4
        (the kernel stages 2-bit symbols).  Ids outside that range are
        the caller's error: the kernel clamps them into it, the plain
        version indexes the item memory with them as given.
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
    smem = smem_bytes(length, n)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"hdc_encode: reads of {length} tokens with n={n} need {smem} "
            f"bytes of shared memory per block, above {MAX_SMEM_BYTES}")
    out = torch.empty((b, w), dtype=torch.int32, device=tokens.device)
    if b == 0:
        return out
    with torch.cuda.device(tokens.device):
        err = _lib().hdc_encode_launch(
            *map(_build.ptr, (tokens, lengths, im_rolled, tie, out)),
            b, length, n, alphabet, w, _build.current_stream())
    if err != 0:
        raise RuntimeError(f"hdc_encode: kernel launch failed with CUDA "
                           f"error {err} (B={b}, L={length}, W={w})")
    _build.count_launch(hdc_encode)
    return out


hdc_encode.launches = 0
