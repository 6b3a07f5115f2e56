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
* Alphabets above 4 (up to 65,536) take the wide path: 16-bit symbols,
  and the pair table split into its two separable halves ``F[a] =
  imr[0][a]`` shifted by one word and ``G[b] = imr[n-1][b]`` (2A rows
  instead of A^2), so a gram costs two 16-byte loads and one more XOR.
  The tables sit in shared memory when they fit there; else the wrapper
  lays them out in global memory (:func:`wide_tables`) and the kernel
  reads them through L2.  The 2-bit path of A <= 4 is unchanged.

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
#: Largest alphabet the kernels take (the wide path stages 16-bit symbols).
MAX_ALPHABET = 2 ** 16
#: Largest alphabet of the 2-bit path; larger ones take the wide path.
NARROW_ALPHABET = 4
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


def wide_tok_words(read_len: int) -> int:
    """Words of one read's staged 16-bit symbols on the wide path
    (``wide_tok_words`` in C)."""
    return _round16(read_len // 2 + 18)


def wide_table_stride(w: int) -> int:
    """Row stride, in words, of :func:`wide_tables` (``wide_table_stride``
    in C): W + 256 rounded to 16 bytes."""
    return _round16(w + 256)


def smem_bytes(read_len: int, n: int, alphabet: int = NARROW_ALPHABET,
               shared_tables: bool = True) -> int:
    """Shared memory of one block (``hdc_encode_smem_bytes`` in C).

    A <= 4: the pair table of 2 runs of 128 words (16 rows), the runs'
    ``(n, 4)`` edge columns, and 4 reads' staged tokens and pair ids.
    A > 4: 4 reads' 16-bit symbols and, with ``shared_tables``, the F / G
    tables of the 256 words (2A rows) and the runs' ``(n, A)`` edge
    columns."""
    if alphabet <= NARROW_ALPHABET:
        tw, pw = staged_words(read_len)
        return (16 * 256 + _round16(2 * n * 4) + 4 * tw + 4 * pw) * 4
    words = 4 * wide_tok_words(read_len)
    if shared_tables:
        words += 2 * alphabet * 256 + _round16(2 * n * alphabet)
    return words * 4


def shared_tables(read_len: int, n: int, alphabet: int) -> bool:
    """Whether the wide path's tables fit in the encoder's shared memory
    (else :func:`hdc_encode` reads them from :func:`wide_tables`)."""
    return smem_bytes(read_len, n, alphabet, True) <= MAX_SMEM_BYTES


def wide_tables(im_rolled: torch.Tensor) -> torch.Tensor:
    """The wide path's F / G tables in global memory, ``(2A, Wx)`` int32
    with ``Wx = wide_table_stride(W)``: row ``a`` is ``imr[0][a]`` shifted
    left by one word, row ``A + b`` is ``imr[n-1][b]``, each wrapped mod W
    over Wx words, so any block's run of words is one aligned stretch."""
    n, _, w = im_rolled.shape
    cols = torch.arange(wide_table_stride(w), device=im_rolled.device)
    return torch.cat([im_rolled[0][:, (cols + 1) % w],
                      im_rolled[n - 1][:, cols % w]]).contiguous()


def check_shape(name: str, read_len: int, n: int, alphabet: int) -> None:
    """Raise ``ValueError`` for what the encode kernels do not take."""
    if not 1 <= alphabet <= MAX_ALPHABET:
        raise ValueError(f"{name}: the kernels stage symbols in 16 bits; "
                         f"alphabets of 1 to {MAX_ALPHABET} symbols are "
                         f"supported, got {alphabet}")
    if n < 1:
        raise ValueError(f"{name}: n must be positive, got {n}")
    if read_len - n + 1 > MAX_GRAMS:
        raise ValueError(f"{name}: reads of {read_len} tokens have more than "
                         f"{MAX_GRAMS} grams")


def _lib():
    lib = _build.library("hdc_encoder")
    if not getattr(lib, "_typed", False):
        lib.hdc_encode_launch.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.hdc_encode_launch.restype = ctypes.c_int
        lib.hdc_encode_smem_bytes.argtypes = [ctypes.c_int] * 4
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
      tokens: ``(B, L)`` int32 symbol ids in [0, alphabet), alphabet <=
        65,536 (2-bit symbols up to 4, 16-bit ones above).  Ids outside
        that range are the caller's error: the kernel clamps them into
        it, the plain version indexes the item memory with them as given.
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
    in_smem = alphabet <= NARROW_ALPHABET or shared_tables(length, n,
                                                          alphabet)
    smem = smem_bytes(length, n, alphabet, in_smem)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"hdc_encode: reads of {length} tokens with n={n} need {smem} "
            f"bytes of shared memory per block, above {MAX_SMEM_BYTES}")
    out = torch.empty((b, w), dtype=torch.int32, device=tokens.device)
    if b == 0:
        return out
    fg = None if in_smem else wide_tables(im_rolled)
    with torch.cuda.device(tokens.device):
        err = _lib().hdc_encode_launch(
            *map(_build.ptr, (tokens, lengths, im_rolled, tie)),
            None if fg is None else _build.ptr(fg), _build.ptr(out),
            b, length, n, alphabet, w, _build.current_stream())
    if err != 0:
        raise RuntimeError(f"hdc_encode: kernel launch failed with CUDA "
                           f"error {err} (B={b}, L={length}, W={w})")
    _build.count_launch(hdc_encode)
    return out


hdc_encode.launches = 0
