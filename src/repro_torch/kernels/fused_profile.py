"""Fused encode->search kernel: read tokens -> agreement with every prototype.

Replaces the TPU kernels ``repro/kernels/fused_profile.py::_kernel`` and
its double-buffered twin ``_kernel_dma`` (launched by ``fused_profile``)
with CUDA C++ for ``sm_90a`` (``csrc/fused_profile.cu``).

* What bounds it on the card: at the main path's shapes the search,
  ``B * S * D`` bit agreements (1.0e11), whose least time at the b1
  ``mma.sync`` rate the card issues (8.1e15 operations/s counting an AND
  and an add per bit, ``tools/search_mma_probe.py``) is 0.025 ms, and the
  prototype stream (``S * W * 4`` bytes, ~50 MB, read once per read tile,
  mostly from L2).  The encode is ~6 integer instructions per word-gram,
  ~0.02 ms of work.
* What the design does about it: the search runs on the tensor cores as
  ``mma.sync`` m16n8k256 b1 ``.and.popc`` on the packed words, with
  ``agreement = D - |a| - |b| + 2 popc(a & b)``; tiles of 16 or 32 reads
  (one or two m16 row blocks) cut the AM bytes each read costs; each warp
  streams its prototypes through a ``cp.async`` ring.  A cluster of
  ``cluster`` blocks owns a tile of ``bb`` reads: each block encodes
  1/cluster of the words with the
  encoder's bit-sliced rolling routine (each read is encoded once per
  cluster, unlike the TPU grid, which re-encodes per prototype chunk),
  the blocks exchange their words through distributed shared memory, and
  each scores the whole tile against its share of the prototypes.  The
  encoded ``(B, W)`` matrix never reaches global memory.
* Alphabets above 4 take the encoder's wide path (16-bit symbols, the
  F / G tables of 2A rows in shared memory where they fit beside the
  tile, else read through L2 from :func:`hdc_encoder.wide_tables`); the
  search is the same code.

:func:`fused_profile` launches the kernel for CUDA tensors and counts the
launch in ``fused_profile.launches``; for CPU tensors it runs
:func:`fused_profile_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import assoc_memory, bitops
from repro_torch.kernels import _build
from repro_torch.kernels.hdc_encoder import (NARROW_ALPHABET, _round16,
                                             check_shape, hdc_encode_plain,
                                             staged_words, wide_tables,
                                             wide_tok_words)

MAX_SMEM_BYTES = 232448
#: Reads a cluster tile: one or two m16 row blocks of the search's mma.
BATCH_TILES = (16, 32)
CLUSTER_SIZES = (1, 2, 4, 8)
#: Fastest tiling of the sweep at the main path's shapes (B = 256, L = 150,
#: S = 9,780, D = 40,960): ``python3 chip_smoke.py --sweep``, see PERF.md.
DEFAULT_BB, DEFAULT_CLUSTER = 16, 2
#: Prototype words per search step: rows are padded to a multiple of it.
STEP_WORDS = 32
_THREADS = 512


def smem_bytes(bb: int, cluster: int, read_len: int, n: int, alphabet: int,
               w: int, shared_tables: bool = True) -> int:
    """Shared memory of one block (``fused_profile_smem_bytes`` in C):
    the encoded tile (``bb`` rows of W words padded to 32) and
    its row popcounts, then the larger of the encode scratch and the
    warps' prototype rings (16 rows x 32 words a stage; 4 stages at 16
    rows, 2 at 32).

    The encode scratch at A <= 4: the pair table of the block's runs of
    128 words, their edge columns, the tile's staged tokens and pair ids.
    At A > 4: the tile's 16-bit symbols and, with ``shared_tables``, the
    F / G tables of the block's runs (2A rows) and their ``(n, A)`` edge
    columns; the block's span of words is rounded to 4."""
    rows = bb
    qs = -(-w // STEP_WORDS) * STEP_WORDS
    scratch = rows * qs + _round16(rows)
    if alphabet <= NARROW_ALPHABET:
        runs = -(-(-(-w // cluster)) // 128)
        tw, pw = staged_words(read_len)
        enc = scratch + 16 * runs * 128 + _round16(runs * n * 4) \
            + rows * (tw + pw)
    else:
        runs = -(-_round16(-(-w // cluster)) // 128)
        enc = scratch + rows * wide_tok_words(read_len)
        if shared_tables:
            enc += (2 * alphabet * runs * 128
                    + _round16(runs * n * alphabet))
    stages = 4 if rows == 16 else 2
    ring = scratch + _THREADS // 32 * stages * 16 * STEP_WORDS
    return max(enc, ring) * 4


def shared_tables(bb: int, cluster: int, read_len: int, n: int,
                  alphabet: int, w: int) -> bool:
    """Whether the tiling holds the wide path's tables in shared memory
    (true at A <= 4, whose pair table always sits there)."""
    return (alphabet <= NARROW_ALPHABET
            or smem_bytes(bb, cluster, read_len, n, alphabet, w, True)
            <= MAX_SMEM_BYTES)


def check_tiles(bb: int, cluster: int, read_len: int, n: int, alphabet: int,
                w: int) -> int:
    """Validate a tiling; returns its shared-memory bytes per block."""
    check_shape("fused_profile", read_len, n, alphabet)
    if bb not in BATCH_TILES:
        raise ValueError(f"fused_profile: bb must be one of {BATCH_TILES}, "
                         f"got {bb}")
    if cluster not in CLUSTER_SIZES:
        raise ValueError(f"fused_profile: cluster must be one of "
                         f"{CLUSTER_SIZES}, got {cluster}")
    smem = smem_bytes(bb, cluster, read_len, n, alphabet, w,
                      shared_tables(bb, cluster, read_len, n, alphabet, w))
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"fused_profile: bb={bb}, cluster={cluster} with W={w} words, "
            f"n={n} and reads of {read_len} tokens need {smem} bytes of "
            f"shared memory per block, above the {MAX_SMEM_BYTES} a block "
            f"may use; lower bb or raise cluster")
    return smem


def fused_profile_plain(tokens: torch.Tensor, lengths: torch.Tensor,
                        im_rolled: torch.Tensor, tie: torch.Tensor,
                        prototypes: torch.Tensor, *, dim: int
                        ) -> torch.Tensor:
    """Plain torch version: encode, then packed XOR + popcount agreement."""
    q = hdc_encode_plain(tokens, lengths, im_rolled, tie)
    return assoc_memory.agreement_packed_chunked(q, prototypes, dim)


def _lib():
    lib = _build.library("fused_profile")
    if not getattr(lib, "_typed", False):
        lib.fused_profile_launch.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
        lib.fused_profile_launch.restype = ctypes.c_int
        lib.fused_profile_smem_bytes.argtypes = [ctypes.c_int] * 7
        lib.fused_profile_smem_bytes.restype = ctypes.c_longlong
        lib.fused_profile_max_active_clusters.argtypes = [ctypes.c_int] * 7
        lib.fused_profile_max_active_clusters.restype = ctypes.c_int
        lib._typed = True
    return lib


def max_active_clusters(bb: int, cluster: int, read_len: int, n: int,
                        w: int, alphabet: int = NARROW_ALPHABET) -> int:
    """Clusters of this tiling the card holds at once
    (``fused_profile_max_active_clusters`` in C; 0 or -1 when the tiling
    cannot launch).  Needs a card: it asks the CUDA occupancy API."""
    return _lib().fused_profile_max_active_clusters(
        bb, cluster, read_len, n, alphabet, w,
        int(shared_tables(bb, cluster, read_len, n, alphabet, w)))


def _check(tokens, lengths, im_rolled, tie, prototypes) -> None:
    dev = tokens.device
    for name, t, nd in (("tokens", tokens, 2), ("lengths", lengths, 1),
                        ("im_rolled", im_rolled, 3), ("tie", tie, 1),
                        ("prototypes", prototypes, 2)):
        if t.device != dev:
            raise ValueError(f"fused_profile: {name} is on {t.device}, "
                             f"tokens on {dev}")
        if t.dtype != torch.int32:
            raise ValueError(f"fused_profile: {name} must be int32, "
                             f"got {t.dtype}")
        if t.ndim != nd or not t.is_contiguous():
            raise ValueError(f"fused_profile: {name} must be a contiguous "
                             f"{nd}-d tensor, got shape {tuple(t.shape)}")
    b, w = tokens.shape[0], im_rolled.shape[2]
    if (lengths.shape != (b,) or tie.shape != (w,)
            or prototypes.shape[1] != w):
        raise ValueError(
            f"fused_profile: shapes tokens {tuple(tokens.shape)}, lengths "
            f"{tuple(lengths.shape)}, im_rolled {tuple(im_rolled.shape)}, "
            f"tie {tuple(tie.shape)}, prototypes {tuple(prototypes.shape)} "
            f"do not agree")


def fused_profile(tokens: torch.Tensor, lengths: torch.Tensor,
                  im_rolled: torch.Tensor, tie: torch.Tensor,
                  prototypes: torch.Tensor, *, dim: int,
                  bb: int = DEFAULT_BB, cluster: int = DEFAULT_CLUSTER
                  ) -> torch.Tensor:
    """Agreement of every read against every prototype, in one launch.

    Args:
      tokens: ``(B, L)`` int32 symbol ids in [0, alphabet), alphabet <=
        65,536 (2-bit symbols up to 4, 16-bit ones above).  Ids outside
        that range are the caller's error: the kernel clamps them into
        it, the plain version indexes the item memory with them as given.
      lengths: ``(B,)`` int32 true lengths.
      im_rolled: ``(N, alphabet, W)`` int32 -- ``item_memory.rolled``.
      tie: ``(W,)`` int32 tie-break vector.
      prototypes: ``(S, W)`` int32 packed prototypes.
      dim: the HD dimension D.
      bb / cluster: reads per cluster and blocks per cluster.

    Returns:
      ``(B, S)`` int32 agreement in [0, dim], bit-identical to
      ``agreement(hdc_encode(tokens, lengths, im_rolled, tie), prototypes)``.
    """
    if tokens.device.type == "cpu":
        return fused_profile_plain(tokens, lengths, im_rolled, tie,
                                   prototypes, dim=dim)
    if tokens.device.type != "cuda":
        raise ValueError(f"fused_profile: unsupported device {tokens.device}")
    _check(tokens, lengths, im_rolled, tie, prototypes)
    n, alphabet, w = im_rolled.shape
    b, length = tokens.shape
    s = prototypes.shape[0]
    check_tiles(bb, cluster, length, n, alphabet, w)
    if -(-b // bb) > 65535:
        raise ValueError(f"fused_profile: at most {65535 * bb} reads per "
                         f"launch at bb={bb}, got {b}")
    # Rows of whole 32-word search steps; zero pad words are inert in
    # popc(a & b) (the encoded rows' pad words are zero too).  Only
    # W % 32 != 0 (small test widths) pays for this copy.
    protos = bitops.pad_to_multiple(prototypes, 1, STEP_WORDS)
    out = torch.empty((b, s), dtype=torch.int32, device=tokens.device)
    if b == 0 or s == 0:
        return out
    if protos.data_ptr() % 16:
        raise ValueError("fused_profile: prototypes must be 16-byte aligned")
    # Scratch for the prototypes' row popcounts |b|, written by the launch.
    pc = torch.empty(s, dtype=torch.int32, device=tokens.device)
    fg = (None if shared_tables(bb, cluster, length, n, alphabet, w)
          else wide_tables(im_rolled))
    with torch.cuda.device(tokens.device):
        err = _lib().fused_profile_launch(
            *map(_build.ptr, (tokens, lengths, im_rolled, tie)),
            None if fg is None else _build.ptr(fg),
            *map(_build.ptr, (protos, pc, out)),
            b, length, n, alphabet, w, s, dim, bb, cluster,
            _build.current_stream())
    if err != 0:
        raise RuntimeError(f"fused_profile: kernel launch failed with CUDA "
                           f"error {err}")
    _build.count_launch(fused_profile)
    return out


fused_profile.launches = 0
