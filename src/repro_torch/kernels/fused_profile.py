"""Fused encode->search kernel: read tokens -> agreement with every prototype.

Replaces the TPU kernels ``repro/kernels/fused_profile.py::_kernel`` and
its double-buffered twin ``_kernel_dma`` (launched by ``fused_profile``)
with CUDA C++ for ``sm_90a`` (``csrc/fused_profile.cu``).

* What bounds it on the card: at the main path's shapes the search --
  ``B * S * W`` word XOR + popcount + add -- and the prototype stream
  (``S * W * 4`` bytes, read once per read tile, mostly from L2); the
  encode is ~10x smaller.
* What the design does about it: a cluster of ``cluster`` blocks owns a
  tile of ``bb`` reads.  Each block encodes 1/cluster of the words of the
  tile (each read is encoded once per launch, unlike the TPU grid, which
  re-encodes per prototype chunk), the blocks exchange their words
  through distributed shared memory, and each scores the whole encoded
  tile against 1/cluster of the prototypes, reusing every prototype word
  it loads for ``bb`` reads.  The encoded ``(B, W)`` matrix never reaches
  global memory.

:func:`fused_profile` launches the kernel for CUDA tensors and counts the
launch in ``fused_profile.launches``; for CPU tensors it runs
:func:`fused_profile_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import assoc_memory, bitops
from repro_torch.kernels import _build
from repro_torch.kernels.hdc_encoder import hdc_encode_plain

MAX_SMEM_BYTES = 232448
BATCH_TILES = (1, 2, 4, 8, 16)
CLUSTER_SIZES = (1, 2, 4, 8)
#: Fastest tiling of the sweep at the main path's shapes (B = 256, L = 150,
#: S = 9,780, D = 40,960): ``python3 chip_smoke.py --sweep``, see PERF.md.
DEFAULT_BB, DEFAULT_CLUSTER = 4, 8


def smem_bytes(bb: int, cluster: int, read_len: int, n: int, alphabet: int,
               w: int) -> int:
    """Shared memory of one block (``fused_profile_smem_bytes`` in C):
    the ``(bb, W)`` encoded tile with rows padded to 4 words, the block's
    item-memory slice and the tile's tokens as bytes."""
    q_words = bb * (-(-w // 4)) * 4
    im_words = n * alphabet * (-(-w // cluster))
    raw = (q_words + im_words) * 4 + bb * read_len
    return -(-raw // 16) * 16


def check_tiles(bb: int, cluster: int, read_len: int, n: int, alphabet: int,
                w: int) -> int:
    """Validate a tiling; returns its shared-memory bytes per block."""
    if bb not in BATCH_TILES:
        raise ValueError(f"fused_profile: bb must be one of {BATCH_TILES}, "
                         f"got {bb}")
    if cluster not in CLUSTER_SIZES:
        raise ValueError(f"fused_profile: cluster must be one of "
                         f"{CLUSTER_SIZES}, got {cluster}")
    smem = smem_bytes(bb, cluster, read_len, n, alphabet, w)
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
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
        lib.fused_profile_launch.restype = ctypes.c_int
        lib.fused_profile_smem_bytes.argtypes = [ctypes.c_int] * 6
        lib.fused_profile_smem_bytes.restype = ctypes.c_longlong
        lib._typed = True
    return lib


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
    if im_rolled.shape[1] > 256:
        raise ValueError("fused_profile: the kernel stages tokens as bytes; "
                         "alphabets above 256 symbols are not supported")


def fused_profile(tokens: torch.Tensor, lengths: torch.Tensor,
                  im_rolled: torch.Tensor, tie: torch.Tensor,
                  prototypes: torch.Tensor, *, dim: int,
                  bb: int = DEFAULT_BB, cluster: int = DEFAULT_CLUSTER
                  ) -> torch.Tensor:
    """Agreement of every read against every prototype, in one launch.

    Args:
      tokens: ``(B, L)`` int32 symbol ids in [0, alphabet).
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
    # 16-byte prototype rows; zero pad words are inert (the encoded rows'
    # pad words are zero too).  Only W % 4 != 0 (small test widths) pays
    # for this copy.
    protos = bitops.pad_to_multiple(prototypes, 1, 4)
    out = torch.empty((b, s), dtype=torch.int32, device=tokens.device)
    if b == 0 or s == 0:
        return out
    if protos.data_ptr() % 16:
        raise ValueError("fused_profile: prototypes must be 16-byte aligned")
    with torch.cuda.device(tokens.device):
        err = _lib().fused_profile_launch(
            *map(_build.ptr, (tokens, lengths, im_rolled, tie, protos, out)),
            b, length, n, alphabet, w, s, dim, bb, cluster,
            _build.current_stream())
    if err != 0:
        raise RuntimeError(f"fused_profile: kernel launch failed with CUDA "
                           f"error {err}")
    fused_profile.launches += 1
    return out


fused_profile.launches = 0
