"""Public wrappers around the CUDA kernels (counterpart of
:mod:`repro.kernels.ops`).

They take the session-level arguments (item memory, tie vector, HD
space, formulation), build the rolled item memory and call the kernel
wrappers, which launch on CUDA tensors and run the
plain torch versions on CPU tensors.  Unlike ``repro``'s
``am_agreement``, nothing is padded to tile multiples: the search
kernels take ragged shapes.
"""

from __future__ import annotations

import torch

from repro_torch.core import bitops, item_memory
from repro_torch.core.hd_space import HDSpace
from repro_torch.kernels import am_matmul as _am_matmul
from repro_torch.kernels import fused_profile as _fused_profile
from repro_torch.kernels import hamming_am as _hamming_am
from repro_torch.kernels import hdc_encoder as _hdc_encoder

#: Elements of one row chunk's int32 bit intermediate in :func:`to_pm1`
#: (256 MB), so expanding a whole AM never holds ``(S, W, 32)`` int32.
_PM1_CHUNK_ELEMS = 2 ** 26


def to_pm1(packed: torch.Tensor) -> torch.Tensor:
    """Packed bits ``(..., W)`` -> {-1, +1} bf16 ``(..., 32 W)`` (the
    tensor-core encoding of the AM crossbar), as ``repro``'s ``to_pm1``.

    Plain torch on every device, as ``repro`` runs it outside any kernel;
    the rows are expanded a chunk at a time to bound the peak memory.
    The search path does not call it on CUDA tensors: the packed
    ``am_matmul`` entry expands the words on chip.
    """
    lead, w = packed.shape[:-1], packed.shape[-1]
    rows = packed.reshape(-1, w)
    out = torch.empty((rows.shape[0], 32 * w), dtype=torch.bfloat16,
                      device=packed.device)
    step = max(1, _PM1_CHUNK_ELEMS // max(1, 32 * w))
    for r in range(0, rows.shape[0], step):
        bits = bitops.unpack_bits(rows[r:r + step])
        out[r:r + step] = bits.to(torch.bfloat16).mul_(2).sub_(1)
    return out.reshape(*lead, 32 * w)


def am_agreement(queries: torch.Tensor, prototypes: torch.Tensor, dim: int,
                 formulation: str = "matmul") -> torch.Tensor:
    """Agreement (matching bits) of every query vs every prototype.

    Args:
      queries: ``(B, W)`` int32 packed.
      prototypes: ``(S, W)`` int32 packed.
      formulation: ``"matmul"`` (+-1 products on the tensor cores from the
        packed words, kernel 3, default) or ``"packed"`` (b1 AND +
        popcount on the tensor cores, kernel 4).

    Returns:
      ``(B, S)`` int32 agreement in [0, dim].
    """
    if formulation == "matmul":
        return _am_matmul.am_matmul_packed(queries.contiguous(),
                                           prototypes.contiguous(), dim=dim)
    if formulation == "packed":
        return _hamming_am.hamming_am(queries.contiguous(),
                                      prototypes.contiguous(), dim=dim)
    raise ValueError(f"unknown formulation {formulation!r}")


def hdc_encode(tokens: torch.Tensor, lengths: torch.Tensor, im: torch.Tensor,
               tie: torch.Tensor, space: HDSpace) -> torch.Tensor:
    """Kernel-backed read conversion (step 3): ``(B, L)`` -> ``(B, W)``.

    Same contract as :func:`repro_torch.core.encoder.encode`.
    """
    return _hdc_encoder.hdc_encode(
        tokens.to(torch.int32).contiguous(), lengths.to(torch.int32).contiguous(),
        item_memory.rolled(im, space.ngram).contiguous(), tie.contiguous())


def fused_tile_plan(b: int, s: int, w: int, *,
                    bb: int = _fused_profile.DEFAULT_BB,
                    cluster: int = _fused_profile.DEFAULT_CLUSTER,
                    ngram: int = 16, alphabet: int = 4, read_len: int = 0,
                    sms: int = 132) -> dict[str, int]:
    """The launch :func:`fused_agreement` runs, re-derived for Hopper.

    One cluster of ``cluster`` blocks per tile of ``bb`` reads and per
    ``splits``-th of the prototypes, where ``splits`` fills the ``sms``
    SMs (the kernel reads the SM count of the card it runs on).  Each
    block holds the encoded tile (16 or 32 rows of W words padded to 32)
    and, in turn, its encode scratch and its warps' prototype rings in
    shared memory (checked against the 227 KB a block may use;
    ``read_len=0`` checks the part that does not depend on the reads).
    Each tile reads every prototype row once.

    Returns ``bb``, ``cluster``, ``tiles`` (read tiles), ``splits``,
    ``blocks``, ``w_pad`` (prototype row words, a multiple of 32),
    ``smem_bytes`` per block and ``proto_bytes_per_call`` -- the
    prototype bytes the blocks load per launch (``tiles * S * w_pad * 4``,
    mostly served by L2).
    """
    smem = _fused_profile.check_tiles(bb, cluster, read_len, ngram, alphabet,
                                      w)
    tiles = -(-b // bb)
    splits = max(1, sms // max(1, tiles * cluster))
    w_pad = -(-w // _fused_profile.STEP_WORDS) * _fused_profile.STEP_WORDS
    return {"bb": bb, "cluster": cluster, "tiles": tiles, "splits": splits,
            "blocks": tiles * cluster * splits, "w_pad": w_pad,
            "smem_bytes": smem, "proto_bytes_per_call": tiles * s * w_pad * 4}


def fused_agreement(tokens: torch.Tensor, lengths: torch.Tensor,
                    im: torch.Tensor, tie: torch.Tensor,
                    prototypes: torch.Tensor, space: HDSpace, *,
                    bb: int = _fused_profile.DEFAULT_BB,
                    cluster: int = _fused_profile.DEFAULT_CLUSTER
                    ) -> torch.Tensor:
    """Fused steps 3+4: read tokens -> ``(B, S)`` agreement, with no
    encoded matrix in device memory.  Bit-identical to
    ``agreement(hdc_encode(tokens, lengths, im, tie, space), prototypes)``.
    """
    return _fused_profile.fused_profile(
        tokens.to(torch.int32).contiguous(), lengths.to(torch.int32).contiguous(),
        item_memory.rolled(im, space.ngram).contiguous(), tie.contiguous(),
        prototypes.contiguous(), dim=space.dim, bb=bb, cluster=cluster)
