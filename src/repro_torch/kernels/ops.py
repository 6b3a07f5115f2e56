"""Public wrappers around the CUDA kernels (counterpart of
:mod:`repro.kernels.ops`).

They take the session-level arguments (item memory, tie vector, HD
space), build the rolled item memory and call the kernel wrappers, which
launch on CUDA tensors and run the plain torch versions on CPU tensors.
"""

from __future__ import annotations

import torch

from repro_torch.core import item_memory
from repro_torch.core.hd_space import HDSpace
from repro_torch.kernels import fused_profile as _fused_profile
from repro_torch.kernels import hdc_encoder as _hdc_encoder


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
                    ngram: int = 16, alphabet: int = 4, read_len: int = 0
                    ) -> dict[str, int]:
    """The launch :func:`fused_agreement` runs, re-derived for Hopper.

    One cluster of ``cluster`` blocks per tile of ``bb`` reads; each block
    holds the ``(bb, W)`` encoded tile, its 1/cluster slice of the rolled
    item memory and the tile's tokens in shared memory (checked against
    the 227 KB a block may use; ``read_len=0`` checks the part that does
    not depend on the reads).  Each tile reads every prototype row once.

    Returns ``bb``, ``cluster``, ``tiles`` (read tiles), ``blocks``,
    ``w_pad`` (prototype row words, a multiple of 4), ``smem_bytes`` per
    block and ``proto_bytes_per_call`` -- the prototype bytes the blocks
    load per launch (``tiles * S * w_pad * 4``, mostly served by L2).
    """
    smem = _fused_profile.check_tiles(bb, cluster, read_len, ngram, alphabet,
                                      w)
    tiles = -(-b // bb)
    w_pad = -(-w // 4) * 4
    return {"bb": bb, "cluster": cluster, "tiles": tiles,
            "blocks": tiles * cluster, "w_pad": w_pad, "smem_bytes": smem,
            "proto_bytes_per_call": tiles * s * w_pad * 4}


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
