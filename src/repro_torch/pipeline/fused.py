"""``cuda_fused``: the fused encode->search backend on the H100.

Counterpart of ``repro``'s ``pallas_fused`` (:mod:`repro.pipeline.fused`).
``tokens_agreement`` runs the fused kernel
(:mod:`repro_torch.kernels.fused_profile`): each read is encoded in
shared memory and scored against every prototype, and the encoded
``(B, W)`` matrix never reaches device memory.  ``encode`` -- the RefDB
build -- and the standalone ``agreement`` are ``cuda_matmul``'s: the
encoder kernel and the +-1 tensor-core search kernel, as ``repro``'s
``pallas_fused`` runs ``am_matmul`` there.  On CPU tensors each runs its
kernel's plain torch version.

Options (validated when the session is built, so a bad tiling is a
:class:`ValueError` there and never a launch failure mid-profile):

    bb       reads per cluster tile: 16 or 32 (default 16), one or two
             16-row tensor-core tiles of the search; bb = 32 halves the
             AM bytes a read costs.  Any batch size works: the rows of a
             tail tile past the batch are left idle.
    cluster  blocks per cluster sharing one encoded tile: 1, 2, 4 or 8
             (default 2).  Each block holds the encoded tile, the pair
             table of its 1/cluster of the words and its warps' prototype
             rings in shared memory; the pair must fit the 227 KB a block
             may use.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import fused_profile as _fused_profile
from repro_torch.kernels import ops
from repro_torch.pipeline.backend import (_CudaKernelBackendBase,
                                          register_backend)
from repro_torch.pipeline.config import ProfilerConfig
from repro_torch.pipeline.options import Option, OptionsSchema

_DEFAULTS = {"bb": _fused_profile.DEFAULT_BB,
             "cluster": _fused_profile.DEFAULT_CLUSTER}


def _batch_tile(v) -> str | None:
    if v < 1:
        return "must be a positive int"
    if v not in _fused_profile.BATCH_TILES:
        return (f"must be a power of two up to "
                f"{_fused_profile.BATCH_TILES[-1]} and at least "
                f"{_fused_profile.BATCH_TILES[0]} (one 16-row tensor-core "
                f"tile)")
    return None


FUSED_OPTIONS = OptionsSchema(backend="cuda_fused", options=(
    Option("bb", "int", default=_DEFAULTS["bb"], check=_batch_tile,
           help="reads per cluster tile (16 or 32)"),
    Option("cluster", "int", default=_DEFAULTS["cluster"],
           choices=_fused_profile.CLUSTER_SIZES,
           help="blocks per cluster sharing one encoded read tile"),
))


@register_backend("cuda_fused", schema=FUSED_OPTIONS)
class CudaFusedBackend(_CudaKernelBackendBase):
    """Hand-written CUDA encoder + fused encode->search kernels."""

    name = "cuda_fused"
    formulation = "matmul"

    def __init__(self, config: ProfilerConfig, *,
                 device: str | torch.device | None = None):
        super().__init__(config, device=device)
        opts = config.options
        self.tiles = {k: opts.get(k, v) for k, v in _DEFAULTS.items()}
        ops.fused_tile_plan(
            config.batch_size, 0, self.space.num_words,
            ngram=self.space.ngram, alphabet=self.space.alphabet_size,
            **self.tiles)

    def tokens_agreement(self, tokens: torch.Tensor, lengths: torch.Tensor,
                         prototypes: torch.Tensor) -> torch.Tensor:
        """Steps 3+4 fused: ``(B, L)`` tokens -> ``(B, S)`` agreement."""
        return ops.fused_agreement(tokens, lengths, self.im, self.tie,
                                   prototypes, self.space, **self.tiles)
