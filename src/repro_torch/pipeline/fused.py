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
    autotune        bool: resolve ``bb``/``cluster`` from the on-disk tile
             cache (:mod:`repro_torch.kernels.autotune`) at the first
             batch of each new (prototype count, read-length bucket),
             measuring once per cache key.  Explicit tile options win over
             autotune (warned once a process).
    autotune_cache  str: cache file override (else the
             ``REPRO_TORCH_AUTOTUNE_CACHE`` environment variable, else
             ``~/.cache/repro_torch/autotune.json``).
"""

from __future__ import annotations

import threading
import warnings

import torch

from repro_torch.kernels import fused_profile as _fused_profile
from repro_torch.kernels import ops
from repro_torch.pipeline.backend import (_CudaKernelBackendBase,
                                          register_backend)
from repro_torch.pipeline.config import ProfilerConfig
from repro_torch.pipeline.options import Option, OptionsSchema

_DEFAULTS = {"bb": _fused_profile.DEFAULT_BB,
             "cluster": _fused_profile.DEFAULT_CLUSTER}

#: warn only once per process when explicit tiles silence autotune
_warned_autotune_override = False


def _batch_tile(v) -> str | None:
    if v < 1:
        return "must be a positive int"
    if v not in _fused_profile.BATCH_TILES:
        return (f"must be a power of two up to "
                f"{_fused_profile.BATCH_TILES[-1]} and at least "
                f"{_fused_profile.BATCH_TILES[0]} (one 16-row tensor-core "
                f"tile)")
    return None


def _nonempty_path(v) -> str | None:
    return None if v else "must be a non-empty path"


FUSED_OPTIONS = OptionsSchema(backend="cuda_fused", options=(
    Option("bb", "int", default=_DEFAULTS["bb"], check=_batch_tile,
           help="reads per cluster tile (16 or 32)"),
    Option("cluster", "int", default=_DEFAULTS["cluster"],
           choices=_fused_profile.CLUSTER_SIZES,
           help="blocks per cluster sharing one encoded read tile"),
    Option("autotune", "bool", default=False,
           help="measure candidate tilings once per (S, read-length "
                "bucket)"),
    Option("autotune_cache", "str", default=None,
           check=_nonempty_path,
           help="JSON file persisting autotuner picks across processes"),
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
        explicit = sorted(k for k in _DEFAULTS if k in opts)
        self._autotune = bool(opts.get("autotune", False))
        self._autotune_cache = opts.get("autotune_cache")
        if self._autotune and explicit:
            global _warned_autotune_override
            if not _warned_autotune_override:
                _warned_autotune_override = True
                warnings.warn(
                    f"cuda_fused: explicit tile options {explicit} override "
                    f"autotune=true; the autotuner will not run for this "
                    f"backend", stacklevel=2)
            self._autotune = False
        #: (S, read-length bucket) -> the tiles autotune resolved for it
        self.tuned: dict[tuple[int, int], dict[str, int]] = {}
        # Sessions of several RefDB versions share this backend, and the
        # router pumps them from several threads.
        self._tune_lock = threading.Lock()

    def _resolve_tiles(self, num_prototypes: int, read_len: int
                       ) -> dict[str, int]:
        """Tiles for this batch; runs or reads the autotuner lazily.

        Each new (S, read-length bucket) pays the sweep (or a cache read)
        at its first batch; later batches of the bucket reuse the pick,
        which fits every read length of the bucket.
        """
        if not self._autotune:
            return self.tiles
        from repro_torch.kernels import autotune

        key = (num_prototypes, autotune.read_len_bucket(read_len))
        tiles = self.tuned.get(key)
        if tiles is not None:
            return tiles
        with self._tune_lock:
            tiles = self.tuned.get(key)
            if tiles is None:
                tiles, _ = autotune.tune(
                    self.space, batch=self.config.batch_size,
                    num_prototypes=num_prototypes, read_len=read_len,
                    path=self._autotune_cache, device=self.device)
                self.tuned[key] = tiles
                self.tiles = dict(tiles)
        return tiles

    def tokens_agreement(self, tokens: torch.Tensor, lengths: torch.Tensor,
                         prototypes: torch.Tensor) -> torch.Tensor:
        """Steps 3+4 fused: ``(B, L)`` tokens -> ``(B, S)`` agreement."""
        tiles = self._resolve_tiles(prototypes.shape[0], tokens.shape[1])
        return ops.fused_agreement(tokens, lengths, self.im, self.tie,
                                   prototypes, self.space, **tiles)
