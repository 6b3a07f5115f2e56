"""Execution backends: named, registered implementations of the hot path.

Counterpart of :mod:`repro.pipeline.backend`.  A :class:`Backend` owns the
two bit-exact primitives that differ per substrate,

  ``encode(tokens, lengths) -> (B, W)``          packed query HD vectors
  ``agreement(queries, prototypes) -> (B, S)``   matching-bit counts

and may expose the fused ``tokens_agreement(tokens, lengths,
prototypes)`` capability (steps 3+4 with no encoded matrix in device
memory), which :meth:`ProfilingSession.classify_batch` prefers.

Registered backends:

  reference        plain torch encoder + float32 +-1 matmul agreement.
  reference_packed plain torch encoder + packed XOR+popcount agreement.
  cuda_matmul      the CUDA encoder kernel + the +-1 tensor-core search
                   kernel on packed words (``am_matmul_packed``).
  cuda_packed      the CUDA encoder kernel + the b1 AND+popcount
                   tensor-core search kernel (``hamming_am``).
  cuda_fused       the hand-written CUDA encoder and fused encode->search
                   kernels (:mod:`repro_torch.pipeline.fused`).
  sharded          any of the above with the prototype axis split over the
                   ranks of a process group, one shard a rank
                   (:mod:`repro_torch.pipeline.sharded`).

Every backend takes ``device`` (``None``: ``cuda``, raising without a
GPU) and keeps its item memory and tie-break vector there.
"""

from __future__ import annotations

import functools
from typing import Callable, Protocol, runtime_checkable

import torch

from repro_torch.core import assoc_memory, encoder, item_memory
from repro_torch.core.hd_space import HDSpace
from repro_torch.device import resolve_device
from repro_torch.kernels import hdc_encoder, ops
from repro_torch.pipeline.config import ProfilerConfig
from repro_torch.pipeline.options import OptionsSchema


@runtime_checkable
class Backend(Protocol):
    """The two substrate-dependent primitives of the pipeline."""

    name: str
    space: HDSpace
    device: torch.device

    def encode(self, tokens: torch.Tensor, lengths: torch.Tensor
               ) -> torch.Tensor:
        """Read conversion (step 3): ``(B, L)`` tokens -> ``(B, W)`` packed."""
        ...

    def agreement(self, queries: torch.Tensor, prototypes: torch.Tensor
                  ) -> torch.Tensor:
        """AM search (step 4): ``(B, W) x (S, W)`` -> ``(B, S)`` int32."""
        ...


BackendFactory = Callable[..., Backend]

_REGISTRY: dict[str, BackendFactory] = {}
_SCHEMAS: dict[str, OptionsSchema] = {}

#: Backends that register themselves when their module is imported.
_LAZY_MODULES: dict[str, str] = {
    "cuda_fused": "repro_torch.pipeline.fused",
    "sharded": "repro_torch.pipeline.sharded",
}


def register_backend(name: str, schema: OptionsSchema | None = None
                     ) -> Callable[[BackendFactory], BackendFactory]:
    """Decorator: register a ``(config, device) -> Backend`` factory."""
    def deco(factory: BackendFactory) -> BackendFactory:
        if name in _REGISTRY:
            raise ValueError(f"backend {name!r} already registered")
        _REGISTRY[name] = factory
        _SCHEMAS[name] = (schema if schema is not None
                          else OptionsSchema(backend=name))
        return factory
    return deco


def available_backends() -> tuple[str, ...]:
    """Names of every registered backend (lazy entry points included)."""
    return tuple(sorted(set(_REGISTRY) | set(_LAZY_MODULES)))


def _materialize(name: str) -> None:
    """Import a lazy backend module so its registration runs."""
    if name not in _REGISTRY and name in _LAZY_MODULES:
        import importlib
        importlib.import_module(_LAZY_MODULES[name])


def options_schema(name: str) -> OptionsSchema:
    """The declared options schema of the backend registered as ``name``."""
    _materialize(name)
    try:
        return _SCHEMAS[name]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r}; registered: {available_backends()}"
        ) from None


def resolve_backend(name: str, config: ProfilerConfig, *,
                    device: str | torch.device | None = None) -> Backend:
    """Instantiate the backend registered under ``name`` for ``config``."""
    _materialize(name)
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r}; registered: {available_backends()}"
        ) from None
    return factory(config, device=device)


class _BackendBase:
    """Shared state: options check, device, item memory, tie-break vector
    (drawn in the config's threefry mode)."""

    name = "abstract"

    def __init__(self, config: ProfilerConfig, *,
                 device: str | torch.device | None = None):
        schema = _SCHEMAS.get(config.backend)
        if schema is not None:
            schema.validate(config.options)
        self.config = config
        self.space = config.space
        self.device = resolve_device(device)
        mode = config.threefry_partitionable
        self.im = item_memory.make_item_memory(self.space, device=self.device,
                                               partitionable=mode)
        self.tie = item_memory.make_tie_break(self.space, device=self.device,
                                              partitionable=mode)


@register_backend("reference")
class ReferenceBackend(_BackendBase):
    """Plain torch path: rolling-gram encoder + float32 +-1 matmul agreement.

    The numerical oracle the kernel backends must match bit-exactly.  The
    matmul is exact only in full float32, so TF32 is turned off on CUDA.
    """

    name = "reference"

    def __init__(self, config: ProfilerConfig, *,
                 device: str | torch.device | None = None):
        super().__init__(config, device=device)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
        self._agreement = functools.partial(
            assoc_memory.agreement_matmul, dim=self.space.dim)

    def encode(self, tokens: torch.Tensor, lengths: torch.Tensor
               ) -> torch.Tensor:
        return encoder.encode(tokens, lengths, self.im, self.tie, self.space)

    def agreement(self, queries: torch.Tensor, prototypes: torch.Tensor
                  ) -> torch.Tensor:
        return self._agreement(queries, prototypes)


@register_backend("reference_packed")
class ReferencePackedBackend(ReferenceBackend):
    """Plain torch path with the XOR+popcount agreement."""

    name = "reference_packed"

    def __init__(self, config: ProfilerConfig, *,
                 device: str | torch.device | None = None):
        super().__init__(config, device=device)
        self._agreement = functools.partial(
            assoc_memory.agreement_packed_chunked, dim=self.space.dim)


class _CudaKernelBackendBase(_BackendBase):
    """The CUDA encoder kernel + one standalone AM-search kernel (the
    kernels' plain torch versions on CPU tensors).

    The encode kernels take alphabets of 1 to 65,536 symbols (2-bit
    symbols up to 4, the wide path above); a space outside that range is
    refused here, on every device, rather than at the first launch.
    """

    formulation = "matmul"

    def __init__(self, config: ProfilerConfig, *,
                 device: str | torch.device | None = None):
        hdc_encoder.check_shape(self.name, 0, config.space.ngram,
                                config.space.alphabet_size)
        super().__init__(config, device=device)

    def encode(self, tokens: torch.Tensor, lengths: torch.Tensor
               ) -> torch.Tensor:
        return ops.hdc_encode(tokens, lengths, self.im, self.tie, self.space)

    def agreement(self, queries: torch.Tensor, prototypes: torch.Tensor
                  ) -> torch.Tensor:
        return ops.am_agreement(queries, prototypes, self.space.dim,
                                self.formulation)


@register_backend("cuda_matmul")
class CudaMatmulBackend(_CudaKernelBackendBase):
    """CUDA encoder kernel + +-1 bf16 tensor-core AM-search kernel."""

    name = "cuda_matmul"
    formulation = "matmul"


@register_backend("cuda_packed")
class CudaPackedBackend(_CudaKernelBackendBase):
    """CUDA encoder kernel + packed XOR+popcount AM-search kernel."""

    name = "cuda_packed"
    formulation = "packed"
