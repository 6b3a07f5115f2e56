"""The unified profiling API on torch (counterpart of :mod:`repro.pipeline`).

  :class:`~repro_torch.pipeline.config.ProfilerConfig`  the run's record
      (same fields and fingerprints as ``repro``'s);
  :mod:`~repro_torch.pipeline.backend`  the backend registry
      (``reference``, ``reference_packed``, ``cuda_matmul``,
      ``cuda_packed``, ``cuda_fused``, ``sharded``) and each backend's
      declared options (``options_schema``);
  :mod:`~repro_torch.pipeline.source`   streaming read input;
  :class:`~repro_torch.pipeline.session.ProfilingSession`  the facade.
"""

from repro_torch.pipeline.report import ProfileAccumulator, ProfileReport
from repro_torch.pipeline.config import ProfilerConfig
from repro_torch.pipeline.backend import (Backend, CudaMatmulBackend,
                                          CudaPackedBackend,
                                          available_backends, options_schema,
                                          register_backend, resolve_backend)
from repro_torch.pipeline.source import (ArraySource, FastqSource,
                                         IterableSource, ReadBatch,
                                         ReadSource, SyntheticSource,
                                         as_source, prefetch)
from repro_torch.pipeline import refdb_store
from repro_torch.pipeline.fused import CudaFusedBackend
from repro_torch.pipeline.sharded import (ShardedBackend, pad_refdb,
                                          per_device_bytes, place_refdb)
from repro_torch.pipeline.session import BatchResult, ProfilingSession

__all__ = [
    "ProfileAccumulator", "ProfileReport", "ProfilerConfig",
    "Backend", "CudaMatmulBackend", "CudaPackedBackend",
    "available_backends", "options_schema", "register_backend",
    "resolve_backend",
    "ArraySource", "FastqSource", "IterableSource", "ReadBatch",
    "ReadSource", "SyntheticSource", "as_source", "prefetch",
    "BatchResult", "CudaFusedBackend", "ProfilingSession", "refdb_store",
    "ShardedBackend", "pad_refdb", "per_device_bytes", "place_refdb",
]
