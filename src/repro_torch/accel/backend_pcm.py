"""``pcm_sim`` / ``racetrack_sim``: the simulated-substrate backends.

Counterpart of :mod:`repro.accel.backend_pcm`.  One generic
:class:`SubstrateBackend` runs the AM search (step 4) through the
substrate-generic differential array simulator of
:mod:`repro_torch.accel.crossbar`; read conversion (step 3) runs through
``kernels/ops.hdc_encode`` -- the ``hdc_encoder`` CUDA kernel on the
card, its plain version on the host.  ``repro`` encodes these backends
with its reference encoder; every backend's encode is bit-exact with it,
so the RefDB cache stays shared across all backends and the digital
prototypes are what gets programmed (with noise) into the device.

Which device physics runs underneath is a registered
:class:`repro_torch.accel.substrate.Substrate`; the two backend names are
the same class with different default substrates, and the ``substrate``
option can override either::

    ProfilerConfig(backend="pcm_sim",
                   backend_options={"preset": "pcm", "levels": 4,
                                    "read_sigma": 0.5, "adc_bits": 8})
    ProfilerConfig(backend="racetrack_sim",
                   backend_options={"preset": "racetrack", "seed": 1})

The registered schema is the union over substrates; once the substrate is
chosen the option set narrows to geometry + that substrate's knobs.  With
default (ideal) options both backends are bit-exact with ``reference``;
with noise they draw ``repro``'s noise in the config's threefry mode.

The banks are programmed once per distinct prototype tensor (the cache
holds a strong reference to it, so the identity check cannot alias a
recycled ``id``), and the cache keeps the banks' *read weights* -- the
substrate's ``read_weights`` of the programmed state, a pure function of
the state and the seed -- so a batch pays only the read, where ``repro``
recomputes the weights every batch.
"""

from __future__ import annotations

import time

import torch

from repro_torch import obs
from repro_torch.accel import device as _device          # registers "pcm"
from repro_torch.accel import racetrack as _racetrack    # registers "racetrack"
from repro_torch.accel import substrate as substrate_mod
from repro_torch.accel.crossbar import (CrossbarConfig, program_prototypes,
                                        read_banks)
from repro_torch.accel.substrate import (CROSSBAR_KEYS, Substrate,
                                        resolve_substrate, union_schema)
from repro_torch.core import threefry
from repro_torch.pipeline.backend import (_CudaKernelBackendBase,
                                          register_backend)
from repro_torch.pipeline.config import ProfilerConfig

del _device, _racetrack  # imported for their registration side effects


def split_options(options: dict, *, backend: str = "pcm_sim",
                  default_substrate: str = "pcm",
                  partitionable: bool = threefry.PARTITIONABLE
                  ) -> tuple[CrossbarConfig, Substrate]:
    """Build ``(CrossbarConfig, Substrate)`` from flat backend options,
    validated against the substrate-narrowed schema (unknown names and
    mistyped values raise the uniform friendly ``ValueError``)."""
    sub_name = options.get("substrate", default_substrate)
    if not isinstance(sub_name, str) \
            or sub_name not in substrate_mod.available_substrates():
        raise ValueError(
            f"{backend} option 'substrate' must be one of "
            f"{list(substrate_mod.available_substrates())}, got {sub_name!r}")
    narrowed = substrate_mod.narrowed_schema(backend, sub_name)
    own = narrowed.validate(options)
    xcfg = CrossbarConfig(**{k: v for k, v in own.items()
                             if k in CROSSBAR_KEYS})
    sub_opts = {k: v for k, v in own.items()
                if k not in CROSSBAR_KEYS and k != "substrate"}
    return xcfg, resolve_substrate(sub_name, sub_opts,
                                   partitionable=partitionable)


class SubstrateBackend(_CudaKernelBackendBase):
    """Encoder kernel + simulated in-memory AM search."""

    name = "abstract_substrate"
    default_substrate = "pcm"

    def __init__(self, config: ProfilerConfig, *,
                 device: str | torch.device | None = None):
        super().__init__(config, device=device)
        if self.device.type == "cuda":      # full float32 noisy products
            torch.backends.cuda.matmul.allow_tf32 = False
        self.crossbar_config, self.substrate = split_options(
            config.options, backend=self.name,
            default_substrate=self.default_substrate,
            partitionable=config.threefry_partitionable)
        self._programmed: tuple[torch.Tensor, torch.Tensor,
                                torch.Tensor] | None = None
        #: Host seconds of the last programming event (ending in a
        #: synchronize), or None before the first.
        self.program_seconds: float | None = None
        prefix = self.name.removesuffix("_sim")
        self._obs = obs.resolve_metrics(None)
        self._m_prog_events = self._obs.counter(
            f"{prefix}_program_events_total",
            "Array programming events (prototype-array cache misses).")
        self._m_prog_seconds = self._obs.histogram(
            f"{prefix}_program_seconds",
            "Host seconds to program both banks and cache their read "
            "weights, ending in a synchronize.", unit="s")
        self._m_reads = self._obs.counter(
            f"{prefix}_reads_total", "AM read events (one per batch).")
        self._m_adc_clips = self._obs.counter(
            f"{prefix}_adc_clips_total",
            "Converter codes saturated at the range limits.")
        self._m_stuck = self._obs.gauge(
            f"{prefix}_stuck_cells",
            "Static fault sites in the programmed banks, by kind.")

    def _program(self, prototypes: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
        """Program both banks and return their read weights."""
        s_pos, s_neg = program_prototypes(prototypes, self.crossbar_config,
                                          self.substrate)
        w_pos = self.substrate.read_weights(s_pos, stream=0)
        del s_pos
        return w_pos, self.substrate.read_weights(s_neg, stream=1)

    def program(self, prototypes: torch.Tensor) -> None:
        """Program the banks for ``prototypes`` unless they already hold
        them (one programming event per distinct prototype tensor), and
        time it in :attr:`program_seconds`; under a running
        ``torch.profiler`` the span ``repro_torch.crossbar.program``."""
        if self._programmed is not None and self._programmed[0] is prototypes:
            return
        self._programmed = None                  # free the old banks first
        t0 = time.perf_counter()
        with obs.span("repro_torch.crossbar.program"):
            self._programmed = (prototypes, *self._program(prototypes))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.program_seconds = time.perf_counter() - t0
        if self._obs.enabled:
            self._m_prog_seconds.observe(self.program_seconds)
            self._note_programmed(tuple(self._programmed[1].shape))

    @property
    def banks_bytes(self) -> int:
        """Device bytes of the programmed banks' cached read weights."""
        if self._programmed is None:
            return 0
        return sum(w.numel() * w.element_size()
                   for w in self._programmed[1:])

    def agreement(self, queries: torch.Tensor, prototypes: torch.Tensor
                  ) -> torch.Tensor:
        b, s = queries.shape[0], prototypes.shape[0]
        self.program(prototypes)
        _, w_pos, w_neg = self._programmed
        dim = self.space.dim
        if self._obs.enabled:
            out, clips = read_banks(queries, w_pos, w_neg, dim,
                                    self.crossbar_config, self.substrate,
                                    with_stats=True)
            self._m_reads.inc(1)
            self._m_adc_clips.inc(clips)
            return out[:b, :s]
        return read_banks(queries, w_pos, w_neg, dim, self.crossbar_config,
                          self.substrate)[:b, :s]

    def _note_programmed(self, bank_shape: tuple[int, ...]) -> None:
        """Record one programming event + the banks' fault census."""
        self._m_prog_events.inc(1)
        for stream, bank in ((0, "pos"), (1, "neg")):
            census = self.substrate.fault_census(bank_shape, stream=stream,
                                                 device=self.device)
            for kind, n in census.items():
                self._m_stuck.set(n, bank=bank, polarity=kind)


@register_backend("pcm_sim", schema=union_schema("pcm_sim", "pcm"))
class PCMSimBackend(SubstrateBackend):
    """The simulated AM search on the PCM crossbar substrate."""

    name = "pcm_sim"
    default_substrate = "pcm"


@register_backend("racetrack_sim",
                  schema=union_schema("racetrack_sim", "racetrack"))
class RacetrackSimBackend(SubstrateBackend):
    """The simulated AM search on the racetrack (domain-wall) substrate."""

    name = "racetrack_sim"
    default_substrate = "racetrack"


#: historical alias (the backend predates the substrate split).
PCMBackend = PCMSimBackend
