"""PCM cell models for the simulated Acc-Demeter crossbar (paper §5).

Counterpart of :mod:`repro.accel.device`.  A binary HD bit is stored as
the conductance of one phase-change-memory cell (logical 1 = SET, high
conductance ``g_on_us``; 0 = RESET, ``g_off_us``); every way a real PCM
array diverges from that ideal is a knob on the frozen
:class:`DeviceConfig` -- multi-bit levels, programming noise, conductance
drift, stuck-at faults and bit-line read noise -- with ``repro``'s
semantics and ``repro``'s draws: the same keys (``fold_in(fold_in(
key(seed), bank), source)``, sources ``_PROG, _FAULT, READ_SOURCE = 0, 1,
2``), the same ``jax.random`` words (the Threefry kernel on the card,
:mod:`repro_torch.kernels.threefry`), and float32 arithmetic in ``repro``'s
order, each Python constant rounded to float32 as JAX rounds it.

:class:`PCMSubstrate` adapts the cell model to the
:class:`repro_torch.accel.substrate.Substrate` protocol (registered as
``"pcm"``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.accel import substrate as _sub
from repro_torch.accel.substrate import f32, register_substrate
from repro_torch.core import threefry
from repro_torch.pipeline.options import (Option, non_negative, positive,
                                          unit_interval)


@dataclasses.dataclass(frozen=True)
class DeviceConfig:
    """Frozen PCM cell parameters (defaults = ideal, zero-noise device).

    Attributes:
      g_on_us: SET (crystalline) conductance, microsiemens.
      g_off_us: RESET (amorphous) conductance, microsiemens.
      levels: conductance levels the program-and-verify loop can target
        (2 = binary SET/RESET, 4/8 = MLC-precision programming).  HD bits
        always sit at the extreme levels; ``levels`` sets the *absolute*
        noise scale through the level spacing, and the per-cell
        programming cost through the longer verify sequence.
      prog_sigma: programming-noise std as a fraction of the level
        spacing ``(g_on_us - g_off_us) / (levels - 1)`` — at the binary
        default the spacing is the full window, so existing
        parameterizations are unchanged; 0 disables.
      read_sigma: per-cell read-noise std as a fraction of the level
        spacing; applied at the bit line scaled by sqrt(active rows);
        0 disables.
      drift_nu: conductance-drift exponent (``g *= (t/t0)**-nu``,
        t0 = 1 s); 0 disables.
      drift_t_s: seconds elapsed since programming (drift horizon).
      drift_calibration: fraction of the drift decay the read periphery
        compensates via reference-cell calibration (standard PCM
        practice); 1 = perfect compensation, 0 = raw drifted currents.
        The residual ``drift_factor**(1 - drift_calibration)`` scale
        error is the non-ideality the profiler actually sees.
      stuck_on_rate: fraction of cells pinned at ``g_on_us``.
      stuck_off_rate: fraction of cells pinned at ``g_off_us``.
      seed: base PRNG seed for every device sample (programming noise,
        fault map, read noise); the backend threads it from
        ``ProfilerConfig.backend_options``.
    """

    g_on_us: float = 20.0
    g_off_us: float = 0.1
    levels: int = 2
    prog_sigma: float = 0.0
    read_sigma: float = 0.0
    drift_nu: float = 0.0
    drift_t_s: float = 0.0
    drift_calibration: float = 1.0
    stuck_on_rate: float = 0.0
    stuck_off_rate: float = 0.0
    seed: int = 0xACC_DE

    def __post_init__(self) -> None:
        if self.g_on_us <= self.g_off_us:
            raise ValueError("g_on_us must exceed g_off_us")
        if self.g_off_us < 0:
            raise ValueError("g_off_us must be >= 0")
        if self.levels < 2:
            raise ValueError("levels must be >= 2")
        for f in ("prog_sigma", "read_sigma", "drift_nu", "drift_t_s"):
            if getattr(self, f) < 0:
                raise ValueError(f"{f} must be >= 0")
        for f in ("stuck_on_rate", "stuck_off_rate", "drift_calibration"):
            if not 0.0 <= getattr(self, f) <= 1.0:
                raise ValueError(f"{f} must be in [0, 1]")
        if self.stuck_on_rate + self.stuck_off_rate > 1.0:
            raise ValueError("stuck_on_rate + stuck_off_rate must be <= 1")

    @property
    def g_window_us(self) -> float:
        """The ON/OFF conductance window (the unit of one agreement count)."""
        return self.g_on_us - self.g_off_us

    @property
    def level_spacing_us(self) -> float:
        """Conductance gap between adjacent programmable levels — the
        precision the program-and-verify loop resolves, and therefore the
        physical scale of both noise sigmas.  Binary cells: the window."""
        return self.g_window_us / (self.levels - 1)

    @property
    def is_ideal(self) -> bool:
        """True when every non-ideality is switched off (bit-exact path)."""
        return (self.prog_sigma == 0.0 and self.read_sigma == 0.0
                and self.residual_drift == 1.0
                and self.stuck_on_rate == 0.0 and self.stuck_off_rate == 0.0)

    @property
    def drift_factor(self) -> float:
        """Multiplicative conductance decay after ``drift_t_s`` seconds."""
        if self.drift_nu == 0.0 or self.drift_t_s <= 1.0:
            return 1.0
        return float(self.drift_t_s ** -self.drift_nu)

    @property
    def residual_drift(self) -> float:
        """Drift scale error left after periphery calibration."""
        return float(self.drift_factor ** (1.0 - self.drift_calibration))

    @classmethod
    def pcm(cls, **overrides) -> "DeviceConfig":
        """Literature-parameterized mushroom-cell PCM (Karunaratne-style
        silicon prototype numbers): ~8% programming spread, ~3% read
        fluctuation, nu = 0.05 drift read back after ~1 day with 90%
        reference-cell calibration, 1e-3 stuck cells per polarity."""
        base = dict(prog_sigma=0.08, read_sigma=0.03,
                    drift_nu=0.05, drift_t_s=86_400.0, drift_calibration=0.9,
                    stuck_on_rate=1e-3, stuck_off_rate=1e-3)
        base.update(overrides)
        return cls(**base)


def _key(cfg: DeviceConfig, stream: int, source: int) -> tuple:
    """Deterministic sub-key: one per (crossbar bank, noise source)."""
    return _sub.sub_key(cfg.seed, stream, source)


# Noise-source tags -- one per physically distinct mechanism.
_PROG, _FAULT, READ_SOURCE = 0, 1, 2


def program_conductances(bits: torch.Tensor, cfg: DeviceConfig, *,
                         stream: int = 0,
                         partitionable: bool = threefry.PARTITIONABLE
                         ) -> torch.Tensor:
    """Program a {0,1} bit tensor into per-cell conductances (uS).

    Target level, programming spread, drift to the read-back horizon, then
    the stuck-at fault map (faults win).  With ``cfg.is_ideal`` the result
    is exactly ``g_off + bits * (g_on - g_off)``.  Returns float32
    conductances of ``bits``' shape, clipped to >= 0, on its device.
    """
    b = bits.to(torch.float32)
    g = b * f32(cfg.g_window_us) + f32(cfg.g_off_us)
    if cfg.prog_sigma > 0.0:
        _sub.add_normal(_key(cfg, stream, _PROG), g,
                        cfg.prog_sigma * cfg.level_spacing_us, partitionable)
    if cfg.drift_factor != 1.0:
        g = g * f32(cfg.drift_factor)
    if cfg.stuck_on_rate > 0.0 or cfg.stuck_off_rate > 0.0:
        u = _sub.draw_uniform(_key(cfg, stream, _FAULT), tuple(b.shape),
                              b.device, partitionable)
        g.masked_fill_(u < f32(cfg.stuck_on_rate), f32(cfg.g_on_us))
        g.masked_fill_(u > f32(1.0 - cfg.stuck_off_rate), f32(cfg.g_off_us))
        del u
    return g.clamp_min_(0.0)


def stuck_cell_counts(shape: tuple[int, ...], cfg: DeviceConfig, *,
                      stream: int = 0,
                      partitionable: bool = threefry.PARTITIONABLE,
                      device: str | torch.device = "cpu") -> tuple[int, int]:
    """Census of one bank's stuck-at fault map: ``(stuck_on, stuck_off)``,
    from the exact uniform draw :func:`program_conductances` masks with."""
    if cfg.stuck_on_rate == 0.0 and cfg.stuck_off_rate == 0.0:
        return 0, 0
    u = _sub.draw_uniform(_key(cfg, stream, _FAULT), tuple(shape), device,
                          partitionable)
    return (int((u < f32(cfg.stuck_on_rate)).sum()),
            int((u > f32(1.0 - cfg.stuck_off_rate)).sum()))


def read_event_key(cfg: DeviceConfig, stream: int, digest: int) -> tuple:
    """Key for one read event on one bank: the batch digest (taken mod
    2**32) folded into the bank's read key."""
    return threefry.fold_in(_key(cfg, stream, READ_SOURCE), digest)


def bitline_read_std(active_rows: torch.Tensor, cfg: DeviceConfig
                     ) -> torch.Tensor:
    """Std of the bit-line read current (uS-equivalent) per read:
    ``read_sigma * level_spacing * sqrt(active_rows)``, the sum of
    ``active_rows`` independent per-cell fluctuations."""
    return f32(cfg.read_sigma * cfg.level_spacing_us) * torch.sqrt(
        torch.clamp_min(active_rows.to(torch.float32), 0.0))


def bitline_read_noise(key, shape: tuple[int, ...],
                       active_rows: torch.Tensor, cfg: DeviceConfig, *,
                       partitionable: bool = threefry.PARTITIONABLE
                       ) -> torch.Tensor:
    """Per-read current noise at the bit line (uS-equivalent):
    ``std * normal(key, shape)`` with ``active_rows`` broadcast against
    ``shape``; zeros when ``read_sigma == 0``.  (The crossbar adds the
    noise of all row tiles at once through :meth:`PCMSubstrate
    .add_read_noise`; this is the one-event form.)"""
    noise = torch.zeros(shape, dtype=torch.float32,
                        device=active_rows.device)
    if cfg.read_sigma == 0.0:
        return noise
    _sub.add_normal(key, noise, 1.0, partitionable)
    return bitline_read_std(active_rows, cfg) * noise


# -- the Substrate-protocol adapter -----------------------------------------

#: Declared PCM-specific backend options (geometry/selection options are
#: contributed by :data:`repro_torch.accel.substrate.COMMON_OPTIONS`).
PCM_OPTIONS: tuple[Option, ...] = (
    Option("preset", "str", "ideal", "named device parameterization "
           "(ideal = zero noise, pcm = literature-calibrated silicon)",
           choices=("ideal", "pcm")),
    Option("levels", "int", 2, "programmable conductance levels per cell "
           "(2 = binary; 4/8 = MLC precision, tighter noise, costlier "
           "programming)", choices=(2, 4, 8)),
    Option("g_on_us", "number", 20.0, "SET conductance, uS", check=positive),
    Option("g_off_us", "number", 0.1, "RESET conductance, uS",
           check=non_negative),
    Option("prog_sigma", "number", 0.0,
           "programming-noise std / level spacing", check=non_negative),
    Option("read_sigma", "number", 0.0,
           "per-cell read-noise std / level spacing", check=non_negative),
    Option("drift_nu", "number", 0.0, "conductance-drift exponent",
           check=non_negative),
    Option("drift_t_s", "number", 0.0, "seconds since programming",
           check=non_negative),
    Option("drift_calibration", "number", 1.0,
           "fraction of drift the periphery compensates",
           check=unit_interval),
    Option("stuck_on_rate", "number", 0.0, "cells pinned at g_on",
           check=unit_interval),
    Option("stuck_off_rate", "number", 0.0, "cells pinned at g_off",
           check=unit_interval),
)

_PRESETS = {"ideal": DeviceConfig, "pcm": DeviceConfig.pcm}


@dataclasses.dataclass(frozen=True)
class PCMSubstrate:
    """:class:`~repro_torch.accel.substrate.Substrate` over the PCM cell
    model.  Stored state is the per-cell conductance map (uS); the read
    weight of a cell is its calibrated, pedestal-free conductance in window
    units -- exactly the programmed bit on an ideal device."""

    config: DeviceConfig = DeviceConfig()
    partitionable: bool = threefry.PARTITIONABLE

    name = "pcm"

    @classmethod
    def from_options(cls, options: dict, *,
                     partitionable: bool = threefry.PARTITIONABLE
                     ) -> "PCMSubstrate":
        opts = dict(options)
        preset = opts.pop("preset", "ideal")
        return cls(_PRESETS[preset](**opts), partitionable)

    @property
    def is_ideal(self) -> bool:
        return self.config.is_ideal

    @property
    def _calibration_divisor(self) -> float:
        cfg = self.config
        return cfg.drift_factor ** cfg.drift_calibration

    def program(self, bits: torch.Tensor, *, stream: int = 0
                ) -> torch.Tensor:
        return program_conductances(bits, self.config, stream=stream,
                                    partitionable=self.partitionable)

    def read_weights(self, state: torch.Tensor, *, stream: int = 0
                     ) -> torch.Tensor:
        # The periphery divides out its reference-cell drift estimate, then
        # inverts with the nominal window and g_off pedestal.  Divisions by
        # a tensor on the state's device: torch divides a CUDA tensor by a
        # host scalar as a multiply by its reciprocal, which is not JAX's
        # quotient.
        cfg = self.config
        div = torch.tensor(f32(self._calibration_divisor), device=state.device)
        window = torch.tensor(f32(cfg.g_window_us), device=state.device)
        return (state / div - f32(cfg.g_off_us)) / window

    def read_event_key(self, stream: int, digest: int) -> tuple:
        return read_event_key(self.config, stream, digest)

    def read_noise_scale(self, active_rows: torch.Tensor
                         ) -> tuple[torch.Tensor, float]:
        """``(std, divisor)`` of a read's noise: ``std * normal / divisor``
        counts (the bit-line current noise through the same calibration
        divide and window normalization the signal sees)."""
        cfg = self.config
        return (bitline_read_std(active_rows, cfg),
                f32(self._calibration_divisor * cfg.g_window_us))

    def add_read_noise(self, keys: np.ndarray, counts: torch.Tensor,
                       active_rows: torch.Tensor) -> torch.Tensor:
        if self.config.read_sigma == 0.0:
            return counts
        return _sub.add_tile_read_noise(
            keys, counts, *self.read_noise_scale(active_rows),
            self.partitionable)

    def fault_census(self, shape: tuple[int, ...], *, stream: int = 0,
                     device: str | torch.device = "cpu") -> dict[str, int]:
        n_on, n_off = stuck_cell_counts(shape, self.config, stream=stream,
                                        partitionable=self.partitionable,
                                        device=device)
        return {"on": n_on, "off": n_off}

    def cost(self, num_protos: int, dim: int, read_len: int, ngram: int,
             xcfg):
        from repro_torch.accel import cost as cost_mod
        return cost_mod.accel_cost(num_protos, dim, read_len, ngram, xcfg,
                                   levels=self.config.levels)


@register_substrate("pcm", PCM_OPTIONS)
def _make_pcm(options: dict, partitionable: bool) -> PCMSubstrate:
    return PCMSubstrate.from_options(options, partitionable=partitionable)
