"""Racetrack (domain-wall) memory substrate for the simulated AM search.

Counterpart of :mod:`repro.accel.racetrack`: each prototype segment of
``rows`` HD bits lives as magnetic domains along one nanowire *track*,
read by transverse read (a popcount) after shifting the track under its
ports.  The non-idealities: seeded per-track access misalignment (a
``+-1`` circular offset on ``shift_fault_rate`` of the tracks, static and
census-able), stuck domains, and transverse-read sense noise
(``read_sigma * sqrt(active domains)``, in count units).  Keys and draws
are ``repro``'s: ``fold_in(fold_in(key(seed), bank), source)`` with the
sources ``_FAULT, _SHIFT, _READ = 0, 1, 2`` (not PCM's order), words from
the Threefry kernel on the card.  ``repro``'s ``take_along_axis`` over the
misaligned tracks becomes a per-offset roll of just those tracks
(:func:`repro_torch.accel.crossbar.roll_tracks`).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.accel import substrate as _sub
from repro_torch.accel.crossbar import roll_tracks
from repro_torch.accel.substrate import f32, register_substrate
from repro_torch.core import threefry
from repro_torch.pipeline.options import Option, non_negative, unit_interval


@dataclasses.dataclass(frozen=True)
class RacetrackConfig:
    """Frozen racetrack nanowire parameters (defaults = ideal device).

    Attributes:
      shift_fault_rate: fraction of tracks with a permanent ±1 access
        misalignment (split evenly between the two directions).
      read_sigma: transverse-read sense-noise std per sqrt(active domain),
        in count units; 0 disables.
      stuck_on_rate: fraction of domains pinned at logical 1.
      stuck_off_rate: fraction of domains pinned at logical 0.
      ports: access ports per track (cost model: shifts per access scale
        with ``rows / ports``).
      tr_span: domains one transverse read senses at once (cost model).
      seed: base PRNG seed for fault maps and read noise.
    """

    shift_fault_rate: float = 0.0
    read_sigma: float = 0.0
    stuck_on_rate: float = 0.0
    stuck_off_rate: float = 0.0
    ports: int = 4
    tr_span: int = 5
    seed: int = 0xACC_DE

    def __post_init__(self) -> None:
        if self.read_sigma < 0:
            raise ValueError("read_sigma must be >= 0")
        for f in ("shift_fault_rate", "stuck_on_rate", "stuck_off_rate"):
            if not 0.0 <= getattr(self, f) <= 1.0:
                raise ValueError(f"{f} must be in [0, 1]")
        if self.stuck_on_rate + self.stuck_off_rate > 1.0:
            raise ValueError("stuck_on_rate + stuck_off_rate must be <= 1")
        if self.ports < 1 or self.tr_span < 1:
            raise ValueError("ports and tr_span must be >= 1")

    @property
    def is_ideal(self) -> bool:
        """True when every non-ideality is switched off (bit-exact path)."""
        return (self.shift_fault_rate == 0.0 and self.read_sigma == 0.0
                and self.stuck_on_rate == 0.0 and self.stuck_off_rate == 0.0)

    @classmethod
    def racetrack(cls, **overrides) -> "RacetrackConfig":
        """Literature-flavored noisy device: ~0.2% misaligned tracks
        (the HDCR papers' shift-error regime), 2% TR sense fluctuation,
        5e-4 pinned domains per polarity."""
        base = dict(shift_fault_rate=2e-3, read_sigma=0.02,
                    stuck_on_rate=5e-4, stuck_off_rate=5e-4)
        base.update(overrides)
        return cls(**base)


def _key(cfg: RacetrackConfig, stream: int, source: int) -> tuple:
    """Deterministic sub-key: one per (bank, noise source)."""
    return _sub.sub_key(cfg.seed, stream, source)


# Noise-source tags -- one per physically distinct mechanism.
_FAULT, _SHIFT, _READ = 0, 1, 2


def _shift_offsets(cfg: RacetrackConfig, track_shape: tuple[int, ...],
                   stream: int, *, partitionable: bool = threefry.PARTITIONABLE,
                   device: str | torch.device = "cpu") -> torch.Tensor:
    """Seeded per-track access misalignment: -1 / 0 / +1 domain offsets
    (int64, ``track_shape``)."""
    u = _sub.draw_uniform(_key(cfg, stream, _SHIFT), tuple(track_shape),
                          device, partitionable)
    return torch.where(u < f32(cfg.shift_fault_rate / 2), -1,
                       torch.where(u < f32(cfg.shift_fault_rate), 1, 0))


#: Declared racetrack-specific backend options (geometry/selection options
#: come from :data:`repro_torch.accel.substrate.COMMON_OPTIONS`).
RACETRACK_OPTIONS: tuple[Option, ...] = (
    Option("preset", "str", "ideal", "named device parameterization "
           "(ideal = zero noise, racetrack = literature-flavored faults)",
           choices=("ideal", "racetrack")),
    Option("shift_fault_rate", "number", 0.0,
           "fraction of tracks with a permanent +-1 access misalignment",
           check=unit_interval),
    Option("read_sigma", "number", 0.0,
           "transverse-read sense-noise std per sqrt(active domain)",
           check=non_negative),
    Option("stuck_on_rate", "number", 0.0, "domains pinned at 1",
           check=unit_interval),
    Option("stuck_off_rate", "number", 0.0, "domains pinned at 0",
           check=unit_interval),
    Option("ports", "int", 4, "access ports per track (cost model)",
           check=lambda v: None if v >= 1 else "must be >= 1"),
    Option("tr_span", "int", 5, "domains sensed per transverse read "
           "(cost model)",
           check=lambda v: None if v >= 1 else "must be >= 1"),
)

_PRESETS = {"ideal": RacetrackConfig, "racetrack": RacetrackConfig.racetrack}


@dataclasses.dataclass(frozen=True)
class RacetrackSubstrate:
    """:class:`~repro_torch.accel.substrate.Substrate` over domain-wall
    tracks.  Stored state is the {0,1} domain-magnetization map (one track
    per trailing ``rows``-length slice); ``read_weights`` applies the
    seeded shift misalignment, so a misaligned track reads systematically
    wrong partial counts on every read."""

    config: RacetrackConfig = RacetrackConfig()
    partitionable: bool = threefry.PARTITIONABLE

    name = "racetrack"

    @classmethod
    def from_options(cls, options: dict, *,
                     partitionable: bool = threefry.PARTITIONABLE
                     ) -> "RacetrackSubstrate":
        opts = dict(options)
        preset = opts.pop("preset", "ideal")
        return cls(_PRESETS[preset](**opts), partitionable)

    @property
    def is_ideal(self) -> bool:
        return self.config.is_ideal

    def program(self, bits: torch.Tensor, *, stream: int = 0
                ) -> torch.Tensor:
        """Shift-in write: bits become domains, pinning sites win."""
        cfg = self.config
        state = bits.to(torch.float32)
        if cfg.stuck_on_rate > 0.0 or cfg.stuck_off_rate > 0.0:
            if state is bits:
                state = state.clone()
            u = _sub.draw_uniform(_key(cfg, stream, _FAULT),
                                  tuple(state.shape), state.device,
                                  self.partitionable)
            state.masked_fill_(u < f32(cfg.stuck_on_rate), 1.0)
            state.masked_fill_(u > f32(1.0 - cfg.stuck_off_rate), 0.0)
        return state

    def read_weights(self, state: torch.Tensor, *, stream: int = 0
                     ) -> torch.Tensor:
        cfg = self.config
        if cfg.shift_fault_rate == 0.0:
            return state
        off = _shift_offsets(cfg, tuple(state.shape[:-1]), stream,
                             partitionable=self.partitionable,
                             device=state.device)
        # repro reads state[..., (j + off) % rows]: a roll by -off.
        return roll_tracks(state, -off)

    def read_event_key(self, stream: int, digest: int) -> tuple:
        return threefry.fold_in(_key(self.config, stream, _READ), digest)

    def read_noise_scale(self, active_rows: torch.Tensor
                         ) -> tuple[torch.Tensor | None, float]:
        """``(std, divisor)`` of a read's noise, already in count units:
        ``read_sigma * sqrt(active domains)`` over one; no std at
        ``read_sigma`` 0."""
        if self.config.read_sigma == 0.0:
            return None, 1.0
        return f32(self.config.read_sigma) * torch.sqrt(
            torch.clamp_min(active_rows.to(torch.float32), 0.0)), 1.0

    def fault_census(self, shape: tuple[int, ...], *, stream: int = 0,
                     device: str | torch.device = "cpu") -> dict[str, int]:
        cfg = self.config
        n_on = n_off = n_mis = 0
        if cfg.stuck_on_rate > 0.0 or cfg.stuck_off_rate > 0.0:
            u = _sub.draw_uniform(_key(cfg, stream, _FAULT), tuple(shape),
                                  device, self.partitionable)
            n_on = int((u < f32(cfg.stuck_on_rate)).sum())
            n_off = int((u > f32(1.0 - cfg.stuck_off_rate)).sum())
        if cfg.shift_fault_rate > 0.0:
            n_mis = int((_shift_offsets(
                cfg, tuple(shape[:-1]), stream,
                partitionable=self.partitionable, device=device) != 0).sum())
        return {"on": n_on, "off": n_off, "misaligned": n_mis}

    def cost(self, num_protos: int, dim: int, read_len: int, ngram: int,
             xcfg):
        from repro_torch.accel import cost as cost_mod
        return cost_mod.racetrack_cost(num_protos, dim, read_len, ngram,
                                       xcfg, ports=self.config.ports,
                                       tr_span=self.config.tr_span)


@register_substrate("racetrack", RACETRACK_OPTIONS)
def _make_racetrack(options: dict, partitionable: bool) -> RacetrackSubstrate:
    return RacetrackSubstrate.from_options(options,
                                           partitionable=partitionable)
