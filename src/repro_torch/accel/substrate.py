"""The ``Substrate`` protocol: what any in-memory device model must provide.

Counterpart of :mod:`repro.accel.substrate`.  The substrate-generic
crossbar (:mod:`repro_torch.accel.crossbar`) depends only on these hooks;
everything device-physical lives behind them:

  ``program(bits, stream)``        one-time write: {0,1} bits -> stored
                                   physical state (conductances, domains);
  ``read_weights(state, stream)``  the effective per-cell weight an AM
                                   read sees (ideal: exactly the bits);
  ``read_event_key(stream, digest)``  the key of one read event;
  ``add_read_noise(keys, counts, active_rows)``  the read event's noise,
                                   in count units, added into the partial
                                   counts of every row tile at once;
  ``fault_census(shape, stream)``  static defect counts of a bank;
  ``cost(...)``                    the analytical latency/energy/area entry.

One hook differs from ``repro``'s: ``repro``'s ``read_noise(key, shape,
active_rows)`` returns one tile's noise, which the crossbar adds inside a
``vmap`` over the row tiles; here ``add_read_noise`` takes the ``(T, 2)``
tile keys (``repro``'s ``jax.random.split(read_key, T)``) and adds every
tile's noise into the ``(T, B, S)`` counts in place, through the Threefry
kernel's read-noise epilogue, so no ``(T, B, S)`` noise tensor is made.

Substrates register by name with their declared options (the
:class:`~repro_torch.pipeline.options.Option` rows every backend's options
ride), so backend construction, ``--list-backends`` and the contract test
discover them uniformly: ``pcm`` (:mod:`repro_torch.accel.device`) and
``racetrack`` (:mod:`repro_torch.accel.racetrack`).

Every draw is ``jax.random``'s, keyed as ``repro`` keys it, in the
threefry mode the substrate was made with (``partitionable``, from
``ProfilerConfig.threefry_partitionable``): the same seed reproduces the
same device instance as ``repro``'s.
"""

from __future__ import annotations

from typing import Callable, Mapping, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core import threefry
from repro_torch.kernels import threefry as threefry_kernel
from repro_torch.pipeline.options import Option, OptionsSchema, non_negative


@runtime_checkable
class Substrate(Protocol):
    """Device-physics hooks the substrate-generic crossbar runs through."""

    name: str
    partitionable: bool

    @property
    def is_ideal(self) -> bool:
        """True when every non-ideality is off (the bit-exact path)."""
        ...

    def program(self, bits: torch.Tensor, *, stream: int = 0
                ) -> torch.Tensor:
        """One-time write of a {0,1} bit tensor into physical state
        (deterministic in the seed; ``stream`` tags the bank)."""
        ...

    def read_weights(self, state: torch.Tensor, *, stream: int = 0
                     ) -> torch.Tensor:
        """Stored state -> effective per-cell weights for an AM read."""
        ...

    def read_event_key(self, stream: int, digest: int) -> tuple:
        """The key words of one read event on one bank."""
        ...

    def add_read_noise(self, keys: np.ndarray, counts: torch.Tensor,
                       active_rows: torch.Tensor) -> torch.Tensor:
        """Add one read event's noise to the ``(T, B, S)`` partial counts
        in place (``keys``: ``(T, 2)``, one a row tile; ``active_rows``:
        ``(T, B)``); returns ``counts``."""
        ...

    def fault_census(self, shape: tuple[int, ...], *, stream: int = 0,
                     device: str | torch.device = "cpu") -> dict[str, int]:
        """Static defect counts of one programmed bank (replays the seeded
        fault draws for ``shape`` on ``device``)."""
        ...

    def cost(self, num_protos: int, dim: int, read_len: int, ngram: int,
             xcfg) -> "object":
        """The substrate's analytical cost entry (a ``CostReport``)."""
        ...


#: Geometry + selection options shared by every substrate backend.
COMMON_OPTIONS: tuple[Option, ...] = (
    Option("substrate", "str",
           help="device model running the AM search (see docs/ACC_DEMETER.md)"),
    Option("rows", "int", 256, "word lines / domains per array tile",
           check=lambda v: None if v >= 1 else "must be >= 1"),
    Option("cols", "int", 256, "bit lines (prototypes) per array tile",
           check=lambda v: None if v >= 1 else "must be >= 1"),
    Option("adc_bits", "int", 9, "converter resolution; lossless when "
           "2^bits - 1 >= rows",
           check=lambda v: None if v >= 1 else "must be >= 1"),
    Option("seed", "int", 0xACC_DE, "device PRNG seed (all noise + faults)",
           check=non_negative),
)

#: option names routed to CrossbarConfig (the rest go to the substrate).
CROSSBAR_KEYS = frozenset(("rows", "cols", "adc_bits"))

#: ``(options, partitionable) -> Substrate``
SubstrateFactory = Callable[[Mapping[str, object], bool], Substrate]

_SUBSTRATES: dict[str, tuple[SubstrateFactory, tuple[Option, ...]]] = {}


def register_substrate(name: str, options: tuple[Option, ...]
                       ) -> Callable[[SubstrateFactory], SubstrateFactory]:
    """Decorator: register ``(options, partitionable) -> Substrate`` under
    ``name`` with its substrate-specific options."""
    def deco(factory: SubstrateFactory) -> SubstrateFactory:
        if name in _SUBSTRATES:
            raise ValueError(f"substrate {name!r} already registered")
        _SUBSTRATES[name] = (factory, tuple(options))
        return factory
    return deco


def available_substrates() -> tuple[str, ...]:
    """Names of every registered substrate (import
    :mod:`repro_torch.accel` first; registration happens on import)."""
    return tuple(sorted(_SUBSTRATES))


def substrate_options(name: str) -> tuple[Option, ...]:
    """The declared substrate-specific options of ``name``."""
    _require(name)
    return _SUBSTRATES[name][1]


def resolve_substrate(name: str, options: Mapping[str, object], *,
                      partitionable: bool = threefry.PARTITIONABLE
                      ) -> Substrate:
    """Instantiate the substrate registered as ``name`` from its options,
    drawing in the given ``jax_threefry_partitionable`` mode."""
    _require(name)
    return _SUBSTRATES[name][0](dict(options), partitionable)


def _require(name: str) -> None:
    if name not in _SUBSTRATES:
        raise ValueError(f"unknown substrate {name!r}; registered: "
                         f"{available_substrates()}")


def narrowed_schema(backend: str, substrate: str) -> OptionsSchema:
    """The exact option set valid for ``backend`` once ``substrate`` is
    chosen: common geometry/selection options + that substrate's own."""
    return OptionsSchema(backend=f"{backend} (substrate={substrate})",
                         options=COMMON_OPTIONS + substrate_options(substrate))


def union_schema(backend: str, default_substrate: str) -> OptionsSchema:
    """The display/CLI schema of a substrate backend: common options plus
    every registered substrate's options (shared names merged)."""
    merged: dict[str, Option] = {}
    for opt in COMMON_OPTIONS:
        if opt.name == "substrate":
            opt = Option("substrate", "str", default_substrate, opt.help,
                         choices=available_substrates())
        merged[opt.name] = opt
    for sub in available_substrates():
        for opt in substrate_options(sub):
            prev = merged.get(opt.name)
            if prev is None:
                merged[opt.name] = opt
            elif prev.choices is not None and opt.choices is not None \
                    and prev.choices != opt.choices:
                # e.g. `preset`: each substrate narrows to its own names.
                joint = prev.choices + tuple(c for c in opt.choices
                                             if c not in prev.choices)
                merged[opt.name] = Option(prev.name, prev.kind, prev.default,
                                          prev.help, choices=joint)
    return OptionsSchema(backend=backend, options=tuple(merged.values()))


# -- draws shared by the substrates -----------------------------------------

def sub_key(seed: int, stream: int, source: int) -> tuple:
    """``fold_in(fold_in(key(seed), stream), source)``: one key per (bank,
    noise source), as ``repro``'s ``_key``."""
    return threefry.fold_in(threefry.fold_in(threefry.key(seed), stream),
                            source)


def f32(x: float) -> float:
    """``x`` rounded to float32, as JAX rounds a Python scalar it
    combines with a float32 array."""
    return float(np.float32(x))


def draw_uniform(key, shape: tuple[int, ...], device, partitionable: bool
                 ) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` on ``device`` (the Threefry
    kernel on the card, its plain version on the host)."""
    n = int(np.prod(shape, dtype=np.int64))
    if n == 0:
        return torch.zeros(shape, dtype=torch.float32, device=device)
    keys = threefry_kernel.keys_tensor(key, device)
    return threefry_kernel.threefry_draw(
        keys, n, epilogue="uniform", partitionable=partitionable
    ).reshape(shape)


def add_normal(key, out: torch.Tensor, scale: float, partitionable: bool
               ) -> torch.Tensor:
    """``out + scale * jax.random.normal(key, out.shape)``, in place."""
    if out.numel() == 0:
        return out
    keys = threefry_kernel.keys_tensor(key, out.device)
    threefry_kernel.threefry_draw(keys, out.numel(), epilogue="normal",
                                  partitionable=partitionable, scale=scale,
                                  out=out)
    return out


def add_tile_read_noise(keys: np.ndarray, counts: torch.Tensor,
                        std: torch.Tensor, divisor: float,
                        partitionable: bool) -> torch.Tensor:
    """``counts[t] += (std[t] * normal(keys[t], (B, S))) / divisor`` for
    every row tile ``t``, in place (``std``: ``(T, B)``)."""
    t, b, s = counts.shape
    if counts.numel() == 0:
        return counts
    ktens = threefry_kernel.keys_tensor(keys, counts.device)
    threefry_kernel.threefry_draw(
        ktens, b * s, epilogue="normal", partitionable=partitionable,
        scale=std.contiguous(), inner=s, divisor=divisor, out=counts)
    return counts
