"""`ProfilerConfig`: the single frozen record of a profiling run's setup.

Counterpart of :mod:`repro.pipeline.config`, field for field, so
:meth:`~ProfilerConfig.fingerprint` and
:meth:`~ProfilerConfig.refdb_fingerprint` give the same strings in both
packages and RefDB cache keys agree.  The device is not a field: it
belongs to the session and the backend.

One field is the port's own: ``threefry_partitionable``, the
``jax_threefry_partitionable`` mode whose words the item memory and the
tie vector reproduce.  ``repro`` takes that mode from the installed jax
(partitionable from jax 0.5 on, not on the 0.4 line); the port carries it
in the config.  At its default (True) the field is left out of
:meth:`~ProfilerConfig.to_dict`, so the JSON and both fingerprints stay
``repro``'s; at False it joins them, so stores of the two modes never
share a cache key.

One config names everything a run depends on — the HD space (step 1), the
RefDB windowing (step 2), the batch shape of the streamed query path
(steps 3-4), and the *backend* that executes encode/agreement.  It is a
frozen dataclass: hashable and JSON round-trippable.
:meth:`~ProfilerConfig.fingerprint` covers every field (the config's
identity); :meth:`~ProfilerConfig.refdb_fingerprint` covers exactly the
fields that determine RefDB content, so two configs that could produce
different prototypes can never collide on one cache entry (the session
joins it with a digest of the reference genomes to form the full key).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Mapping

from repro_torch.core.hd_space import HDSpace

#: JSON-primitive types allowed as backend option values.
OptionValue = str | int | float | bool


@dataclasses.dataclass(frozen=True)
class ProfilerConfig:
    """Frozen configuration of a Demeter profiling run.

    Attributes:
      space: the HD space (step 1) — dimension, n-gram, threshold, seed.
      window: reference-genome window length (one AM prototype per window).
      stride: window stride; ``None`` means non-overlapping (= window).
      batch_size: read batch size of the streamed query path.
      backend: registered backend name executing encode/agreement
        (see :mod:`repro_torch.pipeline.backend`); validated at session
        construction so configs may name backends registered later.
      backend_options: backend-specific knobs (e.g. the ``cuda_fused``
        tile sizes).  Accepts a mapping at
        construction time; canonicalized to a sorted tuple of
        ``(name, value)`` pairs so the config stays hashable and
        JSON-round-trippable.  Values must be JSON primitives.
      noise_aware_refdb: build the RefDB noise-aware — after the naive
        build, retrain the prototypes on simulated readout through this
        config's backend + backend_options (the margin-maximizing pass in
        ``repro``'s noise-aware build; not ported yet).  When enabled, backend and
        backend_options *join* the RefDB cache key: the refined
        prototypes depend on the device they were trained against.
      noise_aware_iters: retraining passes when ``noise_aware_refdb``.
      threefry_partitionable: the ``jax_threefry_partitionable`` mode the
        item memory and tie vector are drawn in (True: jax 0.5 and later;
        False: the 0.4 line).  It must match the jax that wrote a
        ``repro`` store this config reads.
    """

    space: HDSpace = HDSpace()
    window: int = 8192
    stride: int | None = None
    batch_size: int = 256
    backend: str = "reference"
    backend_options: tuple[tuple[str, OptionValue], ...] = ()
    noise_aware_refdb: bool = False
    noise_aware_iters: int = 2
    threefry_partitionable: bool = True

    def __post_init__(self) -> None:
        if self.window < 1:
            raise ValueError("window must be >= 1")
        if self.stride is not None and self.stride < 1:
            raise ValueError("stride must be >= 1 (or None for = window)")
        if self.batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if not self.backend or not isinstance(self.backend, str):
            raise ValueError("backend must be a non-empty backend name")
        if self.noise_aware_iters < 1:
            raise ValueError("noise_aware_iters must be >= 1")
        if not isinstance(self.threefry_partitionable, bool):
            raise ValueError("threefry_partitionable must be a bool")
        object.__setattr__(self, "backend_options",
                           _canonical_options(self.backend_options))

    @property
    def options(self) -> dict[str, OptionValue]:
        """``backend_options`` as a plain dict (the read-side view)."""
        return dict(self.backend_options)

    def with_options(self, **options: OptionValue) -> "ProfilerConfig":
        """A copy with ``options`` merged over the existing backend options."""
        return dataclasses.replace(
            self, backend_options={**self.options, **options})

    @property
    def effective_stride(self) -> int:
        """The stride actually used: ``stride`` or (if None) ``window``."""
        return self.stride if self.stride is not None else self.window

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> dict:
        """The fields as JSON-able values (``repro``'s dict, plus
        ``threefry_partitionable`` only when it is False)."""
        d = dataclasses.asdict(self)  # recurses into the HDSpace field
        if self.threefry_partitionable:
            del d["threefry_partitionable"]
        return d

    def to_json(self, indent: int | None = None) -> str:
        return json.dumps(self.to_dict(), sort_keys=True, indent=indent)

    @classmethod
    def from_dict(cls, d: dict) -> "ProfilerConfig":
        d = dict(d)
        d["space"] = HDSpace(**d["space"])
        return cls(**d)

    @classmethod
    def from_json(cls, s: str) -> "ProfilerConfig":
        return cls.from_dict(json.loads(s))

    # -- identity -----------------------------------------------------------
    def fingerprint(self) -> str:
        """Stable hash over *every* field (the config's full identity).

        ``stride`` is canonicalized to :attr:`effective_stride` first, so
        ``stride=None`` and ``stride=window`` hash the same.
        """
        d = self.to_dict()
        d["stride"] = self.effective_stride
        payload = json.dumps(d, sort_keys=True)
        return hashlib.sha256(payload.encode()).hexdigest()[:16]

    def refdb_fingerprint(self) -> str:
        """Stable hash over the fields that determine RefDB *content*.

        Covers space, window and canonicalized stride (and the threefry
        mode when it is not the default) — everything that
        can change the built prototypes (the old cache key ignored stride
        and silently served wrong databases).  ``batch_size`` (a host
        batching knob) and ``backend``/``backend_options`` (every backend's
        *encode* is bit-exact with the reference, enforced by the parity
        tests) are deliberately excluded so tuning any of them
        reuses the cached database instead of forcing a full rebuild.

        With ``noise_aware_refdb`` the exclusion no longer holds: the
        retraining pass reads through the configured backend, so the
        refined prototypes *do* depend on backend, backend_options and
        the iteration count — all three join the key, and a noise-aware
        build can never collide with a naive one.
        """
        d = {"space": dataclasses.asdict(self.space), "window": self.window,
             "stride": self.effective_stride}
        if not self.threefry_partitionable:
            d["threefry_partitionable"] = False
        if self.noise_aware_refdb:
            d["noise_aware"] = {"backend": self.backend,
                                "backend_options": list(self.backend_options),
                                "iters": self.noise_aware_iters}
        payload = json.dumps(d, sort_keys=True)
        return hashlib.sha256(payload.encode()).hexdigest()[:16]


def _canonical_options(options) -> tuple[tuple[str, OptionValue], ...]:
    """Normalize any mapping / iterable-of-pairs into the canonical sorted
    tuple-of-pairs form (hashable, deterministic JSON)."""
    if isinstance(options, Mapping):
        pairs = list(options.items())
    else:
        pairs = [tuple(p) for p in options]
    out = []
    for pair in pairs:
        if len(pair) != 2:
            raise ValueError(f"backend option must be a (name, value) pair, "
                             f"got {pair!r}")
        name, value = pair
        if not isinstance(name, str) or not name:
            raise ValueError(f"backend option name must be a non-empty "
                             f"string, got {name!r}")
        if not isinstance(value, (str, int, float, bool)):
            raise ValueError(
                f"backend option {name!r} must be a JSON primitive "
                f"(str/int/float/bool), got {type(value).__name__}")
        out.append((name, value))
    names = [n for n, _ in out]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate backend option names in {names}")
    return tuple(sorted(out))
