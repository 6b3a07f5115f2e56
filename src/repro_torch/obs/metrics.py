"""Dependency-free metrics core: counters, gauges, bucketed histograms.

Counterpart of :mod:`repro.obs.metrics`, copied so the port imports
nothing of ``repro``: the same instrument names, label handling, bucket
sets, JSON snapshot and Prometheus text exposition, byte for byte.
Every serving component of the port
(:class:`~repro_torch.serve.profiler_service.ProfilingService`,
:class:`~repro_torch.serve.router.TenantRouter`,
:class:`~repro_torch.serve.registry.RefDBRegistry`,
:class:`~repro_torch.pipeline.session.ProfilingSession`) records into one
shared :class:`MetricsRegistry`.

Design constraints, in priority order:

* **Zero-cost when disabled.**  The default registry is the
  :class:`NullRegistry` singleton: every instrument it hands out is an
  inert no-op object behind the same interface, and hot paths guard any
  real work (``time.perf_counter()``, label merging) behind the
  registry's ``enabled`` flag -- so disabled observability costs one
  attribute load per site.
* **Never perturb results.**  All recording is host-side Python; nothing
  here touches a tensor or waits for the card, so metrics-on and
  metrics-off runs are bit-identical (``tests/test_torch_obs.py``).
* **Thread-safe.**  Serving pumps, tenant loaders, and snapshot readers
  race freely; every instrument serializes on one registry lock (the
  instrumented paths record per *cohort*, not per read, so contention is
  negligible).

Instruments are label-keyed like Prometheus: one instrument name owns
many series, one per distinct label set::

    reg = MetricsRegistry()
    lat = reg.histogram("serve_batch_seconds", "cohort latency",
                        unit="s")
    lat.observe(0.012, backend="cuda_fused")
    lat.percentile(99, backend="cuda_fused")

Histograms use *fixed* bucket upper bounds (cumulative-free storage,
constant memory per series) with quantiles estimated by linear
interpolation inside the owning bucket — the standard
Prometheus-histogram estimator.  States of identical bucketing can be
``merge``-d, so per-process registries aggregate across a fleet.

Exposition: :meth:`MetricsRegistry.snapshot` returns a plain-dict JSON
document (with p50/p95/p99 pre-computed per histogram series) and
:meth:`MetricsRegistry.to_prometheus` renders the Prometheus text
format.
"""

from __future__ import annotations

import bisect
import json
import math
import threading
from typing import Iterable, Mapping

#: Default upper bounds for duration histograms, in seconds: 100 µs to
#: 2 minutes, roughly geometric — wide enough for both a single cohort
#: on an accelerator and a whole request draining behind a queue.
TIME_BUCKETS_S = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)

#: Default upper bounds for ratio-valued histograms (cohort fill, ...).
RATIO_BUCKETS = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0)

#: Percentiles pre-computed into every histogram snapshot.
SNAPSHOT_PERCENTILES = (50, 95, 99)


def exponential_buckets(start: float, factor: float, count: int
                        ) -> tuple[float, ...]:
    """``count`` geometric bucket bounds from ``start`` (Prometheus-style)."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError("need start > 0, factor > 1, count >= 1")
    return tuple(start * factor ** i for i in range(count))


def linear_buckets(start: float, width: float, count: int
                   ) -> tuple[float, ...]:
    """``count`` uniform bucket bounds from ``start`` (Prometheus-style)."""
    if width <= 0 or count < 1:
        raise ValueError("need width > 0, count >= 1")
    return tuple(start + width * i for i in range(count))


def _label_key(labels: Mapping[str, str]) -> tuple[tuple[str, str], ...]:
    """Canonical (sorted, stringified) series key for a label mapping."""
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class HistogramState:
    """One histogram series: per-bucket counts + sum over fixed bounds.

    ``bounds`` are ascending *upper* bounds; an observation lands in the
    first bucket whose bound is ``>= value`` (boundary values inclusive,
    Prometheus ``le`` semantics) and anything beyond the last bound goes
    to the overflow bucket.  Values are assumed non-negative (times,
    ratios, counts) — the quantile interpolation uses 0 as the first
    bucket's lower edge.
    """

    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds: Iterable[float]):
        self.bounds = tuple(float(b) for b in bounds)
        if not self.bounds or list(self.bounds) != sorted(set(self.bounds)):
            raise ValueError("bucket bounds must be non-empty, unique, "
                             "and ascending")
        self.counts = [0] * (len(self.bounds) + 1)     # + overflow
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, value)] += 1
        self.sum += value
        self.count += 1

    def merge(self, other: "HistogramState") -> None:
        """Fold another series of identical bucketing into this one."""
        if other.bounds != self.bounds:
            raise ValueError(
                f"cannot merge histograms with different bounds "
                f"({len(self.bounds)} vs {len(other.bounds)} buckets)")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.sum += other.sum
        self.count += other.count

    def percentile(self, q: float) -> float:
        """Estimate the ``q``-th percentile (0-100) from the buckets.

        Linear interpolation within the owning bucket, with 0 as the
        first bucket's lower edge; ranks landing in the overflow bucket
        clamp to the last finite bound (the estimator cannot see beyond
        it).  NaN when the series is empty.
        """
        if not 0 <= q <= 100:
            raise ValueError(f"percentile must be in [0, 100], got {q}")
        if self.count == 0:
            return math.nan
        rank = q / 100.0 * self.count
        cum = 0
        for i, c in enumerate(self.counts[:-1]):
            if cum + c >= rank and c > 0:
                lo = 0.0 if i == 0 else self.bounds[i - 1]
                hi = self.bounds[i]
                return lo + (hi - lo) * min(max(rank - cum, 0.0), c) / c
            cum += c
        return self.bounds[-1]

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else math.nan

    def to_dict(self) -> dict:
        d = {"counts": list(self.counts), "sum": self.sum,
             "count": self.count}
        for p in SNAPSHOT_PERCENTILES:
            v = self.percentile(p)
            d[f"p{p}"] = None if math.isnan(v) else v
        return d


class _Instrument:
    """Shared shape of every instrument: name, help, label-keyed series."""

    kind = "untyped"

    def __init__(self, name: str, help: str, unit: str,
                 lock: threading.Lock):
        self.name = name
        self.help = help
        self.unit = unit
        self._lock = lock
        self._series: dict[tuple[tuple[str, str], ...], object] = {}

    # Real instruments report their registry as live.
    enabled = True

    def _new_state(self):
        raise NotImplementedError

    def _state(self, labels: Mapping[str, str]):
        key = _label_key(labels)
        state = self._series.get(key)
        if state is None:
            state = self._series[key] = self._new_state()
        return state

    def series(self) -> dict[tuple[tuple[str, str], ...], object]:
        with self._lock:
            return dict(self._series)

    def labelsets(self) -> list[dict[str, str]]:
        with self._lock:
            return [dict(k) for k in sorted(self._series)]


class _Box:
    """Mutable float cell (counters and gauges share it)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0


class Counter(_Instrument):
    """Monotone accumulator (events, reads, bytes)."""

    kind = "counter"

    def _new_state(self) -> _Box:
        return _Box()

    def inc(self, amount: float = 1, **labels: str) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a gauge")
        with self._lock:
            self._state(labels).value += amount

    def value(self, **labels: str) -> float:
        with self._lock:
            state = self._series.get(_label_key(labels))
            return state.value if state is not None else 0.0

    def total(self) -> float:
        """Sum over every label series."""
        with self._lock:
            return sum(s.value for s in self._series.values())


class Gauge(_Instrument):
    """Set-to-current-value instrument (queue depth, live version)."""

    kind = "gauge"

    def _new_state(self) -> _Box:
        return _Box()

    def set(self, value: float, **labels: str) -> None:
        with self._lock:
            self._state(labels).value = float(value)

    def inc(self, amount: float = 1, **labels: str) -> None:
        with self._lock:
            self._state(labels).value += amount

    def dec(self, amount: float = 1, **labels: str) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels: str) -> float:
        with self._lock:
            state = self._series.get(_label_key(labels))
            return state.value if state is not None else 0.0


class Histogram(_Instrument):
    """Fixed-bucket distribution instrument with quantile estimation."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "", unit: str = "",
                 buckets: Iterable[float] = TIME_BUCKETS_S,
                 lock: threading.Lock | None = None):
        super().__init__(name, help, unit, lock or threading.Lock())
        self.buckets = tuple(float(b) for b in buckets)
        HistogramState(self.buckets)        # validate once, loudly

    def _new_state(self) -> HistogramState:
        return HistogramState(self.buckets)

    def observe(self, value: float, **labels: str) -> None:
        with self._lock:
            self._state(labels).observe(value)

    def percentile(self, q: float, **labels: str) -> float:
        """Estimated percentile of one series (NaN if never observed)."""
        with self._lock:
            state = self._series.get(_label_key(labels))
            return state.percentile(q) if state is not None else math.nan

    def count(self, **labels: str) -> int:
        with self._lock:
            state = self._series.get(_label_key(labels))
            return state.count if state is not None else 0

    def state(self, **labels: str) -> HistogramState | None:
        with self._lock:
            return self._series.get(_label_key(labels))

    def merged(self) -> HistogramState:
        """All series of this instrument folded into one state."""
        out = HistogramState(self.buckets)
        with self._lock:
            for s in self._series.values():
                out.merge(s)
        return out


class MetricsRegistry:
    """Thread-safe, label-keyed instrument registry.

    ``counter`` / ``gauge`` / ``histogram`` are get-or-create: asking for
    an existing name returns the same instrument (a name used as a
    different kind, or a histogram re-requested with different buckets,
    raises — silent schema drift is how dashboards lie).
    """

    enabled = True

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._instruments: dict[str, _Instrument] = {}

    # -- instrument access --------------------------------------------------
    def counter(self, name: str, help: str = "", unit: str = "") -> Counter:
        return self._get(Counter, name, help, unit)

    def gauge(self, name: str, help: str = "", unit: str = "") -> Gauge:
        return self._get(Gauge, name, help, unit)

    def histogram(self, name: str, help: str = "", unit: str = "",
                  buckets: Iterable[float] = TIME_BUCKETS_S) -> Histogram:
        buckets = tuple(float(b) for b in buckets)
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = Histogram(name, help, unit, buckets,
                                 lock=threading.Lock())
                self._instruments[name] = inst
                return inst
            if not isinstance(inst, Histogram):
                raise ValueError(f"metric {name!r} already registered as "
                                 f"a {inst.kind}")
            if inst.buckets != buckets:
                raise ValueError(f"histogram {name!r} already registered "
                                 f"with different buckets")
            return inst

    def _get(self, cls: type, name: str, help: str, unit: str):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(name, help, unit, threading.Lock())
                self._instruments[name] = inst
            elif not isinstance(inst, cls):
                raise ValueError(f"metric {name!r} already registered as "
                                 f"a {inst.kind}")
            return inst

    def instruments(self) -> tuple[_Instrument, ...]:
        with self._lock:
            return tuple(self._instruments[n]
                         for n in sorted(self._instruments))

    # -- exposition ---------------------------------------------------------
    def snapshot(self) -> dict:
        """The whole registry as one JSON-ready document.

        Histogram series carry their bucket counts plus pre-computed
        p50/p95/p99 so a dumped snapshot answers latency questions
        without re-deriving anything.
        """
        doc: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        for inst in self.instruments():
            series = []
            for key, state in sorted(inst.series().items()):
                entry: dict = {"labels": dict(key)}
                if isinstance(state, HistogramState):
                    entry.update(state.to_dict())
                else:
                    entry["value"] = state.value
                series.append(entry)
            section = doc[inst.kind + "s"]
            section[inst.name] = {"help": inst.help, "unit": inst.unit,
                                  "series": series}
            if isinstance(inst, Histogram):
                section[inst.name]["buckets"] = list(inst.buckets)
        return doc

    def to_json(self, **kw) -> str:
        kw.setdefault("indent", 2)
        kw.setdefault("sort_keys", True)
        return json.dumps(self.snapshot(), **kw)

    # -- cross-process / cross-host aggregation ------------------------------
    def merge_from(self, other: "MetricsRegistry", **labels: str) -> None:
        """Fold every series of ``other`` into this registry.

        ``labels`` are added to each incoming series' label set — the
        fleet controller folds per-host registries with ``host=<id>`` so
        one merged snapshot keeps the per-host breakdown.  Counter
        values add, gauges set (distinct label sets never collide), and
        histogram states fold bucket-by-bucket via
        :meth:`HistogramState.merge`; instruments are get-or-create by
        name, so repeated merges from the same source double-count —
        merge into a fresh registry per snapshot.
        """
        for inst in other.instruments():
            if isinstance(inst, Histogram):
                mine = self.histogram(inst.name, inst.help, inst.unit,
                                      inst.buckets)
            elif isinstance(inst, Counter):
                mine = self.counter(inst.name, inst.help, inst.unit)
            elif isinstance(inst, Gauge):
                mine = self.gauge(inst.name, inst.help, inst.unit)
            else:
                continue
            if not mine.enabled:           # merging into a NullRegistry
                return
            for key, state in sorted(inst.series().items()):
                merged = {**dict(key), **{str(k): str(v)
                                          for k, v in labels.items()}}
                if isinstance(state, HistogramState):
                    with mine._lock:
                        mine._state(merged).merge(state)
                elif isinstance(inst, Counter):
                    mine.inc(state.value, **merged)
                else:
                    mine.set(state.value, **merged)

    @classmethod
    def merged(cls, parts: Mapping[str, "MetricsRegistry"], *,
               label: str = "host") -> "MetricsRegistry":
        """A fresh registry folding ``parts``, each keyed by a ``label``.

        The fleet-snapshot constructor: ``merged({"host0": reg0, ...})``
        returns one registry whose every series carries a ``host`` label
        naming the registry it came from, with same-name histograms
        sharing buckets merged exactly (per-bucket counts add).
        """
        out = cls()
        for part_key in sorted(parts):
            out.merge_from(parts[part_key], **{label: part_key})
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (0.0.4) of every series."""
        lines: list[str] = []
        for inst in self.instruments():
            if inst.help:
                lines.append(f"# HELP {inst.name} {inst.help}")
            lines.append(f"# TYPE {inst.name} {inst.kind}")
            for key, state in sorted(inst.series().items()):
                labels = dict(key)
                if isinstance(state, HistogramState):
                    cum = 0
                    for bound, c in zip(inst.buckets, state.counts):
                        cum += c
                        lines.append(_prom_line(
                            inst.name + "_bucket",
                            {**labels, "le": _prom_float(bound)}, cum))
                    lines.append(_prom_line(
                        inst.name + "_bucket", {**labels, "le": "+Inf"},
                        state.count))
                    lines.append(_prom_line(inst.name + "_sum", labels,
                                            state.sum))
                    lines.append(_prom_line(inst.name + "_count", labels,
                                            state.count))
                else:
                    lines.append(_prom_line(inst.name, labels, state.value))
        return "\n".join(lines) + ("\n" if lines else "")


class _NullInstrument:
    """Inert counter+gauge+histogram: the disabled-observability recorder.

    Accepts every recording call and drops it; read-side methods return
    zeros/NaN.  One shared instance backs every instrument name of the
    :class:`NullRegistry`, so disabled components pay construction-time
    nothing and per-event almost-nothing (one no-op method call, and the
    hot paths don't even reach that — they bail on ``enabled``).
    """

    kind = "null"
    enabled = False
    name = help = unit = ""
    buckets = ()

    def inc(self, *a, **k) -> None:
        pass

    def dec(self, *a, **k) -> None:
        pass

    def set(self, *a, **k) -> None:
        pass

    def observe(self, *a, **k) -> None:
        pass

    def value(self, **k) -> float:
        return 0.0

    def total(self) -> float:
        return 0.0

    def count(self, **k) -> int:
        return 0

    def percentile(self, q: float, **k) -> float:
        return math.nan

    def state(self, **k) -> None:
        return None

    def series(self) -> dict:
        return {}

    def labelsets(self) -> list:
        return []


_NULL_INSTRUMENT = _NullInstrument()


class NullRegistry(MetricsRegistry):
    """The no-op registry behind the same interface: observability off."""

    enabled = False

    def __init__(self) -> None:
        super().__init__()

    def counter(self, name: str, help: str = "", unit: str = ""):
        return _NULL_INSTRUMENT

    def gauge(self, name: str, help: str = "", unit: str = ""):
        return _NULL_INSTRUMENT

    def histogram(self, name: str, help: str = "", unit: str = "",
                  buckets: Iterable[float] = TIME_BUCKETS_S):
        return _NULL_INSTRUMENT

    def instruments(self) -> tuple:
        return ()


def _prom_float(v: float) -> str:
    """Shortest faithful rendering (Prometheus prefers 0.005 over 5e-03)."""
    return repr(v) if v != int(v) else str(int(v))


def _prom_escape(v: str) -> str:
    return (str(v).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _prom_line(name: str, labels: Mapping[str, str], value: float) -> str:
    if labels:
        body = ",".join(f'{k}="{_prom_escape(v)}"'
                        for k, v in sorted(labels.items()))
        return f"{name}{{{body}}} {_prom_float(float(value))}"
    return f"{name} {_prom_float(float(value))}"
