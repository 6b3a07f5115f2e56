"""Observability for the port's serving stack: metrics and request tracing.

Counterpart of :mod:`repro.obs`.  :mod:`repro_torch.obs.metrics` is the
dependency-free metrics core (counters, gauges, fixed-bucket histograms
with percentile estimation, JSON snapshot + Prometheus text exposition);
:mod:`repro_torch.obs.trace` is the span-based request-tracing layer and
the unified request latency clock.  Both are copies of ``repro``'s, so
the metric names, labels, buckets and exposition are the same.

Observability is **opt-in and zero-cost when disabled**: the process
default is the :class:`~repro_torch.obs.metrics.NullRegistry` /
:class:`~repro_torch.obs.trace.NullTraceRecorder` pair -- no-op recorders
behind the real interface -- and instrumented components resolve the
globals at construction time::

    from repro_torch import obs
    reg = obs.enable_metrics()              # before building the stack
    rec = obs.enable_tracing(sample=8)
    ...  # construct sessions / services / routers, serve traffic
    json.dump(reg.snapshot(), fh)
    print(reg.to_prometheus())
    traces = rec.to_dicts()

Components also accept an explicit ``metrics=`` / ``tracer=`` argument;
``None`` means "the global default at construction time".  Recording is
host-side only and never waits for the card, so enabling observability
cannot perturb results -- and :func:`torch_trace` is the separate,
explicitly opt-in ``torch.profiler`` capture for kernel timelines.

:func:`span` names a stretch of the port's own work (``repro_torch.*``)
inside such a capture: a ``RecordFunction`` range, on the same clock as
the kernels it launches, recorded only while a profiler runs.
"""

from __future__ import annotations

import contextlib
import pathlib

import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast as _op_range

from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     HistogramState, MetricsRegistry,
                                     NullRegistry, RATIO_BUCKETS,
                                     TIME_BUCKETS_S, exponential_buckets,
                                     linear_buckets)
from repro_torch.obs.trace import (NullTraceRecorder, RequestTimeline, Span,
                                   Trace, TraceRecorder, assemble_trace)

#: The process-wide disabled-mode singletons.
NULL_METRICS = NullRegistry()
NULL_TRACER = NullTraceRecorder()

_metrics: MetricsRegistry = NULL_METRICS
_tracer: TraceRecorder = NULL_TRACER


def enable_metrics(registry: MetricsRegistry | None = None
                   ) -> MetricsRegistry:
    """Install ``registry`` (default: a fresh one) as the global default.

    Components constructed *after* this call record into it; already-
    constructed components keep whatever they resolved.
    """
    global _metrics
    _metrics = registry if registry is not None else MetricsRegistry()
    return _metrics


def enable_tracing(sample: int = 8,
                   recorder: TraceRecorder | None = None) -> TraceRecorder:
    """Install a trace recorder sampling the first ``sample`` requests."""
    global _tracer
    _tracer = recorder if recorder is not None else TraceRecorder(sample)
    return _tracer


def disable() -> None:
    """Reset both globals to the no-op recorders (observability off)."""
    global _metrics, _tracer
    _metrics = NULL_METRICS
    _tracer = NULL_TRACER


def metrics() -> MetricsRegistry:
    """The current global metrics registry (Null when disabled)."""
    return _metrics


def tracer() -> TraceRecorder:
    """The current global trace recorder (Null when disabled)."""
    return _tracer


def resolve_metrics(explicit: MetricsRegistry | None) -> MetricsRegistry:
    """Constructor helper: an explicit registry, or the global default."""
    return explicit if explicit is not None else _metrics


def resolve_tracer(explicit: TraceRecorder | None) -> TraceRecorder:
    """Constructor helper: an explicit recorder, or the global default."""
    return explicit if explicit is not None else _tracer


_NO_SPAN = contextlib.nullcontext()


def span(name: str, *, host_only: bool = False):
    """A named range of the port's work, for a ``torch.profiler`` trace.

    While a profiler records (:func:`torch_trace`, the benchmark's
    ``--trace 1``), a ``record_function(name)``: the range lands in the
    Chrome trace beside the kernels, copies and launches, on their clock,
    and each launch inside it carries its correlation id.  A span over
    host work alone (``host_only``: no torch operation inside) is instead
    an operator range (``_RecordFunctionFast``, a ``cpu_op`` event, a
    tenth of the cost): it then names its stretch among the trace's
    top-level operations, where the card's idle time would fall under no
    operation, while a span over torch operations leaves them at the top
    level.  Otherwise one shared null context, so a span costs a flag
    read when nothing records.  Every name starts with ``repro_torch.``::

        with obs.span("repro_torch.species_scores"):
            ...
    """
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    if host_only:
        return _op_range(name)
    return _autograd_profiler.record_function(name)


@contextlib.contextmanager
def torch_trace(log_dir: str | pathlib.Path | None):
    """Opt-in ``torch.profiler`` capture (CPU and CUDA activity).

    ``None`` is a no-op (the default everywhere), so callers can wrap
    their serving loop unconditionally::

        with obs.torch_trace(args.torch_profile):
            router.run_until_idle()

    With a directory, the host and kernel timeline is written there as a
    Chrome trace (``trace.json``, for Perfetto or ``chrome://tracing``),
    with every thread's operations and spans (a source's reader runs on
    a thread of its own).  CUDA activity is recorded only when a card is
    present.
    """
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = pathlib.Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    every_thread = torch._C._profiler._ExperimentalConfig(
        profile_all_threads=True)
    with profile(activities=activities,
                 experimental_config=every_thread) as prof:
        yield
    prof.export_chrome_trace(str(out / "trace.json"))


__all__ = [
    "Counter", "Gauge", "Histogram", "HistogramState", "MetricsRegistry",
    "NullRegistry", "RATIO_BUCKETS", "TIME_BUCKETS_S",
    "exponential_buckets", "linear_buckets",
    "NullTraceRecorder", "RequestTimeline", "Span", "Trace",
    "TraceRecorder", "assemble_trace",
    "NULL_METRICS", "NULL_TRACER",
    "enable_metrics", "enable_tracing", "disable", "metrics", "tracer",
    "resolve_metrics", "resolve_tracer", "span", "torch_trace",
]
