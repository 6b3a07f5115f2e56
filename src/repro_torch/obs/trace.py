"""Span-based request tracing: where a slow read actually spent its time.

Counterpart of :mod:`repro.obs.trace` (a copy: same marks, spans and
assembly, so a trace of the port reads like one of ``repro``).

A serving request's life has five phases — admission (queued behind the
service door), scheduling wait (active but not yet in a cohort), cohort
execution, accumulation (demux into its streaming report), finalize —
and ``latency_s`` alone cannot say which one ate the budget.  This
module records the phase boundaries per request and assembles them into
a **trace**: a root ``request`` span plus contiguous child spans, each
with wall-clock and monotonic timestamps and a parent id.

The recording side is deliberately tiny.  Every request owns a
:class:`RequestTimeline` — a dict of monotonic marks, one per phase
boundary — that the service stamps as the request moves through the
pump.  The timeline is *also* the single latency clock: ``latency_s``,
``queue_wait_s`` and ``service_s`` on request handles all derive from
it, so the queue-wait/service split is consistent everywhere (the
router's and the service's handles share it).

Because consecutive marks tile the interval from submit to terminal,
the child spans of an assembled trace sum *exactly* to the request's
end-to-end latency — the invariant the serving acceptance test checks.

:class:`TraceRecorder` keeps the first ``sample`` completed traces
(cancelled and failed requests included: their traces simply stop at
the last phase reached).  The :class:`NullTraceRecorder` singleton is
the disabled mode — same interface, records nothing.
"""

from __future__ import annotations

import dataclasses
import threading
import time

#: Canonical phase-boundary marks, in causal order.
MARKS = ("submitted", "started", "first_execute", "accumulate",
         "finalize", "finished")

#: Span name of the interval *starting* at each mark.
_PHASE_OF = {
    "submitted": "admission",      # queued behind the admission door
    "started": "schedule",         # active, waiting to land in a cohort
    "first_execute": "execute",    # cohort classification (all cohorts)
    "accumulate": "accumulate",    # demux into the streaming accumulator
    "finalize": "finalize",        # report finalization + teardown
}

#: Marks that advance on every cohort (keep the latest, not the first).
_LAST_WINS = frozenset({"accumulate"})


class RequestTimeline:
    """Monotonic phase-boundary clock for one request.

    Marks are recorded with ``time.perf_counter()`` on the thread that
    observed the transition; a wall-clock anchor taken at construction
    converts them to absolute times for exposition.  First-wins per mark
    (except ``accumulate``, which tracks the *latest* cohort demux), so
    racing pumps cannot move a boundary backwards.
    """

    __slots__ = ("wall_anchor", "mono_anchor", "_marks")

    def __init__(self) -> None:
        self.wall_anchor = time.time()
        self.mono_anchor = time.perf_counter()
        self._marks: dict[str, float] = {}

    def mark(self, name: str, at: float | None = None) -> float:
        """Stamp ``name`` (a member of :data:`MARKS`) at ``at`` or now."""
        if name not in _PHASE_OF and name != "finished":
            raise ValueError(f"unknown timeline mark {name!r}; "
                             f"expected one of {MARKS}")
        t = time.perf_counter() if at is None else at
        if name in _LAST_WINS or name not in self._marks:
            self._marks[name] = t
        return self._marks[name]

    def at(self, name: str) -> float | None:
        """The monotonic time of ``name``, or None if never reached."""
        return self._marks.get(name)

    def elapsed(self, a: str, b: str) -> float | None:
        """Seconds between two marks; None unless both were reached."""
        ta, tb = self._marks.get(a), self._marks.get(b)
        return None if ta is None or tb is None else tb - ta

    def wall(self, mono: float) -> float:
        """Convert a monotonic mark back to absolute (epoch) seconds."""
        return self.wall_anchor + (mono - self.mono_anchor)

    # -- the unified latency clock ------------------------------------------
    @property
    def latency_s(self) -> float | None:
        """Submit-to-terminal wall time, once terminal."""
        return self.elapsed("submitted", "finished")

    @property
    def queue_wait_s(self) -> float | None:
        """Admission wait: submit until the request went RUNNING."""
        return self.elapsed("submitted", "started")

    @property
    def service_s(self) -> float | None:
        """Active service time: RUNNING until terminal."""
        return self.elapsed("started", "finished")


@dataclasses.dataclass(frozen=True)
class Span:
    """One named interval of a trace.

    ``start_s``/``end_s`` are monotonic (``time.perf_counter``) seconds;
    ``start_unix`` anchors the span on the wall clock for cross-process
    correlation.  ``parent_id`` is None only for the root span.
    """

    name: str
    span_id: int
    parent_id: int | None
    start_unix: float
    start_s: float
    end_s: float

    @property
    def duration_s(self) -> float:
        return self.end_s - self.start_s

    def to_dict(self) -> dict:
        return {"name": self.name, "span_id": self.span_id,
                "parent_id": self.parent_id,
                "start_unix": self.start_unix,
                "duration_s": self.duration_s}


@dataclasses.dataclass(frozen=True)
class Trace:
    """One request's assembled trace: a root span + phase children."""

    trace_id: str
    state: str                     # terminal RequestState value
    spans: tuple[Span, ...]        # root first, children in time order

    @property
    def root(self) -> Span:
        return self.spans[0]

    @property
    def duration_s(self) -> float:
        return self.root.duration_s

    def span(self, name: str) -> Span | None:
        for s in self.spans:
            if s.name == name:
                return s
        return None

    def to_dict(self) -> dict:
        return {"trace_id": self.trace_id, "state": self.state,
                "duration_s": self.duration_s,
                "spans": [s.to_dict() for s in self.spans]}


def assemble_trace(trace_id: str, timeline: RequestTimeline,
                   state: str = "done") -> Trace:
    """Build the per-request trace from a timeline's recorded marks.

    Child spans run between *consecutive reached* marks and are named
    for the phase the interval belongs to, so a request cancelled while
    queued yields a single ``admission`` child and a failed request's
    trace simply stops at the last phase it reached.  Because children
    tile root exactly, ``sum(child.duration_s) == root.duration_s``.
    """
    reached = [(m, timeline.at(m)) for m in MARKS
               if timeline.at(m) is not None]
    if not reached:
        raise ValueError(f"timeline of {trace_id!r} has no marks")
    t0, t_end = reached[0][1], reached[-1][1]
    spans = [Span(name="request", span_id=0, parent_id=None,
                  start_unix=timeline.wall(t0), start_s=t0, end_s=t_end)]
    for i, (mark, t) in enumerate(reached[:-1]):
        spans.append(Span(
            name=_PHASE_OF[mark], span_id=i + 1, parent_id=0,
            start_unix=timeline.wall(t), start_s=t,
            end_s=reached[i + 1][1]))
    return Trace(trace_id=trace_id, state=state, spans=tuple(spans))


class TraceRecorder:
    """Keeps the first ``sample`` completed request traces, thread-safe.

    First-N sampling is deliberate: deterministic under test, and the
    earliest requests of a serving run are the ones that exercise cold
    caches and compilation — the traces worth reading.
    """

    enabled = True

    def __init__(self, sample: int = 8):
        if sample < 1:
            raise ValueError("sample must be >= 1")
        self.sample = sample
        self._lock = threading.Lock()
        self._traces: list[Trace] = []

    def record(self, trace_id: str, timeline: RequestTimeline,
               state: str = "done") -> Trace | None:
        """Assemble + keep the trace if the sample isn't full yet."""
        with self._lock:
            if len(self._traces) >= self.sample:
                return None
            trace = assemble_trace(trace_id, timeline, state)
            self._traces.append(trace)
            return trace

    @property
    def full(self) -> bool:
        with self._lock:
            return len(self._traces) >= self.sample

    def traces(self) -> tuple[Trace, ...]:
        with self._lock:
            return tuple(self._traces)

    def to_dicts(self) -> list[dict]:
        return [t.to_dict() for t in self.traces()]


class NullTraceRecorder(TraceRecorder):
    """Disabled tracing: same interface, keeps nothing."""

    enabled = False

    def __init__(self) -> None:
        super().__init__(sample=1)

    def record(self, trace_id: str, timeline: RequestTimeline,
               state: str = "done") -> None:
        return None

    @property
    def full(self) -> bool:
        return True

    def traces(self) -> tuple[Trace, ...]:
        return ()
