"""`ProfilingService`: the profiler-first serving front door.

Counterpart of :mod:`repro.serve.profiler_service`.  A service owns
**one** shared RefDB + backend (a
:class:`~repro_torch.pipeline.session.ProfilingSession`, on the session's
device -- ``cuda`` unless it was built with ``device="cpu"``) and admits
many concurrent :class:`ProfileRequest` s, each wrapping its own
:class:`~repro_torch.pipeline.source.ReadSource`::

    service = ProfilingService(session)           # session has a RefDB
    with service:                                 # background worker
        h1 = service.submit(FastqSource("a.fastq"))
        h2 = service.submit(FastqSource("b.fastq"))
        partial = h1.snapshot()                   # streaming report
        report = h1.result(timeout=60)            # final ProfileReport

Requests' reads are interleaved into fixed-shape cohorts through the
generic :class:`~repro_torch.serve.scheduler.FixedShapeScheduler` (rows =
``config.batch_size``, read length padded to a bounded bucket set), run
through the session's single hot-path primitive
:meth:`~repro_torch.pipeline.session.ProfilingSession.classify_batch`
(on ``cuda_fused``: one fused-kernel launch per cohort, at the cohort's
bucket width, with zero-length rows past the live reads), and the
resulting rows are demultiplexed into per-request streaming
:class:`~repro_torch.pipeline.report.ProfileAccumulator` s.

**Bit-exactness contract**: a request's final report equals a sequential
``ProfilingSession.profile(source)`` run of the same reads, bit for bit,
on every backend.  This holds because (a) the scheduler never reorders a
submitter's items, (b) encode/agreement are row-independent and invariant
to length padding (the encoders mask by per-row ``lengths``), and (c)
``ProfileAccumulator.finalize`` is batch-grouping-independent.

Lifecycle & backpressure: requests move QUEUED -> RUNNING -> one of
DONE / CANCELLED / FAILED.  At most ``max_active`` requests interleave at
once; at most ``max_queue`` more wait in admission.  A ``submit`` beyond
that raises :class:`ServiceOverloaded` (or blocks when ``block=True``).

The service is synchronous at heart -- :meth:`step` runs one cohort on the
calling thread -- with an optional single background worker
(:meth:`start`/:meth:`stop`, or the context manager).  A cohort whose
kernel launch fails raises out of :meth:`step`; the worker (or the
router's pump) then fails every live request with that error.  Nothing
retries on a plain version.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
import threading
import time
from typing import Iterator, Sequence

import numpy as np

from repro_torch import obs
from repro_torch.obs.trace import RequestTimeline
from repro_torch.pipeline.report import ProfileAccumulator, ProfileReport
from repro_torch.pipeline.session import ProfilingSession
from repro_torch.pipeline.source import ReadSource, as_source
from repro_torch.serve.scheduler import (Cohort, FixedShapeScheduler,
                                         pow2_buckets)


class RequestState(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    DONE = "done"
    CANCELLED = "cancelled"
    FAILED = "failed"

    @property
    def terminal(self) -> bool:
        return self in (RequestState.DONE, RequestState.CANCELLED,
                        RequestState.FAILED)


class ServiceOverloaded(RuntimeError):
    """Admission queue full: shed load or retry later (HTTP 429 analogue)."""


@dataclasses.dataclass(frozen=True)
class ProfileRequest:
    """One profiling job: a read stream plus bookkeeping identity."""
    source: ReadSource
    request_id: str | None = None


@dataclasses.dataclass(frozen=True)
class _Read:
    """One admitted read row, tagged with its owning request."""
    handle: "ProfileHandle"
    tokens: np.ndarray      # (L_request,) int32
    length: int


class ProfileHandle:
    """Caller-side view of a submitted request (state, snapshots, result)."""

    def __init__(self, service: "ProfilingService", request: ProfileRequest,
                 request_id: str):
        self._service = service
        self.request = request
        self.request_id = request_id
        self.state = RequestState.QUEUED
        self.error: BaseException | None = None
        # The one request clock: every latency figure (here and on the
        # router's RoutedHandle) derives from these phase marks, and the
        # same marks assemble into the request's trace.
        self.timeline = RequestTimeline()
        self.timeline.mark("submitted")
        self.reads_admitted = 0
        self.reads_classified = 0
        self._acc: ProfileAccumulator | None = None
        self._reads: Iterator[tuple[np.ndarray, int]] | None = None
        self._exhausted = False
        self._final: ProfileReport | None = None
        self._terminal = threading.Event()

    # -- caller API ---------------------------------------------------------
    def snapshot(self) -> ProfileReport:
        """Incremental report over the reads classified *so far*.

        Valid in any state (zero-read report while queued); once the
        request is DONE this is the final report.
        """
        with self._service._lock:
            if self._final is not None:
                return self._final
            return self._service._finalize_locked(self)

    def result(self, timeout: float | None = None) -> ProfileReport:
        """Block until terminal; return the final report.

        Raises TimeoutError on timeout, the request's own error if it
        FAILED, and RuntimeError if it was CANCELLED.
        """
        if not self._terminal.wait(timeout):
            raise TimeoutError(
                f"request {self.request_id} still {self.state.value} "
                f"after {timeout}s")
        if self.state is RequestState.FAILED:
            raise self.error  # type: ignore[misc]
        if self.state is RequestState.CANCELLED:
            raise RuntimeError(f"request {self.request_id} was cancelled")
        assert self._final is not None
        return self._final

    def cancel(self) -> bool:
        """Cancel the request; True if it was still live.

        Already-classified reads are discarded with the rest: a cancelled
        request produces no report (``result`` raises).
        """
        return self._service._cancel(self)

    @property
    def done(self) -> bool:
        return self.state.terminal

    # -- the unified latency clock (all timeline-derived) -------------------
    @property
    def submitted_at(self) -> float | None:
        return self.timeline.at("submitted")

    @property
    def started_at(self) -> float | None:
        return self.timeline.at("started")

    @property
    def finished_at(self) -> float | None:
        return self.timeline.at("finished")

    @property
    def latency_s(self) -> float | None:
        """Submit-to-terminal wall time, once terminal."""
        return self.timeline.latency_s

    @property
    def queue_wait_s(self) -> float | None:
        """Admission wait: submit until the request went RUNNING."""
        return self.timeline.queue_wait_s

    @property
    def service_s(self) -> float | None:
        """Active service time: RUNNING until terminal."""
        return self.timeline.service_s


class ProfilingService:
    """Multi-tenant profiling over one shared RefDB + backend."""

    def __init__(self, session: ProfilingSession, *, max_active: int = 8,
                 max_queue: int = 64,
                 buckets: Sequence[int] | None = None,
                 metrics: obs.MetricsRegistry | None = None,
                 tracer: obs.TraceRecorder | None = None,
                 obs_labels: dict[str, str] | None = None):
        """Args:
          session: a session whose RefDB is already built/loaded (the one
            expensive shared structure; requests only read it).  The
            service runs on the session's device.
          max_active: how many requests interleave reads at once.
          max_queue: bound on requests waiting behind the active set.
          buckets: allowed read-length paddings for cohort shapes
            (default: powers of two from 16 up to 4096 -- a bounded set
            of launch shapes).
          metrics: explicit metrics registry (default: the process
            global, a no-op unless ``obs.enable_metrics()`` ran).
          tracer: explicit trace recorder (same default convention).
          obs_labels: constant labels stamped on every sample this
            service records (the tenant router sets ``tenant=...``).
        """
        if session.refdb is None:
            raise ValueError(
                "session has no RefDB; call build_or_load_refdb() before "
                "constructing the service (requests share one database)")
        if max_active < 1 or max_queue < 0:
            raise ValueError("need max_active >= 1 and max_queue >= 0")
        self.session = session
        self.max_active = max_active
        self.max_queue = max_queue
        self._sched: FixedShapeScheduler[_Read] = FixedShapeScheduler(
            slots=session.config.batch_size,
            buckets=buckets if buckets is not None else pow2_buckets(16, 4096))
        self._lock = threading.RLock()
        self._work = threading.Condition(self._lock)
        self._queued: list[ProfileHandle] = []
        self._active: list[ProfileHandle] = []
        self._ids = itertools.count()
        self._worker: threading.Thread | None = None
        self._stopping = False
        self.error: BaseException | None = None
        self.cohorts_run = 0
        self.reads_classified = 0
        self._obs = obs.resolve_metrics(metrics)
        self._tracer = obs.resolve_tracer(tracer)
        self._labels = dict(obs_labels or {})
        self._m_admission_wait = self._obs.histogram(
            "serve_admission_wait_seconds",
            "Queue wait from submit until the request went RUNNING.",
            unit="s")
        self._m_batch_time = self._obs.histogram(
            "serve_batch_seconds",
            "Wall time of one cohort classify_batch, demux included.",
            unit="s")
        self._m_fill_ratio = self._obs.histogram(
            "serve_cohort_fill_ratio",
            "Live rows over total slots per executed cohort.",
            buckets=obs.RATIO_BUCKETS)
        self._m_padding_rows = self._obs.counter(
            "serve_cohort_padding_rows_total",
            "Wasted (padding) rows across executed cohorts.")
        self._m_reads = self._obs.counter(
            "serve_reads_classified_total",
            "Reads classified and demuxed into request accumulators.")
        self._m_requests = self._obs.counter(
            "serve_requests_total",
            "Requests reaching a terminal state, by outcome.")
        self._m_queue_depth = self._obs.gauge(
            "serve_queue_depth", "Requests waiting in admission right now.")
        self._m_active = self._obs.gauge(
            "serve_active_requests", "Requests currently interleaving reads.")

    # -- admission ----------------------------------------------------------
    def submit(self, request: ProfileRequest | ReadSource | object, *,
               request_id: str | None = None, block: bool = False,
               timeout: float | None = None) -> ProfileHandle:
        """Admit one profiling request; returns its :class:`ProfileHandle`.

        Accepts a :class:`ProfileRequest`, a :class:`ReadSource`, or
        anything :func:`~repro_torch.pipeline.source.as_source` coerces.  The
        id precedence is ``request.request_id``, then ``request_id=``,
        then a generated ``req-N``.  When the admission queue is full,
        raises :class:`ServiceOverloaded` (``block=False``) or waits up
        to ``timeout`` for space.
        """
        if not isinstance(request, ProfileRequest):
            request = ProfileRequest(source=as_source(request),
                                     request_id=request_id)
        with self._work:
            if self.error is not None:
                raise RuntimeError(
                    "service worker died on an unrecoverable error"
                ) from self.error
            deadline = None if timeout is None else time.monotonic() + timeout
            # The service holds at most max_active + max_queue live
            # requests; past that, admission is the backpressure point.
            while len(self._queued) + len(self._active) \
                    >= self.max_active + self.max_queue:
                if not block:
                    raise ServiceOverloaded(
                        f"admission queue full ({self.max_queue} queued, "
                        f"{self.max_active} active)")
                left = None if deadline is None \
                    else deadline - time.monotonic()
                if left is not None and left <= 0:
                    raise TimeoutError("timed out waiting for admission")
                self._work.wait(left)
            rid = request.request_id or request_id \
                or f"req-{next(self._ids)}"
            handle = ProfileHandle(self, request, rid)
            self._queued.append(handle)
            if self._obs.enabled:
                self._m_queue_depth.set(len(self._queued), **self._labels)
            self._work.notify_all()
            return handle

    # -- the pump -----------------------------------------------------------
    def step(self) -> bool:
        """Run one cohort (admit -> classify -> demux); False when idle.

        This is the whole serving hot loop at its smallest granularity;
        ``run_until_idle`` and the background worker just call it.
        """
        with self._lock:
            self._activate_locked()
            active = list(self._active)
            want = self._sched.slots - len(self._sched)
        # Source iteration (file IO) happens outside the lock — only the
        # pumping thread touches the iterators, so submissions and
        # snapshots stay responsive while a slow FASTQ parses.
        events = self._pull_reads(active, want)
        with self._lock:
            self._apply_admission_locked(events)
            self._finish_exhausted_locked()
            cohort = self._sched.next_cohort()
            if cohort is None:
                return False
        # Classify outside the lock too: the service stays responsive
        # while the backend crunches the batch.
        tokens, lengths, live = self._assemble(cohort)
        recording = self._obs.enabled
        t_exec = time.perf_counter() if recording or self._tracer.enabled \
            else 0.0
        res = self.session.classify_batch(tokens, lengths,
                                          num_valid=len(live))
        hits = res.classification.hits.cpu().numpy()
        cat = res.classification.category.cpu().numpy()
        t_demux = time.perf_counter() if recording or self._tracer.enabled \
            else 0.0
        with self._work:
            if recording:
                slots = self._sched.slots
                self._m_batch_time.observe(
                    t_demux - t_exec, backend=self.session.config.backend,
                    **self._labels)
                self._m_fill_ratio.observe(len(live) / slots, **self._labels)
                self._m_padding_rows.inc(slots - len(live), **self._labels)
                self._m_reads.inc(len(live), **self._labels)
            # hits + category: two device->host pulls per cohort (the
            # session guards on its own registry's enabled flag).
            self.session.note_host_transfers(2)
            if recording or self._tracer.enabled:
                for h in {r.handle for r in live}:
                    h.timeline.mark("first_execute", at=t_exec)
                    h.timeline.mark("accumulate", at=t_demux)
            self._demux_locked(live, hits, cat)
            self.cohorts_run += 1
            self._finish_exhausted_locked()
            self._work.notify_all()
        return True

    @property
    def idle(self) -> bool:
        """True when nothing is queued, active, or buffered in cohorts.

        The drain condition: an idle service has every admitted request
        terminal.  The tenant router retires an old RefDB version's
        service the moment it reports idle.
        """
        with self._lock:
            return not (self._queued or self._active or len(self._sched))

    def run_until_idle(self) -> None:
        """Pump cohorts on the calling thread until no work remains."""
        while True:
            if self.step():
                continue
            if self.idle:
                return

    # -- background worker --------------------------------------------------
    def start(self) -> "ProfilingService":
        """Start the single background worker pumping :meth:`step`."""
        with self._lock:
            if self._worker is not None:
                raise RuntimeError("service already started")
            self._stopping = False
            self._worker = threading.Thread(target=self._pump, daemon=True,
                                            name="profiling-service")
            self._worker.start()
        return self

    def stop(self, *, drain: bool = True, timeout: float | None = None
             ) -> None:
        """Stop the worker; ``drain=True`` finishes in-flight work first.

        If the worker died on an unrecoverable error, ``service.error``
        holds it (every live request was FAILED with the same error).
        """
        if not drain:
            self.cancel_all()
        with self._work:
            if self._worker is None:
                return
            self._stopping = True
            self._work.notify_all()
        self._worker.join(timeout)
        self._worker = None

    def cancel_all(self) -> int:
        """Best-effort cancel of every queued/active request; returns the
        number actually cancelled (requests mid-cohort may complete)."""
        with self._work:
            n = 0
            for h in list(self._queued) + list(self._active):
                n += bool(self._cancel_locked(h))
            self._work.notify_all()
            return n

    def __enter__(self) -> "ProfilingService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop(drain=exc == (None, None, None))

    def fail_all(self, error: BaseException) -> None:
        """Record a service-fatal error and fail every live request.

        The containment of last resort when per-request isolation could
        not hold (the backend itself died mid-cohort): the service
        refuses new work, and every ``result()``/blocking ``submit()``
        caller wakes immediately with ``error``.  Used by the internal
        worker and by any external pump (the tenant router) driving
        :meth:`step` itself.
        """
        with self._work:
            self.error = error
            for h in list(self._active) + list(self._queued):
                self._fail_locked(h, error)
            self._work.notify_all()

    def _pump(self) -> None:
        while True:
            try:
                did = self.step()
            except BaseException as e:
                # A failure the per-request isolation could not contain
                # (e.g. the backend itself died mid-cohort).  Don't die
                # silently — see fail_all.
                self.fail_all(e)
                return
            with self._work:
                if not did:
                    if self._stopping:
                        return
                    self._work.wait(0.05)

    # -- internals (all *_locked run under self._lock) ----------------------
    def _activate_locked(self) -> None:
        while self._queued and len(self._active) < self.max_active:
            h = self._queued.pop(0)
            if h.state is not RequestState.QUEUED:
                continue                       # cancelled while waiting
            h.state = RequestState.RUNNING
            h.timeline.mark("started")
            if self._obs.enabled:
                self._m_admission_wait.observe(
                    h.queue_wait_s or 0.0, **self._labels)
                self._m_queue_depth.set(len(self._queued), **self._labels)
                self._m_active.set(len(self._active) + 1, **self._labels)
            h._acc = ProfileAccumulator(self.session.refdb.num_species)
            h._reads = _iter_reads(h.request.source,
                                   self.session.config.batch_size)
            self._active.append(h)
            self._work.notify_all()

    def _pull_reads(self, active: list[ProfileHandle], want: int
                    ) -> list[tuple[str, ProfileHandle, object]]:
        """Round-robin up to ``want`` reads from the active streams.

        Runs WITHOUT the lock (the pump thread owns the iterators); the
        returned event list is applied under the lock.  A stream that
        ends, raises, or yields a read longer than the largest bucket
        produces an event for *its own request only* — failure isolation
        lives here.
        """
        events: list[tuple[str, ProfileHandle, object]] = []
        live = [h for h in active
                if not h._exhausted and h.state is RequestState.RUNNING]
        while want > 0 and live:
            for h in list(live):
                try:
                    tokens, length = next(h._reads)
                except StopIteration:
                    events.append(("end", h, None))
                    live.remove(h)
                    continue
                except BaseException as e:
                    events.append(("fail", h, e))
                    live.remove(h)
                    continue
                length = int(length)
                try:
                    self._sched.bucket_for(max(length, 1))
                except ValueError as e:        # oversize read: fail the
                    events.append(("fail", h, e))    # one request, not
                    live.remove(h)                   # the service
                    continue
                # Trim to the true length: the row re-pads to the cohort
                # bucket in _assemble, which may be shorter than the
                # request's own padded width.
                row = np.asarray(tokens, np.int32)[:length]
                events.append(("read", h, (row, length)))
                want -= 1
                if want <= 0:
                    break
        return events

    def _apply_admission_locked(
            self, events: list[tuple[str, ProfileHandle, object]]) -> None:
        for kind, h, payload in events:
            if kind == "end":
                h._exhausted = True
            elif kind == "fail" and not h.state.terminal:
                self._fail_locked(h, payload)
            elif kind == "read" and h.state is RequestState.RUNNING:
                row, length = payload
                h.reads_admitted += 1
                self._sched.submit(_Read(h, row, length), length)

    def _assemble(self, cohort: Cohort[_Read]
                  ) -> tuple[np.ndarray, np.ndarray, list[_Read]]:
        """Pad cohort rows to the fixed ``(batch_size, bucket)`` shape,
        dropping rows whose request died after admission."""
        live = [r for r in cohort.items
                if r.handle.state is RequestState.RUNNING]
        b, length = self._sched.slots, cohort.length
        tokens = np.zeros((b, length), np.int32)
        lengths = np.zeros(b, np.int32)
        for i, r in enumerate(live):
            tokens[i, :len(r.tokens)] = r.tokens
            lengths[i] = r.length
        return tokens, lengths, live

    def _demux_locked(self, live: list[_Read], hits: np.ndarray,
                      cat: np.ndarray) -> None:
        """Split cohort rows back into per-request accumulators, in order."""
        per: dict[ProfileHandle, list[int]] = {}
        for i, r in enumerate(live):
            if r.handle.state is RequestState.RUNNING:
                per.setdefault(r.handle, []).append(i)
        for h, idx in per.items():
            h._acc.add(hits[idx], cat[idx])
            h.reads_classified += len(idx)
            self.reads_classified += len(idx)

    def _finish_exhausted_locked(self) -> None:
        # classified == admitted implies nothing of this request's is
        # still buffered in the scheduler (rows only classify after
        # passing through a cohort, and RUNNING rows are never dropped).
        for h in list(self._active):
            if h.state is RequestState.RUNNING and h._exhausted \
                    and h.reads_classified == h.reads_admitted:
                h.timeline.mark("finalize")
                h._final = self._finalize_locked(h)
                self._terminate_locked(h, RequestState.DONE)

    def _finalize_locked(self, h: ProfileHandle) -> ProfileReport:
        db = self.session.refdb
        acc = h._acc or ProfileAccumulator(db.num_species)
        return acc.finalize(db.genome_lengths.cpu().numpy(),
                            db.species_names)

    def _cancel(self, h: ProfileHandle) -> bool:
        with self._work:
            out = self._cancel_locked(h)
            self._work.notify_all()
            return out

    def _cancel_locked(self, h: ProfileHandle) -> bool:
        if h.state.terminal:
            return False
        self._terminate_locked(h, RequestState.CANCELLED)
        return True

    def _fail_locked(self, h: ProfileHandle, err: BaseException) -> None:
        h.error = err
        self._terminate_locked(h, RequestState.FAILED)

    def _terminate_locked(self, h: ProfileHandle, state: RequestState
                          ) -> None:
        h.state = state
        h.timeline.mark("finished")
        if h in self._active:
            self._active.remove(h)
        if h in self._queued:
            self._queued.remove(h)
        if self._obs.enabled:
            self._m_requests.inc(1, state=state.value, **self._labels)
            self._m_queue_depth.set(len(self._queued), **self._labels)
            self._m_active.set(len(self._active), **self._labels)
        if self._tracer.enabled:
            self._tracer.record(h.request_id, h.timeline, state.value)
        close = getattr(h._reads, "close", None)
        if close is not None:
            close()
        h._terminal.set()
        self._work.notify_all()    # wake blocked submitters: a slot freed


def _iter_reads(source: ReadSource, batch_size: int
                ) -> Iterator[tuple[np.ndarray, int]]:
    """Flatten a source into single reads, in stream order.

    Iterating ``batches(batch_size)`` with the *session's* batch size
    means the service sees exactly the rows a sequential
    ``session.profile(source)`` would — only regrouped into cohorts.
    """
    for batch in source.batches(batch_size):
        for j in range(batch.num_valid):
            yield batch.tokens[j], int(batch.lengths[j])
