"""`TenantRouter`: many tenants, many live databases, one serving front.

Counterpart of :mod:`repro.serve.router`.
:class:`~repro_torch.serve.profiler_service.ProfilingService` is the data
plane: many concurrent requests over **one** RefDB + backend, bit-exact
with sequential runs.  The router is the control plane above it: several
reference databases served at once, each updated live through the
:class:`~repro_torch.serve.registry.RefDBRegistry`::

    registry.create("food", food_genomes, config)
    router = TenantRouter(registry, backend="cuda_fused")
    router.add_tenant("acme", database="food", max_active=4, max_queue=16)
    with router:                                   # pump worker(s)
        h = router.submit(source, tenant="acme")   # routed by tenant
        registry.apply_delta("food", add={"listeria": toks})  # auto-swap
        report = h.result(timeout=60)              # old version, bit-exact

**Routing.**  Each tenant names a database; ``submit`` maps the request
to that database's *current* serving version.  Per-tenant admission
quotas (``max_active`` + ``max_queue`` live requests) are enforced at
the router door: overflow raises :class:`ServiceOverloaded` for that
tenant only.

**Zero-downtime hot-swap.**  Every served database version gets its own
``(ProfilingSession, ProfilingService)`` pair; all of them share one
resolved backend per database (its item memory on the card and its
autotuned tiles).  A swap (explicit :meth:`hot_swap`, or automatic on
registry publish) atomically repoints new admissions at version N+1
while the version-N service keeps draining its in-flight requests.
Cohorts are formed *inside* one service, so no cohort mixes versions,
and a request admitted against N is classified against N's database
from first read to final report.

**Pumping.**  ``step()`` round-robins one cohort attempt across every
live service (current + draining, all databases); ``start(workers=n)``
runs n pump threads -- services are claimed with a per-service
try-lock, so distinct services execute concurrently while one service
is never pumped from two threads at once.  Every thread launches its
kernels on its current CUDA stream, which is the device's default
stream unless a caller set another, so launches from several pumps
serialize on the card.

The router runs on the registry's device: its backends are resolved
there.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time

from repro_torch import obs
from repro_torch.pipeline.backend import Backend, resolve_backend
from repro_torch.pipeline.config import ProfilerConfig
from repro_torch.pipeline.report import ProfileReport
from repro_torch.pipeline.session import ProfilingSession
from repro_torch.serve.profiler_service import (ProfileHandle,
                                                ProfilingService,
                                                RequestState,
                                                ServiceOverloaded)
from repro_torch.serve.registry import RefDBRegistry, RefDBSnapshot

#: Execution-only config fields the router may override per deployment;
#: content fields (space/window/stride) stay pinned by the registry.
_EXEC_FIELDS = ("backend", "backend_options", "batch_size")


class RouterClosed(RuntimeError):
    """The router is stopping or stopped: no new admissions.

    The :meth:`TenantRouter.stop` / :meth:`TenantRouter.submit` race
    contract: a submit that wins the race is admitted and — with
    ``drain=True`` — pumped to completion before the workers exit; a
    submit that loses raises this, immediately.  A handle is never left
    hanging with no pump behind it.  :meth:`TenantRouter.start` reopens
    admissions.
    """


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's routing + admission-quota contract."""

    tenant: str
    database: str
    max_active: int = 4     # requests in flight at once
    max_queue: int = 16     # further requests waiting in admission

    def __post_init__(self) -> None:
        if self.max_active < 1 or self.max_queue < 0:
            raise ValueError("need max_active >= 1 and max_queue >= 0")


class RoutedHandle:
    """Caller view of a routed request: the service handle + routing facts.

    ``version`` records which database version admitted the request —
    the version its report is bit-exact against, whatever swaps happen
    while it runs.
    """

    def __init__(self, handle: ProfileHandle, tenant: str, database: str,
                 version: int):
        self.handle = handle
        self.tenant = tenant
        self.database = database
        self.version = version

    # Delegation, not inheritance: the service owns the handle lifecycle.
    @property
    def request_id(self) -> str:
        return self.handle.request_id

    @property
    def state(self) -> RequestState:
        return self.handle.state

    @property
    def done(self) -> bool:
        return self.handle.done

    @property
    def latency_s(self) -> float | None:
        return self.handle.latency_s

    @property
    def queue_wait_s(self) -> float | None:
        return self.handle.queue_wait_s

    @property
    def service_s(self) -> float | None:
        return self.handle.service_s

    @property
    def timeline(self):
        """The request's phase clock (shared with the service handle)."""
        return self.handle.timeline

    def snapshot(self) -> ProfileReport:
        return self.handle.snapshot()

    def result(self, timeout: float | None = None) -> ProfileReport:
        return self.handle.result(timeout)

    def cancel(self) -> bool:
        return self.handle.cancel()


class _VersionedService:
    """One database version being served: session + service + pump claim."""

    def __init__(self, version: int, session: ProfilingSession,
                 service: ProfilingService):
        self.version = version
        self.session = session
        self.service = service
        self.drain_started: float | None = None   # set at hot-swap time
        # Claimed by at most one pump thread at a time (the service's
        # source iterators are single-pumper by contract); distinct
        # services pump concurrently across worker threads.
        self.pump_claim = threading.Lock()


class _Database:
    """Router-internal serving state of one named database."""

    def __init__(self, name: str, config: ProfilerConfig, backend: Backend,
                 current: _VersionedService):
        self.name = name
        self.config = config
        self.backend = backend
        self.current = current
        self.draining: list[_VersionedService] = []


class TenantRouter:
    """Multi-tenant, multi-database serving with zero-downtime swaps."""

    def __init__(self, registry: RefDBRegistry, *,
                 backend: str | None = None, batch_size: int | None = None,
                 backend_options: dict | None = None,
                 buckets=None, service_active: int = 8,
                 service_queue: int = 256, auto_swap: bool = True,
                 metrics: obs.MetricsRegistry | None = None,
                 tracer: obs.TraceRecorder | None = None):
        """Args:
          registry: source of truth for databases and their versions.
          backend / batch_size / backend_options: execution overrides
            applied over each database's registry config (content fields
            are never overridable — they pin what the prototypes mean).
            None keeps the registry config's value.
          buckets: cohort read-length buckets, forwarded to each service.
          service_active/service_queue: per-version service capacity.
            Tenant quotas are the binding admission limits; these bound
            the cohort-interleaving width and total buffering per
            database version.
          auto_swap: subscribe to the registry so every publish of a
            served database hot-swaps it immediately.
          metrics / tracer: explicit observability sinks (default: the
            process globals — no-ops unless ``obs.enable_*()`` ran).
            Forwarded to every per-version service the router spins up.
        """
        self.registry = registry
        self._overrides = {"backend": backend, "batch_size": batch_size,
                           "backend_options": backend_options}
        self._buckets = buckets
        self._service_active = service_active
        self._service_queue = service_queue
        self._lock = threading.RLock()
        self._dbs: dict[str, _Database] = {}
        self._tenants: dict[str, TenantSpec] = {}
        self._live: dict[str, list[RoutedHandle]] = {}
        self._ids = itertools.count()
        self._workers: list[threading.Thread] = []
        self._stopping = False
        self._closed = False
        self._wake = threading.Condition(self._lock)
        self.swaps = 0
        self.retired: list[tuple[str, int]] = []    # (database, version)
        self._obs = obs.resolve_metrics(metrics)
        self._tracer = obs.resolve_tracer(tracer)
        self._m_requests = self._obs.counter(
            "router_requests_total", "Requests admitted, by tenant.")
        self._m_rejections = self._obs.counter(
            "router_quota_rejections_total",
            "Submissions rejected at a tenant's admission quota.")
        self._m_reads_done = self._obs.counter(
            "router_reads_completed_total",
            "Reads classified in requests that reached DONE, by tenant.")
        self._m_swap_time = self._obs.histogram(
            "router_hot_swap_seconds",
            "Publish-to-serving wall time of a hot swap (spin-up "
            "included).", unit="s")
        self._m_drain_time = self._obs.histogram(
            "router_drain_seconds",
            "Swap-to-retire wall time of a superseded version's drain.",
            unit="s")
        self._m_live_version = self._obs.gauge(
            "router_serving_version",
            "Database version new admissions currently route to.")
        self._subscription = (registry.subscribe(self._on_publish)
                              if auto_swap else None)

    # -- topology -----------------------------------------------------------
    def serve_database(self, name: str) -> int:
        """Attach a registry database to the router; returns the version
        now serving.  Implied by :meth:`add_tenant`; idempotent."""
        with self._lock:
            if name in self._dbs:
                return self._dbs[name].current.version
        snap = self.registry.current(name)
        config = self._config_for(name)
        backend = resolve_backend(config.backend, config,
                                  device=self.registry.device)
        vs = self._spin_up(snap, config, backend)
        with self._lock:
            if name in self._dbs:                   # lost a benign race
                return self._dbs[name].current.version
            self._dbs[name] = _Database(name, config, backend, vs)
            self.registry.pin(name, vs.version)
            if self._obs.enabled:
                self._m_live_version.set(vs.version, database=name)
            return vs.version

    def add_tenant(self, tenant: str, database: str, *,
                   max_active: int = 4, max_queue: int = 16) -> TenantSpec:
        """Register a tenant: route its requests to ``database`` under an
        admission quota of ``max_active`` running + ``max_queue`` waiting."""
        spec = TenantSpec(tenant, database, max_active, max_queue)
        self.serve_database(database)
        with self._lock:
            if tenant in self._tenants:
                raise ValueError(f"tenant {tenant!r} already registered "
                                 f"for {self._tenants[tenant].database!r}")
            self._tenants[tenant] = spec
            self._live[tenant] = []
        return spec

    def tenants(self) -> tuple[TenantSpec, ...]:
        with self._lock:
            return tuple(self._tenants[t] for t in sorted(self._tenants))

    def serving_version(self, database: str) -> int:
        """The version new admissions of ``database`` currently see."""
        with self._lock:
            return self._db(database).current.version

    def draining_versions(self, database: str) -> tuple[int, ...]:
        with self._lock:
            return tuple(vs.version for vs in self._db(database).draining)

    # -- admission ----------------------------------------------------------
    def submit(self, source, *, tenant: str, request_id: str | None = None,
               block: bool = False, timeout: float | None = None
               ) -> RoutedHandle:
        """Admit one request for ``tenant``, routed to its database's
        current version.

        Quota: a tenant may hold ``max_active + max_queue`` live
        (non-terminal) requests; past that, ``submit`` raises
        :class:`ServiceOverloaded` — or, with ``block=True``, waits up to
        ``timeout`` for one of the tenant's own requests to finish.
        Other tenants are unaffected either way.
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._wake:
            try:
                spec = self._tenants[tenant]
            except KeyError:
                raise KeyError(
                    f"unknown tenant {tenant!r}; registered: "
                    f"{sorted(self._tenants)}") from None
            while True:
                # Checked on entry AND after every quota-wait wakeup: a
                # stop() racing this submit closes admissions under the
                # same lock, so the submit either got in before (and
                # will be drained) or raises here — it can never slip a
                # request behind the exiting pump workers.
                if self._closed:
                    raise RouterClosed(
                        f"router is stopped; submit for tenant {tenant!r} "
                        f"rejected (start() reopens admissions)")
                live = self._prune_locked(tenant)
                if len(live) < spec.max_active + spec.max_queue:
                    break
                if not block:
                    if self._obs.enabled:
                        self._m_rejections.inc(1, tenant=tenant)
                    raise ServiceOverloaded(
                        f"tenant {tenant!r} quota full "
                        f"({spec.max_active} active + {spec.max_queue} "
                        f"queued live requests)")
                left = None if deadline is None \
                    else deadline - time.monotonic()
                if left is not None and left <= 0:
                    raise TimeoutError(
                        f"timed out waiting for tenant {tenant!r} quota")
                self._wake.wait(left if left is None else min(left, 0.05))
            db = self._db(spec.database)
            vs = db.current
            rid = request_id or f"{tenant}-{next(self._ids)}"
            handle = vs.service.submit(source, request_id=rid)
            routed = RoutedHandle(handle, tenant, spec.database, vs.version)
            live.append(routed)
            if self._obs.enabled:
                self._m_requests.inc(1, tenant=tenant)
            return routed

    # -- the swap -----------------------------------------------------------
    def hot_swap(self, database: str, *, version: int | None = None) -> int:
        """Serve ``version`` (default: registry current) for new
        admissions; in-flight requests drain on their own version.

        The swap is atomic under the router lock: an admission observes
        either the old service or the new one, and each service's
        cohorts contain only its own version's requests.  The old
        service keeps being pumped until idle, then retires.  No-op if
        the requested version is already serving.
        """
        t0 = time.perf_counter()
        snap = (self.registry.current(database) if version is None
                else self.registry.snapshot(database, version))
        with self._lock:
            db = self._db(database)
            if db.current.version == snap.version:
                return snap.version
        # Build the new version's serving pair outside the lock, so
        # admissions stay live on the old version until the instant of
        # the swap.
        vs = self._spin_up(snap, db.config, db.backend)
        with self._wake:
            if db.current.version == snap.version:  # benign publish race
                return snap.version
            self.registry.pin(database, vs.version)
            db.current.drain_started = time.perf_counter()
            db.draining.append(db.current)
            db.current = vs
            self.swaps += 1
            if self._obs.enabled:
                self._m_swap_time.observe(time.perf_counter() - t0,
                                          database=database)
                self._m_live_version.set(vs.version, database=database)
            self._wake.notify_all()
        return snap.version

    def _on_publish(self, snap: RefDBSnapshot) -> None:
        """Registry subscriber: auto-swap databases this router serves.

        Forward-only: a late notification for an already-superseded
        version never rolls serving back (explicit :meth:`hot_swap` with
        ``version=`` is the rollback path).
        """
        with self._lock:
            db = self._dbs.get(snap.database)
            if db is None or snap.version <= db.current.version:
                return
        self.hot_swap(snap.database, version=snap.version)

    # -- the pump -----------------------------------------------------------
    def step(self) -> bool:
        """One round-robin pass: pump every claimable service one cohort.

        Returns True if any service did work.  Safe to call from many
        threads — each service is claimed by at most one pumper at a
        time, and a claim conflict just skips (the other thread is
        already pumping it).
        """
        did = False
        for vs in self._services():
            if not vs.pump_claim.acquire(blocking=False):
                continue
            try:
                try:
                    did = vs.service.step() or did
                except BaseException as e:
                    # Same containment as the service's own worker: the
                    # failure poisons that one service (and version), not
                    # the router — other databases/versions keep serving.
                    vs.service.fail_all(e)
            finally:
                vs.pump_claim.release()
        if self._retire_drained():
            did = True
        with self._wake:
            # Sweep terminal handles out of every tenant's quota list —
            # keeps quota headroom fresh between submits and is where
            # per-tenant completed-read accounting happens.
            for t in self._tenants:
                self._prune_locked(t)
            self._wake.notify_all()
        return did

    def run_until_idle(self) -> None:
        """Pump on the calling thread until every service is idle."""
        while True:
            if self.step():
                continue
            if self.idle:
                return

    @property
    def idle(self) -> bool:
        return all(vs.service.idle for vs in self._services())

    # -- workers ------------------------------------------------------------
    @property
    def running(self) -> bool:
        """True while pump workers are live (start'ed, not yet stop'ed)."""
        with self._lock:
            return bool(self._workers)

    def start(self, workers: int = 1) -> "TenantRouter":
        """Start ``workers`` pump threads (distinct services in parallel)."""
        if workers < 1:
            raise ValueError("workers must be >= 1")
        with self._lock:
            if self._workers:
                raise RuntimeError("router already started")
            self._stopping = False
            self._closed = False
            self._workers = [
                threading.Thread(target=self._pump, daemon=True,
                                 name=f"tenant-router-{i}")
                for i in range(workers)]
        for t in self._workers:
            t.start()
        return self

    def stop(self, *, drain: bool = True, timeout: float | None = None
             ) -> None:
        """Stop the pump threads; ``drain=True`` finishes in-flight work.

        Closes admissions first (under the router lock), so a submit
        racing this call either completed before the close — and with
        ``drain=True`` its request is pumped to a terminal state before
        the workers exit — or raises :class:`RouterClosed`.  Either way
        no handle is left queued with nothing pumping it.
        """
        with self._wake:
            self._closed = True
            if not drain:
                for vs in self._services():
                    vs.service.cancel_all()
            if not self._workers:
                return
            self._stopping = True
            self._wake.notify_all()
        for t in self._workers:
            t.join(timeout)
        self._workers = []

    def close(self) -> None:
        """Detach from the registry (stop receiving auto-swap publishes)."""
        if self._subscription is not None:
            self.registry.unsubscribe(self._subscription)
            self._subscription = None

    def __enter__(self) -> "TenantRouter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop(drain=exc == (None, None, None))
        self.close()

    def _pump(self) -> None:
        while True:
            did = self.step()
            with self._wake:
                if not did:
                    # Exit only when stopping AND truly idle: a submit
                    # that won the stop race may have landed between the
                    # step above and this check — its request still gets
                    # drained before the worker leaves.
                    if self._stopping and self.idle:
                        return
                    self._wake.wait(0.02)

    # -- internals ----------------------------------------------------------
    def _config_for(self, name: str) -> ProfilerConfig:
        config = self.registry.config(name)
        overrides = {k: v for k, v in self._overrides.items()
                     if v is not None}
        assert set(overrides) <= set(_EXEC_FIELDS)
        return dataclasses.replace(config, **overrides) \
            if overrides else config

    def _spin_up(self, snap: RefDBSnapshot, config: ProfilerConfig,
                 backend: Backend) -> _VersionedService:
        """Session + service for one snapshot: adopt the database on the
        shared backend, ready to admit."""
        session = ProfilingSession(config, backend=backend,
                                   metrics=self._obs)
        session.adopt_refdb(snap.db)
        service = ProfilingService(session,
                                   max_active=self._service_active,
                                   max_queue=self._service_queue,
                                   buckets=self._buckets,
                                   metrics=self._obs,
                                   tracer=self._tracer,
                                   obs_labels={"database": snap.database})
        return _VersionedService(snap.version, session, service)

    def _db(self, name: str) -> _Database:
        try:
            return self._dbs[name]
        except KeyError:
            raise KeyError(
                f"database {name!r} not served by this router; serving "
                f"{sorted(self._dbs)}") from None

    def _services(self) -> list[_VersionedService]:
        with self._lock:
            out = []
            for db in self._dbs.values():
                out.append(db.current)
                out.extend(db.draining)
            return out

    def _retire_drained(self) -> bool:
        """Drop drained old-version services (and their registry pins);
        True if any retired."""
        with self._lock:
            retired = False
            for db in self._dbs.values():
                keep = []
                for vs in db.draining:
                    if vs.service.idle:
                        self.retired.append((db.name, vs.version))
                        self.registry.release(db.name, vs.version)
                        if self._obs.enabled \
                                and vs.drain_started is not None:
                            self._m_drain_time.observe(
                                time.perf_counter() - vs.drain_started,
                                database=db.name)
                        retired = True
                    else:
                        keep.append(vs)
                db.draining = keep
            return retired

    def _prune_locked(self, tenant: str) -> list[RoutedHandle]:
        """Drop terminal handles from the tenant's live list (quota
        accounting); runs under the router lock."""
        live = []
        for h in self._live[tenant]:
            if not h.done:
                live.append(h)
            elif self._obs.enabled and h.state is RequestState.DONE:
                self._m_reads_done.inc(h.handle.reads_classified,
                                       tenant=tenant)
        self._live[tenant] = live
        return live
