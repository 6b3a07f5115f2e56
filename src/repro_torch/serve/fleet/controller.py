"""`FleetController`: replication, routing, failover, fleet-wide swaps.

Counterpart of :mod:`repro.serve.fleet.controller`.  The multi-host front
over a set of :class:`HostReplica` s, all in one process (on a card they
share it).  One source
registry is the truth about database versions; the controller

* **replicates** published versions to every healthy host (pull-based
  :meth:`HostReplica.sync` — resumable after downtime, gaps allowed),
* **routes** each request by tenant affinity (a crc32 ring home, so the
  same tenant lands on the same host whenever load permits) broken by
  least-outstanding-reads load across healthy hosts,
* **fails over**: when a host dies mid-flight, every affected request is
  re-submitted on a surviving replica *before* the dead router's work is
  cancelled — re-submission is safe because reports are deterministic,
  and the rerouted report is bit-identical to a sequential run,
* **swaps fleet-wide** in two phases: *prepare* (every host opens + pins
  the new version; nothing serves it yet) then *flip* (every router
  repoints admissions); the old version's source pins are only released
  as each host reports drained (:meth:`poll_retire`) — generalizing the
  single-host pin/release refcounting across the fleet, so the source
  registry's ``gc`` cannot collect a version any host still serves.

Fleet observability: every replica records into its own registry;
:meth:`metrics_snapshot` folds them with
:meth:`~repro_torch.obs.metrics.MetricsRegistry.merged` into one snapshot
whose every series carries a ``host`` label, plus the controller's own
fleet gauges (healthy hosts, per-host replication lag, per-host
outstanding reads) and counters (requests, reroutes, swaps).
"""

from __future__ import annotations

import itertools
import threading
import time
import zlib
from typing import Callable

import torch

from repro_torch import obs
from repro_torch.pipeline.report import ProfileReport
from repro_torch.pipeline.source import IterableSource, as_source
from repro_torch.serve.profiler_service import (RequestState,
                                                ServiceOverloaded)
from repro_torch.serve.registry import RefDBRegistry
from repro_torch.serve.router import RoutedHandle
from repro_torch.serve.fleet.replica import HostDown, HostReplica, HostState


class NoHealthyHosts(RuntimeError):
    """Every replica is down or draining: nothing can take the request."""


class FleetHandle:
    """Caller view of a fleet request across host failovers.

    ``attempts`` records every (host, routed handle) the request ran on;
    a kill-triggered failover appends a new attempt *before* the dead
    host's copy is cancelled, so :meth:`result` never observes a gap.
    The final report is whatever the last attempt produced — bit-exact
    with a sequential run on :attr:`version` (the database version that
    admitted the final attempt).
    """

    def __init__(self, controller: "FleetController", request_id: str,
                 tenant: str, database: str, source, est_reads: int):
        self._controller = controller
        self.request_id = request_id
        self.tenant = tenant
        self.database = database
        self.source = source
        self.est_reads = est_reads
        self.rerouted = False
        self._attempts: list[tuple[str, RoutedHandle]] = []
        self._error: BaseException | None = None
        self._settled = False

    @property
    def attempts(self) -> tuple[tuple[str, str], ...]:
        """(host_id, routed request_id) per attempt, in order."""
        with self._controller._lock:
            return tuple((h, r.request_id) for h, r in self._attempts)

    @property
    def host(self) -> str:
        """The host serving (or having served) the latest attempt."""
        with self._controller._lock:
            return self._attempts[-1][0]

    @property
    def version(self) -> int:
        """Database version the latest attempt was admitted against."""
        with self._controller._lock:
            return self._attempts[-1][1].version

    @property
    def done(self) -> bool:
        with self._controller._lock:
            return self._error is not None or self._attempts[-1][1].done

    def result(self, timeout: float | None = None) -> ProfileReport:
        """Block until the request (any attempt) is terminal.

        Raises :class:`HostDown` / :class:`NoHealthyHosts` when failover
        was impossible, or the request's own error, like the single-host
        handle."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._controller._lock:
                if self._error is not None:
                    self._settle_locked()
                    raise self._error
                host, routed = self._attempts[-1]
            left = 0.25
            if deadline is not None:
                left = min(left, max(0.0, deadline - time.monotonic()))
            try:
                # timeout=0 still succeeds on an already-terminal attempt
                report = routed.result(timeout=left)
            except TimeoutError:
                if deadline is not None and time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"fleet request {self.request_id} still "
                        f"{routed.state.value} after {timeout}s") from None
                continue
            except BaseException:
                with self._controller._lock:
                    # A kill_host failover appends the replacement
                    # attempt BEFORE cancelling the dead host's copy, so
                    # a cancellation observed here with a newer attempt
                    # (or an error verdict) just means "look again".
                    if (self._attempts[-1][1] is not routed
                            or self._error is not None):
                        continue
                    self._settle_locked()
                raise
            with self._controller._lock:
                if self._attempts[-1][1] is not routed:
                    continue            # superseded mid-completion
                self._settle_locked()
            return report

    def cancel(self) -> bool:
        with self._controller._lock:
            return self._attempts[-1][1].cancel()

    def _settle_locked(self) -> None:
        """One-shot terminal accounting (outstanding reads, live list);
        runs under the controller lock."""
        if self._settled:
            return
        self._settled = True
        host = self._attempts[-1][0]
        c = self._controller
        c._outstanding[host] = max(0, c._outstanding.get(host, 0)
                                   - self.est_reads)
        if self in c._live:
            c._live.remove(self)


class FleetController:
    """Multi-host serving: replication + routing + failover + swaps."""

    def __init__(self, source: RefDBRegistry, hosts: int = 3, *,
                 device: str | torch.device | None = None,
                 backend: str | None = None, batch_size: int | None = None,
                 backend_options: dict | None = None,
                 workers_per_host: int = 1, service_active: int = 8,
                 service_queue: int = 256, buckets=None,
                 metrics: obs.MetricsRegistry | None = None):
        """Args:
          source: the source-of-truth registry (builds/deltas publish
            here; hosts mirror it).
          hosts: number of :class:`HostReplica` s to spin up (named
            ``host0..host{N-1}``).
          device: every host's device (``None``: the source's).
          backend / batch_size / backend_options / workers_per_host /
            service_active / service_queue / buckets: forwarded to every
            replica's router.
          metrics: the controller's own fleet-level registry (default: a
            fresh real one; it is merged into every
            :meth:`metrics_snapshot`).
        """
        if hosts < 1:
            raise ValueError("need at least one host")
        self.source = source
        self._metrics = metrics if metrics is not None \
            else obs.MetricsRegistry()
        self._replicas: dict[str, HostReplica] = {}
        self._order: list[str] = []
        for i in range(hosts):
            hid = f"host{i}"
            self._replicas[hid] = HostReplica(
                hid, source, device=device, backend=backend,
                batch_size=batch_size,
                backend_options=backend_options, workers=workers_per_host,
                service_active=service_active, service_queue=service_queue,
                buckets=buckets)
            self._order.append(hid)
        self._lock = threading.RLock()
        self._tenants: dict[str, dict] = {}    # tenant -> spec kwargs
        self._targets: dict[str, int] = {}     # db -> fleet serving version
        # (db, version) -> host ids holding a source pin for it: one pin
        # per host that serves (or drains) the version, released as each
        # host drains — the fleet-wide generalization of the router's
        # pin/release refcounting.
        self._src_pins: dict[tuple[str, int], set[str]] = {}
        self._outstanding: dict[str, int] = {h: 0 for h in self._order}
        self._live: list[FleetHandle] = []
        self._ids = itertools.count()
        self.swap_log: list[tuple[str, str, int]] = []  # (phase, host, v)
        self._m_requests = self._metrics.counter(
            "fleet_requests_total", "Requests routed, by tenant and host.")
        self._m_reroutes = self._metrics.counter(
            "fleet_reroutes_total",
            "Requests re-submitted on a surviving host after their host "
            "died mid-flight.")
        self._m_swaps = self._metrics.counter(
            "fleet_swaps_total", "Fleet-wide two-phase hot-swaps completed.")
        self._m_healthy = self._metrics.gauge(
            "fleet_healthy_hosts", "Replicas currently accepting routes.")
        self._m_lag = self._metrics.gauge(
            "fleet_replication_lag_versions",
            "Versions a host's mirror trails the source, by host and "
            "database.")
        self._m_outstanding = self._metrics.gauge(
            "fleet_outstanding_reads",
            "Reads admitted to a host and not yet completed, by host.")

    # -- topology ------------------------------------------------------------
    def hosts(self) -> tuple[HostReplica, ...]:
        return tuple(self._replicas[h] for h in self._order)

    def host(self, host_id: str) -> HostReplica:
        try:
            return self._replicas[host_id]
        except KeyError:
            raise KeyError(f"unknown host {host_id!r}; fleet has "
                           f"{self._order}") from None

    def healthy_hosts(self) -> tuple[str, ...]:
        with self._lock:
            return tuple(h for h in self._order
                         if self._replicas[h].state is HostState.HEALTHY)

    def add_tenant(self, tenant: str, database: str, *,
                   max_active: int = 4, max_queue: int = 16) -> None:
        """Register a tenant on every non-down host (replicating the
        database first); quotas apply per host."""
        with self._lock:
            if tenant in self._tenants:
                raise ValueError(f"tenant {tenant!r} already registered")
            self._tenants[tenant] = {
                "database": database, "max_active": max_active,
                "max_queue": max_queue}
        for hid in self._order:
            replica = self._replicas[hid]
            if replica.state is HostState.DOWN:
                continue
            v = replica.add_tenant(tenant, database,
                                   max_active=max_active,
                                   max_queue=max_queue)
            with self._lock:
                self._targets.setdefault(database, v)
                self._pin_source_locked(database, v, hid)

    # -- routing -------------------------------------------------------------
    def submit(self, reads, *, tenant: str,
               request_id: str | None = None) -> FleetHandle:
        """Route one request: tenant-affinity home, least-outstanding
        load tiebreak, next-best host on per-host quota overflow."""
        src = as_source(reads)
        with self._lock:
            try:
                database = self._tenants[tenant]["database"]
            except KeyError:
                raise KeyError(
                    f"unknown tenant {tenant!r}; registered: "
                    f"{sorted(self._tenants)}") from None
            candidates = self._route_order_locked(tenant)
            if not candidates:
                raise NoHealthyHosts(
                    f"no healthy host to route tenant {tenant!r}")
            est = self._est_reads(src)
            rid = request_id or f"{tenant}-f{next(self._ids)}"
            last_err: BaseException | None = None
            for hid in candidates:
                try:
                    routed = self._replicas[hid].submit(
                        src, tenant=tenant, request_id=rid)
                except ServiceOverloaded as e:
                    last_err = e          # quota full HERE; try the next
                    continue
                fh = FleetHandle(self, rid, tenant, database, src, est)
                fh._attempts.append((hid, routed))
                self._outstanding[hid] += est
                self._live.append(fh)
                self._m_requests.inc(1, tenant=tenant, host=hid)
                return fh
            raise last_err if last_err is not None else NoHealthyHosts(
                f"no healthy host accepted tenant {tenant!r}")

    def _route_order_locked(self, tenant: str) -> list[str]:
        """Healthy hosts, best first: least outstanding reads, ring
        distance from the tenant's crc32 affinity home as tiebreak."""
        healthy = [h for h in self._order
                   if self._replicas[h].state is HostState.HEALTHY]
        if not healthy:
            return []
        n = len(self._order)
        home = zlib.crc32(tenant.encode()) % n
        index = {h: i for i, h in enumerate(self._order)}

        def key(hid: str):
            return (self._outstanding.get(hid, 0),
                    (index[hid] - home) % n)

        return sorted(healthy, key=key)

    @staticmethod
    def _est_reads(src) -> int:
        try:
            return max(1, len(src))
        except TypeError:
            return 1

    # -- failover ------------------------------------------------------------
    def kill_host(self, host_id: str) -> list[str]:
        """Simulate a host death; returns the rerouted request ids.

        Order matters: every live request on the dying host is
        re-submitted on a surviving replica *first* (under the
        controller lock, so :meth:`FleetHandle.result` waiters always
        find the replacement attempt), then the dead router is stopped,
        cancelling its copies.  Non-replayable sources cannot be
        re-submitted: their handles fail with :class:`HostDown`.
        """
        replica = self.host(host_id)
        rerouted: list[str] = []
        with self._lock:
            if replica.state is HostState.DOWN:
                return rerouted
            replica.state = HostState.DOWN
            for fh in list(self._live):
                hid, routed = fh._attempts[-1]
                if hid != host_id:
                    continue
                if routed.state is RequestState.DONE:
                    continue              # report already complete
                self._outstanding[hid] = max(
                    0, self._outstanding[hid] - fh.est_reads)
                if isinstance(fh.source, IterableSource):
                    fh._error = HostDown(
                        f"host {host_id} died mid-flight and request "
                        f"{fh.request_id}'s source is not replayable")
                    continue
                targets = self._route_order_locked(fh.tenant)
                placed = False
                for nhid in targets:
                    try:
                        nr = self._replicas[nhid].submit(
                            fh.source, tenant=fh.tenant,
                            request_id=(f"{fh.request_id}"
                                        f"-r{len(fh._attempts)}"))
                    except ServiceOverloaded:
                        continue
                    fh._attempts.append((nhid, nr))
                    fh.rerouted = True
                    self._outstanding[nhid] += fh.est_reads
                    self._m_reroutes.inc(1, **{"from": host_id, "to": nhid})
                    rerouted.append(fh.request_id)
                    placed = True
                    break
                if not placed:
                    fh._error = NoHealthyHosts(
                        f"host {host_id} died and no healthy replica "
                        f"could take request {fh.request_id}")
            # The dead host's serving pins on the source are released:
            # its in-flight work is gone, nothing there drains.
            for (db, v), holders in list(self._src_pins.items()):
                self._release_source_locked(db, v, host_id)
        replica.kill()
        return rerouted

    def revive_host(self, host_id: str) -> None:
        """Bring a DOWN host back into rotation: restart its pump,
        resync every database (resumable — versions the source gc'd
        while it was down are simply skipped), and flip it to the
        fleet's serving version."""
        replica = self.host(host_id)
        if replica.state is not HostState.DOWN:
            return
        replica.revive()
        with self._lock:
            targets = dict(self._targets)
            tenants = dict(self._tenants)
        for tenant, spec in tenants.items():
            if tenant not in {s.tenant for s in replica.router.tenants()}:
                replica.add_tenant(tenant, spec["database"],
                                   max_active=spec["max_active"],
                                   max_queue=spec["max_queue"])
        for db, target in targets.items():
            replica.sync(db)
            if replica.router.serving_version(db) != target:
                replica.prepare(db, target)
                replica.flip(db, target)
            with self._lock:
                self._pin_source_locked(db, target, host_id)

    # -- the fleet-wide two-phase swap ---------------------------------------
    def fleet_swap(self, database: str, *, version: int | None = None,
                   on_phase: Callable[[str], None] | None = None) -> int:
        """Swap every host to ``version`` (default: source current).

        Phase 1 *prepare*: every non-down host installs + pins the new
        version locally; no admissions see it yet — the invariant tests
        assert through ``on_phase("prepared")``.  Phase 2 *flip*: every
        router repoints atomically.  Retire is asynchronous: each host's
        source pin on the old version is released by
        :meth:`poll_retire` once that host reports drained, and only
        when every host has does the old version become gc-eligible at
        the source."""
        snap = (self.source.current(database) if version is None
                else self.source.snapshot(database, version))
        new_v = snap.version
        with self._lock:
            hosts = [h for h in self._order
                     if self._replicas[h].state is not HostState.DOWN]
        for hid in hosts:                             # phase 1: prepare
            self._replicas[hid].prepare(database, new_v)
            with self._lock:
                self._pin_source_locked(database, new_v, hid)
                self.swap_log.append(("prepare", hid, new_v))
        if on_phase is not None:
            on_phase("prepared")
        for hid in hosts:                             # phase 2: flip
            self._replicas[hid].flip(database, new_v)
            with self._lock:
                self.swap_log.append(("flip", hid, new_v))
        if on_phase is not None:
            on_phase("flipped")
        with self._lock:
            self._targets[database] = new_v
        self._m_swaps.inc(1, database=database)
        return new_v

    def poll_retire(self) -> list[tuple[str, int, str]]:
        """Release source pins for old versions hosts have drained;
        returns the (database, version, host) pins released.  When the
        last host's pin goes, the old version is gc-eligible at the
        source (subject to its own keep_last policy)."""
        released: list[tuple[str, int, str]] = []
        with self._lock:
            items = [(db, v, set(hs))
                     for (db, v), hs in self._src_pins.items()
                     if v != self._targets.get(db)]
        for db, v, holders in items:
            for hid in holders:
                if self._replicas[hid].drained(db, v):
                    with self._lock:
                        if self._release_source_locked(db, v, hid):
                            released.append((db, v, hid))
        return released

    def wait_retired(self, database: str, version: int,
                     timeout: float = 60.0) -> None:
        """Block until every host's pin on (database, version) is gone."""
        deadline = time.monotonic() + timeout
        while True:
            self.poll_retire()
            with self._lock:
                if (database, version) not in self._src_pins:
                    return
                holders = sorted(self._src_pins[(database, version)])
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"{database} v{version} still pinned by {holders} "
                    f"after {timeout}s")
            time.sleep(0.005)

    def _pin_source_locked(self, db: str, version: int, hid: str) -> None:
        holders = self._src_pins.setdefault((db, version), set())
        if hid not in holders:
            self.source.pin(db, version)
            holders.add(hid)

    def _release_source_locked(self, db: str, version: int,
                               hid: str) -> bool:
        holders = self._src_pins.get((db, version))
        if holders is None or hid not in holders:
            return False
        self.source.release(db, version)
        holders.discard(hid)
        if not holders:
            del self._src_pins[(db, version)]
        return True

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "FleetController":
        for replica in self.hosts():
            if replica.state is not HostState.DOWN:
                replica.start()
        return self

    def stop(self, *, drain: bool = True) -> None:
        for replica in self.hosts():
            if replica.state is not HostState.DOWN:
                replica.stop(drain=drain)

    def __enter__(self) -> "FleetController":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop(drain=exc == (None, None, None))

    def close(self) -> None:
        """Full teardown: stop every replica and release all the source
        pins this fleet holds (the fleet's versions become gc-eligible
        at the source).  A stopped-but-not-closed fleet can be
        restarted; a closed one is done."""
        self.stop(drain=True)
        with self._lock:
            for (db, v), holders in list(self._src_pins.items()):
                for hid in list(holders):
                    self._release_source_locked(db, v, hid)

    def run_until_idle(self, timeout: float = 600.0) -> None:
        """Block until every live fleet request reached a terminal
        attempt (the replicas' own workers do the pumping)."""
        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                live = [fh for fh in self._live
                        if fh._error is None
                        and not fh._attempts[-1][1].done]
            if not live:
                return
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"{len(live)} fleet request(s) still live after "
                    f"{timeout}s")
            time.sleep(0.005)

    # -- fleet observability -------------------------------------------------
    def metrics_snapshot(self) -> obs.MetricsRegistry:
        """One merged registry: every replica's series labelled
        ``host=<id>``, plus the controller's fleet-level series."""
        with self._lock:
            healthy = sum(r.state is HostState.HEALTHY
                          for r in self._replicas.values())
            self._m_healthy.set(healthy)
            for hid in self._order:
                self._m_outstanding.set(self._outstanding.get(hid, 0),
                                        host=hid)
                replica = self._replicas[hid]
                for db in self.source.databases():
                    self._m_lag.set(replica.lag(db), host=hid, database=db)
        merged = obs.MetricsRegistry.merged(
            {hid: self._replicas[hid].metrics for hid in self._order})
        merged.merge_from(self._metrics)
        return merged
