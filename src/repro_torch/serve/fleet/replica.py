"""`HostReplica`: one simulated host of the serving fleet.

Counterpart of :mod:`repro.serve.fleet.replica`.  A replica is a full copy
of the single-host serving stack — its own in-memory
:class:`~repro_torch.serve.registry.RefDBRegistry` mirror on the host's
device, its own :class:`~repro_torch.serve.router.TenantRouter` with
``auto_swap=False`` (the
fleet controller, not the source registry, decides when a host flips
versions — the two-phase swap invariant depends on it), and its own
:class:`~repro_torch.obs.metrics.MetricsRegistry` so fleet observability
can fold per-host registries into one labelled snapshot.

The fleet's hosts live in one process.  Each takes an explicit device:
on a card they all use ``cuda`` (one card, one default stream, launches
from every host's pumps serialized on it); ``device="cpu"`` runs the
kernels' plain versions, for the tests.

Replication is **pull-based**: :meth:`sync` installs every version the
source registry retains that the mirror is missing, sharing the
immutable ``RefDB`` objects, or copying them when the host's device is
not the source's (no re-encode — see :meth:`RefDBRegistry.install`).  A host that was down across publishes
simply resyncs on revive and the mirror chain skips the versions the
source has since garbage-collected — replication is resumable by
construction.

Health is a three-state machine the controller drives:

  HEALTHY   routed new requests; pumping.
  DRAINING  no new requests; pumping until in-flight work completes.
  DOWN      killed: pump stopped, in-flight requests cancelled (the
            controller reroutes them to surviving replicas).
"""

from __future__ import annotations

import enum
import threading

import torch

from repro_torch import obs
from repro_torch.serve.registry import RefDBRegistry
from repro_torch.serve.router import RoutedHandle, TenantRouter


class HostState(enum.Enum):
    HEALTHY = "healthy"
    DRAINING = "draining"
    DOWN = "down"


class HostDown(RuntimeError):
    """The request's host died and the fleet could not recover it
    (non-replayable source, or no healthy replica left to retry on)."""


class HostReplica:
    """One fleet host: mirror registry + router + per-host metrics."""

    def __init__(self, host_id: str, source: RefDBRegistry, *,
                 device: str | torch.device | None = None,
                 backend: str | None = None, batch_size: int | None = None,
                 backend_options: dict | None = None, workers: int = 1,
                 service_active: int = 8, service_queue: int = 256,
                 buckets=None, metrics: obs.MetricsRegistry | None = None):
        """Args:
          host_id: stable fleet-unique name (becomes the ``host`` label
            on every metric this replica records).
          source: the source-of-truth registry versions are pulled from.
          device: where this host's mirror keeps its databases and its
            router runs its backends; ``None`` means the source's device.
          backend / batch_size / backend_options: execution overrides
            for this host's router (content fields stay pinned by the
            source config, exactly as on a single host).
          workers: pump threads :meth:`start` launches.
          metrics: this host's metrics registry (default: a fresh real
            one — fleet snapshots are built by merging these).
        """
        self.host_id = host_id
        self.source = source
        self.metrics = metrics if metrics is not None \
            else obs.MetricsRegistry()
        self.registry = RefDBRegistry(
            root=None, device=source.device if device is None else device,
            metrics=self.metrics)
        self.router = TenantRouter(
            self.registry, backend=backend, batch_size=batch_size,
            backend_options=backend_options, buckets=buckets,
            service_active=service_active, service_queue=service_queue,
            auto_swap=False, metrics=self.metrics)
        self.state = HostState.HEALTHY
        self.workers = workers
        self._lock = threading.Lock()

    # -- replication ---------------------------------------------------------
    def sync(self, database: str) -> int:
        """Pull every missing retained version of ``database`` from the
        source into the mirror; returns how many were installed.

        Shares the source's immutable ``RefDB`` objects and keeps source
        version numbers, so "version 3" means the same thing on every
        host.  Safe to call repeatedly (installs are idempotent) and
        after any amount of downtime (gaps are fine)."""
        config = self.source.config(database)
        installed = 0
        have = set(self.registry.versions(database)) \
            if database in self.registry.databases() else set()
        for version in self.source.versions(database):
            if version in have:
                continue
            snap = self.source.snapshot(database, version)
            self.registry.install(database, snap, config=config)
            installed += 1
        return installed

    def lag(self, database: str) -> int:
        """Replication lag in versions behind the source's current."""
        src = self.source.current(database).version
        try:
            mine = self.registry.current(database).version
        except KeyError:
            mine = 0
        return max(0, src - mine)

    # -- serving -------------------------------------------------------------
    def add_tenant(self, tenant: str, database: str, *,
                   max_active: int = 4, max_queue: int = 16) -> int:
        """Register a tenant on this host (syncs the database first);
        returns the version this host now serves for it."""
        self.sync(database)
        self.router.add_tenant(tenant, database, max_active=max_active,
                               max_queue=max_queue)
        return self.router.serving_version(database)

    def submit(self, source, *, tenant: str,
               request_id: str | None = None) -> RoutedHandle:
        if self.state is not HostState.HEALTHY:
            raise HostDown(f"host {self.host_id} is {self.state.value}; "
                           f"not accepting new requests")
        return self.router.submit(source, tenant=tenant,
                                  request_id=request_id)

    # -- the two-phase swap, host side --------------------------------------
    def prepare(self, database: str, version: int) -> None:
        """Phase 1: open + pin ``version`` locally without serving it.

        After this returns the snapshot is resident in the mirror and
        pinned there, so nothing local can collect it before the flip —
        but admissions still route to the old version."""
        self.sync(database)
        self.registry.snapshot(database, version)    # loud if absent
        self.registry.pin(database, version)

    def flip(self, database: str, version: int) -> int:
        """Phase 2: atomically repoint new admissions at ``version``.

        The router takes its own serving pin; the prepare pin is
        released here so pin counts stay balanced."""
        served = self.router.hot_swap(database, version=version)
        self.registry.release(database, version)
        return served

    def drained(self, database: str, version: int) -> bool:
        """True once ``version`` neither serves nor drains here — the
        host-side signal the fleet retire phase waits for."""
        if self.state is HostState.DOWN:
            return True        # cancelled work never completes a drain
        return (self.router.serving_version(database) != version
                and version not in self.router.draining_versions(database))

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "HostReplica":
        with self._lock:
            self.state = HostState.HEALTHY
            if not self.router.running:
                self.router.start(self.workers)
        return self

    def stop(self, *, drain: bool = True) -> None:
        self.router.stop(drain=drain)

    def drain(self) -> None:
        """Stop receiving new routes; in-flight work keeps pumping."""
        with self._lock:
            if self.state is HostState.HEALTHY:
                self.state = HostState.DRAINING

    def kill(self) -> None:
        """Simulate host death: cancel in-flight work, stop the pump.

        The controller reroutes the cancelled requests to surviving
        replicas (safe because reports are deterministic).  Idempotent —
        the controller marks the state DOWN first (so routing excludes
        the host while reroutes are placed) and then calls this."""
        with self._lock:
            self.state = HostState.DOWN
        self.router.stop(drain=False)

    def revive(self) -> None:
        """Bring a DOWN host back: restart the pump (the controller
        resyncs databases and re-flips to the fleet's serving version)."""
        with self._lock:
            if self.state is not HostState.DOWN:
                return
            self.state = HostState.HEALTHY
        if not self.router.running:
            self.router.start(self.workers)

    def __repr__(self) -> str:
        return (f"HostReplica({self.host_id!r}, state={self.state.value}, "
                f"databases={list(self.registry.databases())})")
