"""Serving layer of the port: single-DB service and multi-tenant control plane.

Counterpart of :mod:`repro.serve` (without the legacy LM modules, which
are not ported yet).  :class:`ProfilingService` (:mod:`repro_torch.serve.profiler_service`)
is the data plane -- many concurrent requests over one RefDB, bit-exact
with sequential runs -- on top of the generic
:class:`FixedShapeScheduler` (:mod:`repro_torch.serve.scheduler`).  Above
it, :class:`RefDBRegistry` (:mod:`repro_torch.serve.registry`) owns named
databases with versioned, delta-updatable snapshots, and
:class:`TenantRouter` (:mod:`repro_torch.serve.router`) maps tenants to
databases with per-tenant quotas and zero-downtime hot-swap.
:class:`FleetController` (:mod:`repro_torch.serve.fleet`) runs several
such hosts in one process: version replication, tenant-affinity routing
by least outstanding reads, failover of a dead host's requests and the
two-phase fleet-wide swap.
"""

from repro_torch.serve.scheduler import (Cohort, FixedShapeScheduler,
                                         pow2_buckets)
from repro_torch.serve.profiler_service import (ProfileHandle,
                                                ProfileRequest,
                                                ProfilingService,
                                                RequestState,
                                                ServiceOverloaded)
from repro_torch.serve.registry import RefDBRegistry, RefDBSnapshot
from repro_torch.serve.router import (RoutedHandle, RouterClosed,
                                      TenantRouter, TenantSpec)
from repro_torch.serve.fleet import (FleetController, FleetHandle, HostDown,
                                     HostReplica, HostState, NoHealthyHosts)

__all__ = [
    "Cohort", "FixedShapeScheduler", "pow2_buckets",
    "ProfileHandle", "ProfileRequest", "ProfilingService", "RequestState",
    "ServiceOverloaded",
    "RefDBRegistry", "RefDBSnapshot",
    "RoutedHandle", "RouterClosed", "TenantRouter", "TenantSpec",
    "FleetController", "FleetHandle", "HostDown", "HostReplica",
    "HostState", "NoHealthyHosts",
]
