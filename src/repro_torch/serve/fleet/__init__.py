"""Multi-host fleet serving: replicated hosts behind one controller.

Counterpart of :mod:`repro.serve.fleet`, with every host in one process
on one device (the card, or the CPU for the tests).

Each :class:`HostReplica` is a complete copy of the single-host stack
(mirror registry + tenant router + per-host metrics); the
:class:`FleetController` replicates database versions to every host,
routes by tenant affinity + least-outstanding-reads, fails requests
over to surviving replicas when a host dies mid-flight (bit-exactly —
reports are deterministic), and hot-swaps the whole fleet in two phases
with source-registry pins guaranteeing the old version only becomes
gc-eligible after every host drained (``repro``'s ``docs/FLEET.md``
describes the design).
"""

from repro_torch.serve.fleet.controller import (FleetController,
                                                FleetHandle, NoHealthyHosts)
from repro_torch.serve.fleet.replica import HostDown, HostReplica, HostState

__all__ = [
    "FleetController", "FleetHandle", "NoHealthyHosts",
    "HostDown", "HostReplica", "HostState",
]
