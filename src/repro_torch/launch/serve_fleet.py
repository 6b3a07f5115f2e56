"""Fleet serving CLI on PyTorch/CUDA: multi-host failover + fleet swap.

    python -m repro_torch.launch.serve_fleet --smoke --check
    python -m repro_torch.launch.serve_fleet --hosts 3 --tenants 2 \
        --kill-host 1 --swap-at 8 --check --backend cuda_fused
    python -m repro_torch.launch.serve_fleet --hosts 4 --requests 8 \
        --metrics-json fleet_metrics.json

Counterpart of :mod:`repro.launch.serve_fleet`, with the same flags,
output lines and ``--metrics-json`` document, plus ``--device`` (default
``cuda``; without a GPU the run is a CLI error unless ``--device cpu``).
Every host of the fleet lives in this process on that device.

Builds one source-of-truth
:class:`~repro_torch.serve.registry.RefDBRegistry` database, spins up a
:class:`~repro_torch.serve.fleet.FleetController` with ``--hosts``
simulated host replicas (each its own mirror registry + tenant router +
metrics registry), and drives multi-tenant traffic through the fleet.
Mid-run it can

* **kill a host** (``--kill-host K``; ``-1`` picks the host with the
  most in-flight requests): every affected request is re-submitted on a
  surviving replica, and with ``--check`` each rerouted report is
  verified bit-identical to a sequential run — the determinism argument
  that makes fleet failover safe;
* **fleet-swap** (``--swap-at T``: after the T-th submission an
  add-species delta publishes and the fleet runs its two-phase swap) —
  prepare pins the new version on every host before any router flips,
  and the old version's source pins are only released after every host
  drains (asserted here: the CLI waits for retire, then shows the
  source registry's pin table).

``--metrics-json`` writes the merged fleet snapshot — every per-host
series carries a ``host`` label, alongside the controller's fleet
gauges.  ``--smoke`` shrinks everything to CI size (implies ``--check``,
an auto kill, and a mid-run swap).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np
import torch

from repro_torch.core.hd_space import HDSpace
from repro_torch.device import resolve_device
from repro_torch.genomics import synth
from repro_torch.pipeline import (ArraySource, ProfilerConfig,
                                  ProfilingSession, available_backends)
from repro_torch.serve import FleetController, RefDBRegistry
from repro_torch.serve.fleet import HostState


def _percentile(xs: list[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) if xs else float("nan")


def drive(*, config: ProfilerConfig, num_species: int, genome_len: int,
          hosts: int, tenants: int, requests_per_tenant: int,
          reads_per_request: int, workers_per_host: int = 1,
          kill_host: int | None = None, swap_at: int | None = None,
          check: bool = False, metrics_json: str | None = None,
          device: str | torch.device | None = None) -> dict:
    """Run the fleet experiment on ``device`` (``None``: ``cuda``);
    returns the summary dict."""
    spec = synth.CommunitySpec(num_species=num_species,
                               genome_len=genome_len, seed=7)
    total = tenants * requests_per_tenant
    genomes, toks, lens, _, _ = synth.make_sample(
        spec, num_reads=total * reads_per_request)
    rng = np.random.default_rng(spec.seed + 1)
    delta_genomes = {"sp_delta": rng.integers(0, 4, genome_len,
                                              dtype=np.int32)}

    source_reg = RefDBRegistry(root=None, device=device)
    t0 = time.perf_counter()
    source_reg.create("food", genomes, config)
    print(f"backend {config.backend} | RefDB food:v1 build "
          f"{time.perf_counter() - t0:.2f}s | fleet of {hosts} host(s), "
          f"{tenants} tenant(s) x {requests_per_tenant} requests")

    fleet = FleetController(source_reg, hosts=hosts,
                            workers_per_host=workers_per_host)
    names = [f"tenant{i}" for i in range(tenants)]
    for name in names:
        fleet.add_tenant(name, "food", max_active=2, max_queue=total)

    sources = [ArraySource(toks[i::total], lens[i::total])
               for i in range(total)]
    handles = []
    killed = rerouted = None
    swap_versions: tuple[int, int] | None = None
    t0 = time.perf_counter()
    with fleet:
        kill_at = total // 3 if kill_host is not None else None
        for i, src in enumerate(sources):
            if kill_at is not None and i == kill_at:
                killed = _pick_victim(fleet, handles, kill_host)
                rerouted = fleet.kill_host(killed)
                print(f"killed {killed} after {i} submissions; "
                      f"rerouted {len(rerouted)} request(s): "
                      f"{' '.join(rerouted) or '(none in flight)'}")
            if swap_at is not None and i == swap_at:
                old_v = source_reg.current("food").version
                snap = source_reg.apply_delta("food", add=delta_genomes)
                new_v = fleet.fleet_swap("food", version=snap.version)
                swap_versions = (old_v, new_v)
                print(f"fleet swap v{old_v} -> v{new_v} after {i} "
                      f"submissions ({2 * len(fleet.healthy_hosts())} "
                      f"phase steps)")
            handles.append(fleet.submit(src, tenant=names[i % tenants],
                                        request_id=f"req-{i}"))
        reports = [h.result(timeout=600) for h in handles]
        if swap_versions is not None:
            fleet.wait_retired("food", swap_versions[0], timeout=600)
            print(f"retire complete: source pins now "
                  f"{source_reg.pins('food')} (old v{swap_versions[0]} "
                  f"gc-eligible)")
        if metrics_json is not None:
            merged = fleet.metrics_snapshot()
            payload = {"schema": 1, "hosts": hosts,
                       "metrics": merged.snapshot()}
            path = pathlib.Path(metrics_json)
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(json.dumps(payload, indent=2, sort_keys=True))
            print(f"wrote merged fleet metrics snapshot to {path}")
    wall = time.perf_counter() - t0

    lat = [h._attempts[-1][1].latency_s for h in handles]
    total_reads = sum(r.total_reads for r in reports)
    by_host: dict[str, int] = {}
    for h in handles:
        by_host[h.host] = by_host.get(h.host, 0) + 1
    summary = {
        "backend": config.backend,
        "hosts": hosts,
        "tenants": tenants,
        "requests": total,
        "reads": total_reads,
        "wall_s": wall,
        "reads_per_s": total_reads / max(wall, 1e-9),
        "p50_ms": _percentile(lat, 50) * 1e3,
        "p99_ms": _percentile(lat, 99) * 1e3,
        "by_host": dict(sorted(by_host.items())),
        "killed": killed,
        "rerouted": rerouted or [],
        "swap": swap_versions,
    }
    print(f"fleet: {total} requests ({total_reads} reads) in {wall:.2f}s | "
          f"{summary['reads_per_s']:.0f} reads/s aggregate | "
          f"p50 {summary['p50_ms']:.0f}ms p99 {summary['p99_ms']:.0f}ms | "
          f"placement {summary['by_host']}")

    if check:
        sessions: dict[int, ProfilingSession] = {}

        def sequential(version: int) -> ProfilingSession:
            if version not in sessions:
                s = ProfilingSession(config, device=source_reg.device)
                s.adopt_refdb(source_reg.snapshot("food", version).db)
                sessions[version] = s
            return sessions[version]

        failing = []
        for h, src, rep in zip(handles, sources, reports):
            if rep.to_json() != sequential(h.version).profile(src).to_json():
                failing.append(h.request_id)
        if failing:
            print(f"CHECK FAILED: {len(failing)} report(s) diverged from "
                  f"sequential runs: {' '.join(failing)}", file=sys.stderr)
            raise SystemExit(1)
        n_re = sum(h.rerouted for h in handles)
        print(f"check OK: all {total} reports bit-identical to sequential "
              f"runs on their admitted versions ({n_re} rerouted)")
    return summary


def _pick_victim(fleet: FleetController, handles, kill_host: int) -> str:
    """The host to kill: an explicit index, or (``-1``) the healthy host
    carrying the most live requests — guaranteeing the kill actually
    hits in-flight work."""
    if kill_host >= 0:
        return f"host{kill_host}"
    live: dict[str, int] = {}
    for h in handles:
        if not h.done:
            live[h.host] = live.get(h.host, 0) + 1
    healthy = [hid for hid in live
               if fleet.host(hid).state is HostState.HEALTHY]
    if healthy:
        return max(healthy, key=lambda hid: live[hid])
    return fleet.healthy_hosts()[0]


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--hosts", type=int, default=3)
    ap.add_argument("--tenants", type=int, default=2)
    ap.add_argument("--requests", type=int, default=8,
                    help="requests per tenant")
    ap.add_argument("--reads-per-request", type=int, default=256)
    ap.add_argument("--workers", type=int, default=1,
                    help="pump threads per host")
    ap.add_argument("--kill-host", type=int, default=None, metavar="K",
                    help="kill hostK a third of the way through the"
                         " submissions (-1: auto-pick the busiest host);"
                         " affected requests fail over to survivors")
    ap.add_argument("--swap-at", type=int, default=None, metavar="T",
                    help="publish an add-species delta and run the"
                         " two-phase fleet swap after the T-th submission")
    ap.add_argument("--dim", type=int, default=4096)
    ap.add_argument("--ngram", type=int, default=16)
    ap.add_argument("--window", type=int, default=4096)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--species", type=int, default=8)
    ap.add_argument("--genome-len", type=int, default=40_000)
    ap.add_argument("--backend", default="reference",
                    choices=available_backends())
    ap.add_argument("--device", default="cuda",
                    help="torch device of every host (default cuda; cpu"
                         " runs the plain torch path on the host)")
    ap.add_argument("--check", action="store_true",
                    help="verify every report (rerouted ones included)"
                         " bit-identical to a sequential run on its"
                         " admitted database version")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="write the merged fleet metrics snapshot"
                         " (per-host labelled series + fleet gauges) here")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny CI-sized run: 3 hosts x 2 tenants, one"
                         " auto-picked host kill, one fleet swap,"
                         " --check on")
    args = ap.parse_args(argv)
    try:    # a missing GPU is a CLI error, not a traceback
        resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))

    if args.smoke:
        config = ProfilerConfig(
            space=HDSpace(dim=512, ngram=8, z_threshold=3.0),
            window=1024, batch_size=32, backend=args.backend)
        drive(config=config, num_species=4, genome_len=8_000,
              hosts=3, tenants=2, requests_per_tenant=6,
              reads_per_request=32, workers_per_host=args.workers,
              kill_host=-1, swap_at=8, check=True,
              metrics_json=args.metrics_json, device=args.device)
        return
    config = ProfilerConfig(
        space=HDSpace(dim=args.dim, ngram=args.ngram),
        window=args.window, batch_size=args.batch_size,
        backend=args.backend)
    drive(config=config, num_species=args.species,
          genome_len=args.genome_len, hosts=args.hosts,
          tenants=args.tenants, requests_per_tenant=args.requests,
          reads_per_request=args.reads_per_request,
          workers_per_host=args.workers, kill_host=args.kill_host,
          swap_at=args.swap_at, check=args.check,
          metrics_json=args.metrics_json, device=args.device)


if __name__ == "__main__":
    main()
