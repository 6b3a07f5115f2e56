"""Profiler serving CLI on PyTorch/CUDA: request-rate / latency harness.

    python -m repro_torch.launch.serve_profiler --requests 16 --rate 20
    python -m repro_torch.launch.serve_profiler --smoke --backend cuda_fused
    python -m repro_torch.launch.serve_profiler --smoke --tenants 2
    python -m repro_torch.launch.serve_profiler --tenants 4 --workers 2 \
        --rate 20,10,10,5 --check

Counterpart of :mod:`repro.launch.serve_profiler`, with the same flags,
output lines, ``--check`` and ``--json``, plus ``--device`` (default
``cuda``; without a GPU the run is a CLI error unless ``--device cpu``),
and ``--torch-profile DIR`` in place of ``--jax-profile``.

Single-tenant mode (the default) builds one shared RefDB from a
synthetic food community, starts a
:class:`~repro_torch.serve.profiler_service.ProfilingService` with a
background worker, submits many concurrent profiling requests at a
target rate (each request a disjoint slice of sample reads), and
reports sustained throughput plus p50/p99 request latency.

``--tenants N`` switches to fleet mode: a
:class:`~repro_torch.serve.registry.RefDBRegistry` owns the database, a
:class:`~repro_torch.serve.router.TenantRouter` with ``--workers`` pump
threads serves N tenants at per-tenant arrival rates (``--rate`` takes
a comma list), and **mid-traffic an add-species delta is published** --
the router hot-swaps with zero downtime, so requests admitted before
the swap complete against the old version and later admissions see the
new one.  The report covers fleet and per-tenant p50/p99 plus the
versions each tenant's requests ran against.

With ``--check`` each per-request report is verified bit-identical to a
sequential ``ProfilingSession.profile()`` run of the same reads on the
exact database version that admitted it.  On any mismatch the run
prints the failing request ids and exits non-zero.

``--smoke`` shrinks everything (and implies ``--check``) so the full
submit/interleave/stream/finalize(/swap) cycle runs in seconds.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.hd_space import HDSpace
from repro_torch.device import resolve_device
from repro_torch.genomics import synth
from repro_torch.pipeline import (ArraySource, ProfilerConfig,
                                  ProfilingSession, available_backends)
from repro_torch.serve import ProfilingService, RefDBRegistry, TenantRouter


def _percentile(xs: list[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) if xs else float("nan")


def _report_check_failures(failing_ids: list[str]) -> None:
    """Per the serving contract: a --check mismatch is a hard failure."""
    print(f"CHECK FAILED: {len(failing_ids)} request(s) diverged from "
          f"their sequential runs: {' '.join(failing_ids)}", file=sys.stderr)
    raise SystemExit(1)


def drive(*, config: ProfilerConfig, num_species: int, genome_len: int,
          num_requests: int, reads_per_request: int, rate_hz: float,
          max_active: int = 8, check: bool = False,
          json_dir: str | None = None,
          device: str | torch.device | None = None) -> dict:
    """Run the rate-driven serving experiment; returns the summary dict."""
    spec = synth.CommunitySpec(num_species=num_species,
                               genome_len=genome_len, seed=7)
    genomes, toks, lens, _, _ = synth.make_sample(
        spec, num_reads=num_requests * reads_per_request)

    session = ProfilingSession(config, device=device)
    t0 = time.perf_counter()
    session.build_refdb(genomes)
    t_build = time.perf_counter() - t0
    print(f"backend {config.backend} | RefDB build {t_build:.2f}s "
          f"({session.refdb.num_prototypes} prototypes, shared by "
          f"{num_requests} requests)")

    # Each request profiles its own disjoint slice of the sample.
    sources = [ArraySource(toks[i::num_requests], lens[i::num_requests])
               for i in range(num_requests)]

    service = ProfilingService(session, max_active=max_active,
                               max_queue=max(num_requests, 1))
    handles = []
    t0 = time.perf_counter()
    with service:
        for i, src in enumerate(sources):
            if rate_hz > 0 and i:
                # open-loop arrivals: steady 1/rate spacing from t0
                time.sleep(max(0.0, t0 + i / rate_hz - time.perf_counter()))
            handles.append(service.submit(src, request_id=f"req-{i}"))
        reports = [h.result(timeout=600) for h in handles]
    wall = time.perf_counter() - t0

    lat = [h.latency_s for h in handles]
    total_reads = sum(r.total_reads for r in reports)
    summary = {
        "backend": config.backend,
        "requests": num_requests,
        "reads": total_reads,
        "wall_s": wall,
        "reads_per_s": total_reads / max(wall, 1e-9),
        "p50_ms": _percentile(lat, 50) * 1e3,
        "p99_ms": _percentile(lat, 99) * 1e3,
        "cohorts": service.cohorts_run,
    }
    print(f"{num_requests} requests x {reads_per_request} reads in "
          f"{wall:.2f}s | {summary['reads_per_s']:.0f} reads/s | "
          f"latency p50 {summary['p50_ms']:.0f}ms "
          f"p99 {summary['p99_ms']:.0f}ms | {service.cohorts_run} cohorts")

    if json_dir is not None:
        out = pathlib.Path(json_dir)
        out.mkdir(parents=True, exist_ok=True)
        for h, rep in zip(handles, reports):
            (out / f"{h.request_id}.json").write_text(rep.to_json(indent=2))
        print(f"wrote {len(reports)} report snapshots to {out}/")

    if check:
        failing = []
        for h, src, rep in zip(handles, sources, reports):
            if rep.to_json() != session.profile(src).to_json():
                failing.append(h.request_id)
        if failing:
            _report_check_failures(failing)
        print(f"check OK: all {num_requests} reports bit-identical to "
              f"sequential ProfilingSession.profile() runs")
    return summary


def drive_fleet(*, config: ProfilerConfig, num_species: int, genome_len: int,
                tenants: int, requests_per_tenant: int,
                reads_per_request: int, rates_hz: list[float],
                workers: int = 1, max_active: int = 4, max_queue: int = 16,
                check: bool = False, store: str | None = None,
                json_dir: str | None = None,
                gate_last_on_delta: bool = False,
                gc_keep_last: int | None = None,
                device: str | torch.device | None = None) -> dict:
    """Multi-tenant fleet experiment with a mid-traffic delta hot-swap.

    ``gate_last_on_delta`` holds each tenant's final request until the
    delta is published, guaranteeing the run exercises admissions on
    both sides of the swap (the CI smoke asserts this).

    ``gc_keep_last`` runs a post-drain registry sweep keeping that many
    newest versions -- previewed with ``dry_run=True`` first (the safe
    operator flow), then applied for real; both land in the summary.
    """
    spec = synth.CommunitySpec(num_species=num_species,
                               genome_len=genome_len, seed=7)
    total_requests = tenants * requests_per_tenant
    genomes, toks, lens, _, _ = synth.make_sample(
        spec, num_reads=total_requests * reads_per_request)
    # The mid-traffic update: one genuinely new species for the delta.
    rng = np.random.default_rng(spec.seed + 1)
    delta_genomes = {"sp_delta": rng.integers(0, 4, genome_len,
                                              dtype=np.int32)}

    root = store or tempfile.mkdtemp(prefix="refdb-registry-")
    registry = RefDBRegistry(root=root, device=device)
    t0 = time.perf_counter()
    registry.create("food", genomes, config)
    t_build = time.perf_counter() - t0
    print(f"backend {config.backend} | registry at {root} | "
          f"RefDB food:v1 build {t_build:.2f}s | "
          f"{tenants} tenants x {requests_per_tenant} requests")

    router = TenantRouter(registry)
    names = [f"tenant{i}" for i in range(tenants)]
    for name in names:
        router.add_tenant(name, database="food",
                          max_active=max_active, max_queue=max_queue)

    per_tenant = {
        name: [ArraySource(
            toks[(t * requests_per_tenant + i)::total_requests],
            lens[(t * requests_per_tenant + i)::total_requests])
            for i in range(requests_per_tenant)]
        for t, name in enumerate(names)}

    handles: dict[str, list] = {name: [] for name in names}
    submitted = threading.Semaphore(0)
    delta_published = threading.Event()
    errors: list[BaseException] = []

    def tenant_load(name: str, rate_hz: float) -> None:
        """Open-loop arrivals for one tenant (blocking on its quota)."""
        t0 = time.perf_counter()
        try:
            for i, src in enumerate(per_tenant[name]):
                if rate_hz > 0 and i:
                    time.sleep(max(0.0, t0 + i / rate_hz
                                   - time.perf_counter()))
                if gate_last_on_delta and i == requests_per_tenant - 1:
                    delta_published.wait(timeout=600)
                handles[name].append(router.submit(
                    src, tenant=name, block=True, timeout=600))
                submitted.release()
        except BaseException as e:          # surfaced after the join
            errors.append(e)

    loaders = [threading.Thread(target=tenant_load, args=(n, r), daemon=True)
               for n, r in zip(names, rates_hz)]
    t0 = time.perf_counter()
    router.start(workers)
    try:
        for t in loaders:
            t.start()
        # Publish the add-species delta once half the fleet's requests are
        # admitted: the router auto-swaps, in-flight work drains on v1.
        for _ in range(total_requests // 2):
            submitted.acquire()
        t_delta = time.perf_counter()
        snap2 = registry.apply_delta("food", add=delta_genomes)
        delta_published.set()
        print(f"published delta v{snap2.version} (+{snap2.delta['added']}) "
              f"at t={t_delta - t0:.2f}s; serving "
              f"v{router.serving_version('food')}")
        for t in loaders:
            t.join()
        reports = {name: [h.result(timeout=600) for h in hs]
                   for name, hs in handles.items()}
    finally:
        router.stop()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]

    all_handles = [h for hs in handles.values() for h in hs]
    lat = [h.latency_s for h in all_handles]
    total_reads = sum(r.total_reads for rs in reports.values() for r in rs)
    summary = {
        "backend": config.backend,
        "tenants": tenants,
        "workers": workers,
        "requests": total_requests,
        "reads": total_reads,
        "wall_s": wall,
        "reads_per_s": total_reads / max(wall, 1e-9),
        "p50_ms": _percentile(lat, 50) * 1e3,
        "p99_ms": _percentile(lat, 99) * 1e3,
        "swaps": router.swaps,
        "versions": sorted({h.version for h in all_handles}),
        "per_tenant": {},
    }
    print(f"fleet: {total_requests} requests ({total_reads} reads) in "
          f"{wall:.2f}s | {summary['reads_per_s']:.0f} reads/s | "
          f"p50 {summary['p50_ms']:.0f}ms p99 {summary['p99_ms']:.0f}ms | "
          f"{router.swaps} swap(s), versions {summary['versions']}")
    metrics = obs.metrics()
    for name, rate in zip(names, rates_hz):
        hs = handles[name]
        lat_t = [h.latency_s for h in hs]
        vs = sorted({h.version for h in hs})
        treads = sum(r.total_reads for r in reports[name])
        summary["per_tenant"][name] = {
            "rate_hz": rate,
            "reads": treads,
            "reads_per_s": treads / max(wall, 1e-9),
            "p50_ms": _percentile(lat_t, 50) * 1e3,
            "p99_ms": _percentile(lat_t, 99) * 1e3,
            "versions": vs,
        }
        if metrics.enabled:
            metrics.gauge(
                "tenant_reads_per_s",
                "Sustained reads/s per tenant over the drive window.",
            ).set(summary["per_tenant"][name]["reads_per_s"], tenant=name)
        print(f"  {name}: rate {rate:g}/s | "
              f"{summary['per_tenant'][name]['reads_per_s']:.0f} reads/s | "
              f"p50 {summary['per_tenant'][name]['p50_ms']:.0f}ms "
              f"p99 {summary['per_tenant'][name]['p99_ms']:.0f}ms | "
              f"versions {vs}")
    router.close()

    if json_dir is not None:
        out = pathlib.Path(json_dir)
        out.mkdir(parents=True, exist_ok=True)
        for hs, rs in ((handles[n], reports[n]) for n in names):
            for h, rep in zip(hs, rs):
                (out / f"{h.request_id}.json").write_text(
                    rep.to_json(indent=2))
        print(f"wrote {len(all_handles)} report snapshots to {out}/")

    if check:
        # Each report must be bit-identical to a sequential run on the
        # version that ADMITTED the request -- the zero-downtime contract.
        sessions: dict[int, ProfilingSession] = {}

        def sequential(version: int) -> ProfilingSession:
            if version not in sessions:
                s = ProfilingSession(config, device=device)
                s.adopt_refdb(registry.snapshot("food", version).db)
                sessions[version] = s
            return sessions[version]

        failing = []
        for name in names:
            for h, src, rep in zip(handles[name], per_tenant[name],
                                   reports[name]):
                want = sequential(h.version).profile(src)
                if rep.to_json() != want.to_json():
                    failing.append(h.request_id)
        if failing:
            _report_check_failures(failing)
        pre = sum(h.version == 1 for h in all_handles)
        if gate_last_on_delta and not 0 < pre < total_requests:
            print(f"CHECK FAILED: swap not exercised on both sides "
                  f"({pre}/{total_requests} requests on v1)",
                  file=sys.stderr)
            raise SystemExit(1)
        print(f"check OK: all {total_requests} reports bit-identical to "
              f"sequential runs on their admitted versions "
              f"({pre} on v1, {total_requests - pre} on v{snap2.version})")

    if gc_keep_last is not None:
        # Operator flow: dry-run preview first, then the real sweep --
        # identical victim sets by construction (nothing published in
        # between), asserted here so the preview stays trustworthy.
        # Runs last: --check still needs the old versions' snapshots.
        preview = registry.gc("food", keep_last=gc_keep_last, dry_run=True)
        print(f"gc preview (keep_last={gc_keep_last}): would collect "
              f"versions {[v for _, v in preview.collected]} "
              f"({preview.reclaimed_bytes} bytes)")
        swept = registry.gc("food", keep_last=gc_keep_last)
        assert swept.collected == preview.collected
        print(f"gc: collected versions {[v for _, v in swept.collected]} "
              f"({swept.reclaimed_bytes} bytes reclaimed)")
        summary["gc"] = {
            "keep_last": gc_keep_last,
            "collected": [list(c) for c in swept.collected],
            "reclaimed_bytes": swept.reclaimed_bytes,
        }
    return summary


def _parse_rates(raw: str, tenants: int) -> list[float]:
    rates = [float(r) for r in raw.split(",")]
    if len(rates) == 1:
        rates *= tenants
    if len(rates) != tenants:
        raise SystemExit(f"--rate gave {len(rates)} rates for "
                         f"{tenants} tenants")
    return rates


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=16,
                    help="requests (per tenant, with --tenants > 1)")
    ap.add_argument("--reads-per-request", type=int, default=512)
    ap.add_argument("--rate", default="0",
                    help="request arrival rate in req/s (0 = all at once);"
                         " with --tenants, a comma list gives per-tenant"
                         " rates")
    ap.add_argument("--tenants", type=int, nargs="?", const=2, default=1,
                    help="> 1 switches to the registry+router fleet mode"
                         " with a mid-traffic delta hot-swap (bare"
                         " --tenants means 2)")
    ap.add_argument("--workers", type=int, default=1,
                    help="router pump threads (fleet mode)")
    ap.add_argument("--max-active", type=int, default=8)
    ap.add_argument("--dim", type=int, default=4096)
    ap.add_argument("--ngram", type=int, default=16)
    ap.add_argument("--window", type=int, default=4096)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--species", type=int, default=8)
    ap.add_argument("--genome-len", type=int, default=40_000)
    ap.add_argument("--backend", default="reference",
                    choices=available_backends())
    ap.add_argument("--store", default=None, metavar="DIR",
                    help="registry root (fleet mode); default: a temp dir")
    ap.add_argument("--gc-keep-last", type=int, default=None, metavar="N",
                    help="after the drain, sweep the registry keeping the"
                         " N newest versions (dry-run preview first, then"
                         " the real collection; fleet mode only)")
    ap.add_argument("--check", action="store_true",
                    help="verify each report against a sequential run on"
                         " its admitted database version; exit non-zero"
                         " with the failing request ids on mismatch")
    ap.add_argument("--json", default=None, metavar="DIR",
                    help="write each request's ProfileReport JSON here")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="enable the observability layer and write the"
                         " metrics snapshot (+ sampled traces) here")
    ap.add_argument("--trace", type=int, default=0, metavar="N",
                    help="record spans for the first N requests"
                         " (admission -> schedule -> execute -> finalize);"
                         " implies metrics collection")
    ap.add_argument("--torch-profile", default=None, metavar="DIR",
                    help="capture a torch.profiler host + CUDA trace of"
                         " the serving window into DIR/trace.json")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu runs"
                         " the plain torch path on the host)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny CI-sized run (implies --check)")
    args = ap.parse_args(argv)
    try:    # a missing GPU is a CLI error, not a traceback
        resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))

    # Observability is opt-in: the globals flip before any session /
    # service / router is constructed, so every layer resolves them.
    reg = rec = None
    if args.metrics_json or args.trace:
        reg = obs.enable_metrics()
        if args.trace:
            rec = obs.enable_tracing(sample=args.trace)

    if args.smoke:
        config = ProfilerConfig(
            space=HDSpace(dim=512, ngram=8, z_threshold=3.0),
            window=1024, batch_size=32, backend=args.backend)
        with obs.torch_trace(args.torch_profile):
            if args.tenants > 1:
                summary = drive_fleet(
                    config=config, num_species=4, genome_len=8_000,
                    tenants=args.tenants, requests_per_tenant=6,
                    reads_per_request=32, rates_hz=[0.0] * args.tenants,
                    workers=args.workers, max_active=1, max_queue=1,
                    check=True, store=args.store, json_dir=args.json,
                    gate_last_on_delta=True,
                    gc_keep_last=args.gc_keep_last, device=args.device)
            else:
                summary = drive(
                    config=config, num_species=4, genome_len=8_000,
                    num_requests=8, reads_per_request=48, rate_hz=0.0,
                    max_active=4, check=True, json_dir=args.json,
                    device=args.device)
        _dump_observability(args, summary, reg, rec)
        return
    config = ProfilerConfig(
        space=HDSpace(dim=args.dim, ngram=args.ngram),
        window=args.window, batch_size=args.batch_size,
        backend=args.backend)
    with obs.torch_trace(args.torch_profile):
        if args.tenants > 1:
            summary = drive_fleet(
                config=config, num_species=args.species,
                genome_len=args.genome_len, tenants=args.tenants,
                requests_per_tenant=args.requests,
                reads_per_request=args.reads_per_request,
                rates_hz=_parse_rates(args.rate, args.tenants),
                workers=args.workers, max_active=args.max_active,
                check=args.check, store=args.store, json_dir=args.json,
                gc_keep_last=args.gc_keep_last, device=args.device)
        else:
            summary = drive(
                config=config, num_species=args.species,
                genome_len=args.genome_len, num_requests=args.requests,
                reads_per_request=args.reads_per_request,
                rate_hz=float(args.rate.split(",")[0]),
                max_active=args.max_active, check=args.check,
                json_dir=args.json, device=args.device)
    _dump_observability(args, summary, reg, rec)


def _dump_observability(args, summary: dict, reg, rec) -> None:
    """Write the run's metrics snapshot + sampled traces, if enabled."""
    if rec is not None:
        for t in rec.to_dicts():
            phases = " ".join(f"{s['name']} {s['duration_s'] * 1e3:.1f}ms"
                              for s in t["spans"][1:])
            print(f"trace {t['trace_id']} [{t['state']}] "
                  f"{t['duration_s'] * 1e3:.1f}ms: {phases}")
    if args.metrics_json is None:
        return
    payload = {"schema": 1, "run": summary, "metrics": reg.snapshot()}
    if rec is not None:
        payload["traces"] = rec.to_dicts()
    path = pathlib.Path(args.metrics_json)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(payload, indent=2, sort_keys=True))
    print(f"wrote metrics snapshot to {path}")


if __name__ == "__main__":
    main()
