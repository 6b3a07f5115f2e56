#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --sweep    # also time other fused-kernel tilings

(``--shard-worker PATH`` is phase 9's two-rank child: the script starts it
itself, twice, with the rank in the environment.)

Phases (each prints its own lines; any failure exits non-zero and prints
no result line):

1. setup     the card's name and power limit; builds the CUDA kernels from
             ``src/repro_torch/csrc`` with nvcc (one process per source,
             all at once) and prints the build time.
2. parity    each kernel against its plain torch version on the card, bit
             for bit, at the full width D = 40,960, n = 16: the encoder on
             256 windows of 8,192 tokens (one short, one with an even gram
             count, 40 whose gram counts m straddle the bit-sliced
             counters' plane boundaries 2^k - 1, 2^k, 2^k + 1) and on reads
             of lengths 0, 10, 150, 151 and 300; the fused kernel on 253
             reads (a partial tail tile, even and zero gram counts, m at
             plane boundaries) against 1,001 prototypes, at the default
             tiling, at bb 32 / cluster 2 and at bb 16 / cluster 8; the
             search kernels (``hamming_am``, ``am_matmul_packed``, the bf16
             ``am_matmul``) on 253 queries against the same 1,001
             prototypes, and at a ragged W = 1,001, each with a query equal
             to a prototype and one equal to a complement, all equal to
             each other; and at dim != 32 W against their plain versions.
             Then the serving path's cohorts: 256 reads padded to 256 and
             to 2,048 tokens, 56 of them of length 0, through the encoder
             and through the fused kernel at every tiling that fits.
3. main path ``ProfilingSession(..., backend="cuda_fused")`` builds the
             RefDB of a 20 species x 4,000,000 bp synthetic community
             (~9.8k prototypes, ~50 MB) and profiles 32,768 reads of 150 bp,
             with every kernel launch counter set to 0 just before and read
             just after, then times ``WARM_RUNS`` more profiles (their median
             is the end-to-end figure; the first run carries first-call
             costs); then each kernel is timed and held against its
             plain version at the shapes that run gave it, beside its
             bound (and, in the text line, its time before its current design, from PERF.md).
   search    the same reads through ``cuda_packed`` and ``cuda_matmul``
             sessions against phase 3's RefDB, each with the counters set
             to 0 just before and read just after: the encoder and the
             backend's search kernel must launch, the fused kernel must
             not, and each report must equal phase 3's; ``cuda_matmul``
             must call ``ops.to_pm1`` no time (the rise of
             ``max_memory_allocated`` during each profile is printed); then
             ``WARM_RUNS`` more profiles each, as in phase 3.
             Then ``cuda_fused.agreement`` (``am_matmul_packed``) on 256
             reads against ``classify_batch``, and the search kernels
             timed at the main path's shapes beside ``to_pm1`` and the
             library calls on the pre-expanded +-1 operands (float32 and
             bf16 ``torch.mm``, ``torch._int_mm`` on int8 with S padded
             to a multiple of 8).
4. report    a 4 species x 200 kbp community, 2,048 reads: the cuda_fused,
             cuda_packed and cuda_matmul reports and prototypes equal the
             torch ``reference`` backend's on the card.
5. cli       ``python -m repro_torch.launch.profile_run --synthetic`` with
             ``--backend cuda_packed`` and ``--backend cuda_matmul``: both
             exit 0 and write equal report JSONs.
6. serving   at phase 3's width and genomes: ``RefDBRegistry.create``
             through the encoder kernel (its launches counted, prototypes
             equal to phase 3's); a ``ProfilingService`` on ``cuda_fused``
             under 16 requests of 2,048 reads (8 x 150 bp, 4 x 100 bp,
             4 x 1,500 bp: cohorts padded to 128, 256 and 2,048), each
             report equal to a sequential ``profile``, with reads/s and
             p50/p99 latency; a ``TenantRouter`` with two tenants and two
             pump threads, with an add-species delta published mid-traffic
             (each report equal to a sequential profile on the version
             that admitted it); the service load again with metrics on
             and off in turns; one service load and one phase 3 profile
             under ``torch.profiler`` (the device's busy share and its
             top kernels); the tile autotuner at the main path's shape, a tuned session
             against phase 3's report, and tuned cohorts at buckets 2,048
             and 4,096 (also from a cache whose 256-bucket pick is
             bb 32 / cluster 2); and ``serve_profiler --smoke`` on
             ``cuda_packed`` (two tenants, two workers) and ``cuda_matmul``
             in child processes.  Counters are set to 0 just before each
             of the create, service and router runs and read just after.
7. alphabet  alphabets above 4 (the encode kernels' wide path): at
             D = 40,960, n = 16 and A = 5, 8, 20, the encoder on 256
             windows of 8,192 symbols and the fused kernel on 256 reads of
             150 against 9,780 random prototypes (prototype 0 = read 0's
             vector, the last = read 1's complement), and at A = 300 with
             16 windows / 32 reads; each bit-exact against its plain
             version, its ms a launch beside the A = 4 times of phase 3,
             and where its tables sat (shared memory or L2).  Then a
             ``cuda_fused`` session at A = 20 (4 species x 200 kbp of
             symbols in [0, 20) from a seed, 2,048 reads of 150) against a
             torch ``reference`` session: equal prototypes and reports.
8. fleet     phase 3's config and genomes behind a source
             ``RefDBRegistry`` (its create counted: 40 encoder launches)
             and a ``FleetController`` of 3 hosts on the one card: 2
             tenants x 8 requests of 2,048 of phase 3's reads, the busiest
             host killed after a third of the submissions (its live
             requests rerouted), a one-genome add-species delta and a
             two-phase ``fleet_swap`` after two thirds, ``wait_retired``;
             every report (rerouted ones included) equal to a sequential
             ``cuda_fused`` profile on its admitted version, reads/s, p50 /
             p99, the launches (the encoder only for the delta: replication
             copies snapshots) and the ``host`` label on every per-host
             series of the merged metrics; then ``serve_fleet --smoke
             --check`` in a child process.
9. shard     the ``sharded`` backend: at world size 1 (NCCL, this process)
             over bases ``cuda_fused``, ``cuda_packed`` and
             ``cuda_matmul``, and at world size 2 on the one card (gloo
             over CUDA tensors, two ranks started as child processes, base
             ``cuda_fused``, each building the RefDB), phase 3's reads:
             every report equal to phase 3's, with the MB each rank holds
             and the profile time.

The last lines are one JSON object per kernel list and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

#: Peak rates for the bound.  NVIDIA H100 SXM data sheet (at 700 W): HBM3
#: bandwidth, 989 TFLOP/s dense bf16 (the bf16 am_matmul entry's +-1
#: products) and 1,979 TOP/s dense int8 (the packed am_matmul entry's: +-1
#: products are exact in int8, so bf16's rate is not the least time).  CUDA
#: C++ Programming Guide, arithmetic-instruction throughput table, compute
#: capability 9.0: 32-bit integer add and logic at 64 a clock per SM, for
#: the encode's integer work.  Rates given a clock are taken at the SM
#: clock nvidia-smi reports (clocks.max.sm) times the SM count.
HBM_BYTES_PER_S = 3.35e12
TENSOR_BF16_FLOP_PER_S = 989e12
TENSOR_INT8_OPS_PER_S = 1979e12
INT32_OPS_PER_SM_CLOCK = 64
#: The B x S x D bit agreements of fused_profile and hamming_am, counted
#: as 2 B S D operations (an AND and an add a bit), are priced at the
#: rate the card issues mma.sync m16n8k256 b1 .and.popc: 0.471 a clock
#: per SM, 16 x 8 x 256 bits each (tools/search_mma_probe.py on the
#: NVIDIA H100 80GB HBM3 at 700 W; PERF.md).  No b1 rate is published,
#: and this one is about 4x the 1,979 TOP/s int8 peak, so the int8 rate
#: would not be the least time.
B1_MMA_PER_SM_CLOCK = 0.471
B1_OPS_PER_MMA = 2 * 16 * 8 * 256
#: Integer operations per word-gram of the least encode formulation known:
#: one XOR of the rolling bind (a pair-table word) and one carry-save full
#: adder (two LOP3) of the bit-sliced counting.
ENCODE_OPS_PER_WORD_GRAM = 3
#: Each kernel's time a launch before its current design (chip_smoke,
#: NVIDIA H100 80GB HBM3, 700.00 W; PERF.md's kernel table), printed in the
#: [time] lines beside this run's.
PRIOR_MS = {"hdc_encoder": 1.201, "fused_profile": 0.240,
           "hamming_am": 0.934, "am_matmul": 1.060}

GENOME_LEN = 4_000_000
NUM_SPECIES = 20
NUM_READS = 32_768
#: ``profile`` runs timed after each backend's first (cold) one, which
#: carries first-call costs; their median is the end-to-end figure.
WARM_RUNS = 5


def say(*parts) -> None:
    print(*parts, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def cuda_time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean ms per call over ``reps`` back-to-back calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def warm_profile(sess, sample, db, want: dict) -> tuple[float, list[float]]:
    """Median and list of ``WARM_RUNS`` back-to-back ``profile`` seconds
    (host clock, after ``synchronize``); each report must equal ``want``."""
    import torch

    secs = []
    for _ in range(WARM_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = sess.profile(sample, refdb=db)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if rep.to_dict() != want:
            fail(f"a warm {sess.config.backend} profile differs from the "
                 f"first")
    return statistics.median(secs), secs


def warm_line(med: float, secs: list[float]) -> str:
    return (f"warm median {med:.3f} s of {len(secs)} "
            f"({' '.join(f'{x:.3f}' for x in secs)}) | "
            f"{NUM_READS / med:.0f} reads/s")


def max_abs_err(got, want) -> int:
    diff = (got.to("cpu").long() - want.to("cpu").long()).abs()
    return int(diff.max()) if diff.numel() else 0


def expect_equal(name: str, got, want) -> int:
    import torch

    if got.shape != want.shape or not torch.equal(got.cpu(), want.cpu()):
        bad = (got.cpu() != want.cpu()).nonzero()
        fail(f"{name}: kernel and plain version differ "
             f"({len(bad)} elements, first at {bad[:1].tolist()})")
    return max_abs_err(got, want)


def encoder_ops(lengths, n: int, w: int) -> int:
    """Integer operations of the valid word-grams of these reads."""
    m = np.maximum(np.asarray(lengths, np.int64) - (n - 1), 0)
    return int(m.sum()) * w * ENCODE_OPS_PER_WORD_GRAM


def bound_ms(nbytes: int, int_ops: int = 0, tensor_ops: int = 0,
             tensor_rate: float = 0.0,
             int_rate: float = 0.0) -> tuple[float, str]:
    """The least time: the largest of the bytes over HBM bandwidth, the
    integer operations over the integer rate and the tensor-core
    operations over their rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(int_ops / int_rate if int_ops else 0.0,
                tensor_ops / tensor_rate if tensor_ops else 0.0)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")




def search_parity(name, q, p, dim, errs) -> None:
    """The search kernels against their plain versions and, at
    dim = 32 W, against each other on packed ``q``/``p`` whose row 0
    equals prototype 0 and row 1 the complement of the last prototype."""
    from repro_torch.kernels import am_matmul, hamming_am, ops

    got_h = hamming_am.hamming_am(q, p, dim=dim)
    errs["hamming_am"] = max(errs["hamming_am"], expect_equal(
        f"hamming_am {name}", got_h, hamming_am.hamming_am_plain(q, p,
                                                                 dim=dim)))
    got_k = am_matmul.am_matmul_packed(q, p, dim=dim)
    errs["am_matmul_packed"] = max(errs["am_matmul_packed"], expect_equal(
        f"am_matmul_packed {name}", got_k,
        am_matmul.am_matmul_packed_plain(q, p, dim=dim)))
    q_pm, p_pm = ops.to_pm1(q), ops.to_pm1(p)
    got_m = am_matmul.am_matmul(q_pm, p_pm, dim=dim)
    errs["am_matmul"] = max(errs["am_matmul"], expect_equal(
        f"am_matmul {name}", got_m, am_matmul.am_matmul_plain(q_pm, p_pm,
                                                              dim=dim)))
    expect_equal(f"am_matmul_packed vs am_matmul {name}", got_k, got_m)
    if dim != 32 * q.shape[1]:
        say(f"[parity] hamming_am, am_matmul_packed and am_matmul == plain "
            f"on {q.shape[0]} queries x {p.shape[0]} prototypes, W = "
            f"{q.shape[1]}, dim = {dim} (bit-exact)")
        return
    expect_equal(f"am_matmul_packed vs hamming_am {name}", got_k, got_h)
    corners = (int(got_h[0, 0]), int(got_h[1, -1]))
    if corners != (dim, 0):
        fail(f"search {name}: equal / complement rows give {corners}, "
             f"want ({dim}, 0)")
    say(f"[parity] hamming_am == am_matmul_packed == am_matmul == plain on "
        f"{q.shape[0]} queries x {p.shape[0]} prototypes, W = {q.shape[1]} "
        f"(bit-exact; equal row {corners[0]}, complement row {corners[1]})")


def with_corner_rows(q, p):
    """``q`` with row 0 = prototype 0 and row 1 = ~(last prototype)."""
    q = q.clone()
    q[0], q[1] = p[0], ~p[-1]
    return q


def run_cli(backend: str, out_dir: str) -> dict:
    """``profile_run --synthetic`` on the card in a child process."""
    path = os.path.join(out_dir, f"profile_run_{backend}.json")
    cmd = [sys.executable, "-m", "repro_torch.launch.profile_run",
           "--synthetic", "--backend", backend, "--json", path]
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    if out.returncode != 0:
        fail(f"profile_run --backend {backend} exited {out.returncode}:\n"
             f"{out.stdout[-2000:]}\n{out.stderr[-2000:]}")
    lines = [ln for ln in out.stdout.splitlines()
             if ln.startswith(("backend ", "vs ground truth"))]
    say(f"[cli] {' | '.join(lines)} ({time.perf_counter() - t0:.1f} s "
        f"with start-up)")
    with open(path) as f:
        return json.load(f)


def run_serve_cli(args: list[str]) -> None:
    """``serve_profiler --smoke`` (which implies ``--check``) on the card
    in a child process; a mismatch exits non-zero."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve_profiler",
           "--smoke", *args]
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    if out.returncode != 0:
        fail(f"serve_profiler {' '.join(args)} exited {out.returncode}:\n"
             f"{out.stdout[-2000:]}\n{out.stderr[-2000:]}")
    lines = [ln.strip() for ln in out.stdout.splitlines()
             if ln.startswith(("backend ", "check OK", "fleet:"))
             or "requests x" in ln]
    say(f"[serve] serve_profiler --smoke {' '.join(args)}: "
        f"{' | '.join(lines)} ({time.perf_counter() - t0:.1f} s with "
        f"start-up)")


def traced_busy(label: str, fn, trace_dir: str, card: str) -> None:
    """Run ``fn`` under ``obs.torch_trace`` and print the device's busy
    share of the wall time (the sum of the trace's kernel events; one
    stream, so they do not overlap) and the kernels that took most of
    it."""
    import torch

    from repro_torch import obs

    torch.cuda.synchronize()
    with obs.torch_trace(trace_dir):
        t0 = time.perf_counter()           # the profiler's start and the
        fn()                               # trace's export stay outside
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with open(os.path.join(trace_dir, "trace.json")) as f:
        events = json.load(f).get("traceEvents", [])
    busy: dict[str, float] = {}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        short = re.split(r"[<(]", e["name"].replace(
            "(anonymous namespace)::", "").removeprefix("void "))[0]
        short = short.rsplit("::", 1)[-1]
        busy[short] = busy.get(short, 0.0) + e["dur"] / 1e6
    if not busy:
        say(f"[trace] {label}: no kernel events in its torch.profiler "
            f"trace ({len(events)} events); device busy share not measured")
        return
    t_busy = sum(busy.values())
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:5]
    say(f"[trace] {label} under torch.profiler: {wall:.3f} s wall, device "
        f"busy {t_busy:.3f} s = {100 * t_busy / wall:.1f} % (idle "
        f"{100 - 100 * t_busy / wall:.1f} %) | "
        + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in top) + f" | {card}")


def serving_phase(*, config, sample, db, session, main_report, card,
                  out_dir, zero_counts, read_counts) -> None:
    """Phase 6: the serving path at the main path's full width."""
    import dataclasses
    import shutil

    import torch

    from repro_torch import obs
    from repro_torch.core.assoc_memory import window_tokens
    from repro_torch.genomics import synth
    from repro_torch.kernels import autotune, fused_profile
    from repro_torch.pipeline import ArraySource, ProfilingSession
    from repro_torch.serve import (ProfilingService, RefDBRegistry,
                                   TenantRouter)

    # -- 6.1 registry create through the encoder kernel ------------------
    root = os.path.join(out_dir, "refdbs")
    shutil.rmtree(root, ignore_errors=True)
    registry = RefDBRegistry(root=root)
    batches = sum(-(-len(window_tokens(g, config.window,
                                       config.effective_stride)[0])
                    // config.batch_size) for g in sample.genomes.values())
    zero_counts()
    t0 = time.perf_counter()
    snap1 = registry.create("food", sample.genomes, config)
    torch.cuda.synchronize()
    create_s = time.perf_counter() - t0
    runs = read_counts()
    say(f"[serve] registry create food:v1 {create_s:.3f} s (snapshot written "
        f"to {os.path.relpath(root, ROOT)}) | launches {json.dumps(runs)}")
    if runs["hdc_encoder"] != batches or runs["fused_profile"] != 0:
        fail(f"registry create launched {runs}, want hdc_encoder {batches} "
             f"(one a 256-window batch) and nothing else")
    if not (torch.equal(snap1.db.prototypes, db.prototypes)
            and torch.equal(snap1.db.proto_species, db.proto_species)):
        fail("registry create: prototypes differ from phase 3's build_refdb")
    say(f"[serve] registry v1 prototypes == phase 3's ({db.num_prototypes} "
        f"rows, bit-exact); {batches} encoder launches")

    # -- 6.2 the service under mixed read lengths ------------------------
    per_request = 2048
    mix = (150, 100, 150, 1500) * 4               # 8 x 150, 4 x 100, 4 x 1500
    t0 = time.perf_counter()
    pools = {}
    for n_len in sorted(set(mix)):
        spec = dataclasses.replace(sample.spec, read_len=n_len)
        _, toks, lens, _, _ = synth.make_sample(
            spec, num_reads=mix.count(n_len) * per_request)
        pools[n_len] = (toks, lens)
    taken = {n_len: 0 for n_len in pools}
    requests = []
    for n_len in mix:
        k = taken[n_len]
        toks, lens = pools[n_len]
        requests.append(ArraySource(toks[k:k + per_request],
                                    lens[k:k + per_request]))
        taken[n_len] = k + per_request
    total = per_request * len(mix)
    say(f"[serve] {len(mix)} requests x {per_request} reads ({total} reads: "
        f"8 x 150 bp, 4 x 100 bp, 4 x 1500 bp; made in "
        f"{time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    sequential = {1: [session.profile(src, refdb=db).to_dict()
                      for src in requests]}
    torch.cuda.synchronize()
    say(f"[serve] sequential profiles of the 16 requests: "
        f"{time.perf_counter() - t0:.3f} s")

    def serve_load(sess, metrics=None) -> tuple[list, ProfilingService,
                                                 float, dict]:
        service = ProfilingService(sess, max_active=8, metrics=metrics)
        zero_counts()
        t_0 = time.perf_counter()
        with service:                  # one background pump thread
            hs = [service.submit(src) for src in requests]
            reps = [h.result(timeout=600) for h in hs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_0
        counts = read_counts()
        if [r.to_dict() for r in reps] != sequential[1]:
            bad = [h.request_id for h, r, w in zip(hs, reps, sequential[1])
                   if r.to_dict() != w]
            fail(f"served reports differ from sequential profiles: {bad}")
        return hs, service, wall, counts

    hs, service, wall_serve, counts = serve_load(session)
    lat = sorted(h.latency_s for h in hs)
    fill = total / (service.cohorts_run * config.batch_size)
    say(f"[serve] ProfilingService cuda_fused, max_active 8: {total} reads "
        f"in {wall_serve:.3f} s | {total / wall_serve:.0f} reads/s | "
        f"latency p50 "
        f"{np.percentile(lat, 50) * 1e3:.1f} ms p99 "
        f"{np.percentile(lat, 99) * 1e3:.1f} ms | {service.cohorts_run} "
        f"cohorts, mean fill {fill:.3f} | launches {json.dumps(counts)} | "
        f"{card}")
    if counts["fused_profile"] != service.cohorts_run \
            or counts["hdc_encoder"] != 0:
        fail(f"service: {counts} for {service.cohorts_run} cohorts, want "
             f"one fused_profile launch a cohort and nothing else")
    say(f"[serve] all {len(hs)} served reports == sequential "
        f"ProfilingSession.profile (bit-exact)")

    # -- 6.3 the router: two tenants, two pumps, a delta mid-traffic -----
    rng = np.random.default_rng(sample.spec.seed + 101)
    delta = {"species_new": rng.integers(0, 4, len(next(iter(
        sample.genomes.values()))), dtype=np.int32)}
    delta_batches = -(-len(window_tokens(
        delta["species_new"], config.window, config.effective_stride)[0])
        // config.batch_size)
    router = TenantRouter(registry)
    for tenant in ("a", "b"):
        router.add_tenant(tenant, database="food", max_active=4,
                          max_queue=16)
    routed = []
    zero_counts()
    t0 = time.perf_counter()
    router.start(workers=2)
    try:
        for i, src in enumerate(requests[:8]):
            routed.append((i, router.submit(src, tenant="ab"[i % 2])))
        deadline = time.monotonic() + 300
        while not any(h.done for _, h in routed):
            if time.monotonic() > deadline:
                fail("router: no request finished within 300 s")
            time.sleep(0.001)
        t_delta = time.perf_counter() - t0
        snap2 = registry.apply_delta("food", add=delta)
        for i, src in enumerate(requests[8:], start=8):
            routed.append((i, router.submit(src, tenant="ab"[i % 2])))
        reps = [(i, h, h.result(timeout=600)) for i, h in routed]
    finally:
        router.stop()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    router.close()
    s2 = ProfilingSession(config)
    s2.adopt_refdb(snap2.db)
    sequential[2] = {}
    bad = []
    for i, h, rep in reps:
        if h.version == 2 and i not in sequential[2]:
            sequential[2][i] = s2.profile(requests[i]).to_dict()
        want = sequential[1][i] if h.version == 1 else sequential[2][i]
        if rep.to_dict() != want:
            bad.append(h.request_id)
    versions = sorted({h.version for _, h, _ in reps})
    say(f"[serve] TenantRouter tenants a, b, workers 2: {total} reads in "
        f"{wall:.3f} s | {total / wall:.0f} reads/s | delta "
        f"+species_new -> v{snap2.version} at t={t_delta:.3f} s "
        f"({router.swaps} swap, retired {router.retired}) | versions "
        f"{versions} | launches {json.dumps(counts)} (read after both "
        f"pumps stopped; the counters are locked) | {card}")
    if bad:
        fail(f"routed reports differ from sequential profiles on their "
             f"admitted versions: {bad}")
    if versions != [1, 2]:
        fail(f"router requests ran on versions {versions}, want [1, 2]")
    if counts["hdc_encoder"] != delta_batches or counts["fused_profile"] < 1:
        fail(f"router phase launched {counts}, want hdc_encoder "
             f"{delta_batches} (the delta) and fused_profile")
    say(f"[serve] all {len(reps)} routed reports == sequential profiles on "
        f"their admitted version ({sum(h.version == 1 for _, h, _ in reps)} "
        f"on v1, {sum(h.version == 2 for _, h, _ in reps)} on v2; "
        f"bit-exact); the delta launched the encoder {delta_batches} times")

    # -- 6.4 metrics on against off, in turns: on, off, on ---------------
    walls = {"off": [wall_serve], "on": []}
    for mode in ("on", "off", "on"):
        if mode == "on":
            reg = obs.enable_metrics()
        try:
            s_obs = ProfilingSession(config)
            s_obs.adopt_refdb(db)
            walls[mode].append(serve_load(s_obs)[2])
        finally:
            obs.disable()
    names = ("serve_reads_classified_total",
             "serve_cohort_padding_rows_total",
             "session_classify_batches_total")
    vals = {k: reg.counter(k).total() for k in names}
    say(f"[serve] metrics on: reports == metrics off (bit-exact) | reads/s "
        f"off {' '.join(f'{total / x:.0f}' for x in walls['off'])}, on "
        f"{' '.join(f'{total / x:.0f}' for x in walls['on'])} | "
        + " | ".join(f"{k} {v:.0f}" for k, v in vals.items()))
    if vals["serve_reads_classified_total"] != total:
        fail(f"serve_reads_classified_total {vals} != {total}")

    # -- 6.4b where the time goes: a service load and a profile, traced ---
    traced_busy("one service load", lambda: serve_load(session),
                os.path.join(out_dir, "serve_trace"), card)
    traced_busy("one cuda_fused profile of the 32,768 150-bp reads",
                lambda: session.profile(sample, refdb=db),
                os.path.join(out_dir, "profile_trace"), card)

    # -- 6.5 the autotuner --------------------------------------------------
    cache = os.path.join(out_dir, "autotune.json")
    if os.path.exists(cache):
        os.unlink(cache)
    t0 = time.perf_counter()
    tiles, cached = autotune.tune(
        config.space, batch=config.batch_size, num_prototypes=db.num_prototypes,
        read_len=150, path=cache)
    key = autotune.cache_key(config.batch_size, config.space.num_words,
                             db.num_prototypes, config.space.dim, 150)
    entry = autotune.load_cache(cache)[key]
    say(f"[tune] {key}: {entry['swept']} feasible tilings timed in "
        f"{time.perf_counter() - t0:.2f} s: "
        + ", ".join(f"{k} {v * 1e3:.3f} ms"
                    for k, v in sorted(entry["times_s"].items()))
        + f" | pick bb {tiles['bb']} / cluster {tiles['cluster']} | {card}")
    if cached:
        fail("autotune: the fresh cache reported a hit")
    opts = {"autotune": True, "autotune_cache": cache}
    tuned = ProfilingSession(dataclasses.replace(
        config, backend_options=opts))
    if tuned.profile(sample, refdb=db).to_dict() != main_report:
        fail("the autotuned cuda_fused session's report differs from "
             "phase 3's")
    say(f"[tune] autotune=true session == phase 3's report (tiles "
        f"{tuned.backend.tiles})")
    # A pick cached for 150-token reads (bucket 256), here the widest one
    # that fits there (bb 32 / cluster 2), must not reach a 2,048 cohort.
    poisoned = os.path.join(out_dir, "autotune_poisoned.json")
    autotune.save_cache({key: {"tiles": {"bb": 32, "cluster": 2}}}, poisoned)
    spec = dataclasses.replace(sample.spec, read_len=3000)
    _, t3k, l3k, _, _ = synth.make_sample(spec, num_reads=512)
    long_reads = {1500: ArraySource(pools[1500][0][:512],
                                    pools[1500][1][:512]),
                  3000: ArraySource(t3k, l3k)}
    for cache_file in (cache, poisoned):
        sess = ProfilingSession(dataclasses.replace(
            config, backend_options={"autotune": True,
                                     "autotune_cache": cache_file}))
        sess.adopt_refdb(db)
        service = ProfilingService(sess, max_active=8)
        for n_len, src in long_reads.items():
            h = service.submit(src)
            service.run_until_idle()
            got = h.result(timeout=0).to_dict()
            if got != session.profile(src, refdb=db).to_dict():
                fail(f"autotuned service at {n_len} bp differs from the "
                     f"sequential profile")
        picks = {f"L{b}": t for (_, b), t in sess.backend.tuned.items()}
        for (_, b), t in sess.backend.tuned.items():
            smem = fused_profile.smem_bytes(
                t["bb"], t["cluster"], b, config.space.ngram,
                config.space.alphabet_size, config.space.num_words)
            if smem > fused_profile.MAX_SMEM_BYTES:
                fail(f"autotune picked {t} for bucket {b}: {smem} bytes")
        say(f"[tune] {os.path.basename(cache_file)}: cohorts of 1500 bp "
            f"(bucket 2048) and 3000 bp (bucket 4096) ran == sequential; "
            f"picks per bucket {json.dumps(picks)}")

    # -- 6.6 the serve_profiler CLI -------------------------------------------
    run_serve_cli(["--backend", "cuda_packed", "--tenants", "2",
                   "--workers", "2"])
    run_serve_cli(["--backend", "cuda_matmul"])


def alphabet_phase(*, space, rows, card, zero_counts, read_counts) -> None:
    """Phase 7: alphabets above 4 through both encode kernels, full width."""
    import dataclasses

    import torch

    from repro_torch import convert
    from repro_torch.core import item_memory
    from repro_torch.kernels import fused_profile, hdc_encoder
    from repro_torch.pipeline import (ArraySource, ProfilerConfig,
                                      ProfilingSession)

    dev = torch.device("cuda")
    n, w, dim = space.ngram, space.num_words, space.dim
    a4 = {r["name"]: r["ms"] for r in rows}
    rng = np.random.default_rng(2207)
    protos = convert.words_to_tensor(rng.integers(
        0, 2 ** 32, (9780, w), dtype=np.uint32), dev)
    bb, cl = fused_profile.DEFAULT_BB, fused_profile.DEFAULT_CLUSTER
    for alphabet, b_win, b_read in ((5, 256, 256), (8, 256, 256),
                                    (20, 256, 256), (300, 16, 32)):
        sp = dataclasses.replace(space, alphabet_size=alphabet)
        imr = item_memory.rolled(item_memory.make_item_memory(
            sp, device=dev), n).contiguous()
        tie = item_memory.make_tie_break(sp, device=dev)
        wins = torch.from_numpy(rng.integers(
            0, alphabet, (b_win, 8192)).astype(np.int32)).to(dev)
        wl = np.full(b_win, 8192, np.int32)
        wl[-2:] = [8191, 5000]                 # m = 8176 even; a short one
        wlen = torch.from_numpy(wl).to(dev)
        expect_equal(f"hdc_encoder A={alphabet}",
                     hdc_encoder.hdc_encode(wins, wlen, imr, tie),
                     hdc_encoder.hdc_encode_plain(wins, wlen, imr, tie))
        enc_ms = cuda_time_ms(
            lambda: hdc_encoder.hdc_encode(wins, wlen, imr, tie), reps=5)
        starts = rng.integers(0, 8192 - 150, b_read).tolist()
        qt = torch.stack([wins[i % b_win, s0:s0 + 150]
                          for i, s0 in enumerate(starts)]).contiguous()
        ql = np.full(b_read, 150, np.int32)
        ql[2:5] = [0, 10, 151 - 2]             # empty, m = 0, even m
        qlen = torch.from_numpy(ql).to(dev)
        pair = hdc_encoder.hdc_encode_plain(qt[:2], qlen[:2], imr, tie)
        protos[0], protos[-1] = pair[0], ~pair[1]
        got = fused_profile.fused_profile(qt, qlen, imr, tie, protos,
                                          dim=dim, bb=bb, cluster=cl)
        expect_equal(f"fused_profile A={alphabet}", got,
                     fused_profile.fused_profile_plain(qt, qlen, imr, tie,
                                                       protos, dim=dim))
        corners = (int(got[0, 0]), int(got[1, -1]))
        if corners != (dim, 0):
            fail(f"fused_profile A={alphabet}: equal / complement rows give "
                 f"{corners}, want ({dim}, 0)")
        f_ms = cuda_time_ms(lambda: fused_profile.fused_profile(
            qt, qlen, imr, tie, protos, dim=dim, bb=bb, cluster=cl), reps=10)
        where_e = ("shared memory" if hdc_encoder.shared_tables(8192, n,
                                                                alphabet)
                   else "L2 (global tables)")
        where_f = ("shared memory" if fused_profile.shared_tables(
            bb, cl, 150, n, alphabet, w) else "L2 (global tables)")
        say(f"[alphabet] A={alphabet}: hdc_encoder {b_win} x 8192 == plain, "
            f"{enc_ms:.3f} ms a launch (A = 4, 256 windows: "
            f"{a4['hdc_encoder']:.3f} ms), tables in {where_e} | "
            f"fused_profile {b_read} x 150 vs 9780 at bb {bb} / cluster "
            f"{cl} == plain (equal row {corners[0]}, complement row "
            f"{corners[1]}), {f_ms:.3f} ms a launch (A = 4, 256 reads: "
            f"{a4['fused_profile']:.3f} ms), tables in {where_f} | {card}")

    # A whole session at A = 20 against the torch reference on the card.
    sp20 = dataclasses.replace(space, alphabet_size=20)
    rng = np.random.default_rng(20)
    genomes = {f"species_{i:02d}": rng.integers(0, 20, 200_000).astype(
        np.int32) for i in range(4)}
    names = list(genomes)
    toks = np.zeros((2048, 150), np.int32)
    for r in range(len(toks)):
        g = genomes[names[r % 4]]
        s0 = int(rng.integers(0, len(g) - 150))
        toks[r] = g[s0:s0 + 150]
    lens = np.full(len(toks), 150, np.int32)
    reports, dbs = {}, {}
    for backend in ("cuda_fused", "reference"):
        sess = ProfilingSession(ProfilerConfig(
            space=sp20, window=8192, batch_size=256, backend=backend))
        zero_counts()
        t0 = time.perf_counter()
        dbs[backend] = sess.build_refdb(genomes)
        reports[backend] = sess.profile(ArraySource(toks, lens)).to_dict()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        runs = read_counts()
        if backend == "cuda_fused" and min(runs["hdc_encoder"],
                                           runs["fused_profile"]) < 1:
            fail(f"the A = 20 cuda_fused session skipped a kernel: {runs}")
        say(f"[alphabet] A=20 {backend} session: build + profile "
            f"{secs:.3f} s | launches {json.dumps(runs)}")
    if not torch.equal(dbs["cuda_fused"].prototypes,
                       dbs["reference"].prototypes):
        fail("A = 20: cuda_fused prototypes differ from the reference's")
    rep = reports["reference"]
    if reports["cuda_fused"] != rep:
        fail("A = 20: the cuda_fused report differs from the reference's")
    if rep["unmapped_reads"] >= rep["total_reads"]:
        fail("A = 20: no read mapped")
    say(f"[alphabet] A=20 cuda_fused == reference on the card: "
        f"{dbs['reference'].num_prototypes} prototypes, "
        f"{rep['total_reads']} reads, unmapped {rep['unmapped_reads']}, "
        f"multi {rep['multi_reads']}")


def fleet_phase(*, config, sample, db, card, zero_counts,
                read_counts) -> None:
    """Phase 8: a fleet of 3 hosts on the one card, full width."""
    import torch

    from repro_torch.core.assoc_memory import window_tokens
    from repro_torch.pipeline import ArraySource, ProfilingSession
    from repro_torch.serve import FleetController, RefDBRegistry
    from repro_torch.serve.fleet import HostState

    def encoder_batches(genomes) -> int:
        return sum(-(-len(window_tokens(g, config.window,
                                        config.effective_stride)[0])
                     // config.batch_size) for g in genomes.values())

    source = RefDBRegistry(root=None)
    zero_counts()
    t0 = time.perf_counter()
    snap1 = source.create("food", sample.genomes, config)
    torch.cuda.synchronize()
    create_s = time.perf_counter() - t0
    runs = read_counts()
    if runs["hdc_encoder"] != encoder_batches(sample.genomes) \
            or runs["fused_profile"] != 0:
        fail(f"source registry create launched {runs}")
    if not torch.equal(snap1.db.prototypes, db.prototypes):
        fail("source registry create: prototypes differ from phase 3's")
    say(f"[fleet] source registry create food:v1 {create_s:.3f} s | "
        f"launches {json.dumps(runs)} | prototypes == phase 3's")

    per_request, total = 2048, 16
    requests = [ArraySource(sample.tokens[i * per_request:
                                          (i + 1) * per_request],
                            sample.lengths[i * per_request:
                                           (i + 1) * per_request])
                for i in range(total)]
    rng = np.random.default_rng(sample.spec.seed + 202)
    delta = {"species_fleet": rng.integers(0, 4, GENOME_LEN, dtype=np.int32)}
    fleet = FleetController(source, hosts=3)
    for tenant in ("tenant0", "tenant1"):
        fleet.add_tenant(tenant, "food", max_active=2, max_queue=total)
    handles, killed, rerouted, snap2 = [], None, [], None
    zero_counts()
    t0 = time.perf_counter()
    with fleet:
        for i, src in enumerate(requests):
            if i == total // 3:                # kill the busiest host
                live: dict[str, int] = {}
                for h in handles:
                    if not h.done:
                        live[h.host] = live.get(h.host, 0) + 1
                healthy = [hid for hid in live
                           if fleet.host(hid).state is HostState.HEALTHY]
                killed = (max(healthy, key=live.get) if healthy
                          else fleet.healthy_hosts()[0])
                rerouted = fleet.kill_host(killed)
                say(f"[fleet] killed {killed} after {i} submissions (live "
                    f"{json.dumps(live)}); rerouted {len(rerouted)}: "
                    f"{' '.join(rerouted) or '(none in flight)'}")
            if i == 2 * total // 3:            # delta + two-phase swap
                snap2 = source.apply_delta("food", add=delta)
                fleet.fleet_swap("food", version=snap2.version)
                say(f"[fleet] fleet swap v1 -> v{snap2.version} after {i} "
                    f"submissions ({len(fleet.healthy_hosts())} healthy "
                    f"hosts)")
            handles.append(fleet.submit(src, tenant=f"tenant{i % 2}",
                                        request_id=f"req-{i}"))
        reports = [h.result(timeout=600) for h in handles]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        t_ret = time.perf_counter()
        fleet.wait_retired("food", 1, timeout=300)
        retire_s = time.perf_counter() - t_ret
        merged = fleet.metrics_snapshot().snapshot()
    counts = read_counts()
    fleet.close()
    sessions, bad = {}, []
    for h, src, rep in zip(handles, requests, reports):
        if h.version not in sessions:
            sess = ProfilingSession(config)
            sess.adopt_refdb(source.snapshot("food", h.version).db)
            sessions[h.version] = sess
        if rep.to_dict() != sessions[h.version].profile(src).to_dict():
            bad.append(h.request_id)
    if bad:
        fail(f"fleet reports differ from sequential cuda_fused profiles on "
             f"their admitted versions: {bad}")
    delta_batches = encoder_batches(delta)
    if counts["hdc_encoder"] != delta_batches or counts["fused_profile"] < 1:
        fail(f"fleet launched {counts}, want hdc_encoder {delta_batches} "
             f"(the delta alone: replication copies snapshots) and "
             f"fused_profile")
    unlabeled = [name for kind in ("counters", "gauges", "histograms")
                 for name, m in merged.get(kind, {}).items()
                 if not name.startswith("fleet_")
                 for series in m["series"] if "host" not in series["labels"]]
    if unlabeled:
        fail(f"merged fleet metrics: series without a host label in "
             f"{sorted(set(unlabeled))}")
    n_series = sum(len(m["series"]) for kind in ("counters", "gauges",
                                                 "histograms")
                   for name, m in merged.get(kind, {}).items()
                   if not name.startswith("fleet_"))
    lat = sorted(h._attempts[-1][1].latency_s for h in handles)
    reads = per_request * total
    by_host: dict[str, int] = {}
    for h in handles:
        by_host[h.host] = by_host.get(h.host, 0) + 1
    say(f"[fleet] 3 hosts, 2 tenants x 8 requests of {per_request} reads: "
        f"{reads} reads in {wall:.3f} s | {reads / wall:.0f} reads/s | "
        f"latency p50 {np.percentile(lat, 50) * 1e3:.1f} ms p99 "
        f"{np.percentile(lat, 99) * 1e3:.1f} ms | reroutes "
        f"{sum(h.rerouted for h in handles)} | placement "
        f"{json.dumps(dict(sorted(by_host.items())))} | versions "
        f"{sorted({h.version for h in handles})} | retire "
        f"{retire_s * 1e3:.1f} ms | launches {json.dumps(counts)} | {card}")
    say(f"[fleet] all {total} reports (rerouted ones included) == "
        f"sequential cuda_fused profiles on their admitted versions; "
        f"encoder launched {delta_batches} times (the delta alone); "
        f"{n_series} per-host metric series, each with a host label")
    cmd = [sys.executable, "-m", "repro_torch.launch.serve_fleet", "--smoke",
           "--check", "--backend", "cuda_fused"]
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    if out.returncode != 0:
        fail(f"serve_fleet --smoke --check exited {out.returncode}:\n"
             f"{out.stdout[-2000:]}\n{out.stderr[-2000:]}")
    lines = [ln.strip() for ln in out.stdout.splitlines()
             if ln.startswith(("fleet:", "check OK", "killed"))]
    say(f"[fleet] serve_fleet --smoke --check --backend cuda_fused: "
        f"{' | '.join(lines)} ({time.perf_counter() - t0:.1f} s with "
        f"start-up)")


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def shard_phase(*, config, sample, db, main_report, card, out_dir,
                zero_counts, read_counts) -> None:
    """Phase 9: the sharded backend at world sizes 1 and 2."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.pipeline import ProfilingSession, per_device_bytes

    kernels = {"cuda_fused": "fused_profile", "cuda_packed": "hamming_am",
               "cuda_matmul": "am_matmul_packed"}
    first = " (the group's first collective included)"
    for i, (base, kernel) in enumerate(kernels.items()):
        sess = ProfilingSession(dataclasses.replace(
            config, backend="sharded", backend_options={"base": base}))
        sess.adopt_refdb(db)
        zero_counts()
        t0 = time.perf_counter()
        rep = sess.profile(sample)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        runs = read_counts()
        if rep.to_dict() != main_report:
            fail(f"sharded (world size 1, base {base}) report differs from "
                 f"phase 3's")
        if runs[kernel] < 1:
            fail(f"sharded base {base} did not launch {kernel}: {runs}")
        med, warm = warm_profile(sess, sample, sess.refdb, main_report)
        say(f"[shard] world size 1 ({sess.backend.mesh.backend}), base "
            f"{base}: profile {secs:.3f} s cold{first if i == 0 else ''}, "
            f"{warm_line(med, warm)} | "
            f"{per_device_bytes(db, 1) / 1e6:.1f} MB per device | launches "
            f"{json.dumps(runs)} | report == phase 3's | {card}")
    if dist.is_initialized():
        dist.destroy_process_group()

    world = 2
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port()),
           "WORLD_SIZE": str(world)}
    paths = [os.path.join(out_dir, f"shard_rank{r}.json")
             for r in range(world)]
    for path in paths:
        if os.path.exists(path):
            os.unlink(path)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--shard-worker",
         paths[r]], cwd=ROOT, env={**env, "RANK": str(r),
                                   "LOCAL_RANK": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=900)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            fail(f"shard rank {r} exited {p.returncode}:\n{log[-3000:]}")
    outs = []
    for path in paths:
        with open(path) as f:
            outs.append(json.load(f))
    for out in outs:
        if out["report"] != main_report:
            fail(f"sharded rank {out['rank']} of {world} report differs from "
                 f"phase 3's")
    say(f"[shard] world size {world} on the one card ({outs[0]['backend']} "
        f"over CUDA tensors), base cuda_fused: "
        + " | ".join(f"rank {o['rank']}: {o['rows']} rows, {o['mb']:.1f} MB, "
                     f"build {o['build_s']:.3f} s, profile "
                     f"{o['profile_s']:.3f} s cold, warm median "
                     f"{o['warm_s']:.3f} s of {WARM_RUNS}, launches "
                     f"{json.dumps(o['launches'])}" for o in outs)
        + f" | both reports == phase 3's ({time.perf_counter() - t0:.1f} s "
        f"with start-up) | {card}")


def shard_worker(out_path: str) -> int:
    """One rank of phase 9's two-rank run (rank and world size from the
    environment): builds phase 3's RefDB through ``sharded`` over
    ``cuda_fused``, profiles phase 3's reads, writes its result."""
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core.hd_space import HDSpace
    from repro_torch.genomics import synth
    from repro_torch.kernels import am_matmul, fused_profile, hamming_am
    from repro_torch.kernels import hdc_encoder
    from repro_torch.pipeline import (ProfilerConfig, ProfilingSession,
                                      SyntheticSource)

    counters = {"hdc_encoder": hdc_encoder.hdc_encode,
                "fused_profile": fused_profile.fused_profile,
                "hamming_am": hamming_am.hamming_am,
                "am_matmul_packed": am_matmul.am_matmul_packed}
    sample = SyntheticSource(synth.CommunitySpec(
        num_species=NUM_SPECIES, genome_len=GENOME_LEN, seed=7),
        num_reads=NUM_READS)
    world = int(os.environ["WORLD_SIZE"])
    sess = ProfilingSession(ProfilerConfig(
        space=HDSpace(), window=8192, batch_size=256, backend="sharded",
        backend_options={"base": "cuda_fused", "shards": world}))
    t0 = time.perf_counter()
    db = sess.build_refdb(sample.genomes)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    for fn in counters.values():
        fn.launches = 0
    dist.barrier()
    t0 = time.perf_counter()
    rep = sess.profile(sample)
    torch.cuda.synchronize()
    profile_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    warm = []
    for _ in range(WARM_RUNS):
        dist.barrier()
        t0 = time.perf_counter()
        again = sess.profile(sample)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
        if again.to_dict() != rep.to_dict():
            return 1
    out = {"rank": sess.backend.mesh.rank, "backend": sess.backend.mesh.backend,
           "rows": db.num_prototypes, "mb": db.memory_bytes() / 1e6,
           "build_s": build_s, "profile_s": profile_s,
           "warm_s": statistics.median(warm), "launches": launches,
           "report": rep.to_dict()}
    with open(out_path, "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def main() -> int:
    sweep = "--sweep" in sys.argv[1:]
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs the port on an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import convert
    from repro_torch.core import item_memory
    from repro_torch.core.assoc_memory import window_tokens
    from repro_torch.core.hd_space import HDSpace
    from repro_torch.eval import score_profile
    from repro_torch.genomics import synth
    from repro_torch.kernels import (_build, _search, am_matmul,
                                     fused_profile, hamming_am, hdc_encoder,
                                     ops)
    from repro_torch.pipeline import (ProfilerConfig, ProfilingSession,
                                      SyntheticSource)

    dev = torch.device("cuda")
    card = card_line()
    clock = sm_clock_hz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    int_rate = INT32_OPS_PER_SM_CLOCK * sms * clock
    b1_rate = B1_MMA_PER_SM_CLOCK * B1_OPS_PER_MMA * sms * clock
    counters = {"hdc_encoder": hdc_encoder.hdc_encode,
                "fused_profile": fused_profile.fused_profile,
                "hamming_am": hamming_am.hamming_am,
                "am_matmul_packed": am_matmul.am_matmul_packed,
                "am_matmul": am_matmul.am_matmul}

    def zero_counts() -> None:
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0

    def read_counts() -> dict:
        torch.cuda.synchronize()
        return {k: fn.launches for k, fn in counters.items()}

    # -- 1. setup --------------------------------------------------------
    say(f"[setup] card: {card} | {sms} SMs at {clock / 1e6:.0f} MHz: "
        f"32-bit integer rate {int_rate / 1e12:.2f} T/s, b1 mma search "
        f"rate {b1_rate / 1e12:.0f} TOP/s")
    say(f"[setup] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.build_all()
    say(f"[setup] built {', '.join(_build.SOURCES)} with nvcc in "
        f"{time.perf_counter() - t0:.1f} s")

    space = HDSpace()                          # D = 40,960, n = 16
    n, w, alphabet = space.ngram, space.num_words, space.alphabet_size
    im = item_memory.make_item_memory(space, device=dev)
    tie = item_memory.make_tie_break(space, device=dev)
    imr = item_memory.rolled(im, n).contiguous()
    errs = {name: 0 for name in counters}

    # -- 2. kernel parity at full width ----------------------------------
    rng = np.random.default_rng(2206)
    wins = rng.integers(0, 4, (256, 8192)).astype(np.int32)
    wlens = np.full(256, 8192, np.int32)
    wlens[-1], wlens[-2] = 5000, 8191          # short tail; m = 8176 even
    plane_ms = [v for k in range(1, 14) for v in (2 ** k - 1, 2 ** k,
                                                  2 ** k + 1) if v <= 8177]
    wlens[:len(plane_ms)] = np.array(plane_ms) + (n - 1)
    t_w, l_w = (torch.from_numpy(wins).to(dev), torch.from_numpy(wlens).to(dev))
    enc = hdc_encoder.hdc_encode(t_w, l_w, imr, tie)
    enc_plain = hdc_encoder.hdc_encode_plain(t_w, l_w, imr, tie)
    errs["hdc_encoder"] = max(errs["hdc_encoder"],
                              expect_equal("hdc_encoder windows", enc, enc_plain))
    rlens = np.array([0, 10, 150, 151, 300], np.int32)
    reads = rng.integers(0, 4, (5, 300)).astype(np.int32)
    t_r, l_r = torch.from_numpy(reads).to(dev), torch.from_numpy(rlens).to(dev)
    errs["hdc_encoder"] = max(errs["hdc_encoder"], expect_equal(
        "hdc_encoder reads", hdc_encoder.hdc_encode(t_r, l_r, imr, tie),
        hdc_encoder.hdc_encode_plain(t_r, l_r, imr, tie)))
    say(f"[parity] hdc_encoder == plain on 256 x 8192 windows ({len(plane_ms)} "
        f"with m at plane boundaries 1 .. 8193) and reads of lengths "
        f"0/10/150/151/300 (bit-exact)")

    protos = torch.cat([enc, convert.words_to_tensor(rng.integers(
        0, 2 ** 32, (745, w), dtype=np.uint32), dev)]).contiguous()
    starts = rng.integers(0, 8192 - 151, 253)
    qtoks = np.stack([wins[i % 256, s:s + 151] for i, s in enumerate(starts)])
    qlens = np.full(253, 150, np.int32)
    qlens[:4] = [151, 0, 10, 15]               # even m, empty, short, m = 0
    read_ms = [v for k in range(1, 8) for v in (2 ** k - 1, 2 ** k,
                                                2 ** k + 1) if v <= 136]
    qlens[4:4 + len(read_ms)] = np.array(read_ms) + (n - 1)
    t_q, l_q = torch.from_numpy(qtoks).to(dev), torch.from_numpy(qlens).to(dev)
    agree_plain = fused_profile.fused_profile_plain(t_q, l_q, imr, tie, protos,
                                                    dim=space.dim)
    for bb_p, cl_p in ((fused_profile.DEFAULT_BB,
                        fused_profile.DEFAULT_CLUSTER), (32, 2), (16, 8)):
        agree = fused_profile.fused_profile(t_q, l_q, imr, tie, protos,
                                            dim=space.dim, bb=bb_p,
                                            cluster=cl_p)
        errs["fused_profile"] = max(errs["fused_profile"], expect_equal(
            f"fused_profile bb={bb_p} cluster={cl_p}", agree, agree_plain))
    if int(agree.max()) <= space.threshold_bits:
        fail("fused_profile: no read reaches the threshold of its window")
    say(f"[parity] fused_profile == plain on 253 reads ({len(read_ms)} with "
        f"m at plane boundaries) x 1001 prototypes at bb/cluster "
        f"{fused_profile.DEFAULT_BB}/{fused_profile.DEFAULT_CLUSTER}, 32/2 "
        f"and 16/8 (bit-exact; max agreement {int(agree.max())} of "
        f"{space.dim})")
    # The serving path's cohorts: reads padded to a bucket width, rows of
    # length 0 past the live reads, at every tiling that fits the width.
    for width, live in ((256, (150, 100, 256, 17)), (2048, (1500, 100,
                                                            2048, 150))):
        b_tok = np.zeros((256, width), np.int32)
        b_len = np.zeros(256, np.int32)
        for i in range(200):
            n_i = live[i % len(live)]
            s_i = int(rng.integers(0, 8192 - n_i))
            b_tok[i, :n_i] = wins[i % 256, s_i:s_i + n_i]
            b_len[i] = n_i
        t_b, l_b = torch.from_numpy(b_tok).to(dev), torch.from_numpy(b_len).to(dev)
        errs["hdc_encoder"] = max(errs["hdc_encoder"], expect_equal(
            f"hdc_encoder cohort L={width}",
            hdc_encoder.hdc_encode(t_b, l_b, imr, tie),
            hdc_encoder.hdc_encode_plain(t_b, l_b, imr, tie)))
        want_b = fused_profile.fused_profile_plain(t_b, l_b, imr, tie,
                                                   protos, dim=space.dim)
        fit = [(bb_p, cl_p) for bb_p in fused_profile.BATCH_TILES
               for cl_p in fused_profile.CLUSTER_SIZES
               if fused_profile.smem_bytes(bb_p, cl_p, width, n, alphabet, w)
               <= fused_profile.MAX_SMEM_BYTES]
        for bb_p, cl_p in fit:
            errs["fused_profile"] = max(errs["fused_profile"], expect_equal(
                f"fused_profile cohort L={width} bb={bb_p} cluster={cl_p}",
                fused_profile.fused_profile(t_b, l_b, imr, tie, protos,
                                            dim=space.dim, bb=bb_p,
                                            cluster=cl_p), want_b))
        say(f"[parity] serving cohort L = {width} (200 reads of lengths "
            f"{'/'.join(map(str, live))}, 56 rows of length 0): hdc_encoder "
            f"== plain, fused_profile == plain at the {len(fit)} tilings "
            f"that fit ({' '.join(f'{a}/{c}' for a, c in fit)}) (bit-exact)")

    # The search kernels: the encoded windows plus random rows against the
    # same 1,001 prototypes, then a ragged W = 1,001 (a word tail in the
    # last 32-word step, rows not 16-byte aligned; a K tail for the bf16
    # entry's 64-wide tiles), then that W at an odd dim below 32 W.
    q_search = with_corner_rows(torch.cat([enc[:200], convert.words_to_tensor(
        rng.integers(0, 2 ** 32, (53, w), dtype=np.uint32), dev)]), protos)
    search_parity("D=40960", q_search.contiguous(), protos, space.dim, errs)
    p_rag = convert.words_to_tensor(rng.integers(
        0, 2 ** 32, (1001, 1001), dtype=np.uint32), dev)
    q_rag = with_corner_rows(convert.words_to_tensor(rng.integers(
        0, 2 ** 32, (253, 1001), dtype=np.uint32), dev), p_rag)
    search_parity("ragged W", q_rag.contiguous(), p_rag, 32 * 1001, errs)
    search_parity("dim != 32 W", q_rag.contiguous(), p_rag, 32 * 1001 - 7,
                  errs)

    # -- 3. main path at full width --------------------------------------
    config = ProfilerConfig(space=space, window=8192, batch_size=256,
                            backend="cuda_fused")
    t0 = time.perf_counter()
    sample = SyntheticSource(synth.CommunitySpec(
        num_species=NUM_SPECIES, genome_len=GENOME_LEN, seed=7),
        num_reads=NUM_READS)
    say(f"[main] community {NUM_SPECIES} species x {GENOME_LEN} bp, "
        f"{NUM_READS} reads of 150 bp (made in "
        f"{time.perf_counter() - t0:.1f} s)")
    session = ProfilingSession(config)
    zero_counts()
    t0 = time.perf_counter()
    db = session.build_refdb(sample.genomes)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    report = session.profile(sample)
    torch.cuda.synchronize()
    profile_s = time.perf_counter() - t0
    launches = read_counts()
    say(f"[main] build {build_s:.3f} s ({db.num_prototypes} prototypes, "
        f"{db.memory_bytes() / 1e6:.1f} MB AM) | profile {profile_s:.3f} s | "
        f"{NUM_READS / profile_s:.0f} reads/s")
    say(f"[main] launches {json.dumps(launches)}")
    if min(launches["hdc_encoder"], launches["fused_profile"]) < 1:
        fail(f"main path skipped a kernel: {launches}")
    m = score_profile(report.abundance, sample.true_abundance)
    say(f"[main] precision {m.precision:.3f} recall {m.recall:.3f} | "
        f"unmapped {report.unmapped_reads} multi {report.multi_reads} of "
        f"{report.total_reads} | top {report.top(3)}")
    if report.total_reads != NUM_READS or report.mapped_reads == 0 \
            or not np.isfinite(report.abundance).all():
        fail("main path report is empty or not finite")
    main_report = report.to_dict()
    med, secs = warm_profile(session, sample, db, main_report)
    say(f"[main] cuda_fused profile {warm_line(med, secs)} | {card}")

    # Kernel times and parity at the shapes the main path gave them:
    # a full 256-window build batch and a 256-read query batch.
    first = next(iter(sample.genomes.values()))
    bw, bl = window_tokens(first, 8192, 8192)
    t_bw = torch.from_numpy(bw[:256]).to(dev)
    l_bw = torch.from_numpy(bl[:256]).to(dev)
    t_rd = torch.from_numpy(sample.tokens[:256]).to(dev)
    l_rd = torch.from_numpy(sample.lengths[:256]).to(dev)
    kern = {
        "hdc_encoder": (lambda: hdc_encoder.hdc_encode(t_bw, l_bw, imr, tie),
                        lambda: hdc_encoder.hdc_encode_plain(t_bw, l_bw, imr,
                                                             tie)),
        "fused_profile": (
            lambda: fused_profile.fused_profile(
                t_rd, l_rd, imr, tie, db.prototypes, dim=space.dim,
                **session.backend.tiles),
            lambda: fused_profile.fused_profile_plain(
                t_rd, l_rd, imr, tie, db.prototypes, dim=space.dim)),
    }
    s, b_rd = db.num_prototypes, t_rd.shape[0]
    work = {
        "hdc_encoder": bound_ms(
            t_bw.numel() * 4 + l_bw.numel() * 4 + imr.numel() * 4 + w * 4
            + t_bw.shape[0] * w * 4, encoder_ops(bl[:256], n, w),
            int_rate=int_rate),
        "fused_profile": bound_ms(
            t_rd.numel() * 4 + b_rd * 4 + imr.numel() * 4 + w * 4
            + s * w * 4 + b_rd * s * 4,
            encoder_ops(sample.lengths[:256], n, w), 2 * b_rd * s * space.dim,
            tensor_rate=b1_rate, int_rate=int_rate),
    }
    rows = []
    sources = {"hdc_encoder": ("src/repro_torch/csrc/hdc_encoder.cu",
                               "src/repro/kernels/hdc_encoder.py:50"),
               "fused_profile": ("src/repro_torch/csrc/fused_profile.cu",
                                 "src/repro/kernels/fused_profile.py:148"),
               "hamming_am": ("src/repro_torch/csrc/hamming_am.cu",
                              "src/repro/kernels/hamming_am.py:24"),
               "am_matmul_packed": ("src/repro_torch/csrc/am_matmul.cu",
                                    "src/repro/kernels/am_matmul.py:31"),
               "am_matmul": ("src/repro_torch/csrc/am_matmul.cu",
                             "src/repro/kernels/am_matmul.py:31")}

    def time_row(name, kfn, pfn, bound, runs, library_ms=None) -> dict:
        errs[name] = max(errs[name], expect_equal(f"{name} main-path shape",
                                                  kfn(), pfn()))
        ms = cuda_time_ms(kfn, reps=10)
        plain_ms = cuda_time_ms(pfn, reps=1)
        b_ms, b_by = bound
        row = {"name": name, "route": "cuda", "source": sources[name][0],
               "replaces": sources[name][1], "launches": runs[name],
               "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms}
        lib = "" if library_ms is None else f", library {library_ms:.3f} ms"
        before = (f"before: {PRIOR_MS[name]:.3f} ms, PERF.md"
                  if name in PRIOR_MS else "a new entry")
        say(f"[time] {name}: {ms:.3f} ms/launch ({before}; plain "
            f"{plain_ms:.1f} ms, bound {b_ms:.4f} ms by {b_by}{lib}) | "
            f"{card}")
        rows.append(row)
        return row

    for name, (kfn, pfn) in kern.items():
        time_row(name, kfn, pfn, work[name], launches)
    one = db.prototypes[:1].contiguous()
    enc_ms = cuda_time_ms(lambda: fused_profile.fused_profile(
        t_rd, l_rd, imr, tie, one, dim=space.dim, **session.backend.tiles),
        reps=10)
    say(f"[time] fused_profile split at B=256, L=150, S={s}: encode "
        f"{enc_ms:.3f} ms (S=1) + search {rows[1]['ms'] - enc_ms:.3f} ms")
    if sweep:
        for bb in fused_profile.BATCH_TILES:
            for cl in fused_profile.CLUSTER_SIZES:
                if fused_profile.smem_bytes(bb, cl, 150, n, alphabet, w) > \
                        fused_profile.MAX_SMEM_BYTES:
                    continue
                ms = cuda_time_ms(lambda: fused_profile.fused_profile(
                    t_rd, l_rd, imr, tie, db.prototypes, dim=space.dim,
                    bb=bb, cluster=cl), reps=5)
                plan = ops.fused_tile_plan(b_rd, s, w, bb=bb, cluster=cl,
                                           read_len=150, sms=sms)
                active = fused_profile.max_active_clusters(bb, cl, 150, n, w)
                say(f"[sweep] fused_profile bb={bb} cluster={cl}: "
                    f"{ms:.3f} ms | {plan['tiles']} tiles x {plan['splits']} "
                    f"splits = {plan['tiles'] * plan['splits']} clusters, "
                    f"{active} fit at once")

    # -- 3b. the unfused search paths at full width -----------------------
    pm1_calls = [0]
    real_to_pm1 = ops.to_pm1

    def counted_to_pm1(packed):
        pm1_calls[0] += 1
        return real_to_pm1(packed)

    search_runs = {}
    for backend, kernel in (("cuda_packed", "hamming_am"),
                            ("cuda_matmul", "am_matmul_packed")):
        sess = ProfilingSession(ProfilerConfig(
            space=space, window=8192, batch_size=256, backend=backend))
        zero_counts()
        pm1_calls[0] = 0
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        ops.to_pm1 = counted_to_pm1
        try:
            t0 = time.perf_counter()
            rep = sess.profile(sample, refdb=db)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            ops.to_pm1 = real_to_pm1
        rise = torch.cuda.max_memory_allocated() - mem0
        runs = read_counts()
        search_runs[backend] = runs
        say(f"[search] {backend}: profile {secs:.3f} s | "
            f"{NUM_READS / secs:.0f} reads/s | launches {json.dumps(runs)} | "
            f"to_pm1 calls {pm1_calls[0]} | max_memory_allocated rise "
            f"{rise / 1e6:.1f} MB")
        if runs["hdc_encoder"] < 1 or runs[kernel] < 1 \
                or runs["fused_profile"] != 0 or runs["am_matmul"] != 0:
            fail(f"{backend} path did not run encoder + {kernel} alone: "
                 f"{runs}")
        if pm1_calls[0]:
            fail(f"{backend} profile expanded to +-1 with ops.to_pm1 "
                 f"{pm1_calls[0]} times")
        if rep.to_dict() != main_report:
            fail(f"{backend} report differs from cuda_fused's")
        med, secs = warm_profile(sess, sample, db, main_report)
        say(f"[search] {backend} profile {warm_line(med, secs)} | {card}")
    say("[search] cuda_packed and cuda_matmul reports == cuda_fused's "
        f"({NUM_READS} reads, {db.num_prototypes} prototypes)")

    zero_counts()
    res = session.classify_queries(session.encode_reads(t_rd, l_rd), db)
    runs = read_counts()
    fused_res = session.classify_batch(t_rd, l_rd, refdb=db).classification
    if runs["am_matmul_packed"] < 1:
        fail(f"cuda_fused.agreement did not launch am_matmul_packed: {runs}")
    if not (torch.equal(res.hits, fused_res.hits)
            and torch.equal(res.category, fused_res.category)):
        fail("cuda_fused.agreement hits differ from classify_batch's")
    say(f"[search] cuda_fused.agreement (am_matmul_packed) == classify_batch "
        f"on {b_rd} reads | launches {json.dumps(runs)}")

    q_rd = hdc_encoder.hdc_encode(t_rd, l_rd, imr, tie)
    protos_main = db.prototypes
    dim = space.dim
    slab = hamming_am.slab_protos(b_rd, s)
    if slab <= 0:
        fail(f"search slab: hamming_am_slab_protos returned {slab}")
    slabs, rows_b = -(-s // slab), _search.BLOCK_B
    say(f"[time] search tiling (hamming_am, am_matmul_packed) at B={b_rd}, "
        f"S={s}: {rows_b} reads x {slab} prototypes a block, "
        f"{slabs * -(-b_rd // rows_b)} blocks on {sms} SMs; a launch reads "
        f"the AM ({s * w * 4 / 1e6:.1f} MB) once and the packed reads "
        f"{slabs * b_rd * w * 4 / 1e6:.1f} MB (once a block, mostly L2)")

    # Library yardsticks on the pre-expanded +-1 operands (they do not pay
    # for the expansion; no path calls them).
    pm1_ms = cuda_time_ms(lambda: ops.to_pm1(protos_main), reps=3)
    q_pm, p_pm = ops.to_pm1(q_rd), ops.to_pm1(protos_main)
    k = q_pm.shape[1]
    say(f"[time] to_pm1 of the AM ({s} x {w} words -> {s} x {k} bf16, "
        f"{p_pm.numel() * 2 / 1e6:.1f} MB; off every path): {pm1_ms:.3f} ms "
        f"| {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    qf, pf = q_pm.float(), p_pm.float()
    f32_ms = cuda_time_ms(lambda: torch.matmul(qf, pf.T), reps=3)
    del qf, pf
    dots = 2 * am_matmul.am_matmul(q_pm, p_pm, dim=k) - k  # exact +-1 dots
    try:                               # exact: sums of +-1 below 2^24
        bf16_mm = torch.mm(q_pm, p_pm.T, out_dtype=torch.float32)
        if not torch.equal(bf16_mm.to(torch.int32), dots):
            fail("torch.mm bf16 -> float32 on the +-1 operands disagrees")
        bf16_ms = cuda_time_ms(lambda: torch.mm(
            q_pm, p_pm.T, out_dtype=torch.float32), reps=10)
        bf16_line = f"{bf16_ms:.3f} ms"
    except (RuntimeError, TypeError) as e:   # the library call refused
        bf16_ms = None
        bf16_line = f"refused ({str(e).splitlines()[0][:120]})"
    s8 = -(-s // 8) * 8                # _int_mm wants N a multiple of 8
    qi = q_pm.to(torch.int8)
    pi = torch.zeros((s8, k), dtype=torch.int8, device=dev)
    pi[:s] = p_pm.to(torch.int8)
    try:
        int_mm = torch._int_mm(qi, pi.T)
        if not torch.equal(int_mm[:, :s], dots):
            fail("torch._int_mm on the +-1 operands disagrees")
        i8_ms = cuda_time_ms(lambda: torch._int_mm(qi, pi.T), reps=10)
        i8_line = f"{i8_ms:.3f} ms"
    except RuntimeError as e:          # the library call refused the shape
        i8_ms = None
        i8_line = f"refused ({str(e).splitlines()[0][:120]})"
    del qi, pi, dots
    say(f"[time] library on the pre-expanded +-1 operands: torch.matmul "
        f"float32 (TF32 off) {f32_ms:.3f} ms | torch.mm bf16 -> float32 "
        f"{bf16_line} (the bf16 entry's yardstick) | torch._int_mm int8, S "
        f"padded to {s8}: {i8_line} (the yardstick of hamming_am and "
        f"am_matmul_packed) | {card}")

    search_bound = bound_ms((b_rd + s) * w * 4 + b_rd * s * 4,
                            tensor_ops=2 * b_rd * s * space.dim,
                            tensor_rate=b1_rate)
    time_row("hamming_am",
             lambda: hamming_am.hamming_am(q_rd, protos_main, dim=dim),
             lambda: hamming_am.hamming_am_plain(q_rd, protos_main, dim=dim),
             search_bound, search_runs["cuda_packed"], library_ms=i8_ms)
    packed_bound = bound_ms((b_rd + s) * w * 4 + b_rd * s * 4,
                            tensor_ops=2 * b_rd * s * space.dim,
                            tensor_rate=TENSOR_INT8_OPS_PER_S)
    time_row("am_matmul_packed",
             lambda: am_matmul.am_matmul_packed(q_rd, protos_main, dim=dim),
             lambda: am_matmul.am_matmul_packed_plain(q_rd, protos_main,
                                                      dim=dim),
             packed_bound, search_runs["cuda_matmul"], library_ms=i8_ms)
    say(f"[time] am_matmul_packed bound {packed_bound[0]:.4f} ms (2 B S D at "
        f"the 1,979 TOP/s int8 peak); the same function in hamming_am's b1 "
        f"formulation: {search_bound[0]:.4f} ms")
    time_row("am_matmul",
             lambda: am_matmul.am_matmul(q_pm, p_pm, dim=dim),
             lambda: am_matmul.am_matmul_plain(q_pm, p_pm, dim=dim),
             bound_ms((b_rd + s) * k * 2 + b_rd * s * 4,
                      tensor_ops=2 * b_rd * s * k,
                      tensor_rate=TENSOR_BF16_FLOP_PER_S),
             search_runs["cuda_matmul"],     # 0: no path calls the bf16 entry
             library_ms=bf16_ms if bf16_ms is not None else f32_ms)
    del q_pm, p_pm
    batch_ms = cuda_time_ms(lambda: ops.am_agreement(
        q_rd, protos_main, dim, "matmul"), reps=10)
    say(f"[time] one cuda_matmul search step (am_matmul_packed on the packed "
        f"words, no to_pm1) at B={b_rd}, S={s}: {batch_ms:.3f} ms | {card}")

    # -- 4. whole-report parity on the card ------------------------------
    small = SyntheticSource(synth.CommunitySpec(
        num_species=4, genome_len=200_000, seed=5), num_reads=2048)
    reports, dbs = {}, {}
    for backend in ("cuda_fused", "cuda_packed", "cuda_matmul", "reference"):
        sess = ProfilingSession(ProfilerConfig(
            space=space, window=8192, batch_size=256, backend=backend))
        dbs[backend] = sess.build_refdb(small.genomes)
        reports[backend] = sess.profile(small).to_dict()
    for backend in ("cuda_fused", "cuda_packed", "cuda_matmul"):
        if not torch.equal(dbs[backend].prototypes,
                           dbs["reference"].prototypes):
            fail(f"{backend} prototypes differ from the torch reference's")
        if reports[backend] != reports["reference"]:
            fail(f"{backend} report differs from the torch reference's")
        if not torch.equal(dbs[backend].proto_species,
                           dbs["reference"].proto_species):
            fail(f"{backend} species tags differ")
    r = reports["reference"]
    say(f"[report] cuda_fused == cuda_packed == cuda_matmul == reference on "
        f"the card: {dbs['reference'].num_prototypes} prototypes, "
        f"{r['total_reads']} reads, unmapped {r['unmapped_reads']}, multi "
        f"{r['multi_reads']}")

    # -- 5. the profile_run CLI on the card ------------------------------
    out_dir = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    driven = {b: run_cli(b, out_dir) for b in ("cuda_packed",
                                                  "cuda_matmul")}
    if driven["cuda_packed"] != driven["cuda_matmul"]:
        fail("profile_run reports differ between cuda_packed and cuda_matmul")
    say("[cli] profile_run --synthetic: cuda_packed and cuda_matmul "
        "report JSONs are equal")

    # -- 6. the serving path at full width --------------------------------
    t0 = time.perf_counter()
    serving_phase(config=config, sample=sample, db=db, session=session,
                  main_report=main_report, card=card, out_dir=out_dir,
                  zero_counts=zero_counts, read_counts=read_counts)
    say(f"[serve] serving phase {time.perf_counter() - t0:.1f} s")

    # -- 7. alphabets above 4 ----------------------------------------------
    t0 = time.perf_counter()
    alphabet_phase(space=space, rows=rows, card=card,
                   zero_counts=zero_counts, read_counts=read_counts)
    say(f"[alphabet] alphabet phase {time.perf_counter() - t0:.1f} s")

    # -- 8. the serving fleet -------------------------------------------------
    t0 = time.perf_counter()
    fleet_phase(config=config, sample=sample, db=db, card=card,
                zero_counts=zero_counts, read_counts=read_counts)
    say(f"[fleet] fleet phase {time.perf_counter() - t0:.1f} s")

    # -- 9. the sharded backend ---------------------------------------------
    t0 = time.perf_counter()
    shard_phase(config=config, sample=sample, db=db, main_report=main_report,
                card=card, out_dir=out_dir, zero_counts=zero_counts,
                read_counts=read_counts)
    say(f"[shard] shard phase {time.perf_counter() - t0:.1f} s")

    say(card)
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--shard-worker"]:
        sys.exit(shard_worker(sys.argv[2]))
    sys.exit(main())
