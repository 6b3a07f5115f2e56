#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --sweep    # also time other fused-kernel tilings

Phases (each prints its own lines; any failure exits non-zero and prints
no result line):

1. setup     the card's name and power limit; builds the CUDA kernels from
             ``src/repro_torch/csrc`` with nvcc and prints the build time.
2. parity    each kernel against its plain torch version on the card, bit
             for bit, at the full width D = 40,960, n = 16: the encoder on
             256 windows of 8,192 tokens (one short, one with an even gram
             count) and on reads of lengths 0, 10, 150, 151 and 300; the
             fused kernel on 253 reads (a partial tail tile, even and zero
             gram counts) against 1,001 prototypes.
3. main path ``ProfilingSession(..., backend="cuda_fused")`` builds the
             RefDB of a 20 species x 4,000,000 bp synthetic community
             (~9.8k prototypes, ~50 MB) and profiles 32,768 reads of 150 bp,
             with every kernel launch counter set to 0 just before and read
             just after; then each kernel is timed and held against its
             plain version at the shapes that run gave it.
4. report    a 4 species x 200 kbp community, 2,048 reads: the cuda_fused
             report and prototypes equal the torch ``reference`` backend's
             on the card.

The last lines are one JSON object per kernel list and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

#: Peak rates for the bound (NVIDIA H100 SXM data sheet, at 700 W): HBM3
#: bandwidth, and the 67 T/s non-tensor 32-bit rate, taken for the 32-bit
#: integer and logic operations both kernels do.
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12

GENOME_LEN = 4_000_000
NUM_SPECIES = 20
NUM_READS = 32_768


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


def score_profile(est, truth, detect: float = 0.01) -> tuple[float, float]:
    called, present = np.asarray(est) >= detect, np.asarray(truth) > 0
    tp = int((called & present).sum())
    fp = int((called & ~present).sum())
    fn = int((~called & present).sum())
    return (tp / (tp + fp) if tp + fp else 0.0,
            tp / (tp + fn) if tp + fn else 0.0)


def encoder_ops(lengths, n: int, w: int) -> int:
    """Bind XORs plus one counter update per bit of every valid gram."""
    m = np.maximum(np.asarray(lengths, np.int64) - (n - 1), 0)
    return int(m.sum()) * w * ((n - 1) + 32)


def bound_ms(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


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
    from repro_torch.genomics import synth
    from repro_torch.kernels import _build, fused_profile, hdc_encoder
    from repro_torch.pipeline import (ProfilerConfig, ProfilingSession,
                                      SyntheticSource)

    dev = torch.device("cuda")
    card = card_line()

    # -- 1. setup --------------------------------------------------------
    say(f"[setup] card: {card}")
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
    errs = {"hdc_encoder": 0, "fused_profile": 0}

    # -- 2. kernel parity at full width ----------------------------------
    rng = np.random.default_rng(2206)
    wins = rng.integers(0, 4, (256, 8192)).astype(np.int32)
    wlens = np.full(256, 8192, np.int32)
    wlens[-1], wlens[-2] = 5000, 8191          # short tail; m = 8176 even
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
    say("[parity] hdc_encoder == plain on 256 x 8192 windows and reads of "
        "lengths 0/10/150/151/300 (bit-exact)")

    protos = torch.cat([enc, convert.words_to_tensor(rng.integers(
        0, 2 ** 32, (745, w), dtype=np.uint32), dev)]).contiguous()
    starts = rng.integers(0, 8192 - 151, 253)
    qtoks = np.stack([wins[i % 256, s:s + 151] for i, s in enumerate(starts)])
    qlens = np.full(253, 150, np.int32)
    qlens[:4] = [151, 0, 10, 15]               # even m, empty, short, m = 0
    t_q, l_q = torch.from_numpy(qtoks).to(dev), torch.from_numpy(qlens).to(dev)
    agree = fused_profile.fused_profile(t_q, l_q, imr, tie, protos,
                                        dim=space.dim)
    agree_plain = fused_profile.fused_profile_plain(t_q, l_q, imr, tie, protos,
                                                    dim=space.dim)
    errs["fused_profile"] = expect_equal("fused_profile", agree, agree_plain)
    if int(agree.max()) <= space.threshold_bits:
        fail("fused_profile: no read reaches the threshold of its window")
    say(f"[parity] fused_profile == plain on 253 reads x 1001 prototypes "
        f"(bit-exact; max agreement {int(agree.max())} of {space.dim})")

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
    hdc_encoder.hdc_encode.launches = 0
    fused_profile.fused_profile.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    db = session.build_refdb(sample.genomes)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    report = session.profile(sample)
    torch.cuda.synchronize()
    profile_s = time.perf_counter() - t0
    launches = {"hdc_encoder": hdc_encoder.hdc_encode.launches,
                "fused_profile": fused_profile.fused_profile.launches}
    say(f"[main] build {build_s:.3f} s ({db.num_prototypes} prototypes, "
        f"{db.memory_bytes() / 1e6:.1f} MB AM) | profile {profile_s:.3f} s | "
        f"{NUM_READS / profile_s:.0f} reads/s")
    say(f"[main] launches {json.dumps(launches)}")
    if min(launches.values()) < 1:
        fail(f"main path skipped a kernel: {launches}")
    precision, recall = score_profile(report.abundance, sample.true_abundance)
    say(f"[main] precision {precision:.3f} recall {recall:.3f} | unmapped "
        f"{report.unmapped_reads} multi {report.multi_reads} of "
        f"{report.total_reads} | top {report.top(3)}")
    if report.total_reads != NUM_READS or report.mapped_reads == 0 \
            or not np.isfinite(report.abundance).all():
        fail("main path report is empty or not finite")

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
            + t_bw.shape[0] * w * 4, encoder_ops(bl[:256], n, w)),
        "fused_profile": bound_ms(
            t_rd.numel() * 4 + b_rd * 4 + imr.numel() * 4 + w * 4
            + s * w * 4 + b_rd * s * 4,
            encoder_ops(sample.lengths[:256], n, w) + 3 * b_rd * s * w),
    }
    rows = []
    sources = {"hdc_encoder": ("src/repro_torch/csrc/hdc_encoder.cu",
                               "src/repro/kernels/hdc_encoder.py:50"),
               "fused_profile": ("src/repro_torch/csrc/fused_profile.cu",
                                 "src/repro/kernels/fused_profile.py:148")}
    for name, (kfn, pfn) in kern.items():
        errs[name] = max(errs[name], expect_equal(f"{name} main-path shape",
                                                  kfn(), pfn()))
        ms = cuda_time_ms(kfn, reps=10)
        plain_ms = cuda_time_ms(pfn, reps=1)
        b_ms, b_by = work[name]
        rows.append({"name": name, "route": "cuda", "source": sources[name][0],
                     "replaces": sources[name][1], "launches": launches[name],
                     "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
        say(f"[time] {name}: {ms:.3f} ms/launch (plain {plain_ms:.1f} ms, "
            f"bound {b_ms:.3f} ms by {b_by}) | {card}")
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
                say(f"[sweep] fused_profile bb={bb} cluster={cl}: "
                    f"{ms:.3f} ms")

    # -- 4. whole-report parity on the card ------------------------------
    small = SyntheticSource(synth.CommunitySpec(
        num_species=4, genome_len=200_000, seed=5), num_reads=2048)
    reports, dbs = {}, {}
    for backend in ("cuda_fused", "reference"):
        sess = ProfilingSession(ProfilerConfig(
            space=space, window=8192, batch_size=256, backend=backend))
        dbs[backend] = sess.build_refdb(small.genomes)
        reports[backend] = sess.profile(small).to_dict()
    if not torch.equal(dbs["cuda_fused"].prototypes, dbs["reference"].prototypes):
        fail("cuda_fused prototypes differ from the torch reference's")
    if reports["cuda_fused"] != reports["reference"]:
        fail("cuda_fused report differs from the torch reference's")
    if not torch.equal(dbs["cuda_fused"].proto_species,
                       dbs["reference"].proto_species):
        fail("species tags differ")
    r = reports["reference"]
    say(f"[report] cuda_fused == reference on the card: "
        f"{dbs['reference'].num_prototypes} prototypes, {r['total_reads']} "
        f"reads, unmapped {r['unmapped_reads']}, multi {r['multi_reads']}")

    say(card)
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
