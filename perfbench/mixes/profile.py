"""Traffic driver ``profile``: offline samples through
``ProfilingSession.profile``, back to back.

Parameters (the cell's ``params``): ``samples`` samples of
``reads_per_sample`` reads of ``read_len`` bp, each from a seeded
abundance profile over ``present_fraction`` of the species, made in
set-up and profiled in turn until ``--seconds`` have passed.  Every call
is whole: the rate (reported as the end-to-end metric ``rate_metric``) is
the reads of all calls over the wall time from the first call's start to
the last call's end.  Warm-up
profiles two batches of the first sample (the cell's only shape).

With ``--trace 1`` the second call of the window is the traced stretch,
and the session records its metrics (``session_classify_batch_seconds``)
for the whole window.

The check (``check_reads`` reads, and ``check_per_launch`` prototypes of
every encode launch of the RefDB build, drawn from the seed): the sampled
prototypes against the reference's encode of their windows from the
genomes; the sampled reads' species scores against the
reference's; on every read of every call, hits against scores at the
threshold and the category against the hits; every call's report against
step 5 of the reference over the call's hits, with ``total_reads`` held
to the sample's size.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from perfbench import check as compare
from perfbench import generator, harness, system

#: Stream ids of the run's seed (``generator.rng_for``).
_SAMPLES, _CHECK = 10, 11


@dataclasses.dataclass
class State:
    sys: system.System
    samples: list[np.ndarray]
    log: harness.CallLog | None = None
    # (sample index, report, first and last index into log.calls)
    calls: list = dataclasses.field(default_factory=list)
    prototypes: torch.Tensor | None = None


def prepare(run: harness.Run) -> State:
    p = run.params
    metrics = None
    if run.trace:
        from repro_torch.obs import MetricsRegistry
        metrics = MetricsRegistry()
    sy = system.setup(run.config, run.seed, run.device, metrics=metrics)
    t0 = time.perf_counter()
    rng = generator.rng_for(run.seed, _SAMPLES)
    samples = []
    for _ in range(p["samples"]):
        ab = generator.abundance(rng, sy.orgs.shape[0], p["present_fraction"])
        toks, _ = generator.reads(rng, sy.orgs, ab, p["reads_per_sample"],
                                  p["read_len"], run.config["read_error_rate"])
        samples.append(toks)
    sy.timings["reads_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    warm = samples[0][:2 * run.config["batch_size"]]
    sy.session.profile((warm, np.full(len(warm), p["read_len"], np.int32)))
    _sync(run)
    sy.timings["warmup_s"] = time.perf_counter() - t0
    run.layer["refdb_build_s"] = sy.refdb_build_s
    run.layer["prototypes"] = sy.session.refdb.num_prototypes
    run.layer["registry"] = metrics
    run.log("set-up " + ", ".join(f"{k} {v:.3f}"
                                  for k, v in sy.timings.items()))
    return State(sy, samples)


def _sync(run: harness.Run) -> None:
    if run.device.startswith("cuda"):
        torch.cuda.synchronize()


def window(run: harness.Run, st: State) -> None:
    p = run.params
    session = st.sys.session
    st.log = harness.CallLog(session, keep_inputs=False, annotate=run.trace)
    lengths = np.full(p["reads_per_sample"], p["read_len"], np.int32)
    t_first = run.start_window()
    while True:
        k = len(st.calls)
        n0 = len(st.log.calls)
        src = (st.samples[k % len(st.samples)], lengths)
        if run.trace and k == 1:
            with run.stretch():
                rep = session.profile(src)
        else:
            rep = session.profile(src)
        st.calls.append((k % len(st.samples), rep, n0, len(st.log.calls)))
        elapsed = time.perf_counter() - t_first
        if elapsed >= run.seconds and (not run.trace or len(st.calls) > 1):
            break
    st.log.detach()
    reads = len(st.calls) * p["reads_per_sample"]
    run.metrics[p["rate_metric"]] = reads / elapsed
    run.attempted = len(st.calls)
    run.log(f"window: {len(st.calls)} calls, {reads} reads in "
            f"{elapsed:.3f} s")


def release(st: State) -> None:
    """Free the program's state but for what the check reads: the
    prototypes, the calls' reports and per-read classifications."""
    st.prototypes = st.sys.session.refdb.prototypes
    st.sys.session = None


def check(run: harness.Run, st: State) -> list[harness.Check]:
    return checks(run, st, compare.Reference(run.config, st.sys.genomes,
                                           run.device))


def checks(run: harness.Run, st: State, ref: compare.Reference,
           control: compare.Reference | None = None) -> list[harness.Check]:
    """Compare the window's outputs with ``ref``; with ``control``, the
    sampled reads' scores are the control's instead of the program's."""
    p = run.params
    rng = generator.rng_for(run.seed, _CHECK)
    words = compare.proto_words(ref, st.prototypes, rng, p["check_per_launch"])
    hit_rows = cat_rows = counts = 0
    gap = 0.0
    per_call = []
    for k, rep, i0, i1 in st.calls:
        parts = st.log.calls[i0:i1]
        sc = torch.cat([c.scores[:n] for c, n, _ in parts])
        hi = torch.cat([c.hits[:n] for c, n, _ in parts])
        ca = torch.cat([c.category[:n] for c, n, _ in parts])
        h, c = compare.chain(sc, hi, ca, ref.threshold)
        hit_rows, cat_rows = hit_rows + h, cat_rows + c
        want = hdc_report(hi, ref, p["reads_per_sample"])
        n_diff, g = compare.report_diff(rep, want)
        counts, gap = counts + n_diff, max(gap, g)
        per_call.append((k, sc))
    # A seeded sample of (call, read) pairs over the whole window.
    total = len(per_call) * p["reads_per_sample"]
    pick = np.sort(rng.choice(total, min(p["check_reads"], total),
                              replace=False))
    call_of, row_of = np.divmod(pick, p["reads_per_sample"])
    toks = np.stack([st.samples[per_call[c][0]][r]
                     for c, r in zip(call_of, row_of)])
    lens = np.full(len(toks), p["read_len"])
    want = ref.scores(toks, lens, st.prototypes)
    if control is not None:
        got = control.scores(toks, lens, st.prototypes)
    else:
        got = torch.stack([per_call[c][1][r] if r < len(per_call[c][1])
                           else torch.full_like(per_call[c][1][0], -1)
                           for c, r in zip(call_of, row_of)])
    return [harness.Check("proto_words", words, 0),
            harness.Check("score_rows", compare.rows_differ(got, want), 0),
            harness.Check("hit_rows", hit_rows, 0),
            harness.Check("category_rows", cat_rows, 0),
            harness.Check("report_counts", counts, 0),
            harness.Check("report_gap", gap, 1e-9)]


def hdc_report(hits: torch.Tensor, ref: compare.Reference, reads: int) -> dict:
    from perfbench.reference import hdc

    out = hdc.report(hits.cpu().numpy(),
                     np.full(ref.genomes.shape[0], ref.genomes.shape[1]))
    out["total_reads"] = reads
    return out
