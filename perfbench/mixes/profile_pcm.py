"""Traffic driver ``profile_pcm``: the ``profile`` traffic on a simulated
in-memory associative memory (``pcm_sim``), held to the plain crossbar
reference (:mod:`perfbench.reference.crossbar`).

Set-up, the window and the release are ``mixes/profile.py``'s, with the
same parameters, so a traced run reads as the others do; set-up also
keeps the backend's ``program_seconds`` (the banks' programming at the
warm-up's first read), which the metric ``crossbar_program_s`` reads.

The check keeps ``profile``'s ``proto_words``, ``hit_rows``,
``category_rows``, ``report_counts`` and ``report_gap``, and replaces its
exact ``score_rows`` with two checks on a seeded sample of
``check_reads`` reads from ``check_batches`` whole batches of the window.
The reference encodes each of those batches whole (its read event's key
folds in the whole batch's digest), programs its own banks from the
program's prototypes (which ``proto_words`` holds to the genomes) and
reads the sampled rows:

* ``score_far``: (read, species) entries more than one count from the
  reference's.  Limit 0.
* ``score_near_share``: the share of entries off by exactly one.  Limit
  1e-3: float32 sums of noisy weights taken in another order may round a
  tile's count the other way at an ADC step's edge, which moves an
  agreement by one.

A read in a lower precision fails them (:mod:`perfbench.control_pcm`: the
reference's read with TF32 products, and the ideal device's noise-free
read, in the program's place).
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench import check as compare
from perfbench import generator, harness, paths
from perfbench.reference import crossbar

base = paths.mix("profile")
State = base.State
window = base.window
release = base.release
NEAR_SHARE = 1e-3


def prepare(run: harness.Run) -> State:
    st = base.prepare(run)
    run.layer["program_s"] = getattr(st.sys.session.backend,
                                     "program_seconds", None)
    mode = st.sys.session.config.threefry_partitionable
    if mode != run.config["threefry_partitionable"]:
        raise ValueError(f"the session draws in threefry_partitionable="
                         f"{mode}, the configuration states the other mode")
    return st


def check(run: harness.Run, st: State) -> list[harness.Check]:
    return checks(run, st, compare.Reference(run.config, st.sys.genomes,
                                           run.device))


def checks(run: harness.Run, st: State, ref: compare.Reference,
           control: str | None = None) -> list[harness.Check]:
    """Compare the window's outputs with ``ref``; with ``control``
    (``"tf32"`` or ``"ideal"``), the sampled reads' scores are the
    reference's read in that form instead of the program's."""
    p = run.params
    rng = generator.rng_for(run.seed, base._CHECK)
    words = compare.proto_words(ref, st.prototypes, rng, p["check_per_launch"])
    hit_rows = cat_rows = counts = 0
    gap = 0.0
    for _, rep, i0, i1 in st.calls:
        parts = st.log.calls[i0:i1]
        sc = torch.cat([c.scores[:n] for c, n, _ in parts])
        hi = torch.cat([c.hits[:n] for c, n, _ in parts])
        ca = torch.cat([c.category[:n] for c, n, _ in parts])
        h, c = compare.chain(sc, hi, ca, ref.threshold)
        hit_rows, cat_rows = hit_rows + h, cat_rows + c
        n_diff, g = compare.report_diff(
            rep, base.hdc_report(hi, ref, p["reads_per_sample"]))
        counts, gap = counts + n_diff, max(gap, g)
    far, near = score_gaps(run, st, ref, rng, control)
    return [harness.Check("proto_words", words, 0),
            harness.Check("score_far", far, 0),
            harness.Check("score_near_share", near, NEAR_SHARE),
            harness.Check("hit_rows", hit_rows, 0),
            harness.Check("category_rows", cat_rows, 0),
            harness.Check("report_counts", counts, 0),
            harness.Check("report_gap", gap, 1e-9)]


def _batch(run: harness.Run, st: State, call: int, j: int
           ) -> tuple[np.ndarray, np.ndarray, int]:
    """Batch ``j`` of window call ``call`` as the session read it: tokens
    and lengths padded to the batch size, and its valid rows."""
    p, b = run.params, run.config["batch_size"]
    toks = st.samples[st.calls[call][0]][j * b:(j + 1) * b]
    n = len(toks)
    padded = np.zeros((b, toks.shape[1]), toks.dtype)
    padded[:n] = toks
    lens = np.zeros(b, np.int64)
    lens[:n] = p["read_len"]
    return padded, lens, n


def score_gaps(run: harness.Run, st: State, ref: compare.Reference,
               rng: np.random.Generator, control: str | None
               ) -> tuple[int, float]:
    """``(entries off by more than one, share off by exactly one)`` of the
    sampled reads' species scores against the reference's."""
    p = run.params
    mode = run.config["threefry_partitionable"]
    options = run.config["backend_options"]
    dim = ref.space["dim"]
    protos = st.prototypes.to(run.device)
    banks = crossbar.program(protos, dim, crossbar.Device.from_options(
        options), mode)
    other = banks
    if control == "ideal":
        other = crossbar.program(protos, dim, crossbar.Device.from_options(
            dict(options, preset="ideal")), mode)
    batches = [(k, j) for k, (_, _, i0, i1) in enumerate(st.calls)
               for j in range(i1 - i0)]
    pick = rng.choice(len(batches), min(p["check_batches"], len(batches)),
                      replace=False)
    per = -(-p["check_reads"] // len(pick))
    far = near = entries = 0
    for k, j in (batches[i] for i in sorted(pick)):
        toks, lens, valid = _batch(run, st, k, j)
        queries = ref.encode(toks, lens)
        rows = np.sort(rng.choice(valid, min(per, valid), replace=False))
        want = crossbar.species_max(crossbar.read(queries, rows, banks),
                                    ref.rows)
        if control is None:
            scores = st.log.calls[st.calls[k][2] + j][0].scores
            got = scores[torch.from_numpy(rows).to(scores.device)]
        else:
            got = crossbar.species_max(crossbar.read(
                queries, rows, other,
                "tf32" if control == "tf32" else "float32"), ref.rows)
        entries += want.numel()
        if got.shape != want.shape:
            far += want.numel()
            continue
        diff = (got.to(want.device).long() - want.long()).abs()
        far += int((diff > 1).sum())
        near += int((diff == 1).sum())
    return far, near / max(entries, 1)
