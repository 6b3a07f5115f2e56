"""The program's own spans in the traced stretch.

While a profiler records, the port names its work with ``RecordFunction``
ranges (``repro_torch.obs.span``): the Chrome trace's ``user_annotation``
events, and ``cpu_op`` events for the spans over host work alone, whose
names start with ``repro_torch.``, on the clock of the kernels.  From the trace that ``harness.Run.stretch`` leaves
at ``paths.cache_dir() / "trace.json"`` this module takes:

* the spans of the stretch's own thread (the main thread, which runs
  ``profile``), clipped to the ``perfbench.window`` stretch;
* the source's spans (``repro_torch.source.batch``) on the other threads,
  clipped alike;
* each kernel wholly inside the stretch, with the names of the program's
  spans open on its launching thread at its launch (the kernel's
  correlation id -> the runtime or driver call, as ``trace.read`` finds
  a kernel's ``classify_batch`` call, with ``trace._call_of``);
* the device's idle gaps (``Trace.gaps``) split by the innermost
  main-thread span over each instant.

A trace without the program's spans (a program that has none) gives
nothing, and the readers then report nothing.  The trace is parsed once
for all the readers of a run.

    python3 -m perfbench.spans [trace.json]

prints the split of one traced stretch's idle time, the device time under
each span and the source's time, as JSON.
"""

from __future__ import annotations

import bisect
import dataclasses
import functools
import json
import os
import sys

from perfbench import paths, trace as trace_mod

PREFIX = "repro_torch."
SPAN_CATS = ("user_annotation", "cpu_op")
SPECIES_MAX = "repro_torch.species_scores"
BATCH = "repro_torch.classify_batch"
NEXT_BATCH = "repro_torch.profile.next_batch"
SOURCE = "repro_torch.source.batch"
#: The session's own spans: the batch step, its upload and path, and the
#: children of ``profile`` (the species max and the threshold are the
#: classifier's; the bare ``profile`` holds the caller's work between
#: them).
SESSION = ("repro_torch.classify_batch", "repro_torch.to_device",
           "repro_torch.tokens_species_scores", "repro_torch.tokens_agreement",
           "repro_torch.encode")
SESSION_PREFIX = "repro_torch.profile."
NO_SPAN = "(no span)"
#: Seconds within which two times of the trace are one (it gives ns).
EPS = 1e-8


def is_session(name: str) -> bool:
    return name in SESSION or name.startswith(SESSION_PREFIX)


@dataclasses.dataclass
class Spans:
    main: list[tuple[str, float, float]]   # main thread, clipped, by start
    kernels: list[tuple[str, float, frozenset]]  # (name, dur, open spans)
    source: list[tuple[float, float]]      # source.batch, other threads

    def kernel_time(self, span: str) -> float:
        """Device seconds of the kernels launched inside ``span``."""
        return sum(d for _, d, open_ in self.kernels if span in open_)

    def count(self, span: str) -> int:
        return sum(1 for n, _, _ in self.main if n == span)

    def host_idle_s(self, gaps: list[tuple[float, float]]) -> float:
        """Idle seconds whose innermost main-thread span is one of the
        session's own (each instant once)."""
        return sum(v for n, v in self.idle_by_span(gaps).items()
                   if is_session(n))

    def idle_by_span(self, gaps: list[tuple[float, float]]
                     ) -> dict[str, float]:
        """Idle seconds by the innermost main-thread span over each
        instant; what no span covers is under ``NO_SPAN``."""
        pieces = _innermost(self.main)
        starts = [p[0] for p in pieces]
        out: dict[str, float] = {}
        for gs, ge in gaps:
            covered = 0.0
            i = max(bisect.bisect_right(starts, gs) - 1, 0)
            while i < len(pieces) and pieces[i][0] < ge:
                s, e, name = pieces[i]
                o = min(e, ge) - max(s, gs)
                if o > 0:
                    out[name] = out.get(name, 0.0) + o
                    covered += o
                i += 1
            if ge - gs > covered:
                out[NO_SPAN] = out.get(NO_SPAN, 0.0) + (ge - gs - covered)
        return out

    def source_split(self, gaps: list[tuple[float, float]]) -> dict:
        """The source's time on its thread: all of it, the part while
        the card is idle, and the part while the main thread waits for
        the next batch (seconds)."""
        src = trace_mod._union(self.source)
        wait = trace_mod._union([(s, e) for n, s, e in self.main
                                 if n == NEXT_BATCH])
        return {"source_batch_s": sum(e - s for s, e in src),
                "source_batch_idle_s": _overlap(src, gaps),
                "source_batch_in_next_batch_s": _overlap(src, wait)}


def _overlap(a: list[tuple[float, float]], b: list[tuple[float, float]]
             ) -> float:
    """Seconds where two lists of disjoint intervals meet."""
    return sum(max(0.0, min(e, be) - max(s, bs))
               for s, e in a for bs, be in b if s < be and e > bs)


def _innermost(spans: list[tuple[str, float, float]]
               ) -> list[tuple[float, float, str]]:
    """The time the spans of one thread cover, cut into pieces, each
    under its innermost span.  A thread's spans nest: a span that starts
    within ``EPS`` of the end of the one open before it follows it, and a
    child that ends past its parent by a rounding is cut at the parent's
    end."""
    pieces: list[tuple[float, float, str]] = []
    stack: list[tuple[str, float]] = []
    t = 0.0
    for name, s, e in sorted(spans, key=lambda x: (x[1], -x[2])):
        while stack and stack[-1][1] <= s + EPS:
            top, end = stack.pop()
            pieces.append((t, end, top))
            t = end
        if stack:
            pieces.append((t, s, stack[-1][0]))
            e = min(e, stack[-1][1])
        stack.append((name, e))
        t = s
    while stack:
        top, end = stack.pop()
        pieces.append((t, end, top))
        t = end
    return [p for p in pieces if p[1] > p[0]]


def read(path: str) -> Spans | None:
    """The program's spans in the stretch of the Chrome trace at ``path``
    (seconds); None without the stretch or without a program span."""
    st = os.stat(path)
    return _read(path, st.st_mtime_ns, st.st_size)


@functools.lru_cache(maxsize=1)
def _read(path: str, mtime_ns: int, size: int) -> Spans | None:
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    window = None
    spans: dict[object, list[tuple[str, float, float]]] = {}
    device, launches = [], {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        s = float(e["ts"]) * 1e-6
        d = float(e.get("dur", 0.0)) * 1e-6
        tid = (e.get("pid"), e.get("tid"))
        if cat in SPAN_CATS and name.startswith(PREFIX):
            spans.setdefault(tid, []).append((name, s, s + d))
        elif cat == "user_annotation" and name == trace_mod.WINDOW:
            window = (tid, s, s + d)
        elif cat == "kernel":
            device.append((name, s, d, e.get("args", {}).get("correlation")))
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (tid, s)
    if window is None or not spans:
        return None
    main, w0, w1 = window
    # trace._call_of's lookup, once a span name: {name: {thread: (starts,
    # [(start, end, name)])}}
    by_name: dict[str, dict] = {}
    for tid, v in spans.items():
        for name, s, e in sorted(v, key=lambda x: x[1]):
            starts, ivs = by_name.setdefault(name, {}).setdefault(
                tid, ([], []))
            starts.append(s)
            ivs.append((s, e, name))
    kernels = []
    for name, s, d, corr in device:
        if s >= w0 and s + d <= w1:
            launch = launches.get(corr)
            kernels.append((name, d, frozenset(
                n for n, by_thread in by_name.items()
                if trace_mod._call_of(launch, by_thread) is not None)))

    def clip(v):
        return [(n, max(s, w0), min(e, w1)) for n, s, e in v
                if min(e, w1) > max(s, w0)]

    inside = sorted(clip(spans.get(main, [])), key=lambda x: x[1])
    source = [(s, e) for tid, v in spans.items() if tid != main
              for n, s, e in clip(v) if n == SOURCE]
    return Spans(inside, kernels, source)


def load(ctx) -> Spans | None:
    """The spans of the run's traced stretch (None in a run without
    one)."""
    path = paths.cache_dir() / "trace.json"
    if ctx.get("trace") is None or not path.is_file():
        return None
    return read(str(path))


def summary(path: str) -> dict:
    """One stretch's idle split by span, device time under the program's
    spans, and the source's time against the idle and the main thread's
    wait for the next batch, in seconds."""
    tr = trace_mod.read(path)
    sp = read(path)
    gaps = tr.gaps()
    idle = sum(ge - gs for gs, ge in gaps)
    out = {"window_s": tr.window_s, "idle_s": idle,
           "batches": len(tr.calls)}
    if sp is None:
        return out
    split = sp.idle_by_span(gaps)
    names = sorted({n for n, _, _ in sp.main} |
                   {n for _, _, o in sp.kernels for n in o})
    host = sp.host_idle_s(gaps)
    out.update(
        host_idle_s=host,
        idle_share_under_host_spans=host / idle if idle else None,
        idle_share_under_a_span=(1.0 - split.get(NO_SPAN, 0.0) / idle)
        if idle else None,
        idle_by_span=dict(sorted(split.items(), key=lambda kv: -kv[1])),
        device_s_by_span={n: sp.kernel_time(n) for n in names},
        **sp.source_split(gaps))
    return out


if __name__ == "__main__":
    where = sys.argv[1] if len(sys.argv) > 1 else \
        str(paths.cache_dir() / "trace.json")
    print(json.dumps(summary(where), indent=1))
