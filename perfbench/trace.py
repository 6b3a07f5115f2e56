"""Reading a ``torch.profiler`` Chrome trace of one traced stretch.

The harness marks the stretch with a ``perfbench.window`` annotation and
each call into ``ProfilingSession.classify_batch`` with a
``perfbench.classify_batch`` annotation that carries the call's shapes.
From the trace this module takes:

* the device intervals (kernels, copies, sets) inside the stretch, their
  union (busy seconds) and the gaps between them;
* kernels by name, each attributed to the ``classify_batch`` call that
  launched it (the kernel's correlation id -> the launching runtime or
  driver call -> the annotation open on that thread at that time);
* the breakdown: the device operations that took most time, and the idle
  gaps by the host operation that covered them.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import re

WINDOW = "perfbench.window"
CALL = "perfbench.classify_batch"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_NO_OP = "host: no torch op"


@dataclasses.dataclass
class Kernel:
    name: str
    start: float          # seconds, trace clock
    dur: float
    call: dict | None     # the shapes of the classify_batch that launched it


@dataclasses.dataclass
class Trace:
    start: float
    end: float
    device: list[tuple[str, float, float]]   # (category, start, end), clipped
    kernels: list[Kernel]                    # inside the stretch
    calls: list[dict]                        # classify_batch calls inside it
    host_ops: list[tuple[str, float, float]]  # top-level CPU ops

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy_s(self) -> float:
        return sum(e - s for s, e in _union([(s, e) for _, s, e in
                                             self.device]))

    def kernel_time(self, pattern: str) -> float:
        rx = re.compile(pattern)
        return sum(k.dur for k in self.kernels if rx.search(k.name))

    def kernels_of(self, pattern: str) -> list[Kernel]:
        rx = re.compile(pattern)
        return [k for k in self.kernels if rx.search(k.name)]

    def breakdown(self, top: int = 10) -> dict:
        ops: dict[str, float] = {}
        for k in self.kernels:
            ops[short_name(k.name)] = ops.get(short_name(k.name), 0.0) + k.dur
        gaps: dict[str, float] = {}
        for gs, ge in self.gaps():
            covered = 0.0
            for name, s, e in self.host_ops:
                o = min(e, ge) - max(s, gs)
                if o > 0:
                    gaps[name] = gaps.get(name, 0.0) + o
                    covered += o
            if ge - gs > covered:
                gaps[_NO_OP] = gaps.get(_NO_OP, 0.0) + (ge - gs - covered)
        return {"device_ops": _top(ops, top), "idle_gaps": _top(gaps, top)}

    def gaps(self) -> list[tuple[float, float]]:
        out, t = [], self.start
        for s, e in _union([(s, e) for _, s, e in self.device]):
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.end > t:
            out.append((t, self.end))
        return out


def short_name(name: str) -> str:
    """A kernel's name without its template arguments and namespaces."""
    n = re.split(r"[<(]", name.replace("(anonymous namespace)::", "")
                 .removeprefix("void "))[0]
    return n.rsplit("::", 1)[-1]


def parse_call(name: str) -> dict:
    """The ``key=value`` fields of a classify_batch annotation."""
    return {k: int(v) for k, v in re.findall(r"(\w+)=(\d+)", name)}


def call_name(batch: int, read_len: int, grams: int, valid: int) -> str:
    return f"{CALL} B={batch} L={read_len} grams={grams} valid={valid}"


def _top(d: dict[str, float], n: int) -> list[list]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def _union(iv: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _top_level(ops: list[tuple[str, float, float, object]]
               ) -> list[tuple[str, float, float]]:
    """CPU ops not nested in another op of their thread."""
    out = []
    ends: dict[object, float] = {}
    for name, s, e, tid in sorted(ops, key=lambda o: (o[1], -o[2])):
        if s >= ends.get(tid, float("-inf")):
            out.append((name, s, e))
            ends[tid] = e
    return out


def read(path: str) -> Trace:
    """Parse the Chrome trace at ``path`` (times in seconds)."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    window = None
    device, kernels, annots, cpu_ops = [], [], [], []
    launches: dict[int, tuple[object, float]] = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        s = float(e["ts"]) * 1e-6
        d = float(e.get("dur", 0.0)) * 1e-6
        if cat == "user_annotation" and name == WINDOW:
            window = (s, s + d)
        elif cat in ("user_annotation", "gpu_user_annotation") \
                and name.startswith(CALL):
            if cat == "user_annotation":
                annots.append(((e.get("pid"), e.get("tid")), s, s + d,
                               parse_call(name)))
        elif cat in DEVICE_CATS:
            device.append((cat, s, s + d, name,
                           e.get("args", {}).get("correlation")))
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = ((e.get("pid"), e.get("tid")), s)
        elif cat == "cpu_op":
            cpu_ops.append((name, s, s + d, (e.get("pid"), e.get("tid"))))
    if window is None:
        raise ValueError(f"{path}: no {WINDOW!r} annotation in the trace")
    w0, w1 = window
    by_thread: dict[object, list] = {}
    for tid, s, e, call in annots:
        by_thread.setdefault(tid, []).append((s, e, call))
    for k, v in by_thread.items():
        v.sort(key=lambda a: a[0])
        by_thread[k] = ([a[0] for a in v], v)
    clipped, inside = [], []
    for cat, s, e, name, corr in device:
        cs, ce = max(s, w0), min(e, w1)
        if ce <= cs:
            continue
        clipped.append((cat, cs, ce))
        if cat == "kernel" and s >= w0 and e <= w1:
            inside.append(Kernel(name, s, e - s,
                                 _call_of(launches.get(corr), by_thread)))
    calls = [c for _, s, e, c in annots if s >= w0 and e <= w1]
    host = [(n, max(s, w0), min(e, w1))
            for n, s, e in _top_level(cpu_ops) if min(e, w1) > max(s, w0)]
    return Trace(w0, w1, clipped, inside, calls, host)


def _call_of(launch, by_thread) -> dict | None:
    if launch is None:
        return None
    tid, t = launch
    starts, spans = by_thread.get(tid, ([], []))
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and spans[i][0] <= t <= spans[i][1]:
        return spans[i][2]
    return None
