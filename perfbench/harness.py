"""One run of one cell: set-up, the measured window, the check, the result.

The flow is the same for every cell; what differs lives in the cell's
traffic driver (``mixes/<mix>.py``) and in the per-layer metric readers
(``metrics/<metric>.py``):

1. ``mix.prepare(run)`` makes the community and the traffic from the
   seed, builds the RefDB and warms the cell's own shapes (set-up).
2. ``mix.window(run, state)`` drives the program for ``--seconds`` and
   returns the end-to-end metrics; ``setup_s`` ends at its first timed
   call.  With ``--trace 1`` it also runs one short steady stretch under
   ``torch.profiler`` (:meth:`Run.stretch`), and the per-layer metrics
   are read instead of the end-to-end ones.
3. The device's peak memory is read, ``mix.release(state)`` frees the
   program's state, and ``mix.check(run, state)`` compares what the timed
   path produced with the plain reference (``perfbench/reference``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import time

import numpy as np
import torch

from perfbench import paths, trace as trace_mod

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclasses.dataclass
class Run:
    cell: str
    workload: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t_process: float
    metrics: dict = dataclasses.field(default_factory=dict)   # e2e, by name
    layer: dict = dataclasses.field(default_factory=dict)     # reader ctx
    attempted: int = 0
    failed: int = 0
    t_first: float | None = None
    traced: trace_mod.Trace | None = None
    _prof: object = None

    @property
    def params(self) -> dict:
        return self.workload["params"]

    def log(self, msg: str) -> None:
        print(f"[{self.cell}] {msg}", file=sys.stderr, flush=True)

    def start_window(self) -> float:
        """Mark the first timed call: set-up ends here."""
        self.t_first = time.perf_counter()
        return self.t_first

    def start_profiler(self) -> None:
        """Start ``torch.profiler`` (``--trace 1`` only)."""
        if not self.trace or self._prof is not None:
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        t0 = time.perf_counter()
        self._prof = profile(activities=acts, **_all_threads())
        self._prof.start()
        self.log(f"profiler started in {time.perf_counter() - t0:.1f} s")

    @contextlib.contextmanager
    def stretch(self, sync: bool = True):
        """The traced stretch, marked by a ``perfbench.window`` annotation
        in the profiler's trace (a no-op unless ``--trace 1``).  The
        profiler stops at the stretch's end and its trace is read."""
        if not self.trace:
            yield
            return
        from torch.profiler import record_function

        self.start_profiler()
        try:
            if sync and torch.cuda.is_available():
                torch.cuda.synchronize()
            with record_function(trace_mod.WINDOW):
                yield
                if sync and torch.cuda.is_available():
                    torch.cuda.synchronize()
        finally:
            self._prof.stop()
        path = paths.cache_dir() / "trace.json"
        t0 = time.perf_counter()
        self._prof.export_chrome_trace(str(path))
        self._prof = None
        self.traced = trace_mod.read(str(path))
        self.log(f"trace: {len(self.traced.kernels)} kernels in a "
                 f"{self.traced.window_s:.3f} s stretch, exported and read "
                 f"in {time.perf_counter() - t0:.1f} s")


def _all_threads() -> dict:
    """Profiler arguments that record every thread's operations (a
    source's reader runs on a thread of its own); none on a torch without
    the option."""
    try:
        cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        return {}
    return {"experimental_config": cfg}


class CallLog:
    """Watches ``ProfilingSession.classify_batch``, the one hot-path step
    both entry points drive, from outside the program: keeps each call's
    classification (for the check) and, when tracing, wraps the call in an
    annotation that carries its shapes (for the kernel readers)."""

    def __init__(self, session, *, keep_inputs: bool, annotate: bool):
        self.calls: list[tuple] = []
        ngram = session.space.ngram
        orig = session.classify_batch

        def classify_batch(tokens, lengths, **kw):
            if annotate:
                from torch.profiler import record_function

                lens = np.asarray(lengths)
                b, length = np.shape(tokens)
                grams = int(np.maximum(lens.astype(np.int64) - (ngram - 1),
                                       0).sum())
                valid = kw.get("num_valid") or b
                with record_function(trace_mod.call_name(b, length, grams,
                                                         valid)):
                    res = orig(tokens, lengths, **kw)
            else:
                res = orig(tokens, lengths, **kw)
            self.calls.append((res.classification, res.num_valid,
                               (tokens, lengths) if keep_inputs else None))
            return res

        session.classify_batch = classify_batch
        self._session = session

    def detach(self) -> None:
        self._session.__dict__.pop("classify_batch", None)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is the JAX package's or JAX's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def per_layer_names(bench: dict, cell: str) -> list[str]:
    """The per-layer metrics ``cell`` reports, as BENCHMARK.json lists
    them."""
    e2e = set(end_to_end_names(bench, cell))
    return [m["name"] for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


def end_to_end_names(bench: dict, cell: str) -> list[str]:
    return [m["name"] for m in bench["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]


def units(bench: dict) -> dict[str, str]:
    return {m["name"]: m["unit"]
            for m in bench["end_to_end"] + bench["per_layer"]}


def device_info(device: str) -> dict:
    if device.startswith("cuda"):
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *,
             device: str, t_process: float, bench: dict | None = None,
             workload: dict | None = None, config: dict | None = None
             ) -> tuple[dict, list[Check]]:
    """One run of ``cell``; returns the result line's object and the
    checks (also placed last in the object)."""
    bench = bench if bench is not None else paths.benchmark()
    workload = workload if workload is not None else paths.workload(cell)
    config = config if config is not None \
        else paths.config(workload["config"])
    mix = paths.mix(workload["mix"])
    run = Run(cell, workload, config, seed, seconds, trace, device,
              t_process)
    state = mix.prepare(run)
    mix.window(run, state)
    dev = device_info(device)
    if trace and run.traced is not None:
        dev["busy_s"] = run.traced.busy_s()
        dev["window_s"] = run.traced.window_s
    mix.release(state)
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    checks = mix.check(run, state)
    run.log(f"check took {time.perf_counter() - t0:.1f} s")
    unit = units(bench)
    metrics = {}
    if trace:
        ctx = dict(run.layer, trace=run.traced, config=config,
                   workload=workload)
        for name in per_layer_names(bench, cell):
            value = paths.metric(name).read(ctx)
            if value is not None:
                metrics[name] = {"value": value, "unit": unit[name]}
    else:
        values = dict(run.metrics,
                      setup_s=run.t_first - t_process)
        for name in end_to_end_names(bench, cell):
            metrics[name] = {"value": values[name], "unit": unit[name]}
    out = {"correct": all(c.ok for c in checks),
           "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": dev}
    if trace and run.traced is not None:
        out["breakdown"] = run.traced.breakdown()
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in checks}
    return out, checks
