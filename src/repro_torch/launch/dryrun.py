"""Dry run: run every (arch x shape x mesh) cell on a fake process group.

Counterpart of :mod:`repro.launch.dryrun`.  ``repro`` lowers and
compiles each cell's step function for 256 / 512 placeholder devices and
reads XLA's memory and cost analyses and the partitioned HLO.  The port
has no compiler to ask, so it runs the step function itself --
``make_train_step``, ``prefill`` or ``decode_step`` -- as rank 0 of a
*fake* process group of 256 or 512 ranks (collectives return at once and
move nothing), on ``meta`` tensors (shapes only: nothing is allocated or
computed) placed as DTensors by :mod:`repro_torch.distributed.
param_specs`.  It records, per device:

* ``memory``: argument and output bytes of this rank's shards, and the
  step's peak by ``MemTracker`` (this rank's tensors on ``meta``, by
  kind; XLA's temp bytes have no counterpart);
* ``cost``: FLOPs of the *local* ops (the ops DTensor runs on this
  rank's shards, counted with ``torch.utils.flop_counter``'s formulas;
  the global-shape ops of DTensor's sharding propagation are not run on
  any device and are left out);
* ``collectives``: counts by kind (``CommDebugMode``) and the result
  bytes of each (the local collective ops), with ``repro``'s ring
  link-bytes model (``_link_bytes``).

There is no HLO to parse: ``CommDebugMode`` is the counterpart of
``parse_collectives``.  The port's layers are a Python loop, so every
layer is counted and ``extra["roofline"]`` needs no two-depth fit (its
keys are ``repro``'s).  A fake CPU group has no all-to-all: DTensor
moves a shard from one dimension to another with an all-gather and a
local chunk there, and the counts show that.

Usage:
  python -m repro_torch.launch.dryrun --arch stablelm-3b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] \\
      [--out artifacts/dryrun_torch]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import time
import traceback

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import tree as tree_mod
from repro_torch.config import ModelConfig
from repro_torch.configs import all_archs, get_config
from repro_torch.configs import shapes as shapes_mod
from repro_torch.distributed import param_specs, sharding
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.serve import serve_step
from repro_torch.train import train_step as ts

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

#: torch's functional collectives -> ``repro``'s HLO kinds
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def _link_bytes(ctype: str, result_bytes: int, g: int) -> float:
    """Per-device bytes over ICI links (ring algorithms), from result size.

    all-gather: result is the gathered tensor; each device receives
      (g-1)/g of it.  all-reduce: reduce-scatter + all-gather = 2(g-1)/g.
    reduce-scatter: result is the scattered shard; sends (g-1) shards.
    all-to-all: result-sized exchange, (g-1)/g leaves the device.
    collective-permute: the whole result moves.
    """
    if g <= 1:
        return 0.0
    f = (g - 1) / g
    return {
        "all-gather": result_bytes * f,
        "all-reduce": 2.0 * result_bytes * f,
        "reduce-scatter": result_bytes * (g - 1),
        "all-to-all": result_bytes * f,
        "collective-permute": float(result_bytes),
    }[ctype]


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _local(t):
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def local_bytes(tree) -> int:
    """Bytes of this rank's shards of every tensor of a tree."""
    return sum(_nbytes(_local(t)) for _, t in tree_mod.flatten(tree))


def _group_size(name: str, args) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    group = args[-1]
    if isinstance(group, str):
        return _resolve_process_group(group).size()
    return int(group.size())


class LocalCounter(TorchDispatchMode):
    """Counts what this rank runs: the FLOPs of the ops on local tensors
    (DTensor-level calls are passed on to DTensor, whose local ops come
    back here) and the result bytes of each collective.  DTensor's
    sharding propagation runs ops at the global shapes on ``meta`` to
    learn output shapes; those run on no device and are not counted."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.flops = 0
        self.by_op: dict[str, int] = {}
        self.coll = {c: {"count": 0, "result_bytes": 0, "link_bytes": 0.0}
                     for c in COLLECTIVES}
        self._quiet = 0

    @contextlib.contextmanager
    def quiet(self):
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._quiet:
            return out
        packet = func._overloadpacket
        name = packet.__name__
        if name in _KINDS:
            kind = _KINDS[name]
            g = _group_size(name, args)
            nbytes = sum(_nbytes(t) for _, t in tree_mod.flatten(
                out if isinstance(out, (tuple, list)) else (out,)))
            c = self.coll[kind]
            c["count"] += 1
            c["result_bytes"] += nbytes
            c["link_bytes"] += _link_bytes(kind, nbytes, g)
        elif packet in self.registry:
            n = int(self.registry[packet](*args, **kwargs, out_val=out))
            self.flops += n
            self.by_op[name] = self.by_op.get(name, 0) + n
        return out


@contextlib.contextmanager
def counting():
    """A :class:`LocalCounter` and ``CommDebugMode`` around a step, with
    DTensor's global-shape propagation kept out of the counts."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.distributed.tensor.debug import CommDebugMode
    counter = LocalCounter()
    orig = ShardingPropagator._propagate_tensor_meta_non_cached

    def propagate(self, *a, **k):
        with counter.quiet():
            return orig(self, *a, **k)

    ShardingPropagator._propagate_tensor_meta_non_cached = propagate
    try:
        with CommDebugMode() as comm, counter:
            yield counter, comm
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig


def _comm_counts(comm) -> dict:
    out = {c: 0 for c in COLLECTIVES}
    for op, n in comm.get_comm_counts().items():
        name = getattr(op, "__name__", str(op)).split(".")[-1]
        if name in _KINDS:
            out[_KINDS[name]] += int(n)
    return out


@dataclasses.dataclass
class CellResult:
    arch: str
    shape: str
    mesh: str
    ok: bool
    seconds: float
    skip_reason: str = ""
    error: str = ""
    memory: dict = dataclasses.field(default_factory=dict)
    cost: dict = dataclasses.field(default_factory=dict)
    collectives: dict = dataclasses.field(default_factory=dict)
    extra: dict = dataclasses.field(default_factory=dict)


def _rules_for(kind: str) -> sharding.Rules:
    return {"train": sharding.TRAIN_RULES,
            "prefill": sharding.PREFILL_RULES,
            "decode": sharding.DECODE_RULES}[kind]


def _place(tree, mesh, specs):
    flat = dict(tree_mod.flatten(specs))
    return tree_mod.nest((p, param_specs.distribute(t, mesh, flat[p]))
                         for p, t in tree_mod.flatten(tree))


def fake_group(world: int) -> None:
    """Make the default process group a fake one of ``world`` ranks (this
    process is rank 0); collectives on it return at once."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def run_step(cfg: ModelConfig, shape: shapes_mod.ShapeSpec, mesh, *,
             microbatches: int = 1):
    """Run one cell's step function on ``meta`` DTensors placed on
    ``mesh``.  Returns ``(arguments, run)``: the step's argument tree and
    a thunk that runs the step and returns its outputs."""
    rules = _rules_for(shape.kind)
    specs = shapes_mod.input_specs(cfg, shape)
    batch = _place(specs, mesh, param_specs.batch_specs(specs, mesh, rules))

    if shape.kind == "train":
        tc = ts.TrainConfig(microbatches=microbatches, loss_chunk=512,
                            q_chunk=512, kv_chunk=512, remat=True)
        state = ts.init_train_state(0, cfg, tc, device="meta", mesh=mesh,
                                    rules=rules)
        grad_sh = param_specs.state_specs(state.tree(), mesh,
                                          rules)["params"]
        step = ts.make_train_step(cfg, tc, grad_shardings=grad_sh)
        args = {"state": state.tree(), "batch": batch}

        def run():
            with sharding.use_rules(mesh, rules):
                new, metrics = step(state, batch)
            return {"state": new.tree(), "metrics": metrics}
        return args, run

    model = shapes_mod.param_specs(cfg)
    param_specs.distribute_lm(model, mesh, rules)
    # MemTracker hooks every module parameter's gradient; the steps below
    # run under no_grad, so nothing is recorded for them
    model.requires_grad_(True)
    if shape.kind == "prefill":
        fn = serve_step.make_prefill_step(cfg, max_len=shape.seq_len,
                                          q_chunk=512, kv_chunk=1024)
        args = {"params": model.tree(), "batch": batch}

        def run():
            with torch.no_grad(), sharding.use_rules(mesh, rules):
                kw = {k: v for k, v in batch.items() if k != "tokens"}
                logits, caches = fn(model, batch["tokens"], **kw)
                caches = _constrain_caches(caches, mesh)
            return {"logits": logits, "caches": caches}
        return args, run

    caches = shapes_mod.cache_specs(cfg, shape)
    caches = _place(caches, mesh, param_specs.cache_specs(caches, mesh,
                                                          rules))
    decode = serve_step.make_decode_step(cfg)
    args = {"params": model.tree(), "token": batch["token"],
            "caches": caches}

    def run():
        with torch.no_grad(), sharding.use_rules(mesh, rules):
            logits, new = decode(model, batch["token"], caches,
                                 shape.seq_len - 1)
        return {"logits": logits, "caches": new}
    return args, run


def _constrain_caches(caches, mesh):
    """Prefill's caches redistributed to the decode layout (``repro``'s
    out_shardings: ``DECODE_RULES`` cache specs)."""
    from torch.distributed.tensor import DTensor
    specs = dict(tree_mod.flatten(param_specs.cache_specs(
        caches, mesh, sharding.DECODE_RULES)))
    out = []
    for p, t in tree_mod.flatten(caches):
        if isinstance(t, DTensor):
            t = t.redistribute(mesh, sharding.placements(specs[p], mesh))
        out.append((p, t))
    return tree_mod.nest(out)


def lower_cell(cfg: ModelConfig, shape: shapes_mod.ShapeSpec, mesh) -> dict:
    """Run one cell once under the counters and ``MemTracker`` (this
    rank's tensors, by kind, at the step's peak).  Returns ``memory``,
    ``cost`` and ``collectives``."""
    from torch.distributed._tools.mem_tracker import MemTracker
    args, run = run_step(cfg, shape, mesh)
    tracker = MemTracker()
    with counting() as (counter, comm), tracker:
        outs = run()
    peak = max(tracker.get_tracker_snapshot("peak").values(),
               key=lambda by_kind: by_kind["Total"])
    counts = _comm_counts(comm)
    coll = {c: dict(counter.coll[c]) for c in COLLECTIVES}
    for c in COLLECTIVES:
        coll[c]["comm_debug_count"] = counts[c]
    coll["total_link_bytes"] = sum(coll[c]["link_bytes"] for c in COLLECTIVES)
    coll["total_result_bytes"] = sum(coll[c]["result_bytes"]
                                     for c in COLLECTIVES)
    memory = {"argument_size_in_bytes": local_bytes(args),
              "output_size_in_bytes": local_bytes(outs),
              "peak_bytes": int(peak["Total"]),
              "peak_by_kind": {str(getattr(k, "value", k)): int(v)
                               for k, v in peak.items() if k != "Total"}}
    return {"memory": memory,
            "cost": {"flops": float(counter.flops),
                     "flops_by_op": dict(sorted(counter.by_op.items()))},
            "collectives": coll}


def run_cell(arch: str, shape_name: str, multi_pod: bool, *,
             n_layers: int | None = None) -> CellResult:
    mesh_name = "2x16x16" if multi_pod else "16x16"
    shape = shapes_mod.SHAPES[shape_name]
    cfg = get_config(arch)
    if n_layers is not None:
        kw = {"n_layers": n_layers}
        if cfg.is_encdec:
            kw["n_enc_layers"] = n_layers
        if cfg.n_dense_layers:
            kw["n_dense_layers"] = min(cfg.n_dense_layers, n_layers)
        cfg = dataclasses.replace(cfg, **kw)
    t0 = time.time()
    runs, reason = shapes_mod.applicable(cfg, shape)
    if not runs:
        return CellResult(arch, shape_name, mesh_name, ok=True, seconds=0.0,
                          skip_reason=reason)
    try:
        fake_group(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        got = lower_cell(cfg, shape, mesh)
        res = CellResult(arch, shape_name, mesh_name, ok=True,
                         seconds=time.time() - t0, **got)
        tokens = (shape.global_batch * shape.seq_len
                  if shape.kind in ("train", "prefill")
                  else shape.global_batch)
        res.extra["model_flops_6nd"] = 6 * cfg.active_param_count() * tokens
        if shape.kind != "train":   # decode/prefill: 2ND forward-only
            res.extra["model_flops_6nd"] //= 3
        res.extra["n_layers"] = cfg.n_layers
        res.extra["roofline"] = roofline(got, cfg)
        return res
    except Exception as e:
        return CellResult(arch, shape_name, mesh_name, ok=False,
                          seconds=time.time() - t0,
                          error=f"{type(e).__name__}: {e}\n"
                                + traceback.format_exc(limit=8))


def roofline(got: dict, cfg: ModelConfig) -> dict:
    """``repro``'s ``extrapolated_roofline`` keys, read off the full-depth
    run (every layer counted: no fit).  ``bytes`` is the step's
    arguments and outputs (no HBM traffic model) and ``transcendentals``
    is not counted: both not measured by this dry run."""
    coll = got["collectives"]
    return {
        "flops": got["cost"]["flops"],
        "bytes": "not measured",
        "transcendentals": "not measured",
        "link_bytes": coll["total_link_bytes"],
        "coll_counts": {c: coll[c]["count"] for c in COLLECTIVES},
        "coll_link": {c: coll[c]["link_bytes"] for c in COLLECTIVES},
        "per_layer_flops": "not measured",
        "depth_points": [cfg.n_layers],
    }


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut every arch to this depth")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    args = ap.parse_args(argv)

    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    archs = list(all_archs()) if (args.all or not args.arch) else [args.arch]
    shapes = (list(shapes_mod.SHAPES) if (args.all or not args.shape)
              else [args.shape])
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    n_fail = 0
    for arch in archs:
        for shape_name in shapes:
            for mp in meshes:
                res = run_cell(arch, shape_name, mp, n_layers=args.layers)
                tag = f"{res.arch}.{res.shape}.{res.mesh}"
                path = outdir / f"{tag}.json"
                path.write_text(json.dumps(dataclasses.asdict(res), indent=1))
                status = ("SKIP " + res.skip_reason[:40] if res.skip_reason
                          else ("OK" if res.ok else "FAIL " + res.error[:300]))
                flops = res.cost.get("flops", 0)
                arg = res.memory.get("argument_size_in_bytes", 0)
                link = res.collectives.get("total_link_bytes", 0)
                print(f"[{tag:55s}] {status}  run={res.seconds:6.1f}s "
                      f"flops/dev={flops:.3e} args/dev={arg:.3e}B "
                      f"link/dev={link:.3e}B", flush=True)
                n_fail += (not res.ok)
    print(f"dry-run complete, failures={n_fail}")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
