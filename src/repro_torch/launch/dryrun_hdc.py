"""Dry run of the paper's own workload: the Demeter HDC query step.

Counterpart of :mod:`repro.launch.dryrun_hdc`, on a fake process group of
256 (16x16) or 512 (2x16x16) ranks with ``meta`` tensors (see
:mod:`repro_torch.launch.dryrun`).  Reads are sharded over (pod, data)
and the HD dimension (packed words) over model; the query step is the
port's plain ``bundle_counts`` / ``binarize_majority`` /
``agreement_matmul``, run on each rank's shards under ``local_map`` with
``repro``'s in / out shardings, the collectives written out where GSPMD
inserts them in ``repro``:

  d_contract  -- prototypes D-sharded, agreement partials summed over
                 'model' (one all-reduce)
  proto_shard -- queries all-gathered over 'model', prototypes sharded
                 over S, scores land sharded over S
  query_a2a   -- encode D-sharded, then the packed queries reshard batch
                 over (data x model) by one all-to-all; prototypes
                 replicated

Each result holds the per-device shapes of the inputs and the output,
the argument / output bytes, the local FLOPs and the collectives by kind.

Usage:  python -m repro_torch.launch.dryrun_hdc [--multi-pod]
"""

from __future__ import annotations

import argparse
import json
import pathlib

import torch
import torch.distributed._functional_collectives as fc

from repro_torch.core import assoc_memory, encoder, item_memory
from repro_torch.core.hd_space import HDSpace
from repro_torch.distributed import param_specs, sharding
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import make_production_mesh

SPACE = HDSpace(dim=40960, ngram=16, z_threshold=5.0)
BATCH = 65536           # reads per query step (global)
READ_LEN = 152
NUM_PROTOS = 2048
VARIANTS = ("d_contract", "proto_shard", "query_a2a")


def shardings(variant: str, multi_pod: bool) -> dict:
    """``repro``'s in / out specs of the step: tokens, lengths, protos,
    out."""
    data = ("pod", "data") if multi_pod else ("data",)
    protos = {"d_contract": sharding.Spec((None, "model")),
              "query_a2a": sharding.Spec((None, None)),
              "proto_shard": sharding.Spec(("model", None))}[variant]
    out = {"d_contract": sharding.Spec((data, None)),
           "query_a2a": sharding.Spec((data + ("model",), None)),
           "proto_shard": sharding.Spec((data, "model"))}[variant]
    return {"tokens": sharding.Spec((data, None)),
            "lengths": sharding.Spec((data,)), "protos": protos, "out": out}


def build_query_step(variant: str, mesh):
    """The per-rank body: (tokens, lengths, protos) local shards -> this
    rank's block of the agreement scores."""
    im = item_memory.make_item_memory(SPACE)
    tie = item_memory.make_tie_break(SPACE)
    im_m = torch.empty_like(im, device="meta")
    tie_m = torch.empty_like(tie, device="meta")
    words = SPACE.num_words
    model = mesh.get_group("model")
    n_model = mesh.size(mesh.mesh_dim_names.index("model"))
    w = words // n_model

    def d_slice(q):
        """This rank's words of the packed queries (encoding is bitwise:
        each rank binarizes its own D range)."""
        r = mesh.get_local_rank("model")
        return q[:, r * w:(r + 1) * w]

    def query_step(tokens, lengths, protos):
        from repro_torch.core import bitops
        im_last = bitops.rho(im_m, SPACE.ngram - 1)
        counts, m = encoder.bundle_counts(tokens, lengths, im_m, im_last,
                                          n=SPACE.ngram, dim=SPACE.dim)
        q = encoder.binarize_majority(counts, m, tie_m)
        if variant == "d_contract":
            part = assoc_memory.agreement_matmul(
                d_slice(q), protos, w * 32)
            return fc.all_reduce(part, "sum", model)
        if variant == "proto_shard":
            q = fc.all_gather_tensor(d_slice(q).contiguous(), 1, model)
            return assoc_memory.agreement_matmul(q, protos, SPACE.dim)
        # query_a2a: the packed queries reshard batch over model
        qd = d_slice(q)
        b = qd.shape[0] // n_model
        send = qd.reshape(n_model, b, w).contiguous()
        recv = fc.all_to_all_single(send, None, None, model)
        q = recv.reshape(n_model, b, w).permute(1, 0, 2).reshape(b, words)
        return assoc_memory.agreement_matmul(q, protos, SPACE.dim)

    return query_step


def run(multi_pod: bool, variant: str = "d_contract") -> dict:
    dr.fake_group(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    from torch.distributed.tensor.experimental import local_map
    sh = shardings(variant, multi_pod)
    meta = {"tokens": torch.empty((BATCH, READ_LEN), dtype=torch.int32,
                                  device="meta"),
            "lengths": torch.empty((BATCH,), dtype=torch.int32,
                                   device="meta"),
            "protos": torch.empty((NUM_PROTOS, SPACE.num_words),
                                  dtype=torch.int32, device="meta")}
    args = {k: param_specs.distribute(v, mesh, sh[k])
            for k, v in meta.items()}
    step = local_map(
        build_query_step(variant, mesh),
        out_placements=sharding.placements(sh["out"], mesh),
        in_placements=tuple(sharding.placements(sh[k], mesh)
                            for k in ("tokens", "lengths", "protos")),
        device_mesh=mesh)
    with dr.counting() as (counter, comm):
        out = step(args["tokens"], args["lengths"], args["protos"])
    counts = dr._comm_counts(comm)
    coll = {c: dict(counter.coll[c], comm_debug_count=counts[c])
            for c in dr.COLLECTIVES}
    coll["total_link_bytes"] = sum(coll[c]["link_bytes"]
                                   for c in dr.COLLECTIVES)
    coll["total_result_bytes"] = sum(coll[c]["result_bytes"]
                                     for c in dr.COLLECTIVES)
    shapes = {k: list(v.to_local().shape) for k, v in args.items()}
    shapes["out"] = list(out.to_local().shape)
    for k, v in list(args.items()) + [("out", out)]:
        want = sharding.shard_shape(tuple(v.shape), sh[k], mesh)
        if tuple(shapes[k]) != want:
            raise AssertionError(f"{variant} {k}: shard {shapes[k]} is not "
                                 f"the spec's {want}")
    return {
        "variant": variant,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "ok": True,
        "shard_shapes": shapes,
        "memory": {"argument_size_in_bytes": dr.local_bytes(args),
                   "output_size_in_bytes": dr.local_bytes(out),
                   "peak_bytes": "not measured"},
        "cost": {"flops": float(counter.flops)},
        "collectives": coll,
    }


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    args = ap.parse_args(argv)
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    for mp in meshes:
        for variant in VARIANTS:
            res = run(mp, variant)
            tag = f"demeter_hdc.query.{variant}.{res['mesh']}"
            (out / f"{tag}.json").write_text(json.dumps(res, indent=1))
            kinds = {c: res["collectives"][c]["count"]
                     for c in dr.COLLECTIVES if res["collectives"][c]["count"]}
            print(f"[{tag}] OK out/dev={res['shard_shapes']['out']} "
                  f"args/dev={res['memory']['argument_size_in_bytes']:.3e}B "
                  f"flops/dev={res['cost']['flops']:.3e} "
                  f"link_bytes/dev="
                  f"{res['collectives']['total_link_bytes']:.3e} {kinds}",
                  flush=True)


if __name__ == "__main__":
    main()
