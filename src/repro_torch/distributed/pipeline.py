"""Pipeline parallelism over the 'pod' axis (GPipe fill-drain).

Counterpart of :mod:`repro.distributed.pipeline`.  Each rank of the
mesh's ``pod`` dimension owns a contiguous run of layers (one stage);
microbatches stream through the stages over ``num_microbatches +
n_stages - 1`` ticks, and each tick moves one activation to the next
stage with ``torch.distributed.batch_isend_irecv`` (``repro``'s ring
``ppermute``).  Only the last stage holds finished outputs; a masked
``all_reduce(SUM)`` over the pod group (``repro``'s ``psum``) makes them
replicated on every stage.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist


def pipeline_stages(n_layers: int, n_stages: int) -> list[tuple[int, int]]:
    """Contiguous [start, end) layer ranges per stage (balanced)."""
    base, rem = divmod(n_layers, n_stages)
    out, start = [], 0
    for s in range(n_stages):
        size = base + (1 if s < rem else 0)
        out.append((start, start + size))
        start += size
    return out


def _stage_slice(t: torch.Tensor, stage: int) -> torch.Tensor:
    """This stage's parameters: a DTensor sharded over the pod dimension
    holds them as its local block of one; a whole tensor is indexed."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        return t.to_local()[0]
    return t[stage]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


@torch.no_grad()
def pipelined_apply(stage_params, x: torch.Tensor, stage_fn: Callable, *,
                    mesh, axis: str = "pod",
                    num_microbatches: int) -> torch.Tensor:
    """Run ``x`` through all pipeline stages.

    Args:
      stage_params: tree of tensors with leading dim = n_stages (whole on
        every rank, or DTensors sharded over ``axis``).
      x: (B, ...) global batch, the same on every rank; split into
        microbatches along dim 0.
      stage_fn: (params_for_stage, microbatch) -> microbatch output (same
        shape: a homogeneous-stage pipeline).
      mesh: a ``DeviceMesh`` with an ``axis`` dimension.
    """
    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
    group = mesh.get_group(axis)
    stage = mesh.get_local_rank(axis)
    b = x.shape[0]
    assert b % num_microbatches == 0
    mb = b // num_microbatches
    micro = x.reshape(num_microbatches, mb, *x.shape[1:])
    params_me = _map(lambda t: _stage_slice(t, stage), stage_params)
    nxt_rank = dist.get_global_rank(group, (stage + 1) % n_stages)
    prv_rank = dist.get_global_rank(group, (stage - 1) % n_stages)

    buf = torch.zeros_like(micro[0])
    outputs = torch.zeros_like(micro)
    for t in range(num_microbatches + n_stages - 1):
        # stage 0 injects microbatch t; the others take what came in
        x_in = micro[min(t, num_microbatches - 1)] if stage == 0 else buf
        active = 0 <= t - stage < num_microbatches
        y = stage_fn(params_me, x_in) if active else buf
        if n_stages > 1:        # pass to the next stage (ring)
            recv = torch.empty_like(y)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, y.contiguous(), nxt_rank, group),
                dist.P2POp(dist.irecv, recv, prv_rank, group)])
            for r in reqs:
                r.wait()
        else:
            recv = y
        done = t - (n_stages - 1)
        if stage == n_stages - 1 and done >= 0:
            outputs[done] = y
        buf = recv
    # only the last stage holds real outputs: a masked sum replicates them
    outputs *= float(stage == n_stages - 1)
    dist.all_reduce(outputs, op=dist.ReduceOp.SUM, group=group)
    return outputs.reshape(b, *x.shape[1:])
