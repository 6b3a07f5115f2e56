"""Name-based specs and placements for parameter / optimizer / cache trees.

Counterpart of :mod:`repro.distributed.param_specs`, in two layers:

* the **spec** layer maps each leaf name (``wq``, ``w_in``, ``e_out``,
  ...) to logical axes and resolves them against a mesh and a rules table
  with ``repro``'s divisibility drop, giving ``repro``'s
  ``PartitionSpec`` as a tuple (:mod:`repro_torch.distributed.sharding`).
  It needs only the mesh's names and sizes, so it is held equal to
  ``repro``'s specs with no process group at all.  Stacked leading layer
  dims get a replicated prefix axis, as in ``repro``.
* the **placement** layer turns specs into DTensor placements on a
  ``DeviceMesh`` and places a model's parameters (:func:`distribute_lm`).

The port keeps one tensor a layer (:func:`repro_torch.models.lm.
stacked_leaves`), so a layer's tensor takes its stacked leaf's spec
without the leading ``None`` of the layer axis.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch import tree as tree_mod
from repro_torch.distributed.sharding import (Rules, Spec,
                                              _target, mesh_shape,
                                              placements, target_size)

# logical axes per parameter leaf name (unstacked rank)
PARAM_AXES: dict[str, tuple] = {
    "tok_embed": ("vocab", "fsdp"),
    "lm_head": ("fsdp", "vocab"),
    "wq": ("fsdp", "heads", None),
    "wk": ("fsdp", "kv_heads", None),
    "wv": ("fsdp", "kv_heads", None),
    "wo": ("heads", None, "fsdp"),
    "w_dkv": ("fsdp", None),
    "w_kr": ("fsdp", None),
    "w_uk": (None, "heads", None),
    "w_uv": (None, "heads", None),
    "w_in": ("fsdp", "ff"),
    "w_gate": ("fsdp", "ff"),
    "w_out": ("ff", "fsdp"),
    "router": (None, None),
    "e_in": ("experts", "fsdp", None),
    "e_gate": ("experts", "fsdp", None),
    "e_out": ("experts", None, "fsdp"),
    "in_proj": ("fsdp", None),
    "out_proj": (None, "fsdp"),
    "conv_w": (None, None),
    "conv_b": (None,),
    "a_log": (None,),
    "d_skip": (None,),
    "dt_bias": (None,),
    "scale": (None,),
    "bias": (None,),
    "branch_scale": (None,),
}

CACHE_AXES: dict[str, tuple] = {
    "k": ("batch", "kv_seq", "kv_heads", None),
    "v": ("batch", "kv_seq", "kv_heads", None),
    "c": ("batch", "kv_seq", None),
    "kr": ("batch", "kv_seq", None),
    "kpos": ("batch", "kv_seq"),
    "xk": ("batch", "kv_seq", "kv_heads", None),
    "xv": ("batch", "kv_seq", "kv_heads", None),
    "xkpos": ("batch", "kv_seq"),
    "conv": ("batch", None, None),
    "state": ("batch", "ssm_heads", None, None),
}


def resolve_leaf(shape: tuple[int, ...], axes: tuple, mesh,
                 rules: Rules) -> Spec:
    """``repro``'s ``_resolve_leaf``: a leaf's spec, each axis kept only
    where its mesh size is above 1 and divides the dimension."""
    mesh = mesh_shape(mesh)
    ndim = len(shape)
    if ndim > len(axes):                 # stacked (scan) leading dims
        axes = (None,) * (ndim - len(axes)) + tuple(axes)
    axes = axes[:ndim]
    out = []
    for dim, ax in zip(shape, axes):
        target = _target(mesh, rules, ax)
        size = target_size(mesh, target)
        out.append(target if target is not None and dim % max(size, 1) == 0
                   and size > 1 else None)
    return Spec(out)


def leaf_name(path: tuple) -> str:
    """The last string key of a path (``repro``'s ``_leaf_name``)."""
    for entry in reversed(path):
        if isinstance(entry, str):
            return entry
    return ""


def tree_specs(tree, mesh, rules: Rules, table: dict[str, tuple],
               default: tuple = ()) -> dict:
    """A tree of tensors (any objects with ``.shape``, in ``repro``'s
    layout) -> the same tree of specs."""
    return tree_mod.nest(
        (path, resolve_leaf(tuple(leaf.shape),
                            table.get(leaf_name(path), default), mesh, rules))
        for path, leaf in tree_mod.flatten(tree))


def param_specs(params, mesh, rules: Rules) -> dict:
    return tree_specs(params, mesh, rules, PARAM_AXES)


def state_specs(state: dict, mesh, rules: Rules) -> dict:
    """TrainState ``{params, opt{m, v}, step}`` specs (opt mirrors
    params)."""
    return {"params": param_specs(state["params"], mesh, rules),
            "opt": {"m": param_specs(state["opt"]["m"], mesh, rules),
                    "v": param_specs(state["opt"]["v"], mesh, rules)},
            "step": Spec()}


def cache_specs(caches, mesh, rules: Rules):
    return tree_specs(caches, mesh, rules, CACHE_AXES)


def batch_specs(batch: dict, mesh, rules: Rules) -> dict:
    """Input batches: first dim is batch, everything else replicated."""
    return {k: resolve_leaf(tuple(v.shape),
                            ("batch",) + (None,) * (len(v.shape) - 1),
                            mesh, rules) for k, v in batch.items()}


# -- placements ------------------------------------------------------------------

def layer_spec(leaf, mesh, rules: Rules) -> Spec:
    """The spec of one of ``leaf``'s tensors (a
    :class:`~repro_torch.models.lm.Leaf`): the stacked leaf's spec
    without its layer axis."""
    p = leaf.params[0]
    shape = ((len(leaf.params),) if leaf.stacked else ()) + tuple(p.shape)
    spec = resolve_leaf(shape, PARAM_AXES.get(leaf_name(leaf.path), ()),
                        mesh, rules)
    return Spec(spec[1:]) if leaf.stacked else spec


def distribute(x: torch.Tensor, mesh, spec: Spec):
    """``x`` (the same on every rank) as a DTensor of ``spec`` on
    ``mesh``: each rank keeps its own shard, nothing is sent."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    place = placements(spec, mesh)
    dt = distribute_tensor(x, mesh, place, src_data_rank=None)
    # a shard of its own, so the full tensor can go
    return DTensor.from_local(dt.to_local().clone(), mesh, place,
                              run_check=False, shape=dt.shape,
                              stride=dt.stride())


def distribute_like(x: torch.Tensor, like):
    """``x`` (the whole value, the same on every rank) placed as the
    DTensor ``like`` is."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x, like.device_mesh, like.placements,
                             src_data_rank=None)


def distribute_lm(model, mesh, rules: Rules):
    """Place every parameter of ``model`` (an :class:`~repro_torch.models.
    lm.LM`) on ``mesh`` by its spec, one tensor at a time: each becomes a
    DTensor parameter holding this rank's shard (the full tensor is
    dropped once the shard is kept).  Returns ``model``."""
    from repro_torch.models import lm
    owners = {}
    for mod in model.modules():
        for name, p in mod.named_parameters(recurse=False):
            owners.setdefault(id(p), []).append((mod, name))
    for leaf in lm.stacked_leaves(model):
        if not leaf.params:
            continue
        spec = layer_spec(leaf, mesh, rules)
        for p in leaf.params:
            new = nn.Parameter(distribute(p.detach(), mesh, spec),
                               requires_grad=p.requires_grad)
            for mod, name in owners[id(p)]:
                setattr(mod, name, new)
    return model

