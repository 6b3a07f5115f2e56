"""Elastic scaling: move a training job between mesh sizes.

Counterpart of :mod:`repro.distributed.elastic`.  Checkpoints store full
host arrays (:mod:`repro_torch.checkpoint.checkpointer`), so elasticity
reduces to (1) recomputing the specs for the new mesh and (2) rescaling
schedule-coupled quantities.  ``reshard_plan`` runs on the spec layer
(meshes as names and sizes, :class:`~repro_torch.distributed.sharding.
MeshShape` or a ``DeviceMesh``): it reports which leaves change their
spec and which lose a sharded axis, with ``repro``'s leaf keys.
"""

from __future__ import annotations

import dataclasses

from repro_torch import tree as tree_mod
from repro_torch.distributed import param_specs, sharding


@dataclasses.dataclass(frozen=True)
class ReshardReport:
    n_leaves: int
    changed: tuple[str, ...]          # leaves whose spec changed
    dropped_axes: tuple[str, ...]     # leaves that lost a sharded axis


def _key(path: tuple) -> str:
    """``repro``'s key: dict keys as they are, tuple indices as ``[i]``."""
    return "/".join(f"[{k}]" if isinstance(k, int) else str(k)
                    for k in path)


def _axes(spec) -> set:
    return {a for part in spec if part
            for a in (part if isinstance(part, tuple) else (part,))}


def reshard_plan(state_shapes, old_mesh, new_mesh, rules: sharding.Rules
                 ) -> tuple[dict, ReshardReport]:
    """New-mesh specs for a TrainState tree (``{"params", "opt": {"m",
    "v"}, "step"}``, leaves with a ``shape``) + the delta report."""
    old = param_specs.state_specs(state_shapes, old_mesh, rules)
    new = param_specs.state_specs(state_shapes, new_mesh, rules)
    changed, dropped = [], []
    new_flat = tree_mod.flatten(new)
    for (path, o), (_, n) in zip(tree_mod.flatten(old), new_flat):
        if o != n:
            changed.append(_key(path))
            if _axes(o) - _axes(n):
                dropped.append(_key(path))
    return new, ReshardReport(n_leaves=len(new_flat),
                              changed=tuple(changed),
                              dropped_axes=tuple(dropped))


def rescale_batch(global_batch: int, old_data_shards: int,
                  new_data_shards: int, *, keep_global: bool = True) -> int:
    """Elastic batch policy: keep the global batch (preferred — optimizer
    hyperparameters stay valid) as long as it divides the new data axis."""
    if keep_global:
        if global_batch % new_data_shards != 0:
            raise ValueError(
                f"global batch {global_batch} does not divide new data "
                f"axis {new_data_shards}; pick a microbatch-compatible size")
        return global_batch
    per = global_batch // old_data_shards
    return per * new_data_shards
