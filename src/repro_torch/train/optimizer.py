"""AdamW with a warmup-cosine schedule: counterpart of
:mod:`repro.train.optimizer`.

The moments are float32 whatever the parameter dtype, and the update is
computed in float32 and cast back on write (a bf16 parameter keeps an
implicit float32 master through the update path), one parameter at a
time in place, so no float32 copy of the whole gradient tree is made.

Weight decay follows ``repro``'s rule on its *stacked* leaves: a leaf of
rank >= 2 is decayed.  ``repro`` stacks each segment's layers on a
leading axis, so every block parameter is decayed (a layer's norm scale
``(d,)`` is a ``(L, d)`` leaf there, Hymba's ``branch_scale`` ``(L, 2)``),
and only the top-level 1-D leaves (``final_norm``, ``enc_norm``) escape.
The port keeps one tensor a layer (:func:`repro_torch.models.lm.
stacked_leaves` names the tensors of each leaf), so the rule is taken
from the stacked rank, not the tensor's.

The schedule's and the bias correction's scalars are computed on the
host in float32 numpy, as ``repro`` computes them in float32 on the
device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch import tree as tree_mod
from repro_torch.models import lm

F32 = np.float32


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def lr_at(step: int, oc: OptConfig) -> np.float32:
    """Linear warmup -> cosine decay to min_lr_frac * peak (float32)."""
    step = F32(step)
    warm = F32(oc.peak_lr) * step / F32(max(oc.warmup_steps, 1))
    t = np.clip((step - F32(oc.warmup_steps))
                / F32(max(oc.total_steps - oc.warmup_steps, 1)),
                F32(0), F32(1))
    cos = F32(oc.peak_lr) * (F32(oc.min_lr_frac) + F32(
        (1 - oc.min_lr_frac) * 0.5) * (F32(1) + np.cos(F32(np.pi) * t)))
    return F32(warm if step < oc.warmup_steps else cos)


def global_norm(tensors) -> torch.Tensor:
    """The float32 L2 norm of every tensor together (a 0-d tensor).  A
    DTensor's sum of squares is the whole tensor's, reduced over the
    ranks that hold its shards: the norm is the whole gradient's, as a
    plain tensor on every rank."""
    total = None
    for x in tensors:
        sq = full(torch.sum(torch.square(x.to(torch.float32))))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def full(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value as a plain tensor on every rank (a
    collective: every rank calls it); a plain tensor as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


@torch.no_grad()
def assign(dst: torch.Tensor, src) -> None:
    """Copy ``src`` (the whole value: a tensor or an array, the same on
    every rank) into ``dst``, a plain tensor or this rank's shard of a
    DTensor."""
    if isinstance(src, DTensor):
        dst.copy_(src.redistribute(dst.device_mesh, dst.placements))
        return
    src = torch.as_tensor(src)
    if isinstance(dst, DTensor):
        from repro_torch.distributed.param_specs import distribute_like
        src = distribute_like(src.to(dst.device, dst.dtype), dst)
    dst.copy_(src)


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """The factor ``repro``'s ``clip_by_global_norm`` multiplies into
    every gradient."""
    return torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float):
    """``(clipped grads, norm)``."""
    norm = global_norm(grads)
    scale = clip_scale(norm, max_norm)
    return [g * scale.to(g.dtype) for g in grads], norm


class AdamW(torch.optim.Optimizer):
    """``repro``'s ``adamw_update`` over an :class:`~repro_torch.models.
    lm.LM`'s parameters.

    ``num_steps`` is ``repro``'s ``state["step"]``: the schedule and the
    bias correction read it, and :meth:`step` advances it.  The moments
    live in ``self.state[p]["m"]`` / ``["v"]``; :meth:`moment_tree` and
    :meth:`load_moment_tree` carry them in ``repro``'s layout.
    """

    def __init__(self, model: "lm.LM", oc: OptConfig):
        self.oc = oc
        self.leaves = lm.stacked_leaves(model)
        decay, rest = [], []
        for leaf in self.leaves:
            matrix = leaf.ndim >= 2
            (decay if matrix and oc.weight_decay else rest).extend(
                leaf.params)
        groups = [{"params": ps, "decay": d}
                  for ps, d in ((decay, True), (rest, False)) if ps]
        super().__init__(groups, {})
        self.num_steps = 0
        for group in self.param_groups:
            for p in group["params"]:
                # zeros_like: a DTensor parameter's moments take its
                # placements
                self.state[p] = {
                    "m": torch.zeros_like(p, dtype=torch.float32),
                    "v": torch.zeros_like(p, dtype=torch.float32)}

    @torch.no_grad()
    def step(self, grads: dict | None = None) -> dict:
        """One AdamW step from each parameter's ``.grad`` (or from
        ``grads``, a parameter -> gradient map of any float dtype).
        Returns ``{"grad_norm": 0-d tensor, "lr": float32}``."""
        oc = self.oc
        params = [p for g in self.param_groups for p in g["params"]]
        gs = {p: (p.grad if grads is None else grads[p]) for p in params}
        gs = {p: torch.zeros_like(p) if g is None else g   # unused: zero
              for p, g in gs.items()}
        norm = global_norm(gs[p] for leaf in self.leaves
                           for p in leaf.params)
        scale = clip_scale(norm, oc.clip_norm)
        lr = lr_at(self.num_steps, oc)
        t = F32(self.num_steps) + F32(1)
        bc1 = F32(1) - F32(oc.b1) ** t
        bc2 = F32(1) - F32(oc.b2) ** t
        for group in self.param_groups:
            for p in group["params"]:
                g = gs[p].to(torch.float32) * scale
                st = self.state[p]
                m = st["m"].mul_(oc.b1).add_(g, alpha=1 - oc.b1)
                v = st["v"].mul_(oc.b2).add_(g.mul_(g), alpha=1 - oc.b2)
                u = (m / float(bc1)).div_(
                    torch.sqrt(v / float(bc2)).add_(oc.eps))
                pf = p.to(torch.float32)
                if group["decay"]:
                    u.add_(pf, alpha=oc.weight_decay)
                p.copy_(pf.sub_(u, alpha=float(lr)))
        self.num_steps += 1
        return {"grad_norm": norm, "lr": lr}

    # -- repro's layout -------------------------------------------------------

    def moment_tree(self) -> dict:
        """``{"m": tree, "v": tree}`` in ``repro``'s layout (segment
        leaves stacked), float32 tensors on the parameters' device."""
        return {name: tree_mod.nest(
            (leaf.path, leaf.gather(lambda p: self.state[p][name],
                                    torch.float32))
            for leaf in self.leaves) for name in ("m", "v")}

    @torch.no_grad()
    def load_moment_tree(self, moments: dict) -> None:
        """The inverse of :meth:`moment_tree` (any layout-true tensors or
        numpy arrays, copied onto each moment's device)."""
        for name in ("m", "v"):
            flat = dict(tree_mod.flatten(moments[name]))
            for leaf in self.leaves:
                whole = torch.as_tensor(flat[leaf.path])
                for i, p in enumerate(leaf.params):
                    assign(self.state[p][name],
                           whole[i] if leaf.stacked else whole)
