"""Mixture-of-Experts: top-k routing with grouped, capacity-bounded dispatch.

Counterpart of :mod:`repro.models.moe` (GShard-style one-hot einsum
dispatch): tokens are split into groups of ``group_size``; within each
group every token picks top-k experts, gets a position-in-expert by
cumulative sum (token-major, k-minor), and is dropped beyond the capacity
``C = ceil(group_size * k / E * capacity_factor)``.  Shared (always-on)
experts are a fused dense MLP.

The router runs in float32 (bf16 operands, float32 accumulation); top-k
breaks ties toward the lower expert index, as ``jax.lax.top_k`` does (a
stable sort, so both devices drop the same tokens); the combine weights
are rounded to bf16 even in a float32 model, as in ``repro``.
"""

from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor

from repro_torch.config import ModelConfig, MoEConfig
from repro_torch.distributed import sharding
from repro_torch.models import layers
from repro_torch.models.layers import Keys


def init_moe(keys: Keys, cfg: ModelConfig, m: MoEConfig) -> dict:
    d, dt = cfg.d_model, layers.param_dtype(cfg)
    ks = keys.split(5)
    std = d ** -0.5
    p = {
        "router": ks[0].normal((d, m.num_experts)).mul_(std),   # fp32
        "e_in": ks[1].scaled((m.num_experts, d, m.d_expert), std, dt),
        "e_out": ks[2].scaled((m.num_experts, m.d_expert, d),
                              m.d_expert ** -0.5, dt),
    }
    if cfg.glu:
        p["e_gate"] = ks[3].scaled((m.num_experts, d, m.d_expert), std, dt)
    if m.num_shared:
        p["shared"] = layers.init_mlp(ks[4], cfg, m.num_shared * m.d_expert)
    return p


def capacity(m: MoEConfig) -> int:
    c = math.ceil(m.group_size * m.top_k * m.capacity_factor / m.num_experts)
    return max(4, -(-c // 4) * 4)  # round up to a multiple of 4


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, ties toward
    the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _experts(dispatch, combine, xg, e_in, e_gate, e_out,
             cfg: ModelConfig) -> torch.Tensor:
    """Token exchange + expert FFN: (G, gs, E, C) dispatch / combine and
    (G, gs, d) tokens -> (G, gs, d)."""
    ein = torch.einsum("gtec,gtd->gecd", dispatch, xg)        # (G,E,C,d)
    ein = sharding.constrain_safe(ein, ("expert_group", "experts", None, None))
    h = torch.einsum("gecd,edf->gecf", ein, e_in)
    if e_gate is not None:
        h = layers.act_fn(cfg.act)(
            torch.einsum("gecd,edf->gecf", ein, e_gate)) * h
    else:
        h = layers.act_fn(cfg.act)(h)
    eout = torch.einsum("gecf,efd->gecd", h, e_out)           # (G,E,C,d)
    eout = sharding.constrain_safe(eout,
                                   ("expert_group", "experts", None, None))
    return torch.einsum("gecd,gtec->gtd", eout.to(xg.dtype),
                        combine.to(xg.dtype))


class _SumOver(torch.autograd.Function):
    """A sum over a process group whose result every rank holds: the
    gradient of each rank's part is the result's gradient as it is."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed._functional_collectives as fc
        return fc.all_reduce(x, "sum", group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _local_experts(dispatch, combine, xg, weights, cfg: ModelConfig):
    """:func:`_experts` of DTensors, as ``shard_map`` runs an
    expert-parallel FFN: each rank runs its expert groups' tokens
    through its experts, and the experts' partial outputs are summed
    over the mesh dimensions that split the experts.  DTensor's einsum
    rules merge a sharded expert axis into a product's batch, which some
    versions refuse."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = combine.device_mesh
    spec = sharding.safe_spec(tuple(combine.shape),
                              ("expert_group", None, "experts", None))
    place = sharding.placements(spec, mesh)            # (G, gs, E, C)
    groups = [isinstance(pl, Shard) and pl.dim == 0 for pl in place]
    experts = [isinstance(pl, Shard) and pl.dim == 2 for pl in place]
    tokens = [Shard(0) if g else Replicate() for g in groups]
    w_place = [Shard(0) if e else Replicate() for e in experts]
    # a rank's tokens meet only its experts, its experts only its tokens
    tokens_grad = [Partial() if e else pl for e, pl in zip(experts, tokens)]
    w_grad = [Partial() if g else pl for g, pl in zip(groups, w_place)]
    over = [mesh.get_group(i) for i, e in enumerate(experts) if e]

    def run(dispatch, combine, xg, e_in, e_gate, e_out):
        y = _experts(dispatch, combine, xg, e_in, e_gate, e_out, cfg)
        for group in over:
            y = _SumOver.apply(y, group)
        return y

    ws = tuple(None if w is None else w_place for w in weights)
    args = [t.redistribute(mesh, pl) for t, pl in
            ((dispatch, place), (combine, place), (xg, tokens))] + [
        None if w is None else w.redistribute(mesh, w_place)
        for w in weights]
    return local_map(
        run, out_placements=tokens,
        in_placements=(place, place, tokens) + ws,
        in_grad_placements=(place, place, tokens_grad) + tuple(
            None if w is None else w_grad for w in ws),
        device_mesh=mesh)(*args)


def moe_forward(p, x: torch.Tensor, cfg: ModelConfig, m: MoEConfig
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,S,d), aux_loss scalar)."""
    b, s, d = x.shape
    t = b * s
    gs = min(m.group_size, t)
    pad = (-t) % gs
    # DTensor cannot merge a sequence-sharded axis into the token axis:
    # gather the sequence first (GSPMD reshards seq -> group in one step)
    x = sharding.constrain_safe(x, ("batch", None, None))
    xt = x.reshape(t, d)
    if pad:
        xt = layers.pad_zeros(xt, 0, after=pad)
    g = xt.shape[0] // gs
    xg = xt.reshape(g, gs, d)
    xg = sharding.constrain_safe(xg, ("expert_group", None, None))
    f32 = torch.float32

    # Router: operands in the activations' dtype, float32 accumulation.
    logits = xg.to(f32) @ p["router"].to(xg.dtype).to(f32)   # (G, gs, E)
    probs = torch.softmax(logits, dim=-1)
    weights, idx = top_k(probs, m.top_k)                     # (G, gs, k)
    if m.router_scale:
        weights = weights / torch.clamp_min(
            weights.sum(dim=-1, keepdim=True), 1e-9)

    e = m.num_experts
    c = capacity(m)
    oh = torch.nn.functional.one_hot(idx, e).to(f32)         # (G, gs, k, E)
    # Position of each (token, k) slot within its expert queue (group-local).
    flat = oh.reshape(g, gs * m.top_k, e)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(g, gs, m.top_k, e)
    keep = (pos < c) & (oh > 0)
    cap_oh = (pos.to(torch.int32)[..., None]
              == torch.arange(c, device=x.device)).to(f32)
    cap_oh = cap_oh * keep[..., None].to(f32)                # (G,gs,k,E,C)

    combine = torch.einsum("gtk,gtkec->gtec", weights, cap_oh)  # (G,gs,E,C)
    combine = sharding.constrain_safe(
        combine.to(torch.bfloat16), ("expert_group", None, "experts", None))
    dispatch = (combine > 0).to(x.dtype)

    weights = (p["e_in"], p["e_gate"] if cfg.glu else None, p["e_out"])
    if isinstance(combine, DTensor):
        y = _local_experts(dispatch, combine, xg, weights, cfg)
    else:
        y = _experts(dispatch, combine, xg, *weights, cfg)

    y = y.reshape(-1, d)[:t].reshape(b, s, d)
    if m.num_shared:
        y = y + layers.apply_mlp(p["shared"], x, cfg)

    # Switch-style load-balancing aux loss.
    frac_tokens = oh.sum(dim=2).mean(dim=(0, 1))              # (E,)
    frac_probs = probs.mean(dim=(0, 1))                       # (E,)
    aux = (frac_tokens * frac_probs).sum() * e * m.aux_loss_coef
    return y, aux
