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

from repro_torch.config import ModelConfig, MoEConfig
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


def moe_forward(p, x: torch.Tensor, cfg: ModelConfig, m: MoEConfig
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,S,d), aux_loss scalar)."""
    b, s, d = x.shape
    t = b * s
    gs = min(m.group_size, t)
    pad = (-t) % gs
    xt = x.reshape(t, d)
    if pad:
        xt = torch.nn.functional.pad(xt, (0, 0, 0, pad))
    g = xt.shape[0] // gs
    xg = xt.reshape(g, gs, d)
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
    combine = combine.to(torch.bfloat16)
    dispatch = (combine > 0).to(x.dtype)

    # Token exchange + expert FFN.
    ein = torch.einsum("gtec,gtd->gecd", dispatch, xg)        # (G,E,C,d)
    h = torch.einsum("gecd,edf->gecf", ein, p["e_in"])
    if cfg.glu:
        h = layers.act_fn(cfg.act)(
            torch.einsum("gecd,edf->gecf", ein, p["e_gate"])) * h
    else:
        h = layers.act_fn(cfg.act)(h)
    eout = torch.einsum("gecf,efd->gecd", h, p["e_out"])      # (G,E,C,d)
    y = torch.einsum("gecd,gtec->gtd", eout.to(x.dtype),
                     combine.to(x.dtype))

    y = y.reshape(-1, d)[:t].reshape(b, s, d)
    if m.num_shared:
        y = y + layers.apply_mlp(p["shared"], x, cfg)

    # Switch-style load-balancing aux loss.
    frac_tokens = oh.sum(dim=2).mean(dim=(0, 1))              # (E,)
    frac_probs = probs.mean(dim=(0, 1))                       # (E,)
    aux = (frac_tokens * frac_probs).sum() * e * m.aux_loss_coef
    return y, aux
