"""Mamba-2 (SSD, state-space duality) block -- chunked scan + decode step.

Counterpart of :mod:`repro.models.ssm`, after arXiv:2405.21060's minimal
SSD formulation: within chunks of length Q the quadratic
"attention-like" form runs as batched products; across chunks a linear
recurrence carries the (H, P, N) state.  The decode path is the O(1)
recurrent update.  Includes the depthwise causal conv on (x, B, C), the
gated RMSNorm, and the z-gate, matching mamba2's block.  Mixed-dtype
products promote as ``jnp.einsum`` does (bf16 with float32 -> float32).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.config import ModelConfig, SSMConfig
from repro_torch.distributed import sharding
from repro_torch.models import layers
from repro_torch.models.layers import Keys


def einsum(spec: str, *ops: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum`` over operands of mixed dtypes: promoted first."""
    dt = ops[0].dtype
    for o in ops[1:]:
        dt = torch.promote_types(dt, o.dtype)
    return torch.einsum(spec, *(o.to(dt) for o in ops))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def dims(cfg: ModelConfig, s: SSMConfig) -> dict:
    d_in = s.expand * cfg.d_model
    return dict(
        d_in=d_in,
        n_heads=d_in // s.head_dim,
        conv_dim=d_in + 2 * s.n_groups * s.d_state,
    )


def _linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    """``jnp.linspace(start, stop, num)`` in float32: ``start * (1 - t) +
    stop * t`` with ``t = i / (num - 1)``, the stop exact."""
    if num == 1:
        return np.asarray([start], np.float32)
    div = np.float32(num - 1)
    t = np.arange(num - 1, dtype=np.float32) / div
    out = (np.float32(start) * (np.float32(1) - t) + np.float32(stop) * t)
    return np.concatenate([out, [np.float32(stop)]]).astype(np.float32)


def init_ssm(keys: Keys, cfg: ModelConfig, s: SSMConfig) -> dict:
    d, dt_ = cfg.d_model, layers.param_dtype(cfg)
    dd = dims(cfg, s)
    d_in, h, conv_dim = dd["d_in"], dd["n_heads"], dd["conv_dim"]
    ks = keys.split(6)
    std = d ** -0.5
    dev, n = keys.device, keys.n

    def rows(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(dev).expand(n, -1).clone()

    a_log = torch.log(rows(_linspace_f32(1.0, 16.0, h)))
    dt_bias = torch.log(torch.expm1(rows(_linspace_f32(1e-3, 1e-1, h))))
    # in_proj emits [z (d_in), xBC (conv_dim), dt (H)]
    proj_out = d_in + conv_dim + h
    return {
        "in_proj": ks[0].scaled((d, proj_out), std, dt_),
        "conv_w": ks[1].scaled((s.d_conv, conv_dim), 0.1, dt_),
        "conv_b": keys.full((conv_dim,), 0.0, dt_),
        "a_log": a_log,
        "d_skip": keys.full((h,), 1.0),
        "dt_bias": dt_bias,
        "gate_norm": {"scale": keys.full((d_in,), 1.0)},
        "out_proj": ks[2].scaled((d_in, d), d_in ** -0.5, dt_),
    }


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv, width d_conv: (B, L, C) -> (B, L, C)."""
    k = w.shape[0]
    pad = layers.pad_zeros(xbc, 1, before=k - 1)
    out = 0
    for i in range(k):
        out = out + pad[:, i:i + xbc.shape[1], :] * w[i]
    return F.silu(out + b)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """(..., Q) -> (..., Q, Q): S[i,j] = sum_{k in (j, i]} a_k, -inf above diag."""
    q = a.shape[-1]
    # a positive dim: DTensor's cumsum rule misreads -1 and scans a
    # sharded last axis shard by shard
    cs = torch.cumsum(a, dim=a.ndim - 1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, -torch.inf)


def _split(p, x: torch.Tensor, cfg: ModelConfig, s: SSMConfig):
    dd = dims(cfg, s)
    d_in, h = dd["d_in"], dd["n_heads"]
    gn = s.n_groups * s.d_state
    zxbcdt = x @ p["in_proj"]
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in:d_in + dd["conv_dim"]]
    dt_raw = zxbcdt[..., d_in + dd["conv_dim"]:]
    return z, xbc, dt_raw, d_in, h, gn


def _ssd(xs, dt, bmat, cmat, a, *, chunk: int) -> torch.Tensor:
    """The chunked SSD scan: xs (B, L, H, P), dt (B, L, H), B / C
    (B, L, G, N), a (H,) -> y (B, L, H, P) (before the skip term)."""
    bsz, l, h, hd = xs.shape
    g, n = bmat.shape[2:]
    f32 = torch.float32
    hpg = h // g                    # heads per group for broadcasting B/C

    q = min(chunk, l)
    pad = (-l) % q

    def padl(t):
        return layers.pad_zeros(t, 1, after=pad)
    xs_, b_, c_, dt_ = map(padl, (xs, bmat, cmat, dt))
    lp = xs_.shape[1]
    nc = lp // q
    xs_ = xs_.reshape(bsz, nc, q, h, hd)
    b_ = b_.reshape(bsz, nc, q, g, n)
    c_ = c_.reshape(bsz, nc, q, g, n)
    dt_ = dt_.reshape(bsz, nc, q, h)

    adt = dt_ * a                                          # (B,nc,Q,H)
    acs = torch.cumsum(adt, dim=2)                         # (B,nc,Q,H)
    xdt = xs_ * dt_[..., None]

    # Intra-chunk (quadratic) term.
    lmat = torch.exp(_segsum(torch.movedim(adt, -1, 2)))   # (B,nc,H,Q,Q)
    bh = torch.repeat_interleave(b_, hpg, dim=3)           # (B,nc,Q,H,N)
    ch = torch.repeat_interleave(c_, hpg, dim=3)
    scores = einsum("bcqhn,bcshn->bchqs", ch, bh)          # (B,nc,H,Q,Q)
    y_diag = einsum("bchqs,bcshp->bcqhp", scores * lmat, xdt)

    # Chunk states + inter-chunk recurrence.
    decay_states = torch.exp(acs[:, :, -1:, :] - acs)      # (B,nc,Q,H)
    states = einsum("bcshn,bcsh,bcshp->bchpn",
                    bh, decay_states, xdt)                 # (B,nc,H,P,N)
    chunk_decay = torch.exp(acs[:, :, -1, :])              # (B,nc,H)

    carry = torch.zeros((bsz, h, hd, n), dtype=f32, device=xs.device)
    prev = []
    states = states.to(f32)
    for ci in range(nc):                      # emit state BEFORE chunk
        prev.append(carry)
        carry = carry * chunk_decay[:, ci, :, None, None] + states[:, ci]
    prev_states = torch.stack(prev, dim=1)                 # (B,nc,H,P,N)

    state_decay = torch.exp(acs)                           # (B,nc,Q,H)
    y_off = einsum("bcqhn,bchpn,bcqh->bcqhp",
                   ch, prev_states.to(ch.dtype), state_decay)

    return (y_diag + y_off).reshape(bsz, lp, h, hd)[:, :l]


def by_heads(fn, like, args, *, out_dim: int, **kw) -> torch.Tensor:
    """``fn(*tensors, **kw)`` of per-(batch, head) work.  ``args`` pairs
    each tensor with the dimension of its heads (or groups of heads).
    Plain tensors run as they are; DTensors as ``shard_map`` runs them:
    each rank its own batches (dim 0) and heads, split as ``like``'s
    are (groups split with them where they divide, else whole), under
    ``local_map``.  DTensor's einsum rules merge a sharded head axis
    into a product's batch, which some versions refuse."""
    if not isinstance(like, DTensor):
        return fn(*(t for t, _ in args), **kw)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = like.device_mesh
    batch = [isinstance(pl, Shard) and pl.dim == 0 for pl in like.placements]
    heads = [isinstance(pl, Shard) and pl.dim == 2 for pl in like.placements]
    ways = 1
    for i, hd in enumerate(heads):
        ways *= mesh.size(i) if hd else 1
    if any(t.shape[d] > 1 and t.shape[d] % ways for t, d in args):
        heads = [False] * len(heads)      # groups that cannot split: whole
    places, grads, local = [], [], []
    for t, d in args:
        rows = t.ndim > 1                              # has a batch dim
        split = t.shape[d] > 1                         # one group: whole
        pl = [Shard(0) if b and rows else Shard(d) if hd and split
              else Replicate() for b, hd in zip(batch, heads)]
        # a whole operand meets only this rank's batches and heads: the
        # rest of its gradient comes from the other ranks
        gr = [Partial() if isinstance(p, Replicate) and (b or hd) else p
              for b, hd, p in zip(batch, heads, pl)]
        places.append(pl)
        grads.append(gr)
        local.append(sharding.as_dtensor(t, mesh, pl))
    out = [Shard(0) if b else Shard(out_dim) if hd else Replicate()
           for b, hd in zip(batch, heads)]
    return local_map(lambda *ts: fn(*ts, **kw), out_placements=out,
                     in_placements=tuple(places),
                     in_grad_placements=tuple(grads),
                     device_mesh=mesh)(*local)


def ssm_forward(p, x: torch.Tensor, cfg: ModelConfig, s: SSMConfig
                ) -> torch.Tensor:
    """Full-sequence SSD: (B, L, d) -> (B, L, d)."""
    bsz, l, _ = x.shape
    f32 = torch.float32
    z, xbc, dt_raw, d_in, h, gn = _split(p, x, cfg, s)
    xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xs = xbc[..., :d_in].reshape(bsz, l, h, s.head_dim)
    bmat = xbc[..., d_in:d_in + gn].reshape(bsz, l, s.n_groups, s.d_state)
    cmat = xbc[..., d_in + gn:].reshape(bsz, l, s.n_groups, s.d_state)
    xs = sharding.constrain_safe(xs, ("batch", "seq", "ssm_heads", None))

    dt = softplus(dt_raw.to(f32) + p["dt_bias"])                     # (B,L,H)
    a = -torch.exp(p["a_log"])                                       # (H,)
    y = by_heads(_ssd, xs, ((xs, 2), (dt, 2), (bmat, 2), (cmat, 2), (a, 0)),
                 out_dim=2, chunk=s.chunk)
    y = y + xs * p["d_skip"][None, None, :, None]
    # on a mesh the gradient comes back in the merged axis's layout, whole
    # heads (the merge's backward splits it again)
    y = sharding.pin_grad(y.reshape(bsz, l, d_in))

    y = layers.apply_norm(p["gate_norm"], y * F.silu(z), "rmsnorm")
    return y.to(x.dtype) @ p["out_proj"]


def init_ssm_cache(batch: int, cfg: ModelConfig, s: SSMConfig,
                   dtype=torch.float32, device=None) -> dict:
    dd = dims(cfg, s)
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, dd["conv_dim"]),
                            dtype=dtype, device=device),
        "state": torch.zeros((batch, dd["n_heads"], s.head_dim, s.d_state),
                             dtype=torch.float32, device=device),
    }


def ssm_decode_step(p, x: torch.Tensor, cache: dict, cfg: ModelConfig,
                    s: SSMConfig) -> tuple[torch.Tensor, dict]:
    """One-token recurrent update: x (B, 1, d) -> (y (B, 1, d), new cache)."""
    bsz = x.shape[0]
    f32 = torch.float32
    z, xbc, dt_raw, d_in, h, gn = _split(p, x, cfg, s)
    # conv over [cached w-1 inputs, current]
    cdt = torch.promote_types(cache["conv"].dtype, xbc.dtype)
    win = torch.cat([cache["conv"].to(cdt), xbc.to(cdt)], dim=1)
    conv_out = (win * p["conv_w"][None]).sum(dim=1, keepdim=True)
    xbc1 = F.silu(conv_out + p["conv_b"])                   # (B,1,C)
    new_conv = win[:, 1:, :]

    xs = xbc1[..., :d_in].reshape(bsz, h, s.head_dim)
    bvec = xbc1[..., d_in:d_in + gn].reshape(bsz, s.n_groups, s.d_state)
    cvec = xbc1[..., d_in + gn:].reshape(bsz, s.n_groups, s.d_state)
    hpg = h // s.n_groups
    bh = torch.repeat_interleave(bvec, hpg, dim=1)          # (B,H,N)
    chh = torch.repeat_interleave(cvec, hpg, dim=1)

    dt = softplus(dt_raw[:, 0].to(f32) + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    decay = torch.exp(dt * a)                               # (B,H)
    upd = torch.einsum("bh,bhp,bhn->bhpn", dt, xs.to(f32), bh.to(f32))
    state = cache["state"] * decay[..., None, None] + upd
    y = torch.einsum("bhn,bhpn->bhp", chh.to(f32), state)
    y = y + xs.to(f32) * p["d_skip"][None, :, None]
    y = y.reshape(bsz, 1, d_in)
    y = layers.apply_norm(p["gate_norm"], y * F.silu(z), "rmsnorm")
    out = y.to(x.dtype) @ p["out_proj"]
    return out, {"conv": new_conv, "state": state}
