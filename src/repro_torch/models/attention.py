"""Attention: GQA/MQA, MLA (DeepSeek-V2), sliding-window, prefix-LM.

Counterpart of :mod:`repro.models.attention`.  The workhorse is
:func:`blockwise_attention` -- a chunked online-softmax (flash-style)
attention in plain torch: the (Sq, Skv) logit matrix is never
materialized beyond a (q_chunk, kv_chunk) tile.  It computes the full
rectangle with masking (no causal early-exit), as ``repro``'s does.

Precision follows ``repro``: the QK^T product runs in the activations'
dtype (bf16 by default) and is cast to float32 after, the softmax runs in
float32, and the PV product takes its probabilities cast to the values'
dtype with a float32 accumulation.

MLA follows arXiv:2405.04434: queries carry per-head no-PE + shared-RoPE
parts; K/V are up-projected from a compressed latent c (kv_lora wide) that
is also what the decode cache stores (``blocks._mla_decode`` uses the
absorbed form).

``repro``'s sharding constraints sit at its lines
(:func:`repro_torch.distributed.sharding.constrain_safe`: a no-op off a
mesh), and :func:`head_padding_plan` pads the heads to the active rules'
model axis (tp = 1, no padding, off a mesh).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.config import AttnConfig, ModelConfig
from repro_torch.distributed import sharding
from repro_torch.models import layers
from repro_torch.models.layers import Keys

NEG_INF = -1e30


def proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("...d,dhk->...hk", x, w)`` as one matmul.  On a mesh the
    merged head axis is split again only where the split falls on whole
    heads (forward and gradient)."""
    y = x @ sharding.pin_grad(w.reshape(w.shape[0], -1))
    y = sharding.split_ready(y, y.ndim - 1, w.shape[1])
    return y.reshape(x.shape[:-1] + w.shape[1:])


def out_proj(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("...hv,hvd->...d", o, w)`` as one matmul."""
    return (sharding.pin_grad(o.reshape(o.shape[:-2] + (-1,)))
            @ sharding.pin_grad(w.reshape(-1, w.shape[-1])))


# -- init ----------------------------------------------------------------------

def init_attention(keys: Keys, cfg: ModelConfig, a: AttnConfig,
                   kv_d_model: int | None = None) -> dict:
    """GQA/MQA/MLA projection params. kv_d_model: cross-attn KV source width."""
    d = cfg.d_model
    dkv = kv_d_model or d
    dt = layers.param_dtype(cfg)
    std = d ** -0.5
    ks = keys.split(8)
    if a.kind == "mla":
        qk = a.head_dim + a.rope_head_dim
        return {
            "wq": ks[0].scaled((d, a.num_heads, qk), std, dt),
            "w_dkv": ks[1].scaled((d, a.kv_lora), std, dt),
            "w_kr": ks[2].scaled((d, a.rope_head_dim), std, dt),
            "w_uk": ks[3].scaled((a.kv_lora, a.num_heads, a.head_dim),
                                 a.kv_lora ** -0.5, dt),
            "w_uv": ks[4].scaled((a.kv_lora, a.num_heads, a.vdim),
                                 a.kv_lora ** -0.5, dt),
            "wo": ks[5].scaled((a.num_heads, a.vdim, d),
                               (a.num_heads * a.vdim) ** -0.5, dt),
            "c_norm": {"scale": keys.full((a.kv_lora,), 1.0)},
        }
    return {
        "wq": ks[0].scaled((d, a.num_heads, a.head_dim), std, dt),
        "wk": ks[1].scaled((dkv, a.num_kv_heads, a.head_dim),
                           dkv ** -0.5, dt),
        "wv": ks[2].scaled((dkv, a.num_kv_heads, a.vdim), dkv ** -0.5, dt),
        "wo": ks[3].scaled((a.num_heads, a.vdim, d),
                           (a.num_heads * a.vdim) ** -0.5, dt),
    }


# -- head padding (TP divisibility) ----------------------------------------------

def head_padding_plan(h: int, kv: int, tp: int, *,
                      pad_kv: bool = True) -> tuple | None:
    """Plan q/kv head padding so the q-head dim divides the TP axis.

    Without this, a head count like 36 (starcoder2) or 25 (hymba) on a
    16-way model axis replicates the whole attention.  Padding to the
    nearest (tp, kv)-compatible head count costs only hp/h extra compute.

    Returns (hp, kvp, slots) -- q head i moves to slot[i] in the padded
    layout (grouped under its original kv head); None = no padding needed
    or padding would not beat replication.
    """
    if tp <= 1 or h % tp == 0:
        return None
    g0 = max(h // kv, 1)
    best = None
    kvp_range = range(kv, 4 * tp + 1) if pad_kv else (kv,)
    for kvp in kvp_range:
        l = math.lcm(kvp, tp)
        hp = -(-max(h, g0 * kvp) // l) * l
        while hp // kvp < g0:
            hp += l
        if best is None or (hp, kvp) < best:
            best = (hp, kvp)
    hp, kvp = best
    if hp / h >= tp:          # padding waste would exceed replication
        return None
    g = hp // kvp
    slots = np.asarray([(i // g0) * g + (i % g0) for i in range(h)])
    return hp, kvp, slots


def _slot_matrix(plan: tuple, dtype: torch.dtype, device) -> torch.Tensor:
    """The plan's ``(h, hp)`` 0/1 matrix: row i has its one 1 at
    ``slots[i]``."""
    hp, _, slots = plan
    return torch.from_numpy(np.eye(hp, dtype=np.float32)[slots]).to(
        device=device, dtype=dtype)


def _whole_heads(t: torch.Tensor) -> torch.Tensor:
    """``t`` (``(..., heads, d)``) with its heads whole on every rank: a
    DTensor split along them is gathered (GSPMD's layout for the gather
    of the index form), so the product contracts no split axis, whose
    partial sum some versions plan wrongly."""
    if not isinstance(t, DTensor):
        return t
    from torch.distributed.tensor import Replicate, Shard
    dim = t.ndim - 2
    return t.redistribute(t.device_mesh, [
        Replicate() if isinstance(pl, Shard) and pl.dim == dim else pl
        for pl in t.placements])


def pad_heads(q: torch.Tensor, k: torch.Tensor | None,
              v: torch.Tensor | None, plan: tuple):
    """Scatter real heads into the padded layout (zeros elsewhere).

    The scatter is a product with the plan's 0/1 slot matrix, for which
    DTensor has rules in every version (it has none for the indexed
    write on some).  Each output is one input times 1 plus zeros (plus
    +0.0, so a padding slot is +0.0 whatever the zeros' signs), so the
    result equals the indexed write's bit for bit, but where the input
    holds inf or NaN (times 0: NaN in every slot) and where a real head
    holds -0.0 (it may come out +0.0); on the card, with TF32 off (a
    model made on the card turns it off)."""
    _, kvp, _ = plan
    qp = torch.einsum("...hd,hp->...pd", q,
                      _slot_matrix(plan, q.dtype, q.device)) + 0.0

    def padkv(t):
        if t is None or t.shape[-2] == kvp:
            return t
        return layers.pad_zeros(t, -2, after=kvp - t.shape[-2])
    return qp, padkv(k), padkv(v)


def unpad_heads(out: torch.Tensor, plan: tuple) -> torch.Tensor:
    """The real heads of the padded layout: the product with the slot
    matrix's transpose (exact as :func:`pad_heads` is)."""
    return torch.einsum("...pd,hp->...hd", _whole_heads(out),
                        _slot_matrix(plan, out.dtype, out.device))


# -- chunked online-softmax attention ------------------------------------------

def _pad_axis(x: torch.Tensor, axis: int, multiple: int) -> torch.Tensor:
    pad = (-x.shape[axis]) % multiple
    if pad == 0:
        return x
    widths = [0, 0] * (x.ndim - axis - 1) + [0, pad]
    return F.pad(x, widths)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        q_pos0: int | torch.Tensor = 0,
                        kv_valid: torch.Tensor | None = None,
                        causal: bool = True,
                        window: int | None = None,
                        prefix_len: int = 0,
                        q_chunk: int = 512, kv_chunk: int = 512
                        ) -> torch.Tensor:
    """Memory-bounded attention.

    Args:
      q: ``(B, Sq, H, dh)``; k: ``(B, Skv, KV, dh)``; v: ``(B, Skv, KV, dv)``.
      q_pos0: absolute position of q[0] (continuation chunks / decode).
      kv_valid: ``(B,)`` valid KV length (padding mask).
      causal: causal masking (q_pos >= kv_pos).
      window: sliding-window width (only kv in [q_pos-window, q_pos]).
      prefix_len: kv positions < prefix_len are visible to every query
        (PaliGemma prefix-LM).

    Returns:
      ``(B, Sq, H, dv)``.

    DTensor operands (on a mesh) run on each rank's block of batches and
    heads: see :func:`_local_blockwise`.
    """
    if isinstance(q, DTensor):
        return _local_blockwise(
            q, k, v, kv_valid, q_pos0=q_pos0, causal=causal, window=window,
            prefix_len=prefix_len, q_chunk=q_chunk, kv_chunk=kv_chunk)
    b, sq, h, dh = q.shape
    skv, kv = k.shape[1], k.shape[2]
    g = h // kv
    dv = v.shape[-1]
    scale = dh ** -0.5
    dev = q.device

    qc = min(q_chunk, sq)
    kc = min(kv_chunk, skv)
    qp = _pad_axis(q, 1, qc)
    kp = _pad_axis(k, 1, kc)
    vp = _pad_axis(v, 1, kc)
    sq_p, skv_p = qp.shape[1], kp.shape[1]
    nq, nk = sq_p // qc, skv_p // kc

    qp = qp.reshape(b, nq, qc, kv, g, dh)
    kp = kp.reshape(b, nk, kc, kv, dh)
    vp = vp.reshape(b, nk, kc, kv, dv)
    kv_valid_ = (torch.full((b,), skv, dtype=torch.int32, device=dev)
                 if kv_valid is None else kv_valid.to(torch.int32))
    ar_q = torch.arange(qc, device=dev)
    ar_k = torch.arange(kc, device=dev)

    outs = []
    for qi in range(nq):
        q_blk = qp[:, qi]
        q_positions = q_pos0 + qi * qc + ar_q                     # (qc,)
        m = torch.full((b, qc, kv, g), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, qc, kv, g), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, qc, kv, g, dv), dtype=torch.float32,
                          device=dev)
        for ki in range(nk):
            k_blk, v_blk = kp[:, ki], vp[:, ki]
            kv_positions = ki * kc + ar_k                         # (kc,)
            # The product in the operands' dtype, float32 after (repro's
            # bf16 dot, upcast AFTER).
            logits = torch.einsum("bqkgd,bskd->bqkgs", q_blk,
                                  k_blk).to(torch.float32) * scale
            mask = kv_positions[None, :] < kv_valid_[:, None]     # (b, kc)
            mask = mask[:, None, :]                               # (b, 1, kc)
            rel = q_positions[:, None] - kv_positions[None, :]    # (qc, kc)
            vis = torch.ones_like(rel, dtype=torch.bool)
            if causal:
                vis &= rel >= 0
            if window is not None:
                vis &= rel < window
            if prefix_len:
                vis |= kv_positions[None, :] < prefix_len
            mask = mask & vis[None, :, :]                         # (b, qc, kc)
            logits = torch.where(mask[:, :, None, None, :], logits, NEG_INF)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(logits - m_new[..., None])
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bqkgs,bskv->bqkgv", p.to(v_blk.dtype).to(torch.float32),
                v_blk.to(torch.float32))
            m = m_new
        out = acc / torch.clamp_min(l[..., None], 1e-30)
        outs.append(out.to(q.dtype))
    out = torch.stack(outs, dim=1).reshape(b, sq_p, h, dv)
    return out[:, :sq]


def _local_blockwise(q, k, v, kv_valid, **kw) -> torch.Tensor:
    """``blockwise_attention`` of DTensors as ``shard_map`` runs it: each
    rank attends its own batches and query heads, whole along the
    sequence (``local_map``).  K / V follow the query's batch split;
    their kv heads follow its head split where it falls on whole kv
    heads, and otherwise stay whole, each rank taking the kv heads its
    query heads read (GSPMD's layout for ``kv_heads`` replicated).  The
    chunk loop then runs on plain tensors: DTensor has no rule for some
    of its ops (the padding, the products' merged batch axes) and would
    dispatch thousands of small ones."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    h, kv = q.shape[2], k.shape[2]
    g = h // kv
    rows = [pl if isinstance(pl, Shard) and pl.dim == 0 else Replicate()
            for pl in q.placements]
    place = [pl if isinstance(pl, Shard) and pl.dim in (0, 2)
             else Replicate() for pl in q.placements]
    (_, _, hl, _), (_, _, h0, _) = compute_local_shape_and_global_offset(
        q.shape, mesh, place)
    if hl < h and hl % g and g % hl:         # a rank's heads straddle groups
        place, hl, h0 = rows, h, 0
    q = q.redistribute(mesh, place)
    split = hl < h and hl % g == 0           # query heads on whole kv heads
    kv_place = place if split else rows
    kv_grad = [Partial() if hl < h and not split and isinstance(pl, Shard)
               and pl.dim == 2 else kp for pl, kp in zip(place, kv_place)]
    k0, kn = (h0 // g, 1) if hl < h and not split else (0, k.shape[2])

    def run(q, k, v, kv_valid):
        if kn < k.shape[2]:                  # the kv head these heads read
            k, v = k[:, :, k0:k0 + kn], v[:, :, k0:k0 + kn]
        return blockwise_attention(q, k, v, kv_valid=kv_valid, **kw)

    args = [q] + [t.redistribute(mesh, kv_place) for t in (k, v)]
    if kv_valid is not None:
        kv_valid = sharding.as_dtensor(kv_valid, mesh, rows)
    return local_map(run, out_placements=place,
                     in_placements=(place, kv_place, kv_place,
                                    rows if kv_valid is not None else None),
                     in_grad_placements=(place, kv_grad, kv_grad,
                                         rows if kv_valid is not None
                                         else None),
                     device_mesh=mesh)(*args, kv_valid)


# -- GQA forward ---------------------------------------------------------------

def gqa_forward(p, x: torch.Tensor, a: AttnConfig, *,
                positions: torch.Tensor, causal: bool = True,
                window: int | None = None, prefix_len: int = 0,
                kv_x: torch.Tensor | None = None,
                kv_valid: torch.Tensor | None = None,
                q_chunk: int = 512, kv_chunk: int = 512,
                return_kv: bool = False):
    """Standard multi/grouped-query attention over ``x`` (B, S, d).

    kv_x: cross-attention source (defaults to x). positions: (S,) absolute.
    """
    src = x if kv_x is None else kv_x
    q = proj(x, p["wq"])
    k = proj(src, p["wk"])
    v = proj(src, p["wv"])
    q = sharding.constrain_safe(q, ("batch", "seq", "heads", None))
    k = sharding.constrain_safe(k, ("batch", "kv_seq", "kv_heads", None))
    v = sharding.constrain_safe(v, ("batch", "kv_seq", "kv_heads", None))

    rot = int(a.head_dim * a.rope_fraction)
    if rot and kv_x is None:
        cos, sin = layers.rope_angles(positions, rot, a.rope_theta)
        q = layers.apply_rope(q, cos[None], sin[None], rot)
        k = layers.apply_rope(k, cos[None], sin[None], rot)

    # TP-divisibility head padding to the active rules' model axis (none
    # off a mesh).  The cache (return_kv) keeps the ORIGINAL kv heads.
    plan = head_padding_plan(a.num_heads, a.num_kv_heads,
                             sharding.axis_size("heads"))
    k_orig, v_orig = k, v
    if plan is not None:
        q, k, v = pad_heads(q, k, v, plan)
        q = sharding.constrain_safe(q, ("batch", "seq", "heads", None))

    q_pos0 = positions[0] if positions.ndim else positions
    out = blockwise_attention(
        q, k, v, q_pos0=0 if kv_x is not None else q_pos0,
        kv_valid=kv_valid, causal=causal and kv_x is None,
        window=window, prefix_len=prefix_len,
        q_chunk=q_chunk, kv_chunk=kv_chunk)
    if plan is not None:
        out = unpad_heads(out, plan)
    y = out_proj(out, p["wo"])
    if return_kv:
        return y, (k_orig, v_orig)
    return y


# -- MLA forward ---------------------------------------------------------------

def mla_forward(p, x: torch.Tensor, a: AttnConfig, *,
                positions: torch.Tensor, norm_kind: str = "rmsnorm",
                kv_valid: torch.Tensor | None = None,
                q_chunk: int = 512, kv_chunk: int = 512,
                return_cache: bool = False):
    """Multi-head latent attention (training/prefill form).

    Cache content is the compressed latent (c, k_rope) -- the point of MLA.
    """
    b, s, d = x.shape
    q = proj(x, p["wq"])                             # (B,S,H,nope+rope)
    q_nope, q_rope = q[..., :a.head_dim], q[..., a.head_dim:]

    c = layers.apply_norm(p["c_norm"], x @ p["w_dkv"], norm_kind)
    c = c.to(x.dtype)                                # (B,S,kv_lora)
    k_rope = (x @ p["w_kr"])[:, :, None, :]          # (B,S,1,rope_dim)

    cos, sin = layers.rope_angles(positions, a.rope_head_dim, a.rope_theta)
    q_rope = layers.apply_rope(q_rope, cos[None], sin[None], a.rope_head_dim)
    k_rope = layers.apply_rope(k_rope, cos[None], sin[None], a.rope_head_dim)

    k_nope = proj(c, p["w_uk"])
    vv = proj(c, p["w_uv"])
    k = torch.cat(
        [k_nope, k_rope.expand(b, s, a.num_heads, a.rope_head_dim)], dim=-1)
    qq = torch.cat([q_nope, q_rope], dim=-1)
    qq = sharding.constrain_safe(qq, ("batch", "seq", "heads", None))

    out = blockwise_attention(qq, k, vv, q_pos0=positions[0],
                              kv_valid=kv_valid, causal=True,
                              q_chunk=q_chunk, kv_chunk=kv_chunk)
    y = out_proj(out, p["wo"])
    if return_cache:
        return y, (c, k_rope[:, :, 0, :])
    return y
