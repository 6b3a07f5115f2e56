"""Transformer/SSM/hybrid blocks + per-block decode steps with caches.

Counterpart of :mod:`repro.models.blocks`.  Block kinds (``lm.segments``
plans a model as homogeneous runs of):
  dense          attn + MLP
  moe            attn + MoE FFN
  ssm            Mamba-2 only (mamba2-1.3b has no MLP)
  hybrid_global  (attn ∥ mamba) heads, full attention, + MLP   (hymba)
  hybrid_swa     (attn ∥ mamba) heads, sliding window, + MLP   (hymba)
  enc            bidirectional attn + MLP                       (whisper enc)
  dec            causal self-attn + cross-attn + MLP            (whisper dec)

Decode caches are uniform dicts:
  attention: {k, v, kpos} -- kpos holds the absolute position stored in each
  slot (-1 = empty), which makes full, sliding-window (ring-buffer) and
  prefix caches share one masking rule.
  MLA: {c, kr, kpos} (compressed latent -- the MLA memory win).
  SSM: {conv, state}.

Where ``repro`` returns an updated copy of a cache, the port writes one
token's entries into the cache it is given (:func:`_store`); a
:class:`Block` is one layer of a segment (an ``nn.Module`` over
``repro``'s parameter dict).
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch.config import ModelConfig
from repro_torch.distributed import sharding
from repro_torch.models import attention, layers, moe as moe_mod, \
    ssm as ssm_mod
from repro_torch.models.attention import out_proj, proj
from repro_torch.models.layers import Keys, ParamTree

NEG_INF = -1e30


class Block(ParamTree):
    """One layer of kind ``kind``: ``repro``'s block parameters as a
    module, with :func:`block_forward` and :func:`block_decode`."""

    def __init__(self, cfg: ModelConfig, kind: str, tree: dict):
        super().__init__(tree)
        self.cfg, self.kind = cfg, kind

    def forward(self, x: torch.Tensor, **kw):
        return block_forward(self, x, self.cfg, self.kind, **kw)

    def decode(self, x: torch.Tensor, cache: dict, cur_pos: int):
        return block_decode(self, x, cache, self.cfg, self.kind, cur_pos)


# -- init ----------------------------------------------------------------------

def init_block(keys: Keys, cfg: ModelConfig, kind: str) -> dict:
    """One block's parameters for each key of the batch (leading axis)."""
    ks = keys.split(6)
    p: dict = {}
    if kind in ("dense", "moe", "enc", "dec", "hybrid_global", "hybrid_swa"):
        p["ln1"] = layers.init_norm(keys, cfg, cfg.d_model)
        p["attn"] = attention.init_attention(ks[0], cfg, cfg.attn)
    if kind in ("hybrid_global", "hybrid_swa"):
        p["ssm"] = ssm_mod.init_ssm(ks[1], cfg, cfg.ssm)
        p["attn_norm"] = layers.init_norm(keys, cfg, cfg.d_model)
        p["ssm_norm"] = layers.init_norm(keys, cfg, cfg.d_model)
        p["branch_scale"] = keys.full((2,), 1.0)
    if kind == "ssm":
        p["ln1"] = layers.init_norm(keys, cfg, cfg.d_model)
        p["ssm"] = ssm_mod.init_ssm(ks[1], cfg, cfg.ssm)
        return p
    if kind == "dec":
        p["ln_x"] = layers.init_norm(keys, cfg, cfg.d_model)
        p["xattn"] = attention.init_attention(ks[2], cfg, cfg.attn)
    # FFN
    p["ln2"] = layers.init_norm(keys, cfg, cfg.d_model)
    if kind == "moe":
        p["moe"] = moe_mod.init_moe(ks[3], cfg, cfg.moe)
    else:
        d_ff = cfg.dense_d_ff if (kind == "dense" and cfg.dense_d_ff) \
            else cfg.d_ff
        p["mlp"] = layers.init_mlp(ks[3], cfg, d_ff)
    return p


# -- full-sequence forward (train / prefill) ------------------------------------

def gather_seq(h: torch.Tensor) -> torch.Tensor:
    """``h`` with its sequence axis whole: the residual stream going into
    a branch's norm and projections (sequence parallelism's all-gather,
    which GSPMD inserts in ``repro``), and a branch's output going into
    the residual add, so that the add's gradient reaches the branch's
    products whole.  DTensor cannot flatten a sequence-sharded axis into
    a product's rows (nor, in some versions, into a norm scale's
    gradient).  A no-op off a mesh."""
    return sharding.constrain_safe(h, ("batch", "seq", None))


def block_forward(p, x: torch.Tensor, cfg: ModelConfig, kind: str, *,
                  positions: torch.Tensor, prefix_len: int = 0,
                  kv_valid: torch.Tensor | None = None,
                  enc_out: torch.Tensor | None = None,
                  enc_valid: torch.Tensor | None = None,
                  q_chunk: int = 512, kv_chunk: int = 512,
                  return_cache: bool = False):
    """Returns (x, aux_loss, cache_or_None)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    cache = None
    a = cfg.attn
    window = a.window if (a and kind == "hybrid_swa") else None
    causal = kind != "enc"
    # Sequence-parallel residual stream (no-op outside a mesh / at decode).
    x = sharding.constrain_safe(x, ("batch", "residual_seq", None))

    if kind == "ssm":
        h = layers.apply_norm(p["ln1"], gather_seq(x), cfg.norm)
        if return_cache:
            y, cache = ssm_forward_with_state(p["ssm"], h, cfg)
        else:
            y = ssm_mod.ssm_forward(p["ssm"], h, cfg, cfg.ssm)
        out = sharding.constrain_safe(x + gather_seq(y),
                                      ("batch", "residual_seq", None))
        return out, aux, cache

    h = layers.apply_norm(p["ln1"], gather_seq(x), cfg.norm)
    if a.kind == "mla":
        out = attention.mla_forward(
            p["attn"], h, a, positions=positions, norm_kind=cfg.norm,
            kv_valid=kv_valid, q_chunk=q_chunk, kv_chunk=kv_chunk,
            return_cache=return_cache)
        if return_cache:
            y, (c, kr) = out
            cache = {"c": c, "kr": kr}
        else:
            y = out
    else:
        out = attention.gqa_forward(
            p["attn"], h, a, positions=positions, causal=causal,
            window=window, prefix_len=prefix_len, kv_valid=kv_valid,
            q_chunk=q_chunk, kv_chunk=kv_chunk, return_kv=return_cache)
        if return_cache:
            y, (k, v) = out
            cache = {"k": k, "v": v}
        else:
            y = out

    if kind in ("hybrid_global", "hybrid_swa"):
        if return_cache:
            y_ssm, ssm_cache = ssm_forward_with_state(p["ssm"], h, cfg)
            cache = {"attn": cache, "ssm": ssm_cache}
        else:
            y_ssm = ssm_mod.ssm_forward(p["ssm"], h, cfg, cfg.ssm)
        b = p["branch_scale"]
        y = 0.5 * (b[0] * layers.apply_norm(p["attn_norm"], y, cfg.norm)
                   + b[1] * layers.apply_norm(p["ssm_norm"], y_ssm, cfg.norm))
        y = y.to(x.dtype)

    x = x + gather_seq(y)

    if kind == "dec":
        h = layers.apply_norm(p["ln_x"], gather_seq(x), cfg.norm)
        y = attention.gqa_forward(
            p["xattn"], h, a, positions=positions, causal=False,
            kv_x=enc_out, kv_valid=enc_valid,
            q_chunk=q_chunk, kv_chunk=kv_chunk)
        x = x + gather_seq(y)

    h = layers.apply_norm(p["ln2"], gather_seq(x), cfg.norm)
    if kind == "moe":
        y, aux = moe_mod.moe_forward(p["moe"], h, cfg, cfg.moe)
    else:
        y = layers.apply_mlp(p["mlp"], h, cfg)
    # Pin the block output back to the sequence-sharded residual layout.
    out = sharding.constrain_safe(x + gather_seq(y),
                                  ("batch", "residual_seq", None))
    return out, aux, cache


def ssm_forward_with_state(p, h: torch.Tensor, cfg: ModelConfig):
    """SSD forward that also returns the decode cache (prefill path)."""
    y = ssm_mod.ssm_forward(p, h, cfg, cfg.ssm)
    return y, _ssm_prefill_state(p, h, cfg)


def _ssm_prefill_state(p, h: torch.Tensor, cfg: ModelConfig) -> dict:
    """Final (conv, ssm) state after consuming h (B, L, d)."""
    s = cfg.ssm
    bsz, l, _ = h.shape
    f32 = torch.float32
    z, xbc_raw, dt_raw, d_in, nh, gn = ssm_mod._split(p, h, cfg, s)
    # conv cache: last d_conv-1 raw xbc inputs
    w = s.d_conv
    pad = max(w - 1 - l, 0)
    conv_cache = layers.pad_zeros(xbc_raw, 1, before=pad)[:, -(w - 1):, :]

    xbc = ssm_mod._causal_conv(xbc_raw, p["conv_w"], p["conv_b"])
    xs = xbc[..., :d_in].reshape(bsz, l, nh, s.head_dim)
    bmat = xbc[..., d_in:d_in + gn].reshape(bsz, l, s.n_groups, s.d_state)
    dt = ssm_mod.softplus(dt_raw.to(f32) + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    xs = sharding.constrain_safe(xs, ("batch", "seq", "ssm_heads", None))
    state = ssm_mod.by_heads(_final_state, xs, ((bmat, 2), (dt, 2), (xs, 2),
                                                (a, 0)), out_dim=1)
    return {"conv": conv_cache, "state": state}


def _final_state(bmat, dt, xs, a) -> torch.Tensor:
    """state = sum_t exp(sum_{k>t} adt_k) dt_t B_t x_t^T: (B, H, P, N)."""
    f32 = torch.float32
    adt = dt * a                                           # (B, L, H)
    hpg = xs.shape[2] // bmat.shape[2]
    bh = torch.repeat_interleave(bmat, hpg, dim=2)         # (B, L, H, N)
    xdt = xs * dt[..., None]
    acs = torch.cumsum(adt, dim=1)
    decay = torch.exp(acs[:, -1:, :] - acs)                # (B, L, H)
    return torch.einsum("blhn,blh,blhp->bhpn", bh.to(f32), decay,
                        xdt.to(f32))


# -- decode step -----------------------------------------------------------------

def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.bmm(a, b)`` in float32: operands in their own dtype, float32
    accumulation and result (XLA's ``preferred_element_type=float32``).
    The card takes bf16 / fp16 operands as they are; the CPU has no such
    product and upcasts them."""
    if a.dtype == torch.float32 or a.device.type != "cuda":
        return torch.bmm(a.to(torch.float32), b.to(torch.float32))
    return torch.bmm(a, b, out_dtype=torch.float32)


def cached_attention(q: torch.Tensor, cache: dict, cur_pos: int,
                     window: int | None) -> torch.Tensor:
    """Single-token attention over a position-tagged cache.

    q: (B, H, dh); cache k/v: (B, S, KV, dh/dv); kpos: (B, S) int32.
    Each product reads the cache where it lies, as ``(B, S, KV * dh)``
    rows: the scores with ``q`` laid out block-diagonally (query head i
    meets only its own kv head's columns), the outputs as every head
    against every kv head, of which the diagonal is kept.  That spends KV
    times the products of a per-head attention (the step is bound by the
    cache's bytes) and makes no copy of the cache, nor, on the card, a
    float32 one.
    """
    k, v, kpos = cache["k"], cache["v"], cache["kpos"]
    b, s, kv, dh = k.shape
    h, dv = q.shape[1], v.shape[-1]
    g = h // kv
    on_mesh = isinstance(q, DTensor)
    if on_mesh:
        # DTensor has no rule for the indexed writes and reads below: the
        # same block-diagonal layout by a product with the identity
        # (exact: one term of each sum is not 0)
        eye = torch.eye(kv, dtype=q.dtype, device=q.device)
        qblk = torch.einsum("bkgd,kj->bkjgd", q.reshape(b, kv, g, dh), eye)
    else:
        heads = torch.arange(kv, device=q.device)
        qblk = q.new_zeros((b, kv, kv, g, dh))
        qblk[:, heads, heads] = q.reshape(b, kv, g, dh)
    qblk = qblk.permute(0, 1, 3, 2, 4).reshape(b, h, kv * dh)
    # operands in the cache's dtype, float32 accumulation
    logits = _bmm_f32(qblk, k.view(b, s, kv * dh).transpose(1, 2))  # (B,H,S)
    logits = logits * q.shape[-1] ** -0.5
    valid = (kpos >= 0) & (kpos <= cur_pos)
    if window is not None:
        valid &= kpos > cur_pos - window
    logits = torch.where(valid[:, None, :], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.bmm(w, v.view(b, s, kv * dv))                # (B, H, KV dv)
    if on_mesh:
        return torch.einsum("bkgjv,kj->bkgv", out.view(b, kv, g, kv, dv),
                            eye.to(out.dtype)).reshape(b, h, dv)
    qh = torch.arange(h, device=q.device)
    return out.view(b, h, kv, dv)[:, qh, qh // g]


def _store(cache: dict, names: tuple[str, ...],
           values: tuple[torch.Tensor, ...], cur_pos: int,
           ring: int | None) -> dict:
    """Write one token's cache entries at slot (pos or pos % ring), in
    place (``repro``'s ``dynamic_update_slice``)."""
    slot = cur_pos % ring if ring else cur_pos
    for name, val in zip(names, values):
        sharding.write_slot(cache[name], 1, slot, val)
    sharding.write_slot(cache["kpos"], 1, slot, cur_pos)
    return cache


def block_decode(p, x: torch.Tensor, cache: dict, cfg: ModelConfig,
                 kind: str, cur_pos: int) -> tuple[torch.Tensor, dict]:
    """One-token decode: x (B, 1, d) -> (x, new_cache).  Attention caches
    are written in place; the SSM state comes back new."""
    a = cfg.attn

    if kind == "ssm":
        h = layers.apply_norm(p["ln1"], x, cfg.norm)
        y, new_cache = ssm_mod.ssm_decode_step(p["ssm"], h, cache, cfg,
                                               cfg.ssm)
        return x + y, new_cache

    window = a.window if kind == "hybrid_swa" else None
    ring = cache["attn"]["k"].shape[1] if kind in (
        "hybrid_global", "hybrid_swa") and window is not None else None
    attn_cache = cache["attn"] if "attn" in cache else cache

    h = layers.apply_norm(p["ln1"], x, cfg.norm)

    if a.kind == "mla":
        y, attn_cache = _mla_decode(p["attn"], h, attn_cache, cfg, cur_pos)
    else:
        q = proj(h, p["attn"]["wq"])[:, 0]
        k1 = proj(h, p["attn"]["wk"])[:, 0]
        v1 = proj(h, p["attn"]["wv"])[:, 0]
        rot = int(a.head_dim * a.rope_fraction)
        if rot:
            pos = torch.tensor([cur_pos], device=x.device)
            cos, sin = layers.rope_angles(pos, rot, a.rope_theta)
            q = layers.apply_rope(q[:, None], cos[None], sin[None], rot)[:, 0]
            k1 = layers.apply_rope(k1[:, None], cos[None], sin[None],
                                   rot)[:, 0]
        attn_cache = _store(attn_cache, ("k", "v"),
                            (k1[:, None], v1[:, None]), cur_pos,
                            ring if window is not None else None)
        # q-side head padding to the model axis (the cache keeps the
        # original kv heads); off a mesh (tp = 1) there is none.
        plan = attention.head_padding_plan(a.num_heads, a.num_kv_heads,
                                           sharding.axis_size("heads"),
                                           pad_kv=False)
        if plan is not None:
            qp, _, _ = attention.pad_heads(q[:, None], None, None, plan)
            out = cached_attention(qp[:, 0], attn_cache, cur_pos, window)
            out = attention.unpad_heads(out, plan)
        else:
            out = cached_attention(q, attn_cache, cur_pos, window)
        y = out_proj(out, p["attn"]["wo"])[:, None]

    if kind in ("hybrid_global", "hybrid_swa"):
        y_ssm, ssm_cache = ssm_mod.ssm_decode_step(
            p["ssm"], h, cache["ssm"], cfg, cfg.ssm)
        bsc = p["branch_scale"]
        y = 0.5 * (bsc[0] * layers.apply_norm(p["attn_norm"], y, cfg.norm)
                   + bsc[1] * layers.apply_norm(p["ssm_norm"], y_ssm,
                                                cfg.norm))
        y = y.to(x.dtype)
        new_cache = {"attn": attn_cache, "ssm": ssm_cache}
    else:
        new_cache = attn_cache

    x = x + y

    if kind == "dec":                      # cross-attn over precomputed enc KV
        h = layers.apply_norm(p["ln_x"], x, cfg.norm)
        q = proj(h, p["xattn"]["wq"])[:, 0]
        xc = {"k": cache["xk"], "v": cache["xv"], "kpos": cache["xkpos"]}
        out = cached_attention(q, xc, 2 ** 30, None)
        y = out_proj(out, p["xattn"]["wo"])[:, None]
        x = x + y
        new_cache = dict(new_cache, xk=cache["xk"], xv=cache["xv"],
                         xkpos=cache["xkpos"])

    h = layers.apply_norm(p["ln2"], x, cfg.norm)
    if kind == "moe":
        y, _ = moe_mod.moe_forward(p["moe"], h, cfg, cfg.moe)
    else:
        y = layers.apply_mlp(p["mlp"], h, cfg)
    return x + y, new_cache


def _mla_decode(p, h: torch.Tensor, cache: dict, cfg: ModelConfig,
                cur_pos: int) -> tuple[torch.Tensor, dict]:
    """Absorbed-form MLA decode: attention in the compressed latent space.

    scores = (q_nope W_uk) . c  +  q_rope . k_rope ; ctx = w . c ; out = W_uv ctx.
    Never materializes per-head K/V -- the whole point of caching latents.
    """
    a = cfg.attn
    q = proj(h, p["wq"])[:, 0]                             # (B,H,nope+rope)
    q_nope, q_rope = q[..., :a.head_dim], q[..., a.head_dim:]
    c1 = layers.apply_norm(p["c_norm"], h @ p["w_dkv"], cfg.norm)[:, 0]
    kr1 = (h @ p["w_kr"])[:, 0]                            # (B, rope)

    pos = torch.tensor([cur_pos], device=h.device)
    cos, sin = layers.rope_angles(pos, a.rope_head_dim, a.rope_theta)
    q_rope = layers.apply_rope(q_rope[:, None], cos[None], sin[None],
                               a.rope_head_dim)[:, 0]
    kr1 = layers.apply_rope(kr1[:, None, None], cos[None], sin[None],
                            a.rope_head_dim)[:, 0, 0]

    cache = _store(cache, ("c", "kr"), (c1[:, None], kr1[:, None]),
                   cur_pos, None)

    q_abs = torch.einsum("bhd,lhd->bhl", q_nope, p["w_uk"])  # (B,H,lora)
    scale = (a.head_dim + a.rope_head_dim) ** -0.5
    scores = (torch.einsum("bhl,bsl->bhs", q_abs, cache["c"])
              + torch.einsum("bhr,bsr->bhs", q_rope, cache["kr"])
              ).to(torch.float32) * scale
    valid = (cache["kpos"] >= 0) & (cache["kpos"] <= cur_pos)
    scores = torch.where(valid[:, None, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhs,bsl->bhl", w.to(cache["c"].dtype), cache["c"])
    out = torch.einsum("bhl,lhv->bhv", ctx, p["w_uv"])
    y = out_proj(out, p["wo"])[:, None]
    return y, cache
