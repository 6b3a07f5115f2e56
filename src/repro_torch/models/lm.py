"""Full language models: segment-planned stacks of blocks.

Counterpart of :mod:`repro.models.lm`.  A model is a sequence of
*segments* -- homogeneous runs of one block kind -- so heterogeneous
stacks (DeepSeek-V2's dense first layer, Hymba's three global-attention
layers) keep ``repro``'s parameter layout.  ``repro`` scans each segment
over parameters stacked on a leading layer axis; here a segment is an
``nn.ModuleList`` of :class:`~repro_torch.models.blocks.Block`, whose
parameters are views of that stacked layout (:class:`LM`), and the
decode caches keep the stacked layout: one tensor a leaf per segment,
written in place one layer at a time.  :func:`stacked_leaves` names
the tensors that make each of ``repro``'s stacked leaves, which is what
the trainer's weight decay, gradient compression and checkpoints see.

Entry points:
  init_lm / forward           training + prefill (optionally returns caches)
  init_cache / prefill        decode-cache construction
  decode_step                 one-token decode across all segments
  encode_audio                whisper encoder over stub frame embeddings
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as tree_mod
from repro_torch.config import ModelConfig
from repro_torch.core import threefry
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding
from repro_torch.models import blocks, layers, ssm as ssm_mod
from repro_torch.models.attention import proj
from repro_torch.models.blocks import Block
from repro_torch.models.layers import Keys, ParamTree


def tree_map(fn, tree, *rest):
    """Apply ``fn`` to the leaves of nested dicts (and tuples) of one
    structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(tree_map(fn, v, *(r[i] for r in rest))
                     for i, v in enumerate(tree))
    return fn(tree, *rest)


def segments(cfg: ModelConfig) -> tuple[tuple[str, int], ...]:
    """Plan the layer stack as (kind, count) runs."""
    if cfg.family == "ssm":
        return (("ssm", cfg.n_layers),)
    if cfg.family == "hybrid":
        n = cfg.n_layers  # global full-attention at layers {0, n//2, n-1}
        return (("hybrid_global", 1), ("hybrid_swa", n // 2 - 1),
                ("hybrid_global", 1), ("hybrid_swa", n - n // 2 - 2),
                ("hybrid_global", 1))
    if cfg.family == "audio":
        return (("dec", cfg.n_layers),)
    if cfg.moe is not None:
        if cfg.n_dense_layers:
            return (("dense", cfg.n_dense_layers),
                    ("moe", cfg.n_layers - cfg.n_dense_layers))
        return (("moe", cfg.n_layers),)
    return (("dense", cfg.n_layers),)


def _stack(cfg: ModelConfig, kind: str, tree: dict) -> nn.ModuleList:
    """A stacked segment tree (leading layer axis) -> one Block a layer,
    each holding views of the stacked tensors.  A segment of no layer
    (``repro``'s plan makes one for Hymba at 4 layers) keeps its
    ``(0, ...)`` tensors as ``.empty``."""
    count = next(iter(_leaves(tree))).shape[0]
    seg = nn.ModuleList(
        Block(cfg, kind, tree_map(lambda t, i=i: t[i], tree))
        for i in range(count))
    seg.empty = tree if count == 0 else None
    return seg


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


@dataclasses.dataclass
class Leaf:
    """One of ``repro``'s parameter leaves: its path (``("segments", 0,
    "attn", "wq")``) and the port's tensors that make it: one a layer for
    a segment's leaf (``repro`` stacks them on a leading axis; ``empty``,
    the ``(0, ...)`` tensor, where the segment has no layer), else the
    one tensor."""
    path: tuple
    params: list
    empty: torch.Tensor | None = None

    @property
    def stacked(self) -> bool:
        return self.path[0] in ("segments", "enc_segments")

    @property
    def ndim(self) -> int:
        """The rank of ``repro``'s leaf (a segment's has the layer axis)."""
        if self.empty is not None:
            return self.empty.ndim
        return self.params[0].ndim + self.stacked

    def gather(self, fn, dtype: torch.dtype | None = None) -> torch.Tensor:
        """``repro``'s leaf of ``fn(tensor)``: stacked over the layers, or
        of the one tensor (``dtype``: a 0-layer leaf's, if not the
        parameter's)."""
        if self.empty is not None:
            return self.empty.detach().to(dtype or self.empty.dtype)
        if self.stacked:
            return torch.stack([fn(p) for p in self.params])
        return fn(self.params[0])


def stacked_leaves(model: "LM") -> list[Leaf]:
    """``repro``'s parameter leaves in ``jax.tree``'s order."""
    tops = {"embed": model.embed, "final_norm": model.final_norm,
            "segments": model.segments}
    if model.cfg.is_encdec:
        tops.update(enc_norm=model.enc_norm, enc_segments=model.enc_segments)
    out = []
    for top in sorted(tops):
        node = tops[top]
        if isinstance(node, ParamTree):
            out.extend(Leaf(path, [p]) for path, p in node.leaves((top,)))
            continue
        for i, seg in enumerate(node):
            if seg.empty is not None:
                out.extend(Leaf((top, i) + path, [], t)
                           for path, t in tree_mod.flatten(seg.empty))
                continue
            per_layer = [blk.leaves((top, i)) for blk in seg]
            out.extend(Leaf(path, [layer[j][1] for layer in per_layer])
                       for j, (path, _) in enumerate(per_layer[0]))
    return out


class LM(nn.Module):
    """A whole model: ``repro``'s parameter tree as modules.

    ``tree`` is ``repro``'s layout: ``embed``, ``final_norm`` and
    ``segments`` (one dict a segment, every leaf stacked on a leading
    layer axis), and for enc-dec models ``enc_segments`` and
    ``enc_norm``; ``params["embed"]``-style reads work as on the dict.
    A model made on the card turns TF32 off for CUDA matmuls, whatever
    the caller had set.
    """

    def __init__(self, cfg: ModelConfig, tree: dict):
        super().__init__()
        if next(iter(_leaves(tree))).device.type == "cuda":
            # float32 models hold repro's products in full float32
            torch.backends.cuda.matmul.allow_tf32 = False
        self.cfg = cfg
        self.embed = ParamTree(tree["embed"])
        self.final_norm = ParamTree(tree["final_norm"])
        self.segments = nn.ModuleList(
            _stack(cfg, kind, seg)
            for seg, (kind, _) in zip(tree["segments"], segments(cfg)))
        if cfg.is_encdec:
            self.enc_segments = nn.ModuleList(
                [_stack(cfg, "enc", tree["enc_segments"][0])])
            self.enc_norm = ParamTree(tree["enc_norm"])

    def __getitem__(self, name: str):
        return getattr(self, name)

    def tree(self) -> dict:
        """The parameters in ``repro``'s layout (segments stacked)."""
        return tree_mod.nest((leaf.path, leaf.gather(lambda p: p.data))
                             for leaf in stacked_leaves(self))

    def forward(self, tokens: torch.Tensor, **kw):
        return forward(self, tokens, self.cfg, **kw)


def _stack_init(keys: Keys, cfg: ModelConfig, kind: str, count: int
                ) -> dict:
    """``jax.vmap(init_block)`` over ``split(key, count)``."""
    return blocks.init_block(keys.stacked(count), cfg, kind)


def init_lm(key: Keys | int, cfg: ModelConfig, *,
            device: str | torch.device | None = None,
            partitionable: bool = threefry.PARTITIONABLE) -> LM:
    """``repro``'s ``init_lm(jax.random.key(seed), cfg)`` on ``device``
    (``None``: ``cuda``), drawn through the Threefry kernel there (its
    plain version on the CPU) in the given threefry mode."""
    if not isinstance(key, Keys):
        key = Keys.from_seed(key, resolve_device(device),
                             partitionable=partitionable)
    ks = key.split(4 + len(segments(cfg)))

    def one(tree):                       # drop the batch axis of N = 1
        return tree_map(lambda t: t[0], tree)
    tree = {
        "embed": one(layers.init_embed(ks[0], cfg)),
        "final_norm": one(layers.init_norm(key, cfg, cfg.d_model)),
        "segments": tuple(
            _stack_init(ks[3 + i], cfg, kind, count)
            for i, (kind, count) in enumerate(segments(cfg))),
    }
    if cfg.is_encdec:
        tree["enc_segments"] = (_stack_init(ks[1], cfg, "enc",
                                            cfg.n_enc_layers),)
        tree["enc_norm"] = one(layers.init_norm(key, cfg, cfg.d_model))
    return LM(cfg, tree)


def _run_block(blk: Block, h: torch.Tensor, remat: bool, **kw):
    """``blk(h, **kw)``; with ``remat``, under autograd, its activations
    are recomputed in the backward (``repro``'s ``jax.checkpoint`` around
    each layer)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(blk, h, use_reentrant=False, **kw)
    return blk(h, **kw)


def encode_audio(params, frame_embeds: torch.Tensor, cfg: ModelConfig,
                 enc_valid: torch.Tensor | None = None,
                 q_chunk: int = 512, kv_chunk: int = 512,
                 remat: bool = True) -> torch.Tensor:
    """Whisper encoder over stub conv-frontend frame embeddings (B, S, d)."""
    s = frame_embeds.shape[1]
    pos = torch.arange(s, device=frame_embeds.device)
    h = frame_embeds + layers.sinusoidal_embed(pos, cfg.d_model)[None]
    h = h.to(layers.param_dtype(cfg))
    for blk in params["enc_segments"][0]:
        h, _, _ = _run_block(blk, h, remat, positions=pos,
                             kv_valid=enc_valid, q_chunk=q_chunk,
                             kv_chunk=kv_chunk)
    return layers.apply_norm(params["enc_norm"], blocks.gather_seq(h),
                             cfg.norm).to(h.dtype)


def forward(params, tokens: torch.Tensor, cfg: ModelConfig, *,
            pos0: int = 0,
            prefix_embeds: torch.Tensor | None = None,
            enc_embeds: torch.Tensor | None = None,
            enc_valid: torch.Tensor | None = None,
            kv_valid: torch.Tensor | None = None,
            return_caches: bool = False,
            return_hidden: bool = False,
            remat: bool = True,
            q_chunk: int = 512, kv_chunk: int = 512):
    """Full-sequence forward.

    Returns (logits (B, S_total, vocab), aux_loss, caches_per_segment);
    with ``return_hidden`` the first element is the final hidden state
    instead (the trainer's chunked loss runs over it).  ``prefix_embeds``:
    VLM patch embeddings prepended (prefix-LM mask).  ``enc_embeds``:
    whisper encoder frame embeddings (enc-dec only).  A segment's caches
    come back stacked on a leading layer axis.  ``remat`` recomputes each
    layer in the backward where autograd records and no cache is asked
    for, as ``repro`` does.
    """
    h = layers.embed_tokens(params["embed"], tokens, cfg)
    prefix_len = 0
    if prefix_embeds is not None:
        prefix_len = prefix_embeds.shape[1]
        h = torch.cat([prefix_embeds.to(h.dtype), h], dim=1)
    s_total = h.shape[1]
    positions = pos0 + torch.arange(s_total, device=h.device)
    if cfg.pos == "sinusoidal":
        h = h + layers.sinusoidal_embed(positions,
                                        cfg.d_model)[None].to(h.dtype)
    h = sharding.constrain_safe(h, ("batch", "seq", None))

    enc_out = None
    if cfg.is_encdec:
        if enc_embeds is None:
            raise ValueError("enc-dec model needs enc_embeds")
        enc_out = encode_audio(params, enc_embeds, cfg, enc_valid,
                               q_chunk, kv_chunk, remat=remat)

    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    caches = []
    for seg, (kind, _) in zip(params["segments"], segments(cfg)):
        seg_caches = []
        for blk in seg:
            h, aux, cache = _run_block(
                blk, h, remat and not return_caches, positions=positions,
                prefix_len=prefix_len, kv_valid=kv_valid, enc_out=enc_out,
                enc_valid=enc_valid, q_chunk=q_chunk, kv_chunk=kv_chunk,
                return_cache=return_caches)
            if kind == "dec" and return_caches:
                cache = dict(cache,
                             xk=proj(enc_out, blk["xattn"]["wk"]),
                             xv=proj(enc_out, blk["xattn"]["wv"]))
            aux_total = aux_total + aux
            seg_caches.append(cache)
        caches.append(tree_map(lambda *ls: torch.stack(ls), *seg_caches)
                      if return_caches and seg_caches else None)

    h = layers.apply_norm(params["final_norm"], blocks.gather_seq(h),
                          cfg.norm).to(h.dtype)
    if return_hidden:
        return h, aux_total, caches
    logits = layers.lm_logits(params["embed"], h, cfg)
    logits = sharding.constrain_safe(logits, ("batch", "seq", "vocab"))
    return logits, aux_total, caches


# -- decode caches ---------------------------------------------------------------

def _attn_cache_shape(cfg: ModelConfig, kind: str, count: int, batch: int,
                      max_len: int, dtype, device) -> dict:
    a = cfg.attn
    length = max_len
    if kind == "hybrid_swa" and a.window is not None:
        length = min(a.window, max_len)
    lead = (count, batch, length)
    kpos = torch.full(lead, -1, dtype=torch.int32, device=device)
    if a.kind == "mla":
        return {"c": torch.zeros(lead + (a.kv_lora,), dtype=dtype,
                                 device=device),
                "kr": torch.zeros(lead + (a.rope_head_dim,), dtype=dtype,
                                  device=device),
                "kpos": kpos}
    return {"k": torch.zeros(lead + (a.num_kv_heads, a.head_dim),
                             dtype=dtype, device=device),
            "v": torch.zeros(lead + (a.num_kv_heads, a.vdim), dtype=dtype,
                             device=device),
            "kpos": kpos}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               enc_len: int = 0, dtype=torch.bfloat16,
               device: str | torch.device | None = None) -> list:
    """Zeroed decode caches, one stacked dict per segment."""
    dev = resolve_device(device)
    caches = []
    for kind, count in segments(cfg):
        def ssm_cache():
            return tree_map(
                lambda t: t[None].expand((count,) + t.shape).clone(),
                ssm_mod.init_ssm_cache(batch, cfg, cfg.ssm, dtype, dev))
        if kind == "ssm":
            caches.append(ssm_cache())
            continue
        c = _attn_cache_shape(cfg, kind, count, batch, max_len, dtype, dev)
        if kind in ("hybrid_global", "hybrid_swa"):
            c = {"attn": c, "ssm": ssm_cache()}
        if kind == "dec":
            a = cfg.attn
            c = dict(c,
                     xk=torch.zeros((count, batch, enc_len, a.num_kv_heads,
                                     a.head_dim), dtype=dtype, device=dev),
                     xv=torch.zeros((count, batch, enc_len, a.num_kv_heads,
                                     a.vdim), dtype=dtype, device=dev),
                     xkpos=torch.arange(enc_len, dtype=torch.int32,
                                        device=dev).expand(
                         count, batch, enc_len).clone())
        caches.append(c)
    return caches


def _write_back(full: dict, layer: dict, new: dict, i: int) -> None:
    """Store layer ``i``'s new cache into the stacked one, skipping the
    entries already written in place."""
    for name, value in new.items():
        if isinstance(value, dict):
            _write_back(full[name], layer[name], value, i)
        elif value is not layer[name]:
            full[name][i].copy_(value)


def decode_step(params, token: torch.Tensor, caches: list, cur_pos: int,
                cfg: ModelConfig):
    """One-token decode. token: (B,) int; cur_pos: int.

    Returns (logits (B, vocab) fp32, caches) -- the same cache tensors,
    updated in place.
    """
    h = layers.embed_tokens(params["embed"], token[:, None], cfg)
    if cfg.pos == "sinusoidal":
        pos = torch.tensor([[cur_pos]], device=h.device)
        h = h + layers.sinusoidal_embed(pos, cfg.d_model).to(h.dtype)
    h = sharding.constrain_safe(h, ("batch", None, None))

    for seg, seg_cache, (kind, _) in zip(params["segments"], caches,
                                         segments(cfg)):
        for i, blk in enumerate(seg):
            lc = tree_map(lambda c, i=i: c[i], seg_cache)
            h, nc = blk.decode(h, lc, cur_pos)
            _write_back(seg_cache, lc, nc, i)

    h = layers.apply_norm(params["final_norm"], h, cfg.norm).to(h.dtype)
    logits = layers.lm_logits(params["embed"], h, cfg)[:, 0]
    return logits, caches


def prefill(params, tokens: torch.Tensor, cfg: ModelConfig, max_len: int,
            *, prefix_embeds=None, enc_embeds=None, enc_valid=None,
            kv_valid=None, q_chunk: int = 512, kv_chunk: int = 512):
    """Run the prompt and build decode caches padded to ``max_len``.

    Returns (logits, caches, s_prompt).
    """
    logits, _, seg_caches = forward(
        params, tokens, cfg, prefix_embeds=prefix_embeds,
        enc_embeds=enc_embeds, enc_valid=enc_valid, kv_valid=kv_valid,
        return_caches=True, q_chunk=q_chunk, kv_chunk=kv_chunk)
    b = tokens.shape[0]
    s = logits.shape[1]
    out_caches = []
    for i, ((kind, count), cache) in enumerate(zip(segments(cfg),
                                                   seg_caches)):
        if count == 0:        # a segment of no layer: its (0, ...) caches
            out_caches.append(init_cache(
                cfg, b, max_len, dtype=layers.param_dtype(cfg),
                device=tokens.device)[i])
        else:
            out_caches.append(_assemble_cache(cache, cfg, kind, b, s,
                                              max_len))
    return logits, out_caches, s


def _assemble_cache(cache, cfg: ModelConfig, kind: str, b: int, s: int,
                    max_len: int):
    """Pad/ring-place prefill caches into decode layout (adds kpos)."""
    if kind == "ssm":
        return cache
    a = cfg.attn
    dev = next(iter(_leaves(cache))).device
    pos = torch.arange(s, dtype=torch.int32, device=dev)

    def place(x, length):
        # x: (count, B, s, ...) -> (count, B, length, ...) at slot pos%length
        if s <= length:
            out = x.new_zeros(x.shape[:2] + (length,) + x.shape[3:])
            out[:, :, :s] = x
            return out
        # ring placement of the last `length` positions
        tail = x[:, :, s - length:]
        order = torch.argsort(pos[s - length:] % length)
        return tail[:, :, order]

    def build(attn_cache, length):
        names = ("c", "kr") if a.kind == "mla" else ("k", "v")
        out = {name: place(attn_cache[name], length) for name in names}
        count = out[names[0]].shape[0]
        if s <= length:
            kp = torch.cat([pos, torch.full((length - s,), -1,
                                            dtype=torch.int32, device=dev)])
        else:
            tailp = pos[s - length:]
            kp = tailp[torch.argsort(tailp % length)]
        out["kpos"] = kp[None, None].expand(count, b, length).clone()
        return out

    if kind in ("hybrid_global", "hybrid_swa"):
        length = max_len if kind == "hybrid_global" else min(
            a.window or max_len, max_len)
        return {"attn": build(cache["attn"], length), "ssm": cache["ssm"]}
    if kind == "dec":
        out = build({k: cache[k] for k in ("k", "v")}, max_len)
        count, _, enc_len = cache["xk"].shape[:3]
        out["xk"], out["xv"] = cache["xk"], cache["xv"]
        out["xkpos"] = torch.arange(enc_len, dtype=torch.int32, device=dev
                                    )[None, None].expand(
            count, b, enc_len).clone()
        return out
    return build(cache, max_len)
