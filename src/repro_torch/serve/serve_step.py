"""Serving steps: prefill (last-token logits only) and decode, + sampling.

Counterpart of :mod:`repro.serve.serve_step`.  The prefill step returns
only the last position's logits -- at 32k x 256k-vocab, full prefill
logits would be ~0.5 TB; sampling needs one row per sequence.

Sampling at a temperature above 0 is ``jax.random.categorical``'s Gumbel
max trick on ``jax.random``'s own draws (:mod:`repro_torch.core
.threefry`): ``argmax(logits / t - log(-log(u)))`` with ``u`` uniform on
``[tiny, 1)`` under the given key, so the port samples the tokens
``repro`` samples (but for near-ties of the perturbed logits).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.core import threefry
from repro_torch.kernels import threefry as threefry_kernel
from repro_torch.models import layers, lm

#: float32's smallest normal: the low end of the Gumbel uniforms.
TINY = float(np.finfo(np.float32).tiny)


def make_prefill_step(cfg: ModelConfig, max_len: int, *,
                      q_chunk: int = 512, kv_chunk: int = 1024):
    """prefill(params, tokens, **frontend_kw) -> (last_logits (B,V), caches)."""

    def prefill_step(params, tokens, enc_embeds=None, prefix_embeds=None):
        kw = {}
        if enc_embeds is not None:
            kw["enc_embeds"] = enc_embeds
        if prefix_embeds is not None:
            kw["prefix_embeds"] = prefix_embeds
        h, _, seg_caches = lm.forward(
            params, tokens, cfg, return_caches=True, return_hidden=True,
            q_chunk=q_chunk, kv_chunk=kv_chunk, **kw)
        b, s, _ = h.shape
        caches = [lm._assemble_cache(cache, cfg, kind, b, s, max_len)
                  for (kind, _), cache in zip(lm.segments(cfg), seg_caches)]
        last = layers.lm_logits(params["embed"], h[:, -1:], cfg)[:, 0]
        return last, caches

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """decode(params, token (B,), caches, cur_pos) -> (logits (B,V), caches)."""

    def decode(params, token, caches, cur_pos):
        return lm.decode_step(params, token, caches, cur_pos, cfg)

    return decode


def sample(logits: torch.Tensor, key, temperature: float = 0.0,
           top_k: int = 0, *,
           partitionable: bool = threefry.PARTITIONABLE) -> torch.Tensor:
    """Greedy (t=0) or temperature/top-k sampling. logits: (B, V); ``key``
    a ``jax.random`` key pair (uint32 words)."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / temperature
    if top_k:
        vals = torch.topk(logits, top_k, dim=-1).values
        logits = torch.where(logits < vals[..., -1:], -1e30, logits)
    keys = threefry_kernel.keys_tensor(key, logits.device)
    u = threefry_kernel.threefry_draw(
        keys, logits.numel(), epilogue="uniform", minval=TINY, maxval=1.0,
        partitionable=partitionable).reshape(logits.shape)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(gumbel + logits, dim=-1).to(torch.int32)


def generate(params, prompt: torch.Tensor, cfg: ModelConfig, *, steps: int,
             max_len: int, key=None, temperature: float = 0.0,
             q_chunk: int = 256, kv_chunk: int = 256,
             partitionable: bool = threefry.PARTITIONABLE,
             **frontend_kw) -> torch.Tensor:
    """Simple end-to-end generation loop (prefill + decode steps); ``key``
    defaults to ``jax.random.key(0)``."""
    key = threefry.key(0) if key is None else key
    prefill = make_prefill_step(cfg, max_len, q_chunk=q_chunk,
                                kv_chunk=kv_chunk)
    decode = make_decode_step(cfg)
    logits, caches = prefill(params, prompt, **frontend_kw)
    pos0 = prompt.shape[1] + (
        cfg.vlm_prefix if frontend_kw.get("prefix_embeds") is not None else 0)
    toks = []
    tok = sample(logits, key, temperature, partitionable=partitionable)
    for i in range(steps):
        toks.append(tok)
        logits, caches = decode(params, tok, caches, pos0 + i)
        key, sub = threefry.split(key, 2, partitionable=partitionable)
        tok = sample(logits, sub, temperature, partitionable=partitionable)
    toks.append(tok)
    return torch.stack(toks, dim=1)
