"""Assigned input shapes and allocation-free stand-ins for the dry run.

Counterpart of :mod:`repro.configs.shapes`.  Four LM shapes;
``input_specs`` builds ``meta`` tensors (shape and dtype, no storage) for
every model input of the step function being run:

  train_4k     seq 4,096  x batch 256   -> train_step
  prefill_32k  seq 32,768 x batch 32    -> serve prefill (forward)
  decode_32k   seq 32,768 x batch 128   -> serve decode_step (1 new token)
  long_500k    seq 524,288 x batch 1    -> decode; sub-quadratic archs only

[audio]: seq_len applies to the encoder (stub frame embeddings); decoder
takes dec_len_train tokens for train/prefill shapes.
[vlm]: vlm_prefix stub patch embeddings are part of the sequence budget.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import layers, lm


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runs?, reason-if-skipped)."""
    if shape.name == "long_500k" and cfg.quadratic_attention:
        return False, "pure full-attention arch; 500k decode cache is " \
                      "O(L) per layer for every layer (DESIGN.md skip table)"
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """``meta`` stand-ins for the step function's data arguments.

    train  -> {tokens, labels[, enc_embeds | prefix_embeds]}
    prefill-> {tokens[, enc_embeds | prefix_embeds]}
    decode -> {token, cur_pos}  (caches come from cache_specs())
    """
    b, s = shape.global_batch, shape.seq_len
    dt = layers.param_dtype(cfg)
    i32 = torch.int32
    if shape.kind == "decode":
        return {"token": _meta((b,), i32), "cur_pos": _meta((), i32)}
    if cfg.family == "audio":
        d = cfg.dec_len_train
        spec = {"enc_embeds": _meta((b, s, cfg.d_model), dt),
                "tokens": _meta((b, d), i32)}
        if shape.kind == "train":
            spec["labels"] = _meta((b, d), i32)
        return spec
    if cfg.family == "vlm":
        text = s - cfg.vlm_prefix
        spec = {"prefix_embeds": _meta((b, cfg.vlm_prefix, cfg.d_model), dt),
                "tokens": _meta((b, text), i32)}
        if shape.kind == "train":
            spec["labels"] = _meta((b, text), i32)
        return spec
    spec = {"tokens": _meta((b, s), i32)}
    if shape.kind == "train":
        spec["labels"] = _meta((b, s), i32)
    return spec


def cache_specs(cfg: ModelConfig, shape: ShapeSpec) -> list:
    """Decode caches as ``meta`` tensors (no allocation)."""
    assert shape.kind == "decode"
    enc_len = shape.seq_len if cfg.family == "audio" else 0
    return lm.init_cache(cfg, shape.global_batch, shape.seq_len,
                         enc_len=enc_len, device="meta")


def param_specs(cfg: ModelConfig, seed: int = 0) -> lm.LM:
    """The model on ``meta`` (shapes and dtypes, nothing drawn)."""
    return lm.init_lm(seed, cfg, device="meta")
