"""Gradient compression: int8 quantization with error feedback (EF-SGD).

Counterpart of :mod:`repro.train.compression`.  Each leaf is quantized
to int8 against one float32 scale, the max of ``|g|`` over the leaf over
127; error feedback keeps the quantization residual locally and adds it
to the next step's gradient (Karimireddy et al., 2019).

Trees are ``repro``'s layout (nested dicts and tuples of tensors), so a
segment's leaf is its stacked ``(L, ...)`` gradient
(:meth:`repro_torch.train.train_step.TrainState.grad_tree`) and its
scale is taken over all L layers together, as ``repro`` takes it: a
scale a layer would quantize differently.  ``torch.round`` rounds half
to even, as ``jnp.round`` does, so the payloads equal ``repro``'s.

Usage around a data-parallel reduction:

    cstate = init_state(grads)
    qgrads, cstate = compress(grads, cstate)       # before all-reduce
    grads = decompress(qgrads)                      # after all-reduce

or :func:`compressed_psum`, the explicit reduction over a
``torch.distributed`` group (``repro``'s ``shard_map`` version).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch import tree as tree_mod


def init_state(grads):
    """Error-feedback residuals, zero-initialized, shaped like grads."""
    return tree_mod.nest(
        (p, torch.zeros_like(g, dtype=torch.float32))
        for p, g in tree_mod.flatten(grads))


def _scale(g: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(g.abs().max(), 1e-12) / 127.0


def _quantize(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)


def _quant_one(g: torch.Tensor, err: torch.Tensor):
    g = g.to(torch.float32) + err
    scale = _scale(g)
    q = _quantize(g, scale)
    return {"q": q, "scale": scale}, g - q.to(torch.float32) * scale


def _zip_map(fn, grads, err_state):
    """``fn(g, e)`` over matching leaves -> two trees of its outputs."""
    errs = dict(tree_mod.flatten(err_state))
    outs = [(p, fn(g, errs[p])) for p, g in tree_mod.flatten(grads)]
    return (tree_mod.nest((p, o[0]) for p, o in outs),
            tree_mod.nest((p, o[1]) for p, o in outs))


def compress(grads, err_state):
    """-> (quantized tree of ``{"q": int8, "scale": float32}``, new
    error-feedback state)."""
    return _zip_map(_quant_one, grads, err_state)


def decompress(qgrads):
    flat = tree_mod.flatten(qgrads)
    # a leaf here is the {"q", "scale"} pair: its path ends in the name
    pairs = {}
    for path, x in flat:
        pairs.setdefault(path[:-1], {})[path[-1]] = x
    return tree_mod.nest((p, d["q"].to(torch.float32) * d["scale"])
                         for p, d in pairs.items())


def compressed_psum(grads, err_state, group=None):
    """Explicit compressed data-parallel all-reduce over ``group``.

    The quantization scale is agreed FIRST (a ``MAX`` all-reduce of the
    local maxima, ``repro``'s ``pmax``), then every rank quantizes
    against the shared scale and the int8 payloads sum in int32 (a
    ``SUM`` all-reduce, ``repro``'s ``psum``; no overflow below 2^24
    ranks).  Returns (the ranks' mean gradient, new error-feedback
    state).
    """
    n = dist.get_world_size(group)

    def one(g, e):
        g = g.to(torch.float32) + e
        scale = _scale(g)
        dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
        q = _quantize(g, scale)
        ne = g - q.to(torch.float32) * scale          # error feedback
        summed = q.to(torch.int32)
        dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=group)
        return summed.to(torch.float32) * scale / n, ne

    return _zip_map(one, grads, err_state)
