"""Training step: chunked cross-entropy loss, grad accumulation, AdamW.

Counterpart of :mod:`repro.train.train_step`.  The ``(B, S, vocab)``
logits tensor is never materialized for the whole sequence: the loss runs
over sequence chunks, each under ``torch.utils.checkpoint``, so the peak
is one ``(B, chunk, vocab)`` float32 block and the backward recomputes
it per chunk (``repro``'s ``jax.checkpoint`` in a ``lax.scan``).  Each
layer is recomputed in the backward too (``TrainConfig.remat``).

A :class:`TrainState` is ``repro``'s ``{"params", "opt", "step"}``: the
model, its :class:`~repro_torch.train.optimizer.AdamW` (whose
``num_steps`` is the step) and :meth:`TrainState.tree`, the state in
``repro``'s layout, which is what checkpoints hold.  The train step
updates the state in place and returns it.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as tree_mod
from repro_torch.config import ModelConfig
from repro_torch.core import threefry
from repro_torch.distributed import sharding
from repro_torch.models import layers, lm
from repro_torch.train import optimizer as opt_mod


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """``repro``'s fields but ``unroll`` (a scan option: the port's layers
    are a Python loop)."""
    opt: opt_mod.OptConfig = opt_mod.OptConfig()
    loss_chunk: int = 512            # sequence-chunked CE
    microbatches: int = 1            # gradient accumulation
    remat: bool = True
    q_chunk: int = 512
    kv_chunk: int = 1024
    z_loss: float = 1e-4             # logit-norm regularizer (stability)


class TrainState:
    """The model (``params``, gradients on), its optimizer (``opt``) and
    the step."""

    def __init__(self, params: lm.LM, tc: TrainConfig):
        self.params = params.requires_grad_(True)
        self.opt = opt_mod.AdamW(params, tc.opt)

    @property
    def step(self) -> int:
        return self.opt.num_steps

    def tree(self) -> dict:
        """``repro``'s ``{"params", "opt": {"m", "v"}, "step"}`` (segment
        leaves stacked) as tensors on the state's device."""
        dev = next(self.params.parameters()).device
        return {"params": self.params.tree(), "opt": self.opt.moment_tree(),
                "step": torch.tensor(self.step, dtype=torch.int32,
                                     device=dev)}

    def checkpoint_tree(self) -> dict:
        """:meth:`tree`'s structure with each segment leaf as its per-layer
        tensors (:class:`~repro_torch.checkpoint.checkpointer.Layers`), which
        the checkpointer stacks on the host a layer at a time: a save of
        this tree writes :meth:`tree`'s files and makes no stacked copy on
        the device."""
        from repro_torch.checkpoint.checkpointer import Layers

        def leaf_of(leaf, fn, dtype=None):
            if leaf.stacked and leaf.empty is None:
                return Layers(fn(p) for p in leaf.params)
            return leaf.gather(fn, dtype)
        moments = {name: tree_mod.nest(
            (leaf.path, leaf_of(leaf, lambda p, n=name: self.opt.state[p][n],
                                torch.float32))
            for leaf in self.opt.leaves) for name in ("m", "v")}
        dev = next(self.params.parameters()).device
        return {"params": tree_mod.nest(
                    (leaf.path, leaf_of(leaf, lambda p: p.data))
                    for leaf in lm.stacked_leaves(self.params)),
                "opt": moments,
                "step": torch.tensor(self.step, dtype=torch.int32,
                                     device=dev)}

    def grad_tree(self) -> dict:
        """The parameters' ``.grad`` in ``repro``'s layout (segment leaves
        stacked; zeros where a parameter took no gradient): ``repro``'s
        ``grads``, the input of :mod:`~repro_torch.train.compression`."""
        def grad(p):
            return torch.zeros_like(p) if p.grad is None else p.grad
        return tree_mod.nest((leaf.path, leaf.gather(grad))
                             for leaf in self.opt.leaves)

    @classmethod
    def from_tree(cls, tree: dict, cfg: ModelConfig, tc: TrainConfig
                  ) -> "TrainState":
        """A state from tensors in ``repro``'s layout (the params tree's
        tensors become the model's; the moments are copied)."""
        state = cls(lm.LM(cfg, tree["params"]), tc)
        state.opt.load_moment_tree(tree["opt"])
        state.opt.num_steps = int(tree["step"])
        return state


def init_train_state(seed: int, cfg: ModelConfig, tc: TrainConfig, *,
                     device: str | torch.device | None = None,
                     partitionable: bool = threefry.PARTITIONABLE,
                     mesh=None, rules: sharding.Rules | None = None
                     ) -> TrainState:
    """``repro``'s ``init_train_state(jax.random.key(seed), cfg, tc)``
    on ``device`` (``None``: ``cuda``): ``init_lm``'s weights (drawn
    through the Threefry kernel on the card), zero moments, step 0.
    With a ``mesh`` (a ``DeviceMesh``) every rank draws the same weights
    and keeps its shard of each (``rules``: ``TRAIN_RULES`` by default),
    and the moments take the parameters' placements."""
    model = lm.init_lm(seed, cfg, device=device, partitionable=partitionable)
    if mesh is not None:
        from repro_torch.distributed import param_specs
        param_specs.distribute_lm(model, mesh,
                                  rules or sharding.TRAIN_RULES)
    return TrainState(model, tc)


def _ce_chunk(embed, h: torch.Tensor, labels: torch.Tensor,
              cfg: ModelConfig, z_loss: float):
    logits = layers.lm_logits(embed, h, cfg)                 # float32
    logits = sharding.constrain_safe(logits, ("batch", "seq", "vocab"))
    mask = labels >= 0
    lse = torch.logsumexp(logits, dim=-1)
    idx = labels.clamp_min(0).long()[..., None]
    if isinstance(logits, DTensor):
        # no gather across a vocab-sharded axis: pick the gold logit by a
        # mask and sum it (exact: every other term is 0)
        vocab = torch.arange(logits.shape[-1], device=logits.device)
        gold = torch.where(vocab == idx, logits, 0.0).sum(logits.ndim - 1)
    else:
        gold = torch.gather(logits, -1, idx)[..., 0]
    ce = (lse - gold) * mask
    zl = z_loss * torch.square(lse) * mask
    return (ce + zl).sum(), mask.sum()


def chunked_ce_loss(h: torch.Tensor, embed, labels: torch.Tensor,
                    cfg: ModelConfig, chunk: int, z_loss: float
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy over sequence chunks; returns (sum_loss, n_tokens).

    labels == -1 positions are masked out.
    """
    b, s, d = h.shape
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        # concatenations, which DTensor runs in every version
        h = layers.pad_zeros(h, 1, after=pad)
        labels = layers.pad_zeros(labels, 1, after=pad, value=-1)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    n = torch.zeros((), dtype=torch.int64, device=h.device)
    for c0 in range(0, h.shape[1], chunk):
        hi, li = h[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        if torch.is_grad_enabled():
            part, m = checkpoint(_ce_chunk, embed, hi, li, cfg, z_loss,
                                 use_reentrant=False)
        else:
            part, m = _ce_chunk(embed, hi, li, cfg, z_loss)
        tot, n = tot + part, n + m
    return tot, n


def make_loss_fn(cfg: ModelConfig, tc: TrainConfig):
    """``loss_fn(model, batch) -> (loss, {"ce", "aux", "tokens"})``."""
    def loss_fn(params, batch):
        kw = {}
        if cfg.family == "audio":
            kw["enc_embeds"] = batch["enc_embeds"]
        if cfg.family == "vlm":
            kw["prefix_embeds"] = batch["prefix_embeds"]
        h, aux, _ = lm.forward(
            params, batch["tokens"], cfg, remat=tc.remat,
            q_chunk=tc.q_chunk, kv_chunk=tc.kv_chunk,
            return_hidden=True, **kw)
        labels = batch["labels"]
        if cfg.family == "vlm":      # prefix positions carry no LM loss
            prefix = h.shape[1] - labels.shape[1]
            h = h[:, prefix:]
        tot, n = chunked_ce_loss(h, params["embed"], labels, cfg,
                                 tc.loss_chunk, tc.z_loss)
        ce = tot / torch.clamp_min(n, 1)
        return ce + aux, {"ce": ce, "aux": aux, "tokens": n}
    return loss_fn


def make_train_step(cfg: ModelConfig, tc: TrainConfig,
                    grad_shardings: dict | None = None):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``batch`` holds tensors on the state's device (DTensors placed by
    :func:`~repro_torch.distributed.param_specs.batch_specs` for a state
    on a mesh; the step then runs under :func:`~repro_torch.distributed.
    sharding.use_rules` with the state's mesh and
    ``sharding.TRAIN_RULES``).  With ``tc.microbatches > 1`` the batch's
    leading dim is split and the gradients accumulate in float32
    (``repro``'s sequential scan); the loss is the microbatches' mean and
    ``ce`` / ``aux`` / ``tokens`` the last microbatch's, as in ``repro``.
    Metrics are plain 0-d tensors (``lr`` a float32 scalar).

    A DTensor parameter's gradient is pinned to placements before AdamW
    (``repro``'s ``constrain_grads``): those of ``grad_shardings``, a
    spec tree over ``repro``'s parameter layout
    (:func:`~repro_torch.distributed.param_specs.param_specs`), or by
    default the parameter's own, so the data-parallel reduction of a
    sharded parameter is a reduce-scatter.
    """
    loss_fn = make_loss_fn(cfg, tc)

    specs = (dict(tree_mod.flatten(grad_shardings))
             if grad_shardings is not None else None)

    def pin(opt, grads: dict | None) -> None:
        pinned = {}
        for leaf in opt.leaves:
            spec = None
            if specs is not None:
                spec = specs[leaf.path][1:] if leaf.stacked \
                    else specs[leaf.path]
            for p in leaf.params:
                g = p.grad if grads is None else grads[p]
                if not isinstance(g, DTensor):
                    continue
                place = p.placements if spec is None else \
                    sharding.placements(spec, p.device_mesh)
                pinned[p] = g.redistribute(p.device_mesh, place)
        for p, g in pinned.items():
            if grads is None:
                p.grad = g
            else:
                grads[p] = g

    def train_step(state: TrainState, batch: dict):
        # plain tensors made in the step meet DTensors as replicated ones
        with implicit_replication():
            return _step(state, batch)

    def _step(state: TrainState, batch: dict):
        params, opt = state.params, state.opt
        opt.zero_grad(set_to_none=True)
        grads = None
        if tc.microbatches > 1:
            mb = next(iter(batch.values())).shape[0] // tc.microbatches
            grads = {p: torch.zeros_like(p, dtype=torch.float32)
                     for g in opt.param_groups for p in g["params"]}
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            for i in range(tc.microbatches):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                mloss, metrics = loss_fn(params, micro)
                mloss.backward()
                pin(opt, None)
                with torch.no_grad():
                    for p, acc in grads.items():
                        if p.grad is not None:
                            acc.add_(p.grad.to(torch.float32))
                            p.grad = None
                loss = loss + mloss.detach()
            for acc in grads.values():
                acc.div_(tc.microbatches)
            loss = loss / tc.microbatches
        else:
            loss, metrics = loss_fn(params, batch)
            loss.backward()
            loss = loss.detach()
        pin(opt, grads)
        stats = opt.step(grads)
        metrics = {k: opt_mod.full(v.detach()) for k, v in metrics.items()}
        return state, dict(metrics, loss=opt_mod.full(loss), **stats)

    return train_step
