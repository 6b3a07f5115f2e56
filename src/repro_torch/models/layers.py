"""Shared model layers: norms, MLPs, embeddings, RoPE.

Counterpart of :mod:`repro.models.layers`.  ``repro`` keeps parameters in
plain nested dicts; here they live in :class:`ParamTree` modules with the
same keys (``p["w_in"]``, ``p["attn"]["wq"]``), so each function below
reads like its counterpart and :mod:`repro_torch.convert` carries a
``repro`` tree across key for key.  Compute runs in the parameter dtype
(bf16 by default) with float32 norm / softmax internals, and every cast
sits where ``repro`` puts it.

Weights are drawn as ``repro`` draws them: ``jax.random.split`` and
``jax.random.normal`` through the port's Threefry (:class:`Keys`; the
``threefry`` kernel on the card, its plain version on the CPU), so an
``init_lm`` on either package starts from the same numbers (normals
within a few ulp, :mod:`repro_torch.core.threefry`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.config import ModelConfig
from repro_torch.core import threefry
from repro_torch.distributed import sharding
from repro_torch.kernels import threefry as threefry_kernel

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.param_dtype]


# -- parameters ----------------------------------------------------------------

class ParamTree(nn.Module):
    """One node of ``repro``'s parameter dict: each key a tensor (a
    :class:`torch.nn.Parameter`, frozen until a trainer calls
    ``requires_grad_()``) or a child node, read as ``p[key]``."""

    def __init__(self, tree: dict):
        super().__init__()
        self._keys = tuple(tree)
        for name, value in tree.items():
            if isinstance(value, nn.Module):
                self.add_module(name, value)
            elif isinstance(value, dict):
                self.add_module(name, ParamTree(value))
            else:
                self.register_parameter(
                    name, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def leaves(self, path: tuple = ()) -> list[tuple[tuple, nn.Parameter]]:
        """``(path, parameter)`` of every tensor below, keys sorted as
        ``jax.tree`` flattens a dict."""
        out = []
        for name in sorted(self._keys):
            value = self[name]
            if isinstance(value, ParamTree):
                out.extend(value.leaves(path + (name,)))
            else:
                out.append((path + (name,), value))
        return out

    def tree(self) -> dict:
        """The node as a nested dict of tensors (``repro``'s layout)."""
        out = {}
        for name in self._keys:
            value = self[name]
            out[name] = value.tree() if isinstance(value, ParamTree) \
                else value.data
        return out


@dataclasses.dataclass(frozen=True)
class Keys:
    """A batch of ``N`` ``jax.random`` keys: what ``jax.vmap`` maps an
    init function over (``N`` = 1 outside a stacked segment)."""
    words: np.ndarray                  # (N, 2) uint32
    device: torch.device
    partitionable: bool = threefry.PARTITIONABLE

    @classmethod
    def from_seed(cls, seed: int, device, *,
                  partitionable: bool = threefry.PARTITIONABLE) -> "Keys":
        """``jax.random.key(seed)``."""
        return cls(np.asarray([threefry.key(seed)], np.uint32),
                   torch.device(device), partitionable)

    @property
    def n(self) -> int:
        return self.words.shape[0]

    def split(self, num: int) -> list["Keys"]:
        """``jax.random.split(key, num)`` of every key of the batch."""
        rows = np.stack([threefry.split(tuple(w), num,
                                        partitionable=self.partitionable)
                         for w in self.words], axis=1) if self.n else \
            np.zeros((num, 0, 2), np.uint32)              # (num, N, 2)
        return [dataclasses.replace(self, words=r) for r in rows]

    def stacked(self, count: int) -> "Keys":
        """``jax.random.split(key, count)`` of one key as a batch of
        ``count`` keys (``jax.vmap``'s input)."""
        assert self.n == 1
        return dataclasses.replace(self, words=threefry.split(
            tuple(self.words[0]), count, partitionable=self.partitionable))

    def normal(self, shape: tuple[int, ...]) -> torch.Tensor:
        """``jax.random.normal(key, shape)`` for each key: ``(N, *shape)``
        float32 on the device (on ``meta``, or for no key: the shape
        alone, nothing drawn)."""
        if self.device.type == "meta" or self.n == 0:
            return torch.empty((self.n,) + tuple(shape), device=self.device)
        m = int(np.prod(shape))
        keys = threefry_kernel.keys_tensor(self.words, self.device)
        v = threefry_kernel.threefry_draw(keys, m, epilogue="normal",
                                          partitionable=self.partitionable)
        return v.reshape((self.n,) + tuple(shape))

    def scaled(self, shape, std: float, dtype: torch.dtype) -> torch.Tensor:
        """``(jax.random.normal(key, shape) * std).astype(dtype)``.  A
        batch of keys (a stacked leaf) narrower than float32 is drawn a key
        at a time into the result, so its float32 draws never live whole
        (a word depends only on its key and index: the same values)."""
        if self.n <= 1 or dtype == torch.float32 or \
                self.device.type == "meta":
            return self.normal(shape).mul_(std).to(dtype)
        out = torch.empty((self.n,) + tuple(shape), dtype=dtype,
                          device=self.device)
        for i in range(self.n):
            one = dataclasses.replace(self, words=self.words[i:i + 1])
            out[i] = one.normal(shape)[0].mul_(std)
        return out

    def full(self, shape, value: float, dtype=torch.float32) -> torch.Tensor:
        return torch.full((self.n,) + tuple(shape), value, dtype=dtype,
                          device=self.device)


def pad_zeros(x: torch.Tensor, dim: int, before: int = 0,
              after: int = 0, value: float = 0) -> torch.Tensor:
    """``x`` with ``before`` / ``after`` zeros (or ``value``) along ``dim``
    (``F.pad``'s), as a concatenation, which DTensor runs in every
    version (on a mesh the padding joins as replicated)."""
    if not before and not after:
        return x
    dim %= x.ndim

    def zeros(n):
        return torch.full(x.shape[:dim] + (n,) + x.shape[dim + 1:], value,
                          dtype=x.dtype, device=x.device)
    parts = ([zeros(before)] if before else []) + [x] + (
        [zeros(after)] if after else [])
    return torch.cat(parts, dim=dim)


# -- Norms -------------------------------------------------------------------

def init_norm(keys: Keys, cfg: ModelConfig, d: int) -> dict:
    p = {"scale": keys.full((d,), 1.0)}
    if cfg.norm == "layernorm":
        p["bias"] = keys.full((d,), 0.0)
    return p


def apply_norm(p, x: torch.Tensor, kind: str, eps: float = 1e-6
               ) -> torch.Tensor:
    xf = x.to(torch.float32)
    if kind == "rmsnorm":
        rms = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
        out = xf * rms * p["scale"]
    else:
        mu = xf.mean(dim=-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return out.to(x.dtype)


# -- Activations --------------------------------------------------------------

def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")       # jax.nn.gelu's default


def _relu2(x: torch.Tensor) -> torch.Tensor:
    return torch.square(F.relu(x))             # Nemotron-4 squared ReLU


def act_fn(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return _gelu
    if name == "relu2":
        return _relu2
    raise ValueError(name)


# -- Dense MLP ----------------------------------------------------------------

def init_mlp(keys: Keys, cfg: ModelConfig, d_ff: int) -> dict:
    d, dt = cfg.d_model, param_dtype(cfg)
    k1, k2, k3 = keys.split(3)
    std = d ** -0.5
    p = {"w_in": k1.scaled((d, d_ff), std, dt),
         "w_out": k2.scaled((d_ff, d), d_ff ** -0.5, dt)}
    if cfg.glu:
        p["w_gate"] = k3.scaled((d, d_ff), std, dt)
    return p


def apply_mlp(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    act = act_fn(cfg.act)
    h = x @ p["w_in"]
    if cfg.glu:
        h = act(x @ p["w_gate"]) * h
    else:
        h = act(h)
    h = sharding.constrain_safe(h, ("batch", "seq", "ff"))
    return h @ p["w_out"]


# -- Embeddings ---------------------------------------------------------------

def init_embed(keys: Keys, cfg: ModelConfig) -> dict:
    dt = param_dtype(cfg)
    k1, k2 = keys.split(2)
    p = {"tok_embed": k1.scaled((cfg.vocab, cfg.d_model), 0.02, dt)}
    if not cfg.tie_embeddings:
        p["lm_head"] = k2.scaled((cfg.d_model, cfg.vocab),
                                 cfg.d_model ** -0.5, dt)
    return p


def embed_tokens(p, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    table = p["tok_embed"]
    if isinstance(table, DTensor):
        return _vocab_parallel_lookup(table, tokens).to(param_dtype(cfg))
    return table[tokens].to(param_dtype(cfg))


def _vocab_parallel_lookup(table, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]`` of a DTensor table as Megatron's vocab-parallel
    embedding: the table's vocab rows stay split where they are (its
    other splits gathered), each rank looks up the tokens that fall in
    its rows (zeros elsewhere) and the result is a partial sum over the
    vocab split.  DTensor's own rules for the indexed read and its
    gradient fail for some layouts."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    rows = [pl if isinstance(pl, Shard) and pl.dim == 0 else Replicate()
            for pl in table.placements]
    table = table.redistribute(mesh, rows)
    (n, _), (lo, _) = compute_local_shape_and_global_offset(
        table.shape, mesh, rows)
    if isinstance(tokens, DTensor):
        tok_place = [pl if isinstance(pl, Shard) and pl.dim == 0
                     else Replicate() for pl in tokens.placements]
        tokens = tokens.redistribute(mesh, tok_place)
    else:
        tok_place = [Replicate()] * mesh.ndim
        tokens = DTensor.from_local(tokens, mesh, tok_place, run_check=False)
    out_place = [Partial() if isinstance(r, Shard) else t
                 for r, t in zip(rows, tok_place)]
    # each rank's rows take gradients from its own tokens only: a sum
    # over the mesh dimensions that split the tokens
    grad_place = [Partial() if isinstance(t, Shard) and not isinstance(
        r, Shard) else r for r, t in zip(rows, tok_place)]

    def lookup(table, tokens):
        mine = (tokens >= lo) & (tokens < lo + n)
        got = table[(tokens - lo).clamp(0, n - 1)]
        return got * mine[..., None].to(got.dtype)

    return local_map(lookup, out_placements=out_place,
                     in_placements=(rows, tok_place),
                     in_grad_placements=(grad_place, tok_place),
                     device_mesh=mesh)(table, tokens)


def lm_logits(p, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        # On a mesh the tied table's two gradients (this product's and
        # the lookup's) must meet in one layout before they add: both in
        # the table's own (some versions cannot turn a split one into the
        # product's partial sum)
        table = sharding.pin_grad(p["tok_embed"])
        return (h @ table.T.to(h.dtype)).to(torch.float32)
    return (h @ p["lm_head"]).to(torch.float32)


# -- RoPE ---------------------------------------------------------------------

def rope_angles(positions: torch.Tensor, rot_dim: int, theta: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables: positions (...,) -> (..., rot_dim//2)."""
    expo = -torch.arange(0, rot_dim, 2, dtype=torch.float32,
                         device=positions.device) / rot_dim
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=positions.device), expo)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               rot_dim: int) -> torch.Tensor:
    """Rotate the first ``rot_dim`` features of ``x`` (..., S, H, dh).

    cos/sin are (..., S, rot_dim//2) and broadcast over heads.
    """
    if rot_dim == 0:
        return x
    xr, xp = x[..., :rot_dim], x[..., rot_dim:]
    x1, x2 = xr[..., ::2], xr[..., 1::2]
    c, s = cos[..., None, :], sin[..., None, :]       # add head axis
    o1 = x1 * c - x2 * s
    o2 = x2 * c + x1 * s
    rotated = torch.stack([o1, o2], dim=-1).reshape(xr.shape)
    return torch.cat([rotated, xp.to(rotated.dtype)], dim=-1).to(x.dtype)


def sinusoidal_embed(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Absolute sinusoidal position embeddings (whisper-style stub)."""
    half = d // 2
    expo = -torch.arange(half, dtype=torch.float32,
                         device=positions.device) / half
    freqs = torch.pow(torch.tensor(10_000.0, device=positions.device), expo)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
