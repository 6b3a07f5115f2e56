"""Carrying state across from the JAX package.

``repro`` hands out numpy arrays (``np.asarray`` of its jax arrays):
``uint32`` item memory, tie vector and prototypes, ``int32`` species tags
and genome lengths.  :func:`from_repro_state` turns them into the port's
tensors (packed words as ``int32`` bit patterns) and :class:`RefDB`, so
tests can feed both packages identical state; :func:`to_repro_state` is
the way back.  :func:`banks_from_repro` / :func:`banks_to_repro` carry
the device model's programmed banks (``repro.accel.crossbar
.program_prototypes``: float32 ``(T, S_pad, rows)`` each) across, so a
read can be held against ``repro``'s on ``repro``'s own device state.
:func:`lm_params_from_repro` / :func:`lm_params_to_repro` carry an LM's
parameter tree (``repro.models.lm.init_lm``'s, as numpy: bfloat16 leaves
as ``ml_dtypes`` arrays, every segment stacked on a leading layer axis)
to the port's :class:`~repro_torch.models.lm.LM` and back;
:func:`train_state_from_repro` / :func:`train_state_to_repro` do the same
for a whole train state (``repro.train.train_step.init_train_state``'s
``{"params", "opt": {"m", "v"}, "step"}``), keeping ``repro``'s stacked
layout, which is what its weight decay and gradient compression see.
Nothing here imports ``repro``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.assoc_memory import RefDB
from repro_torch.device import resolve_device


def words_to_tensor(words, device: str | torch.device = "cpu") -> torch.Tensor:
    """``uint32`` (or ``int32``) packed words -> int32 tensor, same bits."""
    a = np.ascontiguousarray(words)
    if a.dtype.itemsize != 4 or a.dtype.kind not in "ui":
        raise ValueError(f"packed words must be 32-bit integers, got {a.dtype}")
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def tensor_to_words(t: torch.Tensor) -> np.ndarray:
    """int32 packed-word tensor -> numpy ``uint32`` with the same bits."""
    return t.detach().cpu().numpy().astype(np.int32, copy=False).view(np.uint32)


def from_repro_state(im, tie, prototypes, proto_species, genome_lengths,
                     species_names, *, device: str | torch.device | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor, RefDB]:
    """``repro``'s item memory, tie vector and RefDB arrays -> the port's
    ``(im, tie, RefDB)`` on ``device`` (``None``: ``cuda``)."""
    dev = resolve_device(device)
    names = tuple(species_names)
    db = RefDB(
        prototypes=words_to_tensor(prototypes, dev),
        proto_species=torch.from_numpy(
            np.asarray(proto_species, np.int32).copy()).to(dev),
        genome_lengths=torch.from_numpy(
            np.asarray(genome_lengths, np.int32).copy()).to(dev),
        num_species=len(names),
        species_names=names,
    )
    return words_to_tensor(im, dev), words_to_tensor(tie, dev), db


def to_repro_state(im: torch.Tensor, tie: torch.Tensor, db: RefDB) -> dict:
    """The inverse of :func:`from_repro_state`: numpy arrays as ``repro``
    holds them (``uint32`` words, ``int32`` tags and lengths)."""
    return {
        "im": tensor_to_words(im),
        "tie": tensor_to_words(tie),
        "prototypes": tensor_to_words(db.prototypes),
        "proto_species": db.proto_species.cpu().numpy().astype(np.int32),
        "genome_lengths": db.genome_lengths.cpu().numpy().astype(np.int32),
        "species_names": db.species_names,
    }


def banks_from_repro(state_pos, state_neg, *,
                     device: str | torch.device | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """``repro``'s programmed banks ``(state_pos, state_neg)`` (numpy
    float32 ``(T, S_pad, rows)``) -> the port's tensors on ``device``
    (``None``: ``cuda``), for :func:`repro_torch.accel.crossbar
    .crossbar_read`."""
    dev = resolve_device(device)
    out = []
    for state in (state_pos, state_neg):
        a = np.ascontiguousarray(np.asarray(state))
        if a.dtype != np.float32 or a.ndim != 3:
            raise ValueError(f"a programmed bank is float32 (T, S_pad, "
                             f"rows), got {a.dtype} {a.shape}")
        out.append(torch.from_numpy(a.copy()).to(dev))
    return out[0], out[1]


def banks_to_repro(state_pos: torch.Tensor, state_neg: torch.Tensor
                   ) -> tuple[np.ndarray, np.ndarray]:
    """The inverse of :func:`banks_from_repro`: numpy float32 banks."""
    return (state_pos.detach().cpu().numpy().astype(np.float32),
            state_neg.detach().cpu().numpy().astype(np.float32))


def _leaf_to_tensor(a, device: torch.device) -> torch.Tensor:
    """A numpy parameter -> a tensor of the same dtype and values
    (bfloat16 through its 16-bit pattern: numpy has no bfloat16 of its
    own)."""
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _tensor_to_leaf(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        bits = t.contiguous().view(torch.int16).numpy()
        try:
            return bits.view(np.dtype("bfloat16"))
        except TypeError:            # no bfloat16 registered with numpy
            return t.float().numpy()
    return t.numpy()


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_map_tree(fn, v) for v in tree)
    return fn(tree)


def lm_params_from_repro(tree: dict, cfg, device: str | torch.device | None
                         = None):
    """``repro``'s LM parameter tree (numpy leaves) -> the port's
    :class:`~repro_torch.models.lm.LM` for ``cfg`` on ``device``
    (``None``: ``cuda``), with the same dtypes and values."""
    from repro_torch.models.lm import LM
    dev = resolve_device(device)
    return LM(cfg, _map_tree(lambda a: _leaf_to_tensor(a, dev), tree))


def lm_params_to_repro(model) -> dict:
    """The inverse of :func:`lm_params_from_repro`: ``repro``'s tree of
    numpy arrays (bfloat16 leaves as ``ml_dtypes`` arrays where numpy
    knows that dtype, else float32)."""
    return _map_tree(_tensor_to_leaf, model.tree())


def train_state_from_repro(tree: dict, cfg, tc, device: str | torch.device
                           | None = None):
    """``repro``'s train state (numpy leaves) -> the port's
    :class:`~repro_torch.train.train_step.TrainState` for ``cfg`` and the
    :class:`~repro_torch.train.train_step.TrainConfig` ``tc`` on
    ``device`` (``None``: ``cuda``): its parameters, float32 moments and
    step."""
    from repro_torch.train.train_step import TrainState
    dev = resolve_device(device)
    return TrainState.from_tree(
        _map_tree(lambda a: _leaf_to_tensor(a, dev), tree), cfg, tc)


def train_state_to_repro(state) -> dict:
    """The inverse of :func:`train_state_from_repro`: ``repro``'s
    ``{"params", "opt": {"m", "v"}, "step"}`` of numpy arrays."""
    return _map_tree(_tensor_to_leaf, state.tree())
