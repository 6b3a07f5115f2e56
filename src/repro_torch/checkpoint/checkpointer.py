"""Checkpoints: atomic publish, async save, restore onto any device.

Counterpart of :mod:`repro.checkpoint.checkpointer`, in its on-disk
format, so each package restores the other's checkpoints:
one directory per step (``step_%08d``) holding

  - ``meta.json``      ``{"step", "manifest": [{"key", "file", "shape",
                       "dtype"}]}``
  - ``<file>.npy``     one full numpy array per leaf

A key is the leaf's tree path joined by ``::`` (``repro``'s
``tree_flatten_with_path`` keys: dict keys and tuple indices), over
``repro``'s layout, so a segment's leaf is its stacked ``(L, ...)``
tensor (:meth:`repro_torch.train.train_step.TrainState.tree`).
bfloat16 leaves are stored as ``repro`` stores them, 2-byte void
records (``|V2``) with ``"dtype": "bfloat16"`` in the manifest, and come
back as ``torch.bfloat16``.  ``repro`` names a leaf's file by the salted
``abs(hash(key))``; the port uses a stable digest of the key, and both
read names from the manifest alone.

Writes go to ``step_%08d.tmp`` and are renamed when complete: a crashed
save is never taken for the latest step.  The async saver snapshots to
host memory on the call and writes on a worker thread.

A tree may hold a segment's leaf as :class:`Layers`, its per-layer
tensors (:meth:`repro_torch.train.train_step.TrainState.checkpoint_tree`):
the leaf is then stacked on the host, one layer copied at a time, so a
save makes no second copy of the state on the device.  The files are
those of the stacked tensor's save.  :func:`save` takes and writes one
leaf at a time.

A state on a mesh (DTensor leaves) is saved as the same full arrays:
every rank takes part in gathering each leaf (``full_tensor()``, one at
a time) and rank 0 writes.  ``restore(..., mesh=, shardings=)`` reads
each leaf on every rank and keeps this rank's shard of it, leaf by leaf,
so nothing is broadcast and no rank holds the whole state at once.
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import shutil
import threading

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch import tree as tree_mod

_SEP = "::"


def _key(path: tuple) -> str:
    return _SEP.join(str(k) for k in path)


class Layers(tuple):
    """One stacked leaf as its per-layer tensors (a leaf of the tree, not a
    tuple of leaves: :mod:`repro_torch.tree` keeps subclasses whole)."""


def _is_bf16(leaf) -> bool:
    if isinstance(leaf, Layers):
        return bool(leaf) and leaf[0].dtype == torch.bfloat16
    return isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16


def _to_numpy(leaf) -> np.ndarray:
    """A host copy of ``leaf`` (a tensor, :class:`Layers`, an array or a
    number)."""
    if isinstance(leaf, Layers):
        out = None
        for i, t in enumerate(leaf):       # a layer on the host at a time
            arr = _to_numpy(t)
            if out is None:
                out = np.empty((len(leaf),) + arr.shape, arr.dtype)
            out[i] = arr
        return out
    if not isinstance(leaf, torch.Tensor):
        return np.array(leaf)
    t = leaf.detach()
    if isinstance(t, DTensor):
        t = t.full_tensor()
    t = t.clone() if t.device.type == "cpu" else t.cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view("V2")
    return t.numpy()


def _to_tensor(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    arr = np.require(arr, requirements="C")
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _write(root: pathlib.Path, flat, step: int) -> pathlib.Path:
    """Write ``(key, array, dtype)`` entries (a list, or an iterator that
    makes each as it is asked for) and publish the step."""
    final = root / f"step_{step:08d}"
    tmp = root / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = []
    for key, arr, dtype in flat:
        fname = hashlib.sha256(key.encode()).hexdigest()[:16] + ".npy"
        np.save(tmp / fname, arr)
        manifest.append({"key": key, "file": fname,
                         "shape": list(arr.shape), "dtype": dtype})
        del arr                     # before the next entry is made
    (tmp / "meta.json").write_text(json.dumps(
        {"step": step, "manifest": manifest}))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    return final


def _writer() -> bool:
    """Whether this process writes: rank 0, or a process of no group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier() -> None:
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def _snapshot(state):
    """``(key, host array, dtype)`` of each leaf, in ``tree`` order, made
    as it is asked for (on a mesh: a collective, on every rank)."""
    for path, leaf in tree_mod.flatten(state):
        arr = _to_numpy(leaf)
        yield (_key(path), arr,
               "bfloat16" if _is_bf16(leaf) else str(arr.dtype))
        del arr


def save(path: str | pathlib.Path, state, step: int) -> pathlib.Path:
    """Synchronous save of a tree (nested dicts / tuples of tensors,
    :class:`Layers`, arrays or numbers) with atomic publish, one leaf at a
    time on the host.  Returns the final dir.  On a process group every
    rank calls it (each leaf is gathered collectively); rank 0 writes,
    and every rank returns once the step is published."""
    root = pathlib.Path(path)
    if _writer():
        _write(root, _snapshot(state), step)
    else:
        for _ in _snapshot(state):
            pass
    _barrier()
    return root / f"step_{step:08d}"


def latest_step(path: str | pathlib.Path) -> int | None:
    root = pathlib.Path(path)
    if not root.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in root.glob("step_*")
             if not p.name.endswith(".tmp") and (p / "meta.json").exists()]
    return max(steps) if steps else None


def restore(path: str | pathlib.Path, target, step: int | None = None, *,
            device: str | torch.device = "cpu", mesh=None,
            shardings=None):
    """Restore into the structure of ``target`` (a tree whose leaves have
    a ``shape``: tensors, ``meta`` tensors, arrays).  Returns (a tree of
    tensors on ``device``, step).  With ``mesh`` and ``shardings`` (a
    spec tree of ``target``'s structure,
    :func:`~repro_torch.distributed.param_specs.state_specs`), each leaf
    comes back as a DTensor on ``mesh`` holding this rank's shard.

    Raises:
      FileNotFoundError: no complete checkpoint under ``path``.
      KeyError: the checkpoint lacks one of ``target``'s leaves.
      ValueError: a leaf's shape differs from ``target``'s.
    """
    root = pathlib.Path(path)
    step = step if step is not None else latest_step(root)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {root}")
    d = root / f"step_{step:08d}"
    meta = json.loads((d / "meta.json").read_text())
    by_key = {m["key"]: m for m in meta["manifest"]}
    specs = dict(tree_mod.flatten(shardings)) if mesh is not None else None
    restored = []
    for p, leaf in tree_mod.flatten(target):
        key = _key(p)
        if key not in by_key:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = np.load(d / by_key[key]["file"])
        want = tuple(leaf.shape)
        if tuple(arr.shape) != want:
            raise ValueError(f"{key}: shape {arr.shape} != {want}")
        t = _to_tensor(arr, by_key[key]["dtype"], device)
        if mesh is not None:
            from repro_torch.distributed.param_specs import distribute
            t = distribute(t, mesh, specs[p])
        restored.append((p, t))
    return tree_mod.nest(restored), step


class AsyncCheckpointer:
    """Snapshot-on-call, write-on-thread checkpointer; keeps the newest
    ``keep`` steps."""

    def __init__(self, path: str | pathlib.Path, keep: int = 3):
        self.path = pathlib.Path(path)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self.error: Exception | None = None

    def save(self, state, step: int) -> None:
        """Snapshot now to host memory (on a process group: every rank,
        collectively; :class:`Layers` a layer at a time) and write on a
        thread (rank 0)."""
        self.wait()
        if not _writer():
            for _ in _snapshot(state):      # take part in each gather
                pass
            return
        snapshot = list(_snapshot(state))

        def work():
            try:
                _write(self.path, snapshot, step)
                self._gc()
            except Exception as e:  # surfaced on next wait()
                self.error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Wait for the last write (on a process group: every rank, until
        rank 0's is published)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        _barrier()
        if self.error is not None:
            err, self.error = self.error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(p for p in self.path.glob("step_*")
                       if not p.name.endswith(".tmp"))
        for p in steps[:-self.keep]:
            shutil.rmtree(p, ignore_errors=True)
