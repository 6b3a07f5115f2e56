"""Training driver: mesh + checkpoint/restart + monitoring.

Counterpart of :mod:`repro.launch.train`, with ``repro``'s flags, on the
card unless ``--device cpu``:

    python -m repro_torch.launch.train --arch stablelm-3b --steps 100 \\
        --global-batch 32 --seq-len 256 [--ckpt-dir ckpt/]
    python -m repro_torch.launch.train --arch stablelm-3b --full \\
        --steps 8 --global-batch 8 --seq-len 512     # 2.8 B params
    torchrun --nproc-per-node N -m repro_torch.launch.train \\
        --arch stablelm-3b --mesh host               # N ranks

The model is ``repro``'s ``init_lm(jax.random.key(0), cfg)`` drawn
through the port's Threefry (the kernel on the card) and the data
``lm_data.batch_at``'s, so a run takes ``repro``'s steps.  Async
checkpoints every ``--ckpt-every`` steps in ``repro``'s format; a run
given a ``--ckpt-dir`` that holds one resumes from its newest step and
replays the same data order (the batch is a function of the step).
``train(..., n_layers=)`` cuts the depth.

Meshes, as in ``repro``: ``--mesh none`` trains on this process's
device; ``--mesh host`` on a process group of several ranks (under
``torchrun``) trains on the ranks' 1-D ``("data",)`` host mesh, and on
one rank without a mesh (``train(..., host_shape=(d, m))`` lays the
ranks out as a ``("data", "model")`` mesh instead, one rank included);
``--mesh prod`` trains on the 16x16 production mesh and needs 256 ranks.
On a mesh the parameters, the moments and each global batch are
DTensors placed by ``repro``'s ``TRAIN_RULES``
(:mod:`repro_torch.distributed.param_specs`), every rank draws the same
weights and keeps its shards, and checkpoints hold the full arrays.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import checkpointer as ck
from repro_torch.configs import get_config
from repro_torch.data import lm_data
from repro_torch.device import resolve_device
from repro_torch.distributed import fault_tolerance as ft
from repro_torch.distributed import param_specs, sharding
from repro_torch.launch.mesh import (check_production_world, make_host_mesh,
                                    make_production_mesh)
from repro_torch.train import train_step as ts
from repro_torch.train.optimizer import OptConfig


def make_mesh(mesh_kind: str, dev: torch.device,
              host_shape: tuple[int, int] | None = None):
    """The mesh ``mesh_kind`` names on ``dev``'s ranks (``None``: train
    without one: ``none``, or ``host`` on one rank with no
    ``host_shape``).  A mesh joins the default process group, made here
    from the environment if none exists
    (:func:`repro_torch.distributed.sharding.init_process_group`).

    Raises:
      ValueError: an unknown kind, or ``prod`` on a world size other
        than 256.
    """
    if mesh_kind not in ("host", "prod", "none"):
        raise ValueError(f"unknown mesh {mesh_kind!r}")
    ranks = dist.get_world_size() if dist.is_initialized() else int(
        os.environ.get("WORLD_SIZE", "1"))
    if mesh_kind == "none" or (mesh_kind == "host" and host_shape is None
                               and ranks == 1):
        return None                   # one rank: no mesh, as in repro
    sharding.init_process_group(dev)
    if mesh_kind == "prod":
        return make_production_mesh(device=dev)
    return make_host_mesh(host_shape, device=dev)


def make_batch_fn(cfg, dc: lm_data.DataConfig, device: torch.device):
    """``repro``'s batches, as tensors on ``device``: the tokens are a
    function of the step; the audio / VLM stub embeddings come from one
    generator in call order, as ``repro``'s do."""
    rng = np.random.default_rng(dc.seed + 17)

    def at(step: int) -> dict:
        batch = lm_data.batch_at(dc, step)   # the global batch
        b = dc.global_batch
        if cfg.family == "audio":
            batch["enc_embeds"] = rng.normal(
                size=(b, dc.seq_len, cfg.d_model)).astype(np.float32)
        if cfg.family == "vlm":
            batch["prefix_embeds"] = rng.normal(
                size=(b, cfg.vlm_prefix, cfg.d_model)).astype(np.float32)
        return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}

    return at


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def place_batch(batch: dict, mesh) -> dict:
    """A global batch split by its placements (each rank keeps its rows;
    every rank made the same batch)."""
    specs = param_specs.batch_specs(batch, mesh, sharding.TRAIN_RULES)
    return {k: param_specs.distribute(v, mesh, specs[k])
            for k, v in batch.items()}


def train_config(steps: int, seq_len: int, peak_lr: float = 3e-3
                 ) -> ts.TrainConfig:
    """The :class:`~repro_torch.train.train_step.TrainConfig` of a run of
    ``steps`` steps on ``seq_len`` tokens (``repro``'s)."""
    return ts.TrainConfig(
        opt=OptConfig(peak_lr=peak_lr, warmup_steps=max(steps // 20, 5),
                      total_steps=steps),
        loss_chunk=min(512, seq_len),
        q_chunk=min(512, seq_len), kv_chunk=min(512, seq_len))


def train(arch: str, *, steps: int, global_batch: int, seq_len: int,
          smoke: bool = True, mesh_kind: str = "host",
          ckpt_dir: str | None = None, ckpt_every: int = 50,
          peak_lr: float = 3e-3, log_every: int = 10,
          device: str | torch.device | None = None,
          n_layers: int | None = None,
          host_shape: tuple[int, int] | None = None,
          return_state: bool = False) -> dict:
    """Train ``arch`` for ``steps`` steps (from the newest checkpoint in
    ``ckpt_dir`` when there is one).  Returns ``final_loss`` and, for the
    steps this call ran, ``losses``, ``grad_norms`` and ``step_s`` (wall
    seconds a step, after a device sync), with ``resumed_from`` (the first
    step run), ``restore_s`` (reading the checkpoint into a state),
    ``save_s`` (seconds the loop spent in checkpoint calls: the
    snapshots, and the last write's wait), ``num_params``, ``mesh``
    (its shape, or None) and, with ``return_state``, ``state`` (the
    :class:`~repro_torch.train.train_step.TrainState` after the last
    step).  Checkpoints are taken a layer at a time to the host
    (:meth:`~repro_torch.train.train_step.TrainState.checkpoint_tree`);
    the closing save is left out where the loop has just saved that
    step."""
    dev = resolve_device(device)
    mesh = make_mesh(mesh_kind, dev, host_shape)
    rules = sharding.TRAIN_RULES
    cfg = get_config(arch, smoke=smoke)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    tc = train_config(steps, seq_len, peak_lr)
    dc = lm_data.DataConfig(vocab=cfg.vocab, seq_len=seq_len,
                            global_batch=global_batch)
    batch_at = make_batch_fn(cfg, dc, dev)
    step_fn = ts.make_train_step(cfg, tc)
    monitor = ft.StragglerMonitor()
    acp = ck.AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
    rank = dist.get_rank() if mesh is not None else 0
    worker = f"worker{rank}"

    state, start, restore_s, save_s = None, 0, 0.0, 0.0
    if acp and ck.latest_step(ckpt_dir) is not None:
        t0 = time.perf_counter()
        target = ts.init_train_state(0, cfg, tc, device="meta").tree()
        specs = (param_specs.state_specs(target, mesh, rules)
                 if mesh is not None else None)
        tree, start = ck.restore(ckpt_dir, target, device=dev, mesh=mesh,
                                 shardings=specs)
        state = ts.TrainState.from_tree(tree, cfg, tc)
        del tree
        _sync(dev)
        restore_s = time.perf_counter() - t0
        if rank == 0:
            print(f"resumed from step {start}")
    if state is None:
        state = ts.init_train_state(0, cfg, tc, device=dev, mesh=mesh,
                                    rules=rules)

    losses, norms, secs = [], [], []
    for i in range(start, steps):
        t0 = time.perf_counter()
        batch = batch_at(i)
        if mesh is not None:
            with sharding.use_rules(mesh, rules):
                state, metrics = step_fn(state, place_batch(batch, mesh))
        else:
            state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        gnorm = float(metrics["grad_norm"])
        _sync(dev)
        dt = time.perf_counter() - t0
        losses.append(loss)
        norms.append(gnorm)
        secs.append(dt)
        monitor.observe(worker, i, dt)
        if rank == 0 and (i % log_every == 0 or i == steps - 1):
            print(f"step {i:5d} loss {loss:.4f} gnorm {gnorm:.3f} "
                  f"lr {float(metrics['lr']):.2e} {dt * 1e3:.0f}ms",
                  flush=True)
        if acp and (i + 1) % ckpt_every == 0:
            t0 = time.perf_counter()
            acp.save(state.checkpoint_tree(), i + 1)
            save_s += time.perf_counter() - t0
    if acp:
        t0 = time.perf_counter()
        if steps > start and steps % ckpt_every:    # not saved just now
            acp.save(state.checkpoint_tree(), steps)
        acp.wait()
        save_s += time.perf_counter() - t0
    out = {"final_loss": losses[-1] if losses else None, "losses": losses,
           "grad_norms": norms, "step_s": secs, "resumed_from": start,
           "restore_s": restore_s, "save_s": save_s,
           "num_params": sum(p.numel() for p in state.params.parameters()),
           "mesh": tuple(mesh.shape) if mesh is not None else None}
    if return_state:
        out["state"] = state
    return out


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--full", action="store_true",
                    help="full (non-smoke) config")
    ap.add_argument("--mesh", default="host", choices=["host", "prod", "none"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain path on the host)")
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
        if args.mesh == "prod":
            sharding.init_process_group(dev)
            check_production_world()
    except (RuntimeError, ValueError) as e:
        ap.error(str(e))
    train(args.arch, steps=args.steps, global_batch=args.global_batch,
          seq_len=args.seq_len, smoke=not args.full, mesh_kind=args.mesh,
          ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
          peak_lr=args.lr, device=dev)


if __name__ == "__main__":
    main()
