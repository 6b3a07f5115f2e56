"""The training path's host pieces on the port, against ``repro``'s:
gradient compression (payloads and scales equal on stacked leaves, error
feedback, ``compressed_psum`` on 2 and 4 gloo ranks against a numpy
oracle), checkpoints (``tests/test_distributed.py``'s cases, and each
package restoring the other's and training on to the same losses),
fault tolerance (restart replay, straggler and heartbeat decisions equal
``repro``'s), and ``launch.train`` (exact resume on the CPU, the CLI,
the mesh and device refusals).
"""

import dataclasses
import json
import os
import pathlib
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from repro.checkpoint import checkpointer as jck
from repro.configs import get_config
from repro.distributed import fault_tolerance as jft
from repro.train import compression as jcomp
from repro.train import train_step as jts
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import checkpointer as ck
from repro_torch.distributed import fault_tolerance as ft
from repro_torch.launch import train as train_mod
from repro_torch.train import compression as comp
from repro_torch.train import train_step as ts
from tests.test_torch_train import batches, leaves, pair

REPO = pathlib.Path(__file__).resolve().parent.parent


def _stacked_tree(seed: int = 0) -> dict:
    """A gradient tree of ``repro``'s shape: a segment's leaves stacked
    on a layer axis, the layers at very different magnitudes (so one
    scale over the leaf is not one a layer)."""
    rng = np.random.default_rng(seed)
    lay = np.array([1.0, 1e-3, 30.0], np.float32)[:, None, None]
    return {"embed": {"tok_embed": rng.normal(size=(16, 8)).astype(
                np.float32)},
            "final_norm": {"scale": rng.normal(size=(8,)).astype(
                np.float32)},
            "segments": ({"mlp": {"w_in": (rng.normal(size=(3, 8, 12))
                                           * lay).astype(np.float32)},
                          "ln1": {"scale": (rng.normal(size=(3, 8))
                                            ).astype(np.float32)}},)}


def _t(tree):
    return jax.tree.map(torch.from_numpy, tree)


# -- compression -------------------------------------------------------------------

def test_compress_equals_repro_on_stacked_leaves():
    g = _stacked_tree()
    err = jax.tree.map(lambda x: (0.01 * np.random.default_rng(1).normal(
        size=x.shape)).astype(np.float32), g)
    q_want, e_want = jcomp.compress(jax.tree.map(jnp.asarray, g),
                                    jax.tree.map(jnp.asarray, err))
    q_got, e_got = comp.compress(_t(g), _t(err))
    for (path, a), (_, b) in zip(leaves(q_want), leaves(q_got)):
        assert b.dtype == (torch.int8 if path[-1].key == "q"
                           else torch.float32), path
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for (_, a), (_, b) in zip(leaves(e_want), leaves(e_got)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for (_, a), (_, b) in zip(leaves(jcomp.decompress(q_want)),
                              leaves(comp.decompress(q_got))):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # one scale over the stacked leaf: the 1e-3 layer is crushed to a few
    # levels, as in repro, not quantized on its own scale
    w = q_got["segments"][0]["mlp"]["w_in"]
    assert w["scale"].ndim == 0
    assert int(w["q"][1].abs().max()) <= 1


def test_compress_train_state_gradients_equal_repro():
    """The port's ``grad_tree`` (stacked from its per-layer tensors)
    compresses to ``repro``'s payloads of ``repro``'s own gradients: the
    payloads agree but for elements on a rounding edge."""
    cfg, jtc, state, tcfg, ttc, tstate = pair("stablelm-3b")
    batch = batches(cfg, 1)[0]
    loss_fn = jts.make_loss_fn(cfg, jtc)
    g_want = jax.jit(jax.grad(lambda p, b: loss_fn(p, b)[0]))(
        state["params"], jax.tree.map(jnp.asarray, batch))
    loss, _ = ts.make_loss_fn(tcfg, ttc)(
        tstate.params, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    g_got = tstate.grad_tree()
    q_want, _ = jcomp.compress(g_want, jcomp.init_state(g_want))
    q_got, _ = comp.compress(g_got, comp.init_state(g_got))
    n = off = 0
    for (path, a), (_, b) in zip(leaves(q_want), leaves(q_got)):
        a, b = np.asarray(a), b.numpy()
        if path[-1].key == "scale":
            np.testing.assert_allclose(b, a, rtol=1e-5)
            continue
        assert np.abs(b.astype(int) - a).max() <= 1
        n, off = n + a.size, off + int((b != a).sum())
    assert off <= 1e-3 * n, (off, n)


def test_error_feedback_converges():
    """``tests/test_distributed.py``'s case on the port."""
    w_star = torch.from_numpy(
        np.random.default_rng(0).normal(size=(32,)).astype(np.float32))
    runs = {}
    for compressed in (False, True):
        w = {"w": torch.zeros(32)}
        est = comp.init_state(w)
        for _ in range(60):
            g = {"w": w["w"] - w_star}
            if compressed:
                q, est = comp.compress(g, est)
                g = comp.decompress(q)
            w = {"w": w["w"] - 0.2 * g["w"]}
        runs[compressed] = float(torch.linalg.norm(w["w"] - w_star))
    assert runs[True] < 1e-2, runs


def test_compression_is_4x():
    g = {"a": torch.zeros(1024)}
    q, _ = comp.compress(g, comp.init_state(g))
    assert q["a"]["q"].dtype == torch.int8
    assert q["a"]["q"].nbytes * 4 == g["a"].nbytes


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_PSUM = """
import json
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.train import compression as comp
dist.init_process_group("gloo")
r = dist.get_rank()
rng = np.random.default_rng(100 + r)
g = {"a": torch.from_numpy((rng.normal(size=(3, 5)) * (1 + 4 * r)
                            ).astype(np.float32)),
     "b": ({"c": torch.from_numpy(rng.normal(size=(7,)).astype(np.float32))},)}
err = comp.init_state(g)
out = []
for _ in range(2):                         # twice: the residual carries
    mean, err = comp.compressed_psum(g, err)
    out.append({"a": mean["a"].tolist(), "c": mean["b"][0]["c"].tolist(),
                "ea": err["a"].tolist(), "ec": err["b"][0]["c"].tolist()})
print(json.dumps(out))
dist.destroy_process_group()
"""


def _psum_oracle(world: int) -> list[dict]:
    """Every rank's gradients, the shared scale (max of local maxima),
    int8 payloads summed, the mean; and each rank's residual."""
    gs = []
    for r in range(world):
        rng = np.random.default_rng(100 + r)
        gs.append({"a": (rng.normal(size=(3, 5)) * (1 + 4 * r)).astype(
            np.float32), "c": rng.normal(size=(7,)).astype(np.float32)})
    errs = [{k: np.zeros_like(v) for k, v in g.items()} for g in gs]
    steps = []
    for _ in range(2):
        res = {}
        for k in ("a", "c"):
            x = [g[k] + e[k] for g, e in zip(gs, errs)]
            scale = max(np.float32(max(np.abs(xi).max(), 1e-12))
                        / np.float32(127) for xi in x)
            q = [np.clip(np.round(xi / scale), -127, 127).astype(np.int8)
                 for xi in x]
            total = np.sum([qi.astype(np.int32) for qi in q], axis=0)
            res[k] = total.astype(np.float32) * scale / np.float32(world)
            for e, xi, qi in zip(errs, x, q):
                e[k] = xi - qi.astype(np.float32) * scale
            res["e" + k] = [e[k].copy() for e in errs]
        steps.append(res)
    return steps


@pytest.mark.parametrize("world", [2, 4])
def test_compressed_psum_on_gloo_ranks(world):
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port()),
           "WORLD_SIZE": str(world), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", _PSUM], env={**env, "RANK": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    want = _psum_oracle(world)
    for r, got in enumerate(outs):
        for step, (g, w) in enumerate(zip(got, want)):
            for k in ("a", "c"):
                np.testing.assert_array_equal(
                    np.asarray(g[k], np.float32).reshape(w[k].shape), w[k],
                    err_msg=f"rank {r} step {step} {k}")
                np.testing.assert_array_equal(
                    np.asarray(g["e" + k], np.float32).reshape(
                        w[k].shape), w["e" + k][r])


# -- checkpoints -------------------------------------------------------------------

def test_checkpoint_roundtrip_async_and_gc(tmp_path):
    state = {"w": torch.arange(6.0), "h": torch.arange(4.0).to(
        torch.bfloat16), "step": torch.tensor(3, dtype=torch.int32)}
    acp = ck.AsyncCheckpointer(tmp_path, keep=2)
    for s in (1, 2, 3):
        acp.save(state, s)
    acp.wait()
    assert ck.latest_step(tmp_path) == 3
    assert len(list(tmp_path.glob("step_*"))) == 2
    target = {k: torch.empty(v.shape, device="meta")
              for k, v in state.items()}
    got, step = ck.restore(tmp_path, target)
    assert step == 3
    for k, v in state.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v)


def test_async_save_snapshots_on_the_call(tmp_path):
    """The snapshot is taken before ``save`` returns: a later in-place
    update (an optimizer step) does not reach the file."""
    w = torch.zeros(1 << 16)
    acp = ck.AsyncCheckpointer(tmp_path)
    acp.save({"w": w}, 1)
    w.add_(1.0)
    acp.wait()
    got, _ = ck.restore(tmp_path, {"w": w})
    assert float(got["w"].abs().max()) == 0.0


def test_checkpoint_atomic_publish(tmp_path):
    """A .tmp dir (crashed save) is never picked up as latest."""
    ck.save(tmp_path, {"w": torch.ones(3)}, 1)
    (tmp_path / "step_00000002.tmp").mkdir()
    assert ck.latest_step(tmp_path) == 1


def test_checkpoint_shape_mismatch_and_missing_leaf_raise(tmp_path):
    ck.save(tmp_path, {"w": torch.ones(3)}, 1)
    with pytest.raises(ValueError):
        ck.restore(tmp_path, {"w": torch.empty(4)})
    with pytest.raises(KeyError):
        ck.restore(tmp_path, {"v": torch.empty(3)})
    with pytest.raises(FileNotFoundError):
        ck.restore(tmp_path / "none", {"w": torch.empty(3)})


def test_format_equals_repro(tmp_path):
    """Keys, shapes, dtypes and array bytes equal ``repro``'s files; only
    the file names differ (``repro``'s are a salted hash)."""
    state = {"a": jnp.arange(3, dtype=jnp.bfloat16),
             "s": (jnp.zeros((2, 2)), {"x": jnp.int32(3)})}
    jck.save(tmp_path / "j", state, 5)
    ck.save(tmp_path / "t", jax.tree.map(np.asarray, state), 5)
    metas = [json.loads((tmp_path / d / "step_00000005" / "meta.json")
                        .read_text()) for d in ("j", "t")]
    assert metas[0]["step"] == metas[1]["step"] == 5
    strip = [[{k: m[k] for k in ("key", "shape", "dtype")}
              for m in meta["manifest"]] for meta in metas]
    assert sorted(strip[0], key=str) == sorted(strip[1], key=str)
    for mj in metas[0]["manifest"]:
        mt = next(m for m in metas[1]["manifest"] if m["key"] == mj["key"])
        a = np.load(tmp_path / "j" / "step_00000005" / mj["file"])
        b = np.load(tmp_path / "t" / "step_00000005" / mt["file"])
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_repro_bf16_checkpoint_restores_in_the_port(tmp_path):
    """``repro`` writes bfloat16 leaves as 2-byte void records and cannot
    read them back itself (``jnp.asarray`` refuses ``|V2``); the port
    reads the manifest's dtype and restores the bits."""
    cfg = dataclasses.replace(get_config("stablelm-3b", smoke=True),
                              n_layers=2)
    tcfg = dataclasses.replace(tconfigs.get_config("stablelm-3b",
                                                   smoke=True), n_layers=2)
    state = jts.init_train_state(jax.random.key(2), cfg, jts.TrainConfig())
    jck.save(tmp_path, state, 0)
    with pytest.raises(TypeError):
        jck.restore(tmp_path, state)
    target = ts.init_train_state(0, tcfg, ts.TrainConfig(),
                                 device="meta").tree()
    got, step = ck.restore(tmp_path, target)
    assert step == 0
    want = jax.tree.map(np.asarray, state)
    for (path, a), (_, b) in zip(leaves(want), leaves(got)):
        if a.dtype.name == "bfloat16":
            assert b.dtype == torch.bfloat16, path
            b = b.view(torch.int16).numpy().view(a.dtype)
        else:
            b = b.numpy()
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b.reshape(-1).view(np.uint8),
                                      a.reshape(-1).view(np.uint8))


@pytest.mark.parametrize("writer", ["repro", "port"])
def test_checkpoint_restores_across_packages(tmp_path, writer):
    """A float32 train state after one step, saved by one package,
    restored by the other, trains on to the writer's losses (the writer
    continues from its own live state)."""
    cfg, jtc, state, tcfg, ttc, tstate = pair("stablelm-3b")
    data = batches(cfg, 3)
    jstep = jax.jit(jts.make_train_step(cfg, jtc))
    tstep = ts.make_train_step(tcfg, ttc)

    def tb(b):
        return {k: torch.from_numpy(v) for k, v in b.items()}
    if writer == "repro":
        state, _ = jstep(state, jax.tree.map(jnp.asarray, data[0]))
        jck.save(tmp_path, state, 1)
        target = ts.init_train_state(0, tcfg, ttc, device="meta").tree()
        tree, step = ck.restore(tmp_path, target)
        tstate = ts.TrainState.from_tree(tree, tcfg, ttc)
        state2, m1 = jstep(state, jax.tree.map(jnp.asarray, data[1]))
        want = [float(m1["loss"]), float(jstep(
            state2, jax.tree.map(jnp.asarray, data[2]))[1]["loss"])]
        got = []
        for b in data[1:]:
            tstate, m = tstep(tstate, tb(b))
            got.append(float(m["loss"]))
    else:
        tstate, _ = tstep(tstate, tb(data[0]))
        ck.save(tmp_path, tstate.tree(), 1)
        target = jax.tree.map(
            lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), state)
        state, step = jck.restore(tmp_path, target)
        want = []
        for b in data[1:]:
            tstate, m = tstep(tstate, tb(b))
            want.append(float(m["loss"]))
        got = []
        for b in data[1:]:
            state, m = jstep(state, jax.tree.map(jnp.asarray, b))
            got.append(float(m["loss"]))
    assert step == 1
    np.testing.assert_allclose(got, want, rtol=1e-6)


# -- fault tolerance ----------------------------------------------------------------

def test_restart_driver_replays_deterministically():
    saved = {}
    crashed = {"done": False}

    def step_fn(s, i):
        if i == 6 and not crashed["done"]:
            crashed["done"] = True
            raise RuntimeError("boom")
        return s + i

    final, stats = ft.run_with_restarts(
        init_fn=lambda: 0, step_fn=step_fn,
        save_fn=lambda s, i: saved.update(ck=(s, i)),
        restore_fn=lambda: saved.get("ck"),
        total_steps=10, checkpoint_every=3)
    assert stats.restarts == 1 and stats.resumed_from == [6]
    assert final == sum(range(10))


def test_straggler_and_heartbeat_decisions_equal_repro():
    rng = np.random.default_rng(7)
    times = np.abs(rng.normal(1.0, 0.05, 200))
    times[rng.integers(0, 200, 12)] *= rng.uniform(1.5, 40, 12)
    workers = [f"w{i % 5}" for i in range(200)]
    mons = [jft.StragglerMonitor(k=3.0, window=16, min_samples=4),
            ft.StragglerMonitor(k=3.0, window=16, min_samples=4)]
    seen = [[], []]
    for i, (w, t) in enumerate(zip(workers, times)):
        for mon, out in zip(mons, seen):
            rep = mon.observe(w, i, float(t))
            out.append(None if rep is None else dataclasses.astuple(rep))
    assert seen[0] == seen[1] and any(seen[1])
    assert mons[0].offenders == mons[1].offenders
    for w in set(workers):
        for strikes in (1, 2, 3):
            assert mons[0].should_replace(w, strikes) == \
                mons[1].should_replace(w, strikes)
    clock = [0.0]
    regs = [mod.HeartbeatRegistry([f"w{i}" for i in range(4)], timeout=5,
                                  clock=lambda: clock[0])
            for mod in (jft, ft)]
    for step in range(40):
        clock[0] = step * 0.75
        who = f"w{int(rng.integers(0, 4))}"
        for reg in regs:
            if step % 7:                       # some pings are lost
                reg.ping(who)
        assert regs[0].dead_workers() == regs[1].dead_workers()
        assert regs[0].healthy() == regs[1].healthy()


# -- launch.train ----------------------------------------------------------------

def test_resume_replays_exactly(tmp_path, capsys):
    kw = dict(steps=6, global_batch=2, seq_len=16, device="cpu",
              log_every=100)
    full = train_mod.train("stablelm-3b", **kw)
    d = tmp_path / "ck"
    first = train_mod.train("stablelm-3b", ckpt_dir=str(d), ckpt_every=3,
                            **kw)
    assert first["losses"] == full["losses"]
    assert ck.latest_step(d) == 6
    shutil.rmtree(d / "step_00000006")
    again = train_mod.train("stablelm-3b", ckpt_dir=str(d), ckpt_every=3,
                            **kw)
    assert "resumed from step 3" in capsys.readouterr().out
    assert again["resumed_from"] == 3
    assert again["losses"] == full["losses"][3:]


@pytest.mark.parametrize("arch", ["hymba-1.5b", "paligemma-3b"])
def test_train_runs_each_family(arch):
    out = train_mod.train(arch, steps=2, global_batch=2, seq_len=12,
                          device="cpu", n_layers=None)
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert np.isfinite(out["grad_norms"]).all()


def test_trainer_refuses_what_it_cannot_run():
    with pytest.raises(ValueError, match="needs a process group of 256"):
        train_mod.train("stablelm-3b", steps=1, global_batch=2, seq_len=8,
                        mesh_kind="prod", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            train_mod.train("stablelm-3b", steps=1, global_batch=2,
                            seq_len=8)


def test_cli_trains_on_the_cpu(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "stablelm-3b", "--steps", "3", "--global-batch", "2",
           "--seq-len", "16", "--device", "cpu", "--ckpt-dir",
           str(tmp_path), "--ckpt-every", "2"]
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.splitlines()[0].startswith("step     0 loss ")
    assert ck.latest_step(tmp_path) == 3
    bad = subprocess.run(cmd[:-4] + ["--mesh", "prod"], env=env,
                         capture_output=True, text=True, timeout=300)
    assert bad.returncode == 2 and "needs a process group of 256" \
        in bad.stderr
