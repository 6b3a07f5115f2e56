"""Training and decoding across ranks: DTensor meshes on gloo CPU ranks.

Four gloo ranks (each its own process, spawned once for every case of
this file) make a 2 x 2 ``("data", "model")`` mesh; parameters, moments
and each global batch are DTensors placed by ``repro``'s
``TRAIN_RULES``.  For every architecture, three float32 train steps
(2 layers; Hymba at its smoke depth) are held against the port's
single-device step and ``repro``'s single-device ``train_step`` (run in
this process while the ranks work): losses and grad norms within rtol
1e-4, parameters within atol 1e-4.  ``repro``'s own pjit test
(``tests/test_mesh_subprocess.py``) is red on this tree, so it is not the
oracle.  Measured (2 x 2, 3 steps): losses within 1.0e-7 and grad norms
within 2.4e-7 of the port's single-device run, relative; parameters
within 4.2e-7.

Also: ``decode_step`` under ``DECODE_RULES`` (KV cache sequence-sharded
over ``model``, written in place on the rank that holds the slot)
against single-device ``repro`` within 1e-4 (the counterpart of the red
``test_decode_step_under_decode_rules``), and the elastic round trip: a
checkpoint saved on 2 x 2 restores on a 1 x 2 mesh (two ranks) and on
one device, and the resumed losses equal the uninterrupted run's.
"""

import dataclasses
import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from repro.configs import all_archs, get_config
from repro.data import lm_data as jdata
from repro.models import lm as jlm
from repro.train import train_step as jts
from repro.train.optimizer import OptConfig as JaxOpt
from repro_torch import configs as tconfigs
from repro_torch import tree as tree_mod
from repro_torch.checkpoint import checkpointer as ck
from repro_torch.train import train_step as ts
from repro_torch.train.optimizer import OptConfig

REPO = pathlib.Path(__file__).resolve().parent.parent
OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)
CHUNKS = dict(loss_chunk=8, q_chunk=8, kv_chunk=8)
STEPS, BATCH, SEQ = 3, 4, 16
RTOL, PARAM_ATOL, DECODE_ATOL = 1e-4, 1e-4, 1e-4
#: dense -> MLA / MoE -> SSM / hybrid -> enc-dec / VLM
ARCHS = ["stablelm_3b", "starcoder2_7b", "deepseek_67b", "nemotron4_15b",
         "deepseek_v2_lite", "phi35_moe", "mamba2_1_3b", "hymba_1_5b",
         "whisper_tiny", "paligemma_3b"]
DECODE_ARCHS = ["deepseek_67b", "deepseek_v2_lite", "hymba_1_5b"]
assert sorted(ARCHS) == sorted(all_archs())


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(snippet: str, world: int) -> list:
    """``tests/test_torch_sharded.py``'s launcher, started without
    waiting: ``world`` gloo ranks, one process each, the group made from
    the environment as torchrun makes it."""
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port()),
           "WORLD_SIZE": str(world), "OMP_NUM_THREADS": "1"}
    return [subprocess.Popen(
        [sys.executable, "-c", snippet], env={**env, "RANK": str(r),
                                              "LOCAL_RANK": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]


def finish_ranks(procs, timeout: int = 900) -> list[dict]:
    """Each rank's last stdout line as JSON (a rank that fails fails the
    caller with its stderr)."""
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=timeout)
        assert p.returncode == 0, err[-3000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    return outs


#: Runs on every rank: {archs} trained on a {shape} mesh, {decode} decoded
#: under DECODE_RULES, (with {elastic}) stablelm's checkpoint saved after
#: 2 of 4 steps and (with {pipe}) a 4-stage pipeline over the ranks as
#: pods; rank 0 writes parameters / logits to {out}.
RANK_SNIPPET = r"""
import dataclasses, json, pathlib
import numpy as np, torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch import configs, tree as tm
from repro_torch.checkpoint import checkpointer as ck
from repro_torch.data import lm_data
from repro_torch.distributed import param_specs as ps, sharding
from repro_torch.launch.train import make_batch_fn, place_batch
from repro_torch.models import lm
from repro_torch.train import train_step as ts
from repro_torch.train.optimizer import OptConfig, full
torch.set_num_threads(1)
dist.init_process_group("gloo")
OUT = pathlib.Path({out!r})
mesh = init_device_mesh("cpu", {shape}, mesh_dim_names=("data", "model"))
rank0 = dist.get_rank() == 0

def config(arch, n=None):
    base = configs.get_config(arch, smoke=True)
    n = n or (base.n_layers if base.family == "hybrid" else 2)
    return dataclasses.replace(base, n_layers=n, param_dtype="float32")

def run(cfg, state, first, last):
    tc = ts.TrainConfig(opt=OptConfig(**{opt}), **{chunks})
    step = ts.make_train_step(cfg, tc)
    at = make_batch_fn(cfg, lm_data.DataConfig(
        vocab=cfg.vocab, seq_len={seq}, global_batch={batch}),
        torch.device("cpu"))
    got = []
    for i in range(last):
        batch = at(i)             # the stub embeddings come in call order
        if i < first:
            continue
        with sharding.use_rules(mesh, sharding.TRAIN_RULES):
            state, m = step(state, place_batch(batch, mesh))
        got.append({{k: float(m[k]) for k in ("loss", "grad_norm", "ce")}})
    return state, got

res = {{"train": {{}}, "decode": {{}}}}
tc = ts.TrainConfig(opt=OptConfig(**{opt}), **{chunks})
for arch in {archs}:
    cfg = config(arch)
    state = ts.init_train_state(0, cfg, tc, device="cpu", mesh=mesh)
    state, got = run(cfg, state, 0, {steps})
    flat = {{"/".join(map(str, p)): full(t).numpy()
             for p, t in tm.flatten(state.params.tree())}}
    if rank0:
        np.savez(OUT / f"{{arch}}.npz", **flat)
    res["train"][arch] = got

R = sharding.DECODE_RULES
for arch in {decode}:
    cfg = config(arch)
    model = ps.distribute_lm(lm.init_lm(0, cfg, device="cpu"), mesh, R)
    caches = lm.init_cache(cfg, {batch}, 32, dtype=torch.float32,
                           device="cpu")
    specs = dict(tm.flatten(ps.cache_specs(caches, mesh, R)))
    caches = tm.nest((p, ps.distribute(t, mesh, specs[p]))
                     for p, t in tm.flatten(caches))
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (3, {batch})))
    logits = []
    with torch.no_grad(), sharding.use_rules(mesh, R):
        for i in range(3):
            tok = ps.distribute(toks[i], mesh, ps.resolve_leaf(
                ({batch},), ("batch",), mesh, R))
            out, caches = lm.decode_step(model, tok, caches, i, cfg)
            logits.append(full(out).numpy())
    if rank0:
        np.save(OUT / f"decode_{{arch}}.npy", np.stack(logits))
    res["decode"][arch] = True

if {elastic}:
    cfg = config("stablelm_3b")
    state = ts.init_train_state(0, cfg, tc, device="cpu", mesh=mesh)
    state, head = run(cfg, state, 0, 2)
    ck.save(OUT / "ckpt", state.tree(), 2)
    state, tail = run(cfg, state, 2, 4)
    res["elastic"] = head + tail

if {pipe}:                      # GPipe over every rank as a pod
    from repro_torch.distributed import pipeline as pp
    pods = init_device_mesh("cpu", (dist.get_world_size(),),
                            mesh_dim_names=("pod",))
    rng = np.random.default_rng(0)
    w = torch.from_numpy((rng.normal(size=(4, 16, 16)) * 0.1).astype(
        np.float32))
    x = torch.from_numpy(rng.normal(size=(8, 16)).astype(np.float32))
    res["pipe"] = pp.pipelined_apply(
        w, x, lambda p, xb: torch.tanh(xb @ p), mesh=pods, axis="pod",
        num_microbatches=4).tolist()
print(json.dumps(res))
"""

#: Runs on every rank of a {shape} mesh: stablelm's checkpoint restored
#: from {ckpt} by this mesh's placements, then steps 2 and 3.
RESTORE_SNIPPET = r"""
import dataclasses, json
import torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch import configs
from repro_torch.checkpoint import checkpointer as ck
from repro_torch.data import lm_data
from repro_torch.distributed import param_specs as ps, sharding
from repro_torch.launch.train import make_batch_fn, place_batch
from repro_torch.train import train_step as ts
from repro_torch.train.optimizer import OptConfig
torch.set_num_threads(1)
dist.init_process_group("gloo")
mesh = init_device_mesh("cpu", {shape}, mesh_dim_names=("data", "model"))
cfg = dataclasses.replace(configs.get_config("stablelm_3b", smoke=True),
                          n_layers=2, param_dtype="float32")
tc = ts.TrainConfig(opt=OptConfig(**{opt}), **{chunks})
target = ts.init_train_state(0, cfg, tc, device="meta").tree()
tree, start = ck.restore({ckpt!r}, target, mesh=mesh, shardings=ps.state_specs(
    target, mesh, sharding.TRAIN_RULES))
state = ts.TrainState.from_tree(tree, cfg, tc)
step = ts.make_train_step(cfg, tc)
at = make_batch_fn(cfg, lm_data.DataConfig(
    vocab=cfg.vocab, seq_len={seq}, global_batch={batch}), torch.device("cpu"))
losses = []
for i in range(start, 4):
    with sharding.use_rules(mesh, sharding.TRAIN_RULES):
        state, m = step(state, place_batch(at(i), mesh))
    losses.append(float(m["loss"]))
print(json.dumps({{"start": start, "losses": losses}}))
"""


def _fmt(snippet: str, **kw) -> str:
    kw.setdefault("pipe", False)
    return snippet.format(opt=OPT, chunks=CHUNKS, seq=SEQ, batch=BATCH,
                          steps=STEPS, **kw)


def _jcfg(arch: str):
    base = get_config(arch, smoke=True)
    n = base.n_layers if base.family == "hybrid" else 2
    return dataclasses.replace(base, n_layers=n, param_dtype="float32")


def _batches(cfg) -> list[dict]:
    dc = jdata.DataConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH)
    rng = np.random.default_rng(dc.seed + 17)
    out = []
    for i in range(STEPS):
        batch = jdata.batch_at(dc, i)
        if cfg.family == "audio":
            batch["enc_embeds"] = rng.normal(
                size=(BATCH, SEQ, cfg.d_model)).astype(np.float32)
        if cfg.family == "vlm":
            batch["prefix_embeds"] = rng.normal(
                size=(BATCH, cfg.vlm_prefix, cfg.d_model)).astype(np.float32)
        out.append(batch)
    return out


def repro_run(arch: str) -> tuple[list[dict], dict]:
    """``repro``'s single-device steps: metrics and final parameters."""
    cfg = _jcfg(arch)
    jtc = jts.TrainConfig(opt=JaxOpt(**OPT), **CHUNKS)
    state = jts.init_train_state(jax.random.key(0), cfg, jtc)
    step = jax.jit(jts.make_train_step(cfg, jtc))
    got = []
    for batch in _batches(cfg):
        state, m = step(state, jax.tree.map(jnp.asarray, batch))
        got.append({k: float(m[k]) for k in ("loss", "grad_norm", "ce")})
    params = {"/".join(str(getattr(e, "key", getattr(e, "idx", e)))
                       for e in p): np.asarray(v) for p, v in
              jax.tree_util.tree_flatten_with_path(state["params"])[0]}
    return got, params


def port_run(arch: str) -> tuple[list[dict], dict]:
    """The port's single-device steps."""
    tcfg = dataclasses.replace(tconfigs.get_config(arch, smoke=True),
                               n_layers=_jcfg(arch).n_layers,
                               param_dtype="float32")
    tc = ts.TrainConfig(opt=OptConfig(**OPT), **CHUNKS)
    state = ts.init_train_state(0, tcfg, tc, device="cpu")
    step = ts.make_train_step(tcfg, tc)
    got = []
    for batch in _batches(tcfg):
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
        got.append({k: float(m[k]) for k in ("loss", "grad_norm", "ce")})
    params = {"/".join(map(str, p)): t.numpy()
              for p, t in tree_mod.flatten(state.params.tree())}
    return got, params


@pytest.fixture(scope="module")
def mesh22(tmp_path_factory):
    """The 2 x 2 group's results, with both single-device references
    computed here while the ranks run."""
    out = tmp_path_factory.mktemp("mesh22")
    procs = start_ranks(_fmt(RANK_SNIPPET, shape=(2, 2), archs=ARCHS,
                             decode=DECODE_ARCHS, elastic=True,
                             out=str(out)), 4)
    try:
        refs = {a: (repro_run(a), port_run(a)) for a in ARCHS}
        decode = {a: repro_decode(a) for a in DECODE_ARCHS}
    finally:
        ranks = finish_ranks(procs)
    return out, ranks, refs, decode


def repro_decode(arch: str) -> np.ndarray:
    cfg = _jcfg(arch)
    params = jlm.init_lm(jax.random.key(0), cfg)
    caches = jlm.init_cache(cfg, BATCH, 32, dtype=jnp.float32)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (3, BATCH))
    step = jax.jit(lambda p, t, c, pos: jlm.decode_step(p, t, c, pos, cfg))
    out = []
    for i in range(3):
        logits, caches = step(params, jnp.asarray(toks[i], jnp.int32),
                              caches, jnp.int32(i))
        out.append(np.asarray(logits))
    return np.stack(out)


def _close(got: list[dict], want: list[dict], what: str) -> None:
    for i, (g, w) in enumerate(zip(got, want)):
        for k in ("loss", "grad_norm", "ce"):
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=1e-7,
                                       err_msg=f"{what} step {i} {k}")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_on_2x2_matches_single_device(mesh22, arch):
    out, ranks, refs, _ = mesh22
    (jm, jparams), (tm, tparams) = refs[arch]
    for rank in ranks:          # every rank reports the same metrics
        assert rank["train"][arch] == ranks[0]["train"][arch]
    got = ranks[0]["train"][arch]
    assert len(got) == STEPS
    _close(got, tm, f"{arch} vs port")
    _close(got, jm, f"{arch} vs repro")
    mesh_params = dict(np.load(out / f"{arch}.npz"))
    assert set(mesh_params) == set(tparams) == set(jparams)
    for name, want in jparams.items():
        np.testing.assert_allclose(mesh_params[name], tparams[name],
                                   atol=PARAM_ATOL, rtol=0, err_msg=name)
        np.testing.assert_allclose(mesh_params[name], want,
                                   atol=PARAM_ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_under_decode_rules_matches_repro(mesh22, arch):
    out, ranks, _, decode = mesh22
    assert ranks[0]["decode"][arch]
    got = np.load(out / f"decode_{arch}.npy")
    np.testing.assert_allclose(got, decode[arch], atol=DECODE_ATOL,
                               rtol=DECODE_ATOL)


def test_elastic_round_trip(mesh22):
    """Saved on 2 x 2 after 2 steps; restored on 1 x 2 (two ranks) and
    on one device, steps 2 and 3 give the uninterrupted run's losses."""
    out, ranks, _, _ = mesh22
    want = [m["loss"] for m in ranks[0]["elastic"]][2:]
    assert ck.latest_step(out / "ckpt") == 2
    two = finish_ranks(start_ranks(_fmt(RESTORE_SNIPPET, shape=(1, 2),
                                        ckpt=str(out / "ckpt")), 2))
    for r in two:
        assert r["start"] == 2
        np.testing.assert_allclose(r["losses"], want, rtol=1e-5)
    cfg = dataclasses.replace(tconfigs.get_config("stablelm_3b", smoke=True),
                              n_layers=2, param_dtype="float32")
    tc = ts.TrainConfig(opt=OptConfig(**OPT), **CHUNKS)
    target = ts.init_train_state(0, cfg, tc, device="meta").tree()
    tree, start = ck.restore(out / "ckpt", target)
    state = ts.TrainState.from_tree(tree, cfg, tc)
    step = ts.make_train_step(cfg, tc)
    from repro_torch.data import lm_data
    from repro_torch.launch.train import make_batch_fn
    at = make_batch_fn(cfg, lm_data.DataConfig(
        vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH), "cpu")
    losses = []
    for i in range(start, 4):
        state, m = step(state, at(i))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, want, rtol=1e-5)
