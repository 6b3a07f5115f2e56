"""The port's train step (``repro_torch.train``) against ``repro``'s, on
the CPU, in float32, for every smoke architecture.

One ``repro`` train state (``init_train_state(jax.random.key(0), ...)``)
is carried across with ``convert.train_state_from_repro`` and both
packages take 3 steps on the same ``lm_data.batch_at`` batches, with
``repro``'s default weight decay (0.1) on: it decays every stacked block
leaf, norm scales included, which a port that tested its per-layer
tensors' rank would not.  Tolerances: losses and grad norms rtol 1e-4;
step-0 gradients atol 1e-5 x the leaf's max |g| plus rtol 1e-4; ``m``
and ``v`` rtol 1e-4 plus atol 1e-4 x the leaf's max (for elements near
0); parameters atol 1e-5, except where the step-0 |g| is below 1e-6 x
the leaf's max, where AdamW's first step ``g / (|g| + eps)`` may take
float noise to the other sign: there the gap must stay below
``2 * lr * steps``.  Measured (3 steps, batch 2 x 16): parameters within
4.7e-7 (hymba-1.5b; 4.3e-7 or less elsewhere), so no element needed
that exception (the elements it covers are mostly exact zeros: the
embedding rows of tokens the batches lack); gradients within 2.2e-6 x
the leaf max but for hymba's last global layer's ``ssm.a_log``, one of
whose 8 elements (1.035797e-5 against 1.035749e-5) sits 1.26e-5 x the
leaf's max apart, within the rtol; moments within 1.3e-5 x the leaf
max (the same leaf; 3.1e-6 elsewhere); losses within 1.8e-7 and grad
norms within 4.5e-7, relative.

This file holds the architectures without MoE routing or hybrid heads,
and Hymba's plan with a segment of no layer;
``tests/test_torch_train_moe.py`` the others (the two files run in
parallel under the suite's workers).
"""

import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from repro.configs import all_archs, get_config
from repro.data import lm_data as jdata
from repro.train import train_step as jts
from repro.train.optimizer import OptConfig as JaxOpt
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.data import lm_data
from repro_torch.train import train_step as ts
from repro_torch.train.optimizer import OptConfig

OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)
CHUNKS = dict(loss_chunk=8, q_chunk=8, kv_chunk=8)
STEPS = 3
RTOL = 1e-4
GRAD_ATOL = 1e-5
PARAM_ATOL = 1e-5
TINY_G = 1e-6


def depth(arch: str) -> int:
    """2 layers; Hymba's plan needs its smoke depth (a global layer at 0,
    n // 2 and n - 1 with sliding-window runs between)."""
    base = get_config(arch, smoke=True)
    return base.n_layers if base.family == "hybrid" else 2


def pair(arch: str, *, n_layers: int | None = None, opt: dict | None = None,
         **tc_kw):
    """``repro``'s config, train config and state, and the port's, with
    the state carried across."""
    n = n_layers or depth(arch)
    cfg = dataclasses.replace(get_config(arch, smoke=True), n_layers=n,
                              param_dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get_config(arch, smoke=True),
                               n_layers=n, param_dtype="float32")
    okw = {**OPT, **(opt or {})}
    kw = {**CHUNKS, **tc_kw}
    jtc = jts.TrainConfig(opt=JaxOpt(**okw), **kw)
    ttc = ts.TrainConfig(opt=OptConfig(**okw), **kw)
    state = jts.init_train_state(jax.random.key(0), cfg, jtc)
    tstate = convert.train_state_from_repro(
        jax.tree.map(np.asarray, state), tcfg, ttc, "cpu")
    return cfg, jtc, state, tcfg, ttc, tstate


def batches(cfg, steps: int, *, b: int = 2, s: int = 16, seed: int = 0,
            edit=None) -> list[dict]:
    """``lm_data.batch_at``'s batches (numpy), with the audio / VLM stub
    embeddings where the family takes them; ``edit`` may change each."""
    dc = jdata.DataConfig(vocab=cfg.vocab, seq_len=s, global_batch=b,
                          seed=seed)
    rng = np.random.default_rng(seed + 17)
    out = []
    for i in range(steps):
        batch = jdata.batch_at(dc, i)
        if cfg.family == "audio":
            batch["enc_embeds"] = rng.normal(
                size=(b, s, cfg.d_model)).astype(np.float32)
        if cfg.family == "vlm":
            batch["prefix_embeds"] = rng.normal(
                size=(b, cfg.vlm_prefix, cfg.d_model)).astype(np.float32)
        out.append(edit(batch) if edit else batch)
    return out


@functools.lru_cache(maxsize=None)
def _jit_step(cfg, jtc):
    return jax.jit(jts.make_train_step(cfg, jtc))


def run_both(cfg, jtc, state, tcfg, ttc, tstate, data):
    """Both packages through ``data``; each step's metrics (as floats),
    the final states (numpy, ``repro``'s layout) and the step-0
    gradients: the port's ``grad_tree`` and ``repro``'s, recovered from
    its step-0 ``m`` (``(1 - b1) * clip_scale * g``)."""
    jstep, tstep = _jit_step(cfg, jtc), ts.make_train_step(tcfg, ttc)
    jm, tm = [], []
    for i, batch in enumerate(data):
        state, m = jstep(state, jax.tree.map(jnp.asarray, batch))
        tstate, n = tstep(tstate, {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
        jm.append({k: float(v) for k, v in m.items()})
        tm.append({k: float(v) for k, v in n.items()})
        if i == 0:
            scale = min(1.0, jtc.opt.clip_norm / max(jm[0]["grad_norm"],
                                                     1e-9))
            g0_want = jax.tree.map(
                lambda x: np.asarray(x, np.float64)
                / ((1 - jtc.opt.b1) * scale), state["opt"]["m"])
            g0_got = jax.tree.map(lambda t: t.numpy(), tstate.grad_tree())
    return (jm, jax.tree.map(np.asarray, state), tm,
            convert.train_state_to_repro(tstate), (g0_want, g0_got))


def leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def assert_metrics_close(jm, tm, keys=("loss", "ce", "aux", "grad_norm",
                                       "lr", "tokens")):
    for i, (a, b) in enumerate(zip(jm, tm)):
        for k in keys:
            np.testing.assert_allclose(b[k], a[k], rtol=RTOL, atol=1e-7,
                                       err_msg=f"step {i} {k}")


def assert_moments_close(want, got):
    for name in ("m", "v"):
        for (path, a), (_, b) in zip(leaves(want["opt"][name]),
                                     leaves(got["opt"][name])):
            scale = float(np.abs(a).max()) if a.size else 0.0
            np.testing.assert_allclose(
                b, a, rtol=RTOL, atol=RTOL * scale,
                err_msg=f"{name}{jax.tree_util.keystr(path)}")


def assert_params_close(want, got, g0, lr_sum: float):
    """Parameters within ``PARAM_ATOL``, but where the step-0 gradient is
    tiny against its leaf, within ``2 * lr_sum``."""
    for (path, a), (_, b), (_, g) in zip(leaves(want["params"]),
                                         leaves(got["params"]),
                                         leaves(g0)):
        gap = np.abs(np.asarray(b, np.float64) - np.asarray(a, np.float64))
        top = float(np.abs(g).max()) if g.size else 0.0
        tiny = np.abs(g) < TINY_G * max(top, 1e-30)
        name = jax.tree_util.keystr(path)
        assert (gap[~tiny] <= PARAM_ATOL).all(), (name, gap.max())
        assert (gap[tiny] <= 2 * lr_sum).all(), (name, gap.max())


def assert_grads_close(g0):
    for (path, a), (_, b) in zip(leaves(g0[0]), leaves(g0[1])):
        assert a.shape == b.shape, path
        scale = float(np.abs(a).max()) if a.size else 0.0
        np.testing.assert_allclose(
            b, a, rtol=RTOL, atol=GRAD_ATOL * max(scale, 1e-30),
            err_msg=f"grad{jax.tree_util.keystr(path)}")


def _plain(arch: str) -> bool:
    cfg = get_config(arch, smoke=True)
    return cfg.moe is None and cfg.family != "hybrid"


PLAIN_ARCHS = [a for a in all_archs() if _plain(a)]
OTHER_ARCHS = [a for a in all_archs() if not _plain(a)]


def check_three_steps(arch: str, n_layers: int | None = None) -> None:
    cfg, jtc, state, tcfg, ttc, tstate = pair(arch, n_layers=n_layers)
    jm, want, tm, got, g0 = run_both(cfg, jtc, state, tcfg, ttc, tstate,
                                     batches(cfg, STEPS))
    assert_metrics_close(jm, tm)
    assert_grads_close(g0)
    assert [jax.tree_util.keystr(p) for p, _ in leaves(want)] == \
        [jax.tree_util.keystr(p) for p, _ in leaves(got)]
    assert int(got["step"]) == int(want["step"]) == STEPS
    assert_moments_close(want, got)
    assert_params_close(want, got, g0[0], sum(m["lr"] for m in jm))


@pytest.mark.parametrize("arch", PLAIN_ARCHS)
def test_three_steps_match_repro(arch):
    check_three_steps(arch)


def test_zero_layer_segment_matches_repro():
    """Hymba at 4 layers: ``repro``'s plan holds a sliding-window segment
    of no layer (``(0, ...)`` leaves), which the port keeps through its
    train state, moments and checkpoints' layout."""
    check_three_steps("hymba-1.5b", n_layers=4)


def test_port_batches_equal_repro_batches():
    """The port's ``lm_data`` is a copy, not an import: equal arrays."""
    for kind in ("structured", "genome"):
        for seed, step in ((0, 0), (3, 17), (9, 123)):
            kw = dict(vocab=64, seq_len=24, global_batch=3, seed=seed,
                      kind=kind)
            want = jdata.batch_at(jdata.DataConfig(**kw), step)
            got = lm_data.batch_at(lm_data.DataConfig(**kw), step)
            assert sorted(got) == sorted(want) == ["labels", "tokens"]
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
