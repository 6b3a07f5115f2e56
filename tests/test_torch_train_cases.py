"""The port's train step in the cases ``tests/test_torch_train.py``'s
three-step runs leave at their defaults, each against ``repro``'s with
that file's tolerances: gradient accumulation, a large z-loss, masked
labels, a loss chunk that does not divide the sequence (the VLM prefix
and the audio encoder beside it), and the schedule; then remat against
none, the stacked layout through ``convert`` (weight decay sees
``repro``'s leaves), learning on structured data, and the trainer's
parameters against serving.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from repro.configs import get_config
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.data import lm_data
from repro_torch.models import lm
from repro_torch.train import optimizer, train_step as ts
from tests.test_torch_train import (assert_grads_close, assert_metrics_close,
                                    assert_moments_close, assert_params_close,
                                    batches, leaves, pair, run_both)


def _mask_some(batch):
    labels = batch["labels"].copy()
    labels[0, ::3] = -1
    labels[1, 5:] = -1
    return dict(batch, labels=labels)


CASES = {
    # name: (arch, train-config overrides, batches() keywords)
    "microbatches": ("stablelm-3b", {"microbatches": 2}, {"b": 4}),
    "microbatches_moe": ("phi35_moe", {"microbatches": 2}, {"b": 4}),
    "z_loss": ("starcoder2-7b", {"z_loss": 1e-2}, {}),
    "masked_labels": ("stablelm-3b", {}, {"edit": _mask_some}),
    "vlm_prefix_ragged_chunk": ("paligemma-3b", {"loss_chunk": 5},
                                {"s": 12}),
    "audio_ragged_chunk": ("whisper-tiny", {"loss_chunk": 5}, {"s": 12}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_case_matches_repro(case):
    arch, tc_kw, data_kw = CASES[case]
    cfg, jtc, state, tcfg, ttc, tstate = pair(arch, **tc_kw)
    data = batches(cfg, 3, **data_kw)
    jm, want, tm, got, g0 = run_both(cfg, jtc, state, tcfg, ttc, tstate,
                                     data)
    assert_metrics_close(jm, tm)
    if "microbatches" not in tc_kw:       # .grad is the whole batch's
        assert_grads_close(g0)
    assert_moments_close(want, got)
    assert_params_close(want, got, g0[0], sum(m["lr"] for m in jm))
    labels = data[-1]["labels"]
    if "microbatches" in tc_kw:           # the last microbatch's count
        labels = labels[labels.shape[0] // tc_kw["microbatches"]:]
    assert tm[-1]["tokens"] == int((labels >= 0).sum())


def test_clip_by_global_norm_equals_repro():
    rng = np.random.default_rng(4)
    grads = [rng.normal(size=s).astype(np.float32) * 3
             for s in ((4, 5), (7,), (2, 3, 2))]
    want, wnorm = jopt.clip_by_global_norm(
        [jnp.asarray(g) for g in grads], 1.0)
    got, gnorm = optimizer.clip_by_global_norm(
        [torch.from_numpy(g) for g in grads], 1.0)
    np.testing.assert_allclose(float(gnorm), float(wnorm), rtol=1e-6)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)


@pytest.mark.parametrize("step", [0, 10, 55, 100])
def test_lr_at_equals_repro(step):
    kw = dict(peak_lr=1e-3, warmup_steps=10, total_steps=100,
              min_lr_frac=0.1)
    want = np.float32(jopt.lr_at(jnp.int32(step), jopt.OptConfig(**kw)))
    got = optimizer.lr_at(step, optimizer.OptConfig(**kw))
    assert got.dtype == np.float32
    assert got == want


def test_remat_changes_no_number():
    """Recomputing each layer and each loss chunk in the backward gives
    the gradients of the plain backward, bit for bit, on the CPU."""
    cfg = dataclasses.replace(tconfigs.get_config("hymba-1.5b", smoke=True),
                              param_dtype="float32")
    batch = {k: torch.from_numpy(v) for k, v in batches(cfg, 1)[0].items()}
    grads = {}
    for remat in (True, False):
        tc = ts.TrainConfig(loss_chunk=8, q_chunk=8, kv_chunk=8, remat=remat)
        state = ts.init_train_state(0, cfg, tc, device="cpu")
        loss, _ = ts.make_loss_fn(cfg, tc)(state.params, batch)
        loss.backward()
        grads[remat] = lm.tree_map(torch.clone, state.grad_tree())
    for (_, a), (_, b) in zip(leaves(grads[True]), leaves(grads[False])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch,dtype", [("phi35_moe", "float32"),
                                        ("hymba-1.5b", "bfloat16"),
                                        ("whisper-tiny", "bfloat16")])
def test_train_state_round_trip_keeps_stacked_layout(arch, dtype):
    """``repro``'s train state -> the port's -> back: every leaf, key,
    shape and dtype kept (segments stacked on a layer axis), and the
    decay groups are ``repro``'s: every block tensor (norm scales and
    Hymba's ``branch_scale`` too) is decayed, the top-level 1-D norms
    are not."""
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              param_dtype=dtype)
    tcfg = dataclasses.replace(tconfigs.get_config(arch, smoke=True),
                               param_dtype=dtype)
    state = jax.tree.map(np.asarray, jts.init_train_state(
        jax.random.key(1), cfg, jts.TrainConfig()))
    # moments and step made distinct, so a mix-up would show
    rng = np.random.default_rng(0)
    state["opt"] = jax.tree.map(
        lambda x: rng.normal(size=x.shape).astype(np.float32), state["opt"])
    state["step"] = np.int32(7)
    tstate = convert.train_state_from_repro(state, tcfg, ts.TrainConfig(),
                                            "cpu")
    assert tstate.step == 7
    back = convert.train_state_to_repro(tstate)
    want, got = leaves(state), leaves(back)
    assert [jax.tree_util.keystr(p) for p, _ in want] == \
        [jax.tree_util.keystr(p) for p, _ in got]
    for (path, a), (_, b) in zip(want, got):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        np.testing.assert_array_equal(
            np.asarray(b).reshape(-1).view(np.uint8),
            np.asarray(a).reshape(-1).view(np.uint8))
    decayed = {id(p) for g in tstate.opt.param_groups if g["decay"]
               for p in g["params"]}
    want_decay = {jax.tree_util.keystr(p): np.ndim(a) >= 2
                  for p, a in leaves(state["params"])}
    for leaf in tstate.opt.leaves:
        key = jax.tree_util.keystr(tuple(
            jax.tree_util.SequenceKey(k) if isinstance(k, int)
            else jax.tree_util.DictKey(k) for k in leaf.path))
        assert all((id(p) in decayed) == want_decay[key]
                   for p in leaf.params), key
    assert id(tstate.params.final_norm.scale) not in decayed
    block = tstate.params.segments[0][0]
    assert id(block.ln1.scale) in decayed and block.ln1.scale.ndim == 1
    if cfg.family == "hybrid":
        assert id(block.branch_scale) in decayed


def test_loss_decreases_on_structured_data():
    """``tests/test_train_loop.py``'s case on the port: same config, same
    threshold."""
    cfg = dataclasses.replace(tconfigs.get_config("stablelm_3b", smoke=True),
                              vocab=64, n_layers=2, param_dtype="float32")
    dc = lm_data.DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8,
                            seed=1)
    tc = ts.TrainConfig(opt=optimizer.OptConfig(
        peak_lr=1e-2, warmup_steps=5, total_steps=100, weight_decay=0.0),
        loss_chunk=32, q_chunk=32, kv_chunk=32, z_loss=0.0)
    state = ts.init_train_state(0, cfg, tc, device="cpu")
    step = ts.make_train_step(cfg, tc)
    losses = []
    for i in range(100):
        batch = {k: torch.from_numpy(v)
                 for k, v in lm_data.batch_at(dc, i).items()}
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    assert last < first * 0.85, f"no learning: {first:.3f} -> {last:.3f}"
    assert np.isfinite(losses).all()


def test_serving_after_training_runs_without_grad():
    """A trained model serves under ``inference_mode`` as a fresh one
    does: no autograd record, the same logits as its weights copied into
    a model that never trained."""
    cfg = dataclasses.replace(tconfigs.get_config("stablelm-3b", smoke=True),
                              param_dtype="float32")
    tc = ts.TrainConfig(loss_chunk=8, q_chunk=8, kv_chunk=8)
    state = ts.init_train_state(0, cfg, tc, device="cpu")
    step = ts.make_train_step(cfg, tc)
    for batch in batches(cfg, 2):
        state, _ = step(state, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
    fresh = lm.LM(cfg, lm.tree_map(torch.clone, state.params.tree()))
    assert not any(p.requires_grad for p in fresh.parameters())
    toks = torch.from_numpy(batches(cfg, 1)[0]["tokens"])
    with torch.inference_mode():
        a = lm.forward(state.params, toks, cfg, q_chunk=8, kv_chunk=8)[0]
        b = lm.forward(fresh, toks, cfg, q_chunk=8, kv_chunk=8)[0]
    assert not a.requires_grad
    assert torch.equal(a, b)
