"""The streamed checkpoint of a train state
(:meth:`~repro_torch.train.train_step.TrainState.checkpoint_tree`: each
segment leaf as its per-layer tensors, stacked on the host a layer at a
time) against the stacked one (``state.tree()``): the files and
``meta.json`` are byte-identical, for ``save`` and the
``AsyncCheckpointer``; ``repro``'s checkpointer restores them; and a
sync save holds at most one stacked leaf at a time and stacks nothing
with ``torch.stack``.
"""

import dataclasses
import weakref

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.checkpoint import checkpointer as jck
from repro.configs import get_config as jget_config
from repro.train import train_step as jts
from repro_torch import tree as tree_mod
from repro_torch.checkpoint import checkpointer as ck
from repro_torch.configs import get_config
from repro_torch.data import lm_data
from repro_torch.train import train_step as ts

ARCHS = ["stablelm-3b", "deepseek-v2-lite-16b"]


def _state(arch: str, dtype: str) -> ts.TrainState:
    """The smoke config's state after one train step (moments not 0)."""
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              param_dtype=dtype)
    tc = ts.TrainConfig(loss_chunk=8, q_chunk=8, kv_chunk=8)
    state = ts.init_train_state(0, cfg, tc, device="cpu")
    batch = lm_data.batch_at(lm_data.DataConfig(
        vocab=cfg.vocab, seq_len=16, global_batch=2), 0)
    state, _ = ts.make_train_step(cfg, tc)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    return state


def _files(d) -> dict:
    step = d / "step_00000001"
    return {p.name: p.read_bytes() for p in sorted(step.iterdir())}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", ARCHS)
def test_streamed_files_equal_stacked_save(tmp_path, arch, dtype):
    state = _state(arch, dtype)
    ck.save(tmp_path / "stacked", state.tree(), 1)
    ck.save(tmp_path / "streamed", state.checkpoint_tree(), 1)
    acp = ck.AsyncCheckpointer(tmp_path / "async")
    acp.save(state.checkpoint_tree(), 1)
    acp.wait()
    want = _files(tmp_path / "stacked")
    assert "meta.json" in want and len(want) > 10
    assert _files(tmp_path / "streamed") == want
    assert _files(tmp_path / "async") == want
    if dtype == "float32":          # repro cannot read its bf16 leaves
        cfg = dataclasses.replace(jget_config(arch, smoke=True),
                                  param_dtype="float32")
        target = jax.eval_shape(lambda: jts.init_train_state(
            jax.random.key(0), cfg, jts.TrainConfig()))
        got, step = jck.restore(tmp_path / "streamed", target)
        assert step == 1
        flat = dict(tree_mod.flatten(state.tree()))
        jflat = jax.tree_util.tree_flatten_with_path(got)[0]
        assert len(jflat) == len(flat)
        for path, leaf in jflat:
            key = tuple(getattr(e, "key", getattr(e, "idx", None))
                        for e in path)
            np.testing.assert_array_equal(np.asarray(leaf),
                                          flat[key].numpy(), err_msg=key)


@pytest.mark.parametrize("arch", ARCHS)
def test_save_holds_one_stacked_leaf_at_a_time(tmp_path, arch, monkeypatch):
    state = _state(arch, "bfloat16")
    tree = state.checkpoint_tree()
    layers = [leaf for _, leaf in tree_mod.flatten(tree)
              if isinstance(leaf, ck.Layers)]
    assert len(layers) > 10
    made, most, stacks = [], [0], [0]
    real_to_numpy, real_stack = ck._to_numpy, torch.stack

    def counting_to_numpy(leaf):
        out = real_to_numpy(leaf)
        if isinstance(leaf, ck.Layers):
            made.append(weakref.ref(out))
            most[0] = max(most[0], sum(r() is not None for r in made))
        return out

    def counting_stack(*a, **kw):
        stacks[0] += 1
        return real_stack(*a, **kw)
    monkeypatch.setattr(ck, "_to_numpy", counting_to_numpy)
    monkeypatch.setattr(torch, "stack", counting_stack)
    ck.save(tmp_path, tree, 1)
    assert len(made) == len(layers)
    assert most[0] == 1 and stacks[0] == 0
