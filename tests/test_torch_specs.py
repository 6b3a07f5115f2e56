"""The port's spec layer against ``repro``'s, exactly, with no ranks.

For every architecture (smoke and full configs, on ``meta`` tensors /
``jax.eval_shape``), under ``TRAIN_RULES``, ``PREFILL_RULES`` and
``DECODE_RULES``, on meshes (2, 4), (16, 16) and (2, 16, 16): every
parameter, train-state, decode-cache and batch spec of
``repro_torch.distributed.param_specs`` equals ``repro``'s
``PartitionSpec`` on ``sharding.abstract_mesh`` (compared as
``PartitionSpec``s, which take ``("data",)`` and ``"data"`` as one).
Plus ``elastic.reshard_plan``'s report, ``configs.shapes``, the
``dryrun_hdc`` per-device shapes against ``NamedSharding.shard_shape``,
the placement layer's mesh order, and the copied helpers.
"""

import dataclasses
import functools

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.configs import all_archs, get_config
from repro.configs import shapes as jshapes
from repro.distributed import elastic as jelastic
from repro.distributed import param_specs as jps
from repro.distributed import pipeline as jpipeline
from repro.distributed import sharding as jsharding
from repro.models import lm as jlm
from repro.train import train_step as jts
from repro_torch import configs as tconfigs
from repro_torch import tree as tree_mod
from repro_torch.configs import shapes
from repro_torch.distributed import elastic, param_specs, pipeline, sharding
from repro_torch.models import lm
from repro_torch.train import train_step as ts

MESHES = [((2, 4), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
RULES = {"train": (sharding.TRAIN_RULES, jsharding.TRAIN_RULES),
         "prefill": (sharding.PREFILL_RULES, jsharding.PREFILL_RULES),
         "decode": (sharding.DECODE_RULES, jsharding.DECODE_RULES)}
CASES = [(a, smoke) for a in all_archs() for smoke in (True, False)]


def _jpath(path) -> tuple:
    return tuple(getattr(e, "key", getattr(e, "idx", e)) for e in path)


def _jspecs(tree) -> dict:
    """``repro``'s NamedSharding tree -> {path: PartitionSpec}."""
    return {_jpath(p): s.spec for p, s in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _same(ours: dict, theirs: dict, what: str) -> None:
    assert set(ours) == set(theirs), what
    bad = [(p, ours[p], theirs[p]) for p in ours
           if P(*ours[p]) != theirs[p]]
    assert not bad, (what, bad[:5])
    assert all(isinstance(s, sharding.Spec) for s in ours.values())


@functools.lru_cache(maxsize=None)
def _trees(arch: str, smoke: bool):
    cfg = get_config(arch, smoke=smoke)
    tcfg = tconfigs.get_config(arch, smoke=smoke)
    jstate = jax.eval_shape(lambda: jts.init_train_state(
        jax.random.key(0), cfg, jts.TrainConfig()))
    tstate = ts.init_train_state(0, tcfg, ts.TrainConfig(),
                                 device="meta").tree()
    shape = jshapes.SHAPES["decode_32k"]
    enc = shape.seq_len if cfg.family == "audio" else 0
    jcache = jax.eval_shape(lambda: jlm.init_cache(
        cfg, shape.global_batch, shape.seq_len, enc_len=enc))
    tcache = shapes.cache_specs(tcfg, shapes.SHAPES["decode_32k"])
    return cfg, tcfg, jstate, tstate, jcache, tcache


@pytest.mark.parametrize("arch,smoke", CASES)
def test_specs_equal_repro(arch, smoke):
    cfg, tcfg, jstate, tstate, jcache, tcache = _trees(arch, smoke)
    for sizes, names in MESHES:
        amesh = jsharding.abstract_mesh(sizes, names)
        mesh = sharding.MeshShape(sizes, names)
        for kind, (rules, jrules) in RULES.items():
            what = f"{arch} smoke={smoke} {sizes} {kind}"
            ours = dict(tree_mod.flatten(
                param_specs.state_specs(tstate, mesh, rules)))
            _same(ours, _jspecs(jps.state_shardings(jstate, amesh, jrules)),
                  what + " state")
            ours = dict(tree_mod.flatten(
                param_specs.cache_specs(tcache, mesh, rules)))
            _same(ours, _jspecs(jps.cache_shardings(jcache, amesh, jrules)),
                  what + " cache")
            for sname in jshapes.SHAPES:
                jin = jshapes.input_specs(cfg, jshapes.SHAPES[sname])
                tin = shapes.input_specs(tcfg, shapes.SHAPES[sname])
                _same(dict(tree_mod.flatten(
                    param_specs.batch_specs(tin, mesh, rules))),
                      _jspecs(jps.batch_shardings(jin, amesh, jrules)),
                      what + " batch " + sname)


def test_layer_placements_follow_the_stacked_spec():
    """A layer's tensor takes its stacked leaf's spec without the layer
    axis; the leaf name is the path's last key."""
    cfg = tconfigs.get_config("stablelm_3b")
    model = lm.init_lm(0, cfg, device="meta")
    mesh = sharding.MeshShape((16, 16), ("data", "model"))
    specs = dict(tree_mod.flatten(param_specs.param_specs(
        model.tree(), mesh, sharding.TRAIN_RULES)))
    for leaf in lm.stacked_leaves(model):
        got = param_specs.layer_spec(leaf, mesh, sharding.TRAIN_RULES)
        assert got == (specs[leaf.path][1:] if leaf.stacked
                       else specs[leaf.path])
    wq = [leaf for leaf in lm.stacked_leaves(model)
          if leaf.path[-1] == "wq"][0]
    assert param_specs.layer_spec(wq, mesh, sharding.TRAIN_RULES) == \
        ("data", "model", None)


def test_placements_split_in_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    mesh = sharding.MeshShape((2, 16, 16), ("pod", "data", "model"))
    assert sharding.placements(sharding.Spec(((("pod", "data")), None,
                                              "model")), mesh) == \
        [Shard(0), Shard(0), Shard(2)]
    assert sharding.placements(sharding.Spec((None,)), mesh) == \
        [Replicate()] * 3
    with pytest.raises(ValueError, match="axis order"):
        sharding.placements(sharding.Spec(((("data", "pod")),)), mesh)
    one = sharding.MeshShape((1, 4), ("data", "model"))
    assert sharding.placements(sharding.Spec(("data", "model")), one) == \
        [Replicate(), Shard(1)]


@pytest.mark.parametrize("a,b", [((4, 2), (2, 4)), ((2, 4), (4, 2)),
                                 ((16, 16), (2, 16)), ((8, 1), (1, 8))])
def test_reshard_plan_equals_repro(a, b):
    cfg = get_config("stablelm_3b", smoke=True)
    jstate = jax.eval_shape(lambda: jts.init_train_state(
        jax.random.key(0), cfg, jts.TrainConfig()))
    tstate = ts.init_train_state(0, tconfigs.get_config(
        "stablelm_3b", smoke=True), ts.TrainConfig(), device="meta").tree()
    names = ("data", "model")
    _, want = jelastic.reshard_plan(
        jstate, jsharding.abstract_mesh(a, names),
        jsharding.abstract_mesh(b, names), jsharding.TRAIN_RULES)
    new, got = elastic.reshard_plan(
        tstate, sharding.MeshShape(a, names), sharding.MeshShape(b, names),
        sharding.TRAIN_RULES)
    assert got.n_leaves == want.n_leaves
    assert got.changed == want.changed
    assert got.dropped_axes == want.dropped_axes
    assert len(tree_mod.flatten(new)) == want.n_leaves


def test_rescale_batch_and_stages_equal_repro():
    for args in [(256, 16, 8), (256, 8, 16), (96, 4, 3)]:
        assert elastic.rescale_batch(*args) == jelastic.rescale_batch(*args)
        assert elastic.rescale_batch(*args, keep_global=False) == \
            jelastic.rescale_batch(*args, keep_global=False)
    with pytest.raises(ValueError):
        elastic.rescale_batch(100, 16, 64)
    for n, s in [(32, 4), (30, 4), (7, 3), (2, 2)]:
        assert pipeline.pipeline_stages(n, s) == \
            jpipeline.pipeline_stages(n, s)


@pytest.mark.parametrize("arch", list(all_archs()))
def test_shapes_equal_repro(arch):
    cfg = get_config(arch)
    tcfg = tconfigs.get_config(arch)
    assert list(shapes.SHAPES) == list(jshapes.SHAPES)
    for name, spec in jshapes.SHAPES.items():
        ours = shapes.SHAPES[name]
        assert dataclasses.astuple(ours) == dataclasses.astuple(spec)
        assert shapes.applicable(tcfg, ours) == jshapes.applicable(cfg, spec)
        want = jshapes.input_specs(cfg, spec)
        got = shapes.input_specs(tcfg, ours)
        assert list(got) == list(want)
        for k in want:
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == want[k].shape, (name, k)
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
    model = shapes.param_specs(tcfg)
    jparams = jshapes.param_specs(cfg)
    ours = {p: tuple(t.shape) for p, t in tree_mod.flatten(model.tree())}
    theirs = {_jpath(p): t.shape for p, t in
              jax.tree_util.tree_flatten_with_path(jparams)[0]}
    assert ours == theirs


def test_dryrun_hdc_shard_shapes_equal_repro():
    """The per-device shapes ``dryrun_hdc`` places its arguments and its
    output at equal ``NamedSharding.shard_shape`` of ``repro``'s."""
    from repro_torch.launch import dryrun_hdc as hdc
    for multi_pod, (sizes, names) in ((False, MESHES[1]),
                                      (True, MESHES[2])):
        amesh = jsharding.abstract_mesh(sizes, names)
        mesh = sharding.MeshShape(sizes, names)
        glob = {"tokens": (hdc.BATCH, hdc.READ_LEN), "lengths": (hdc.BATCH,),
                "protos": (hdc.NUM_PROTOS, hdc.SPACE.num_words),
                "out": (hdc.BATCH, hdc.NUM_PROTOS)}
        for variant in hdc.VARIANTS:
            sh = hdc.shardings(variant, multi_pod)
            for k, shape in glob.items():
                want = NamedSharding(amesh, P(*sh[k])).shard_shape(shape)
                assert sharding.shard_shape(shape, sh[k], mesh) == want, \
                    (variant, k)
