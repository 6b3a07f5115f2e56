"""The port's LM stack (``repro_torch.models``, ``configs``) against
``repro``'s, on the CPU, in float32.

``repro``'s weights are carried across with ``convert.lm_params_from_repro``
wherever outputs are compared, so each case holds the computation alone.
Tolerances: atol = rtol = 1e-4 on logits (whole models: ``forward``,
``prefill`` and 4 ``decode_step``s for every ``SMOKE`` architecture),
1e-5 on single modules.  ``init_lm`` draws through the port's Threefry:
float32 leaves within 4 ulp of ``repro``'s (``jax.random.normal`` is
reproduced to a few ulp, ``tests/test_torch_random.py``), bfloat16 leaves
equal but for at most one bf16 ulp in 0.1 % of them.
"""

import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from repro.configs import all_archs, get_config
from repro.models import attention as jattn
from repro.models import blocks as jblocks
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro_torch import convert
from repro_torch import tree as tree_mod
from repro_torch import configs as tconfigs
from repro_torch.models import attention, blocks, layers, lm, moe, ssm

MODE = bool(jax.config.jax_threefry_partitionable)
TOL = dict(atol=1e-4, rtol=1e-4)
MODULE_TOL = dict(atol=1e-5, rtol=1e-5)
#: repro's decode step, compiled once a config (its eager scan recompiles
#: the body every call).
JIT_DECODE = jax.jit(jlm.decode_step, static_argnames=("cfg",))
MOE_ARCHS = [a for a in all_archs() if get_config(a, smoke=True).moe]
SSM_ARCHS = [a for a in all_archs() if get_config(a, smoke=True).ssm]


@functools.lru_cache(maxsize=None)
def _models(arch: str, dtype: str = "float32", seed: int = 0):
    """``repro``'s smoke model and the port's with the same weights."""
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              param_dtype=dtype)
    tcfg = dataclasses.replace(tconfigs.get_config(arch, smoke=True),
                               param_dtype=dtype)
    params = jlm.init_lm(jax.random.key(seed), cfg)
    model = convert.lm_params_from_repro(jax.tree.map(np.asarray, params),
                                         tcfg, "cpu")
    return cfg, params, tcfg, model


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _close(got, want, tol=MODULE_TOL, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **tol, err_msg=msg)


def _frontend(cfg, b, rng):
    kw, tkw = {}, {}
    if cfg.family == "audio":
        e = rng.normal(size=(b, 16, cfg.d_model)).astype(np.float32)
        kw["enc_embeds"], tkw["enc_embeds"] = jnp.asarray(e), _t(e)
    if cfg.family == "vlm":
        e = rng.normal(size=(b, cfg.vlm_prefix, cfg.d_model)).astype(
            np.float32)
        kw["prefix_embeds"], tkw["prefix_embeds"] = jnp.asarray(e), _t(e)
    return kw, tkw


# -- configs -------------------------------------------------------------------

@pytest.mark.parametrize("arch", all_archs())
def test_config_matches_repro(arch):
    for smoke in (False, True):
        want = get_config(arch, smoke=smoke)
        got = tconfigs.get_config(arch, smoke=smoke)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.active_param_count() == want.active_param_count()
        assert got.active_params_per_layer() == want.active_params_per_layer()
        assert got.quadratic_attention == want.quadratic_attention
    assert tconfigs.get_config(arch, smoke=True).d_model <= 128


@pytest.mark.parametrize("arch", all_archs())
def test_active_param_count_fidelity(arch):
    """``tests/test_configs.py``'s published sizes, on the port's configs."""
    from tests.test_configs import EXPECTED_ACTIVE
    want, tol = EXPECTED_ACTIVE[arch]
    got = tconfigs.get_config(arch).active_param_count()
    assert abs(got - want) / want < tol


def test_aliases_cover_assignment_ids():
    assert tconfigs.ALIASES == __import__(
        "repro.configs", fromlist=["ALIASES"]).ALIASES
    for alias in tconfigs.ALIASES:
        assert tconfigs.get_config(alias) == tconfigs.get_config(
            tconfigs.ALIASES[alias])


# -- layers ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", all_archs())
def test_layers_match_repro(arch):
    cfg, params, tcfg, model = _models(arch)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, cfg.d_model)).astype(np.float32)
    lp = jax.tree.map(lambda a: a[0], params["segments"][0])
    blk = model.segments[0][0]
    _close(layers.apply_norm(blk["ln1"], _t(x), tcfg.norm),
           jlayers.apply_norm(lp["ln1"], jnp.asarray(x), cfg.norm))
    _close(layers.apply_norm(model["final_norm"], _t(x), "rmsnorm"),
           jlayers.apply_norm(params["final_norm"], jnp.asarray(x),
                              "rmsnorm"))
    if "mlp" in lp:
        _close(layers.apply_mlp(blk["mlp"], _t(x), tcfg),
               jlayers.apply_mlp(lp["mlp"], jnp.asarray(x), cfg))
    for act in ("silu", "gelu", "relu2"):
        _close(layers.act_fn(act)(_t(x)), jlayers.act_fn(act)(x))
    toks = rng.integers(0, cfg.vocab, (2, 5)).astype(np.int32)
    h = layers.embed_tokens(model["embed"], _t(toks), tcfg)
    _close(h, jlayers.embed_tokens(params["embed"], jnp.asarray(toks), cfg))
    _close(layers.lm_logits(model["embed"], _t(x), tcfg),
           jlayers.lm_logits(params["embed"], jnp.asarray(x), cfg))
    pos = np.arange(3, 10)
    for rot in (0, 4, 16):
        jc, js = jlayers.rope_angles(jnp.asarray(pos), rot, 10_000.0)
        tc, ts = layers.rope_angles(_t(pos), rot, 10_000.0)
        _close(tc, jc)
        xh = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
        _close(layers.apply_rope(_t(xh), tc[None], ts[None], rot),
               jlayers.apply_rope(jnp.asarray(xh), jc[None], js[None], rot))
    _close(layers.sinusoidal_embed(_t(pos), 64),
           jlayers.sinusoidal_embed(jnp.asarray(pos), 64))


# -- attention ---------------------------------------------------------------------

ATTN_CASES = {
    "causal": dict(),
    "window": dict(window=5),
    "prefix": dict(prefix_len=4),
    "kv_valid": dict(kv_valid=np.array([9, 13], np.int32)),
    "q_pos0": dict(q_pos0=7, skv=20),
    "noncausal_ragged": dict(causal=False, q_chunk=5, kv_chunk=6),
    "window_ragged_pos0": dict(window=6, q_pos0=5, skv=18, q_chunk=4,
                               kv_chunk=7),
    "prefix_valid_ragged": dict(prefix_len=6, kv_valid=np.array(
        [11, 4], np.int32), q_chunk=3, kv_chunk=5),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_blockwise_attention_matches_repro(case):
    kw = dict(ATTN_CASES[case])
    skv = kw.pop("skv", 13)
    rng = np.random.default_rng(2)
    q = rng.normal(size=(2, 13, 4, 8)).astype(np.float32)
    k = rng.normal(size=(2, skv, 2, 8)).astype(np.float32)
    v = rng.normal(size=(2, skv, 2, 6)).astype(np.float32)
    kw.setdefault("q_chunk", 8)
    kw.setdefault("kv_chunk", 8)
    jkw = dict(kw, kv_valid=None if "kv_valid" not in kw
               else jnp.asarray(kw["kv_valid"]))
    tkw = dict(kw, kv_valid=None if "kv_valid" not in kw
               else _t(kw["kv_valid"]))
    want = jattn.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), **jkw)
    got = attention.blockwise_attention(_t(q), _t(k), _t(v), **tkw)
    _close(got, want)


@pytest.mark.parametrize("h,kv,tp,pad_kv", [
    (36, 4, 16, True), (36, 4, 16, False), (25, 5, 16, True),
    (25, 5, 4, False), (32, 8, 16, True), (6, 6, 4, True), (3, 1, 8, True),
    (8, 8, 1, True), (48, 8, 32, False)])
def test_head_padding_plan_matches_repro(h, kv, tp, pad_kv):
    want = jattn.head_padding_plan(h, kv, tp, pad_kv=pad_kv)
    got = attention.head_padding_plan(h, kv, tp, pad_kv=pad_kv)
    if want is None:
        assert got is None
        return
    assert got[:2] == want[:2]
    np.testing.assert_array_equal(got[2], want[2])
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 3, h, 4)).astype(np.float32)
    kk = rng.normal(size=(2, 3, kv, 4)).astype(np.float32)
    jq, jk, jv = jattn.pad_heads(jnp.asarray(q), jnp.asarray(kk),
                                 jnp.asarray(kk), want)
    tq, tk, tv = attention.pad_heads(_t(q), _t(kk), _t(kk), got)
    _close(tq, jq)
    _close(tk, jk)
    _close(attention.unpad_heads(tq, got), jattn.unpad_heads(jq, want))


# -- MoE and SSM ---------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["as_configured", "tight_capacity",
                                     "tied_router"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_matches_repro(arch, variant):
    cfg, params, tcfg, model = _models(arch)
    seg = [i for i, (k, _) in enumerate(lm.segments(tcfg)) if k == "moe"][0]
    jp = jax.tree.map(lambda a: a[0], params["segments"][seg]["moe"])
    tp = model.segments[seg][0]["moe"]
    m = cfg.moe
    if variant == "tight_capacity":       # tokens dropped past capacity
        m = dataclasses.replace(m, capacity_factor=0.5, group_size=16)
    if variant == "tied_router":          # every expert ties: lower index
        jp = dict(jp, router=jnp.zeros_like(jp["router"]))
        tp = layers.ParamTree(dict(tp.tree(), router=torch.zeros_like(
            tp["router"])))
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 24, cfg.d_model)).astype(np.float32)
    wy, waux = jmoe.moe_forward(jp, jnp.asarray(x), cfg, m)
    ty, taux = moe.moe_forward(tp, _t(x), tcfg, m)
    _close(ty, wy)
    _close(taux, waux)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_forward_and_decode_match_repro(arch):
    cfg, params, tcfg, model = _models(arch)
    jp = jax.tree.map(lambda a: a[0], params["segments"][0]["ssm"])
    tp = model.segments[0][0]["ssm"]
    rng = np.random.default_rng(5)
    for length in (5, 16, 37):            # one chunk, exact, ragged tail
        x = rng.normal(size=(2, length, cfg.d_model)).astype(np.float32)
        _close(ssm.ssm_forward(tp, _t(x), tcfg, tcfg.ssm),
               jssm.ssm_forward(jp, jnp.asarray(x), cfg, cfg.ssm))
        wc = jblocks._ssm_prefill_state(jp, jnp.asarray(x), cfg)
        tc = blocks._ssm_prefill_state(tp, _t(x), tcfg)
        for name in ("conv", "state"):
            _close(tc[name], wc[name], msg=name)
    dd = jssm.dims(cfg, cfg.ssm)
    cache = {"conv": rng.normal(size=(2, cfg.ssm.d_conv - 1,
                                      dd["conv_dim"])).astype(np.float32),
             "state": rng.normal(size=(2, dd["n_heads"], cfg.ssm.head_dim,
                                       cfg.ssm.d_state)).astype(np.float32)}
    x1 = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    wy, wn = jssm.ssm_decode_step(jp, jnp.asarray(x1),
                                  jax.tree.map(jnp.asarray, cache), cfg,
                                  cfg.ssm)
    ty, tn = ssm.ssm_decode_step(tp, _t(x1), {k: _t(v) for k, v in
                                              cache.items()}, tcfg, tcfg.ssm)
    _close(ty, wy)
    for name in ("conv", "state"):
        _close(tn[name], wn[name], msg=name)


# -- blocks and whole models -----------------------------------------------------------

def _cache_to_torch(cache):
    return lm.tree_map(lambda a: _t(a), jax.tree.map(np.asarray, cache))


@pytest.mark.parametrize("arch", all_archs())
def test_block_decode_matches_repro(arch):
    """Each segment's first layer decodes one token against a prefilled
    cache: output and the updated cache (written in place) == repro's."""
    cfg, params, tcfg, model = _models(arch)
    rng = np.random.default_rng(6)
    b, s = 2, 10
    max_len = s + cfg.vlm_prefix + 6
    kw, _ = _frontend(cfg, b, rng)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    _, caches, s0 = jlm.prefill(params, jnp.asarray(toks), cfg, max_len,
                                q_chunk=8, kv_chunk=8, **kw)
    for seg, (kind, _) in enumerate(lm.segments(tcfg)):
        lp = jax.tree.map(lambda a: a[0], params["segments"][seg])
        lc = jax.tree.map(lambda a: a[0], caches[seg])
        x = rng.normal(size=(b, 1, cfg.d_model)).astype(np.float32)
        wy, wc = jblocks.block_decode(lp, jnp.asarray(x), lc, cfg, kind,
                                      jnp.int32(s0))
        tc = _cache_to_torch(lc)
        ty, tn = blocks.block_decode(model.segments[seg][0], _t(x), tc,
                                     tcfg, kind, s0)
        _close(ty, wy, msg=f"{kind} output")
        flat_w = jax.tree_util.tree_flatten_with_path(
            jax.tree.map(np.asarray, wc))[0]
        for path, want in flat_w:
            got = tn
            for p in path:
                got = got[p.key]
            _close(got, want, msg=f"{kind} cache {path}")


@pytest.mark.parametrize("arch", all_archs())
def test_lm_forward_prefill_decode_match_repro(arch):
    cfg, params, tcfg, model = _models(arch)
    rng = np.random.default_rng(7)
    b, s, extra, max_len = 2, 12, 4, 32
    kw, tkw = _frontend(cfg, b, rng)
    toks = rng.integers(0, cfg.vocab, (b, s + extra)).astype(np.int32)
    with torch.inference_mode():
        want, _, _ = jlm.forward(params, jnp.asarray(toks), cfg, q_chunk=8,
                                 kv_chunk=8, remat=False, **kw)
        got, aux, _ = lm.forward(model, _t(toks), tcfg, q_chunk=8,
                                 kv_chunk=8, **tkw)
        _close(got, want, TOL, "forward")
        assert torch.isfinite(aux)
        wl, wcache, ws0 = jlm.prefill(params, jnp.asarray(toks[:, :s]), cfg,
                                      max_len, q_chunk=8, kv_chunk=8, **kw)
        tl, tcache, ts0 = lm.prefill(model, _t(toks[:, :s]), tcfg, max_len,
                                     q_chunk=8, kv_chunk=8, **tkw)
        assert ts0 == ws0
        _close(tl, wl, TOL, "prefill")
        for i in range(extra):
            wl, wcache = JIT_DECODE(params, jnp.asarray(toks[:, s + i]),
                                    wcache, jnp.int32(ws0 + i), cfg=cfg)
            tl, tcache = lm.decode_step(model, _t(toks[:, s + i]), tcache,
                                        ts0 + i, tcfg)
            _close(tl, wl, TOL, f"decode step {i}")
            _close(tl, want[:, ws0 + i], dict(atol=2e-3, rtol=2e-3),
                   f"decode step {i} vs forward")


def test_segment_of_no_layer_matches_repro():
    """Hymba at 4 layers: ``repro``'s plan holds a sliding-window segment
    of no layer.  ``init_lm`` draws ``repro``'s weights (``(0, ...)``
    leaves there), prefill matches ``repro``'s (that segment's caches
    ``(0, ...)`` too) and decode its forward."""
    cfg = dataclasses.replace(get_config("hymba_1_5b", smoke=True),
                              n_layers=4, param_dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get_config("hymba_1_5b", smoke=True),
                               n_layers=4, param_dtype="float32")
    params = jlm.init_lm(jax.random.key(0), cfg)
    model = lm.init_lm(0, tcfg, device="cpu", partitionable=MODE)
    want = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, params))[0]
    got = jax.tree_util.tree_flatten_with_path(
        convert.lm_params_to_repro(model))[0]
    assert [p for p, _ in want] == [p for p, _ in got]
    assert any(a.shape[:1] == (0,) for _, a in want)
    for (path, a), (_, b) in zip(want, got):
        assert a.shape == b.shape, path
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)
    model = convert.lm_params_from_repro(jax.tree.map(np.asarray, params),
                                         tcfg, "cpu")
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 14)).astype(
        np.int32)
    with torch.inference_mode():
        wl, wcache, s = jlm.prefill(params, jnp.asarray(toks[:, :12]), cfg,
                                    16, q_chunk=8, kv_chunk=8)
        tl, tcache, ts0 = lm.prefill(model, _t(toks[:, :12]), tcfg, 16,
                                     q_chunk=8, kv_chunk=8)
        _close(tl, wl, TOL, "prefill")
        assert [tuple(w.shape) for w in jax.tree.leaves(wcache)] == \
            [tuple(t.shape) for _, t in tree_mod.flatten(tcache)]
        # repro's decode_step cannot index a segment of no layer (its scan
        # body slices layer i of a (0, ...) cache); hold the port's decode
        # against repro's full forward, as the other decode tests do
        want, _, _ = jlm.forward(params, jnp.asarray(toks), cfg, q_chunk=8,
                                 kv_chunk=8, remat=False)
        for i in range(2):
            tl, tcache = lm.decode_step(model, _t(toks[:, 12 + i]), tcache,
                                        ts0 + i, tcfg)
            _close(tl, want[:, s + i], dict(atol=2e-3, rtol=2e-3),
                   f"decode step {i} vs forward")


def test_swa_ring_buffer_wraps_correctly():
    """Decode far past hymba's window (8): ring slots stay coherent, and
    every step equals repro's decode and the full forward."""
    cfg, params, tcfg, model = _models("hymba_1_5b", seed=1)
    rng = np.random.default_rng(7)
    b, total, s = 1, 28, 4
    toks = rng.integers(0, cfg.vocab, (b, total)).astype(np.int32)
    with torch.inference_mode():
        full, _, _ = lm.forward(model, _t(toks), tcfg, q_chunk=8, kv_chunk=8)
        _, wcache, _ = jlm.prefill(params, jnp.asarray(toks[:, :s]), cfg,
                                   total, q_chunk=8, kv_chunk=8)
        _, tcache, _ = lm.prefill(model, _t(toks[:, :s]), tcfg, total,
                                  q_chunk=8, kv_chunk=8)
        ring = tcache[1]["attn"]["k"]
        for i in range(total - s - 1):
            wl, wcache = JIT_DECODE(params, jnp.asarray(toks[:, s + i]),
                                    wcache, jnp.int32(s + i), cfg=cfg)
            tl, tcache = lm.decode_step(model, _t(toks[:, s + i]), tcache,
                                        s + i, tcfg)
            _close(tl, wl, TOL, f"pos {s + i}")
            _close(tl, full[:, s + i], dict(atol=5e-3, rtol=5e-3),
                   f"pos {s + i} vs forward")
        assert tcache[1]["attn"]["k"] is ring     # written in place
        kpos = tcache[1]["attn"]["kpos"][0, 0].numpy()
        assert sorted(kpos % 8) == list(range(8)) and kpos.max() == total - 2


@pytest.mark.parametrize("b,s,kv,g,dh,window,cur", [
    (2, 40, 4, 1, 16, None, 30),     # MHA, empty slots (kpos -1)
    (3, 33, 2, 4, 8, None, 32),      # GQA, 4 query heads a kv head
    (2, 24, 2, 2, 16, 8, 40),        # a sliding-window ring
], ids=["mha", "gqa", "window"])
def test_cached_attention_bf16_matches_repro(b, s, kv, g, dh, window, cur):
    """The decode attention in bf16 (its block-diagonal products): float32
    scores from bf16 operands, as XLA's ``preferred_element_type``, within
    one bf16 ulp of repro's largest output (measured: equal)."""
    import ml_dtypes

    rng = np.random.default_rng(s)
    k, v = (rng.normal(size=(b, s, kv, dh)).astype(ml_dtypes.bfloat16)
            for _ in range(2))
    q = rng.normal(size=(b, kv * g, dh)).astype(ml_dtypes.bfloat16)
    kpos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    if window:
        kpos += cur - s + 1
    else:
        kpos[:, -3:] = -1
    want = np.asarray(jblocks.cached_attention(
        jnp.asarray(q), {"k": jnp.asarray(k), "v": jnp.asarray(v),
                         "kpos": jnp.asarray(kpos)},
        jnp.int32(cur), window), np.float32)

    def bf16(a):
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    got = blocks.cached_attention(
        bf16(q), {"k": bf16(k), "v": bf16(v), "kpos": torch.from_numpy(kpos)},
        cur, window)
    assert got.dtype == torch.bfloat16 and got.shape == (b, kv * g, dh)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2 ** -8 * np.abs(want).max())


@pytest.mark.parametrize("arch", all_archs())
def test_init_cache_matches_repro(arch):
    cfg, _, tcfg, _ = _models(arch)
    want = jax.tree.map(np.asarray, jlm.init_cache(cfg, 3, 20, enc_len=5))
    got = lm.init_cache(tcfg, 3, 20, enc_len=5, device="cpu")
    for seg, (w, g) in enumerate(zip(want, got)):
        for path, wl in jax.tree_util.tree_flatten_with_path(w)[0]:
            gl = g
            for p in path:
                gl = gl[p.key]
            assert tuple(gl.shape) == wl.shape, (seg, path)
            assert str(gl.dtype).split(".")[-1] == str(wl.dtype), (seg, path)
            np.testing.assert_array_equal(gl.float().numpy(),
                                          wl.astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", all_archs())
def test_init_lm_matches_repro(arch, dtype):
    cfg = dataclasses.replace(get_config(arch, smoke=True), param_dtype=dtype)
    tcfg = dataclasses.replace(tconfigs.get_config(arch, smoke=True),
                               param_dtype=dtype)
    want = jax.tree.map(np.asarray, jlm.init_lm(jax.random.key(0), cfg))
    got = convert.lm_params_to_repro(
        lm.init_lm(0, tcfg, device="cpu", partitionable=MODE))
    wl, wdef = jax.tree_util.tree_flatten_with_path(want)
    gl, gdef = jax.tree_util.tree_flatten_with_path(got)
    assert [p for p, _ in gl] == [p for p, _ in wl]
    differ = total = 0
    for (path, w), (_, g) in zip(wl, gl):
        assert g.shape == w.shape and g.dtype == w.dtype, path
        w32, g32 = w.astype(np.float32), g.astype(np.float32)
        if w.dtype == np.float32:
            np.testing.assert_allclose(g32, w32, rtol=4 * 2.0 ** -23,
                                       atol=0, err_msg=str(path))
        else:
            np.testing.assert_allclose(g32, w32, rtol=2.0 ** -7, atol=0,
                                       err_msg=str(path))
            differ += int((g32 != w32).sum())
            total += w.size
    assert differ <= total // 1000


def test_lm_params_round_trip():
    cfg, params, tcfg, model = _models("deepseek_v2_lite", "bfloat16")
    back = convert.lm_params_to_repro(model)
    for (path, w), (_, g) in zip(
            jax.tree_util.tree_flatten_with_path(
                jax.tree.map(np.asarray, params))[0],
            jax.tree_util.tree_flatten_with_path(back)[0]):
        assert g.dtype == w.dtype, path
        np.testing.assert_array_equal(g, w, err_msg=str(path))
    # per-layer parameters are views of the stacked segment tensors
    seg = model.segments[1]
    assert seg[0]["attn"]["wq"].untyped_storage().data_ptr() == \
        seg[1]["attn"]["wq"].untyped_storage().data_ptr()
