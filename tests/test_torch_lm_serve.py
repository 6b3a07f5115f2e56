"""The port's LM serving entry points against ``repro``'s, on the CPU.

* ``CohortScheduler``: ``tests/test_serve_batching.py``'s cases on the
  port's models, plus a cohort against ``repro``'s ``generate``.
* ``sample``: greedy and Gumbel-max tokens equal to ``repro``'s on the
  same logits and ``jax.random`` keys, in both threefry modes.
* ``launch.serve.serve(arch)`` at smoke size (bfloat16, both packages
  drawing their own weights) against ``repro.launch.serve.serve``: tokens
  equal.  Where they differ the first difference must sit on a bf16
  near-tie -- the two tokens' sampled scores within ``NEAR_TIE`` on the
  port's side -- and, teacher-forced on the same weights and tokens up to
  that step, the logits must agree within ``BF16_TOL`` (bf16 products
  rounded in another order; measured: at most 0.086 at a logit scale of
  ~3.7).  Measured with jax 0.9.0: greedy tokens differ for
  deepseek-v2-lite and hymba, sampled ones for hymba; the others are
  equal.  (A MoE router can also flip an expert at a bf16 near-tie:
  phi3.5-moe's tokens stay equal while its teacher-forced logits part by
  up to 0.7 after two steps, so logits are held only up to a token
  difference.)
"""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from repro.configs import all_archs, get_config
from repro.launch import serve as jserve
from repro.models import lm as jlm
from repro.serve import serve_step as jstep
from repro_torch import convert
from repro_torch import configs as tconfigs
from repro_torch.core import threefry
from repro_torch.kernels import threefry as threefry_kernel
from repro_torch.launch import serve as tserve
from repro_torch.models import lm
from repro_torch.serve import serve_step
from repro_torch.serve.batching import CohortScheduler, Request

MODE = bool(jax.config.jax_threefry_partitionable)
#: Two logits this close (8 bf16 ulps at magnitudes 2..4) are a near-tie.
NEAR_TIE = 0.125
BF16_TOL = dict(atol=0.125, rtol=0.0)
SERVE_ARCHS = [a for a in all_archs() if not get_config(a).is_encdec]


@pytest.fixture(params=[True, False], ids=["partitionable", "original"])
def mode(request):
    """Set ``jax_threefry_partitionable`` for one test, then restore it."""
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", request.param)
    yield request.param
    jax.config.update("jax_threefry_partitionable", old)


def _port_model(arch, seed=0, dtype=None):
    cfg = tconfigs.get_config(arch, smoke=True)
    if dtype:
        cfg = dataclasses.replace(cfg, param_dtype=dtype)
    return cfg, lm.init_lm(seed, cfg, device="cpu", partitionable=MODE)


# -- CohortScheduler --------------------------------------------------------------

def test_cohort_scheduler_end_to_end():
    cfg, params = _port_model("stablelm_3b")
    max_len = 32
    prefill = serve_step.make_prefill_step(cfg, max_len, q_chunk=8,
                                           kv_chunk=8)
    decode = serve_step.make_decode_step(cfg)
    sched = CohortScheduler(
        slots=2, max_len=max_len, device="cpu",
        prefill_fn=lambda p: prefill(params, p),
        decode_fn=lambda t, c, pos: decode(params, t, c, pos),
        sample_fn=lambda lg: torch.argmax(lg, dim=-1).to(torch.int32))
    rng = np.random.default_rng(0)
    for uid in range(5):                       # 5 requests -> 3 cohorts
        sched.submit(Request(
            uid=uid,
            prompt=rng.integers(0, cfg.vocab, 6 + uid).astype(np.int32),
            max_new_tokens=4 + uid % 3))
    with torch.inference_mode():
        done = sched.run()
    assert len(done) == 5
    for r in done:
        assert r.done and 1 <= len(r.out) <= r.max_new_tokens
        assert all(0 <= t < cfg.vocab for t in r.out)


def test_cohort_matches_unbatched_greedy_and_repro():
    """A single-slot cohort reproduces ``generate`` exactly, and both give
    ``repro``'s ``generate`` tokens on the same (carried) weights."""
    jcfg = get_config("mamba2_1_3b", smoke=True)
    jparams = jlm.init_lm(jax.random.key(1), jcfg)
    cfg = tconfigs.get_config("mamba2_1_3b", smoke=True)
    params = convert.lm_params_from_repro(
        jax.tree.map(np.asarray, jparams), cfg, "cpu")
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, cfg.vocab, 8).astype(np.int32)
    want = np.asarray(jstep.generate(jparams, jnp.asarray(prompt[None]),
                                     jcfg, steps=5, max_len=32, q_chunk=8,
                                     kv_chunk=8))
    with torch.inference_mode():
        got = serve_step.generate(params, torch.from_numpy(prompt[None]),
                                  cfg, steps=5, max_len=32, q_chunk=8,
                                  kv_chunk=8, partitionable=MODE)
        prefill = serve_step.make_prefill_step(cfg, 32, q_chunk=8,
                                               kv_chunk=8)
        decode = serve_step.make_decode_step(cfg)
        sched = CohortScheduler(
            slots=1, max_len=32, device="cpu",
            prefill_fn=lambda p: prefill(params, p),
            decode_fn=lambda t, c, pos: decode(params, t, c, pos),
            sample_fn=lambda lg: torch.argmax(lg, dim=-1).to(torch.int32))
        sched.submit(Request(uid=0, prompt=prompt, max_new_tokens=6))
        done = sched.run()
    np.testing.assert_array_equal(np.asarray(done[0].out), got[0].numpy())
    np.testing.assert_array_equal(got.numpy(), want)


def test_lm_cohorts_can_bucket_prompt_lengths():
    calls = []

    def prefill(prompts):
        calls.append(tuple(prompts.shape))
        return torch.zeros((prompts.shape[0], 7)), None

    sched = CohortScheduler(
        slots=2, max_len=64, buckets=(8, 16), device="cpu",
        prefill_fn=prefill,
        decode_fn=lambda t, c, pos: (torch.zeros((t.shape[0], 7)), c),
        sample_fn=lambda lg: torch.argmax(lg, dim=-1).to(torch.int32))
    rng = np.random.default_rng(0)
    for uid, plen in enumerate((3, 8, 11, 5)):
        sched.submit(Request(uid=uid,
                             prompt=rng.integers(0, 7, plen).astype(np.int32),
                             max_new_tokens=2))
    done = sched.run()
    assert len(done) == 4 and all(r.done for r in done)
    assert [s[1] for s in calls] == [8, 16]  # two bucketed prefill shapes


def test_cohort_stops_at_eos():
    sched = CohortScheduler(
        slots=2, max_len=64, eos_id=3, device="cpu",
        prefill_fn=lambda p: (torch.zeros((p.shape[0], 5)), None),
        decode_fn=lambda t, c, pos: (
            torch.nn.functional.one_hot(torch.full_like(t, 3).long(),
                                        5).float(), c),
        sample_fn=lambda lg: torch.argmax(lg, dim=-1).to(torch.int32))
    sched.submit(Request(uid=0, prompt=np.arange(4, dtype=np.int32),
                         max_new_tokens=10))
    (r,) = sched.run()
    assert r.out == [0, 3] and r.done


# -- sampling -----------------------------------------------------------------------

@pytest.mark.parametrize("temperature,top_k", [(0.0, 0), (0.7, 0), (1.0, 0),
                                               (1.3, 5)])
def test_sample_matches_repro(mode, temperature, top_k):
    rng = np.random.default_rng(8)
    logits = rng.normal(size=(6, 300)).astype(np.float32) * 2.0
    for seed in (0, 1, 12345):
        key = jax.random.key(seed)
        for _ in range(3):
            key, sub = jax.random.split(key)
            words = tuple(int(w) for w in np.asarray(
                jax.random.key_data(sub)))
            want = jstep.sample(jnp.asarray(logits), sub, temperature, top_k)
            got = serve_step.sample(torch.from_numpy(logits),
                                    np.asarray(words, np.uint32),
                                    temperature, top_k, partitionable=mode)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the serve driver ---------------------------------------------------------------

def _repro_logits(arch, tokens, prompt_len):
    """``repro``'s logits a step, teacher-forced on ``tokens`` (its own
    served tokens), and the port's on the same weights."""
    jcfg = get_config(arch, smoke=True)
    jparams = jlm.init_lm(jax.random.key(0), jcfg)
    cfg = tconfigs.get_config(arch, smoke=True)
    params = convert.lm_params_from_repro(
        jax.tree.map(np.asarray, jparams), cfg, "cpu")
    prompts = np.random.default_rng(0).integers(
        0, jcfg.vocab, (tokens.shape[0], prompt_len)).astype(np.int32)
    steps = tokens.shape[1] - 1
    max_len = prompt_len + steps + 1
    qc = min(512, prompt_len)
    jpre = jax.jit(jstep.make_prefill_step(jcfg, max_len, q_chunk=qc,
                                           kv_chunk=qc))
    jdec = jax.jit(jstep.make_decode_step(jcfg))
    tpre = serve_step.make_prefill_step(cfg, max_len, q_chunk=qc,
                                        kv_chunk=qc)
    tdec = serve_step.make_decode_step(cfg)
    jl, jc = jpre(jparams, jnp.asarray(prompts))
    with torch.inference_mode():
        tl, tc = tpre(params, torch.from_numpy(prompts))
        want, got = [np.asarray(jl)], [tl.float().numpy()]
        for i in range(steps):
            tok = tokens[:, i].astype(np.int32)
            jl, jc = jdec(jparams, jnp.asarray(tok), jc,
                          jnp.int32(prompt_len + i))
            tl, tc = tdec(params, torch.from_numpy(tok), tc, prompt_len + i)
            want.append(np.asarray(jl))
            got.append(tl.float().numpy())
    return np.stack(want, 1), np.stack(got, 1)


def _gumbel(step: int, shape) -> np.ndarray:
    """The Gumbel noise ``serve`` adds at ``step``: ``key(1)`` at step 0,
    then the sub-key of each ``split`` of the chain."""
    key = threefry.key(1)
    for _ in range(step):
        key, sub = threefry.split(key, 2, partitionable=MODE)
    k = key if step == 0 else sub
    u = threefry_kernel.threefry_draw(
        threefry_kernel.keys_tensor(k, "cpu"), int(np.prod(shape)),
        epilogue="uniform", minval=serve_step.TINY, maxval=1.0,
        partitionable=MODE).reshape(shape)
    return (-torch.log(-torch.log(u))).numpy()


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serve_matches_repro(arch, temperature):
    kw = dict(num_requests=3, decode_steps=6, prompt_len=10,
              temperature=temperature)
    want = jserve.serve(arch, **kw)["tokens"]
    got = tserve.serve(arch, device="cpu", partitionable=MODE, **kw)
    assert got["tokens"].shape == want.shape
    assert got["prefill_s"] > 0 and got["decode_s"] > 0
    diff = np.argwhere(got["tokens"] != want)
    if not len(diff):
        return
    # The tokens part at a bf16 near-tie: at the first differing step the
    # two tokens' sampled scores (logits / t + Gumbel noise) are within
    # NEAR_TIE on the port's side, and up to that step, teacher-forced on
    # the same weights and tokens, the logits agree within BF16_TOL.
    step = int(diff[:, 1].min())
    jl, tl = _repro_logits(arch, want[:, :step + 1], kw["prompt_len"])
    np.testing.assert_allclose(tl, jl, **BF16_TOL)
    # Every row agrees before ``step``, so the port's teacher-forced logits
    # there are the ones it served from.
    t = temperature or 1.0
    scores = tl[:, step] / t
    if temperature:
        scores = scores + _gumbel(step, scores.shape)
    for row in diff[diff[:, 1] == step][:, 0]:
        gap = scores[row, got["tokens"][row, step]] \
            - scores[row, want[row, step]]
        assert 0 <= gap <= NEAR_TIE / t, (row, step, gap)


def test_serve_enc_dec_needs_frames():
    with pytest.raises(AssertionError, match="enc_embeds"):
        jserve.serve("whisper_tiny", num_requests=1, decode_steps=1)
    with pytest.raises(ValueError, match="encoder frames"):
        tserve.serve("whisper_tiny", num_requests=1, decode_steps=1,
                     device="cpu")


def test_serve_cli_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "stablelm-3b", "--requests", "2", "--steps", "3", "--prompt-len",
         "8", "--device", "cpu"]
        + ([] if MODE else ["--no-threefry-partitionable"]),
        capture_output=True, text=True, timeout=300,
        env={**__import__("os").environ, "PYTHONPATH": "src"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("cohort=2 prefill ")
    assert "decode 3 steps" in out.stdout


def test_serve_cli_without_a_gpu_is_a_cli_error():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    with pytest.raises(SystemExit) as e:
        tserve.main(["--arch", "stablelm-3b"])
    assert e.value.code == 2


def test_sample_default_key_is_repro_key0():
    assert tuple(int(w) for w in threefry.key(0)) == tuple(
        int(w) for w in np.asarray(jax.random.key_data(jax.random.key(0))))
