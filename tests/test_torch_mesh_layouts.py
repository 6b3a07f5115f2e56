"""Other mesh layouts and the pipeline, on gloo CPU ranks.

The 4 x 1 and 1 x 4 ``("data", "model")`` meshes (four gloo ranks each,
spawned once a layout): three float32 train steps of four architectures
-- MLA + MoE with expert groups over four data ranks and the enc-dec
model on 4 x 1; GQA with 2 kv heads under a 4-way model axis (the query
heads are gathered before they split into kv groups) and the hybrid
attention / SSD model on 1 x 4 -- held to the port's single-device step
and ``repro``'s within the tolerances of ``tests/test_torch_mesh_train.py``
(which runs every architecture on 2 x 2).  And ``pipelined_apply`` over a
4-rank ``pod`` mesh (GPipe fill-drain, one ``batch_isend_irecv`` a tick,
a masked ``all_reduce``) against ``repro``'s, run in a child process
with 4 host devices as ``tests/test_mesh_subprocess.py`` runs it, and
against the sequential loop.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import test_torch_mesh_train as base

LAYOUTS = {(4, 1): ["deepseek_v2_lite", "whisper_tiny"],
           (1, 4): ["starcoder2_7b", "hymba_1_5b"]}
CASES = [(shape, arch) for shape, archs in LAYOUTS.items() for arch in archs]

REPRO_PIPE = r"""
import json, jax, numpy as np, jax.numpy as jnp
from repro.distributed import pipeline as pp
mesh = jax.make_mesh((4,), ('pod',))
rng = np.random.default_rng(0)
params = jnp.asarray((rng.normal(size=(4, 16, 16)) * 0.1).astype(np.float32))
x = jnp.asarray(rng.normal(size=(8, 16)).astype(np.float32))
got = pp.pipelined_apply(params, x, lambda w, xb: jnp.tanh(xb @ w),
                         mesh=mesh, axis='pod', num_microbatches=4)
print(json.dumps({"out": np.asarray(got).tolist()}))
"""


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    runs = {}
    for shape, archs in LAYOUTS.items():
        out = tmp_path_factory.mktemp("mesh" + "x".join(map(str, shape)))
        snippet = base._fmt(base.RANK_SNIPPET, shape=shape, archs=archs,
                            decode=[], elastic=False, out=str(out),
                            pipe=shape == (4, 1))
        runs[shape] = (out, base.start_ranks(snippet, 4))
    try:
        refs = {a: (base.repro_run(a), base.port_run(a))
                for archs in LAYOUTS.values() for a in archs}
    finally:
        done = {shape: (out, base.finish_ranks(procs))
                for shape, (out, procs) in runs.items()}
    return done, refs


@pytest.mark.parametrize("shape,arch", CASES)
def test_train_on_layout_matches_single_device(layouts, shape, arch):
    done, refs = layouts
    out, ranks = done[shape]
    (jm, jparams), (tm, tparams) = refs[arch]
    got = ranks[0]["train"][arch]
    for rank in ranks:
        assert rank["train"][arch] == got
    base._close(got, tm, f"{arch} {shape} vs port")
    base._close(got, jm, f"{arch} {shape} vs repro")
    mesh_params = dict(np.load(out / f"{arch}.npz"))
    for name, want in jparams.items():
        np.testing.assert_allclose(mesh_params[name], tparams[name],
                                   atol=base.PARAM_ATOL, rtol=0,
                                   err_msg=name)
        np.testing.assert_allclose(mesh_params[name], want,
                                   atol=base.PARAM_ATOL, rtol=0,
                                   err_msg=name)


def test_pipelined_apply_equals_repro(layouts):
    done, _ = layouts
    ranks = done[(4, 1)][1]
    got = np.asarray(ranks[0]["pipe"], np.float32)
    for r in ranks:               # replicated over the pipeline axis
        np.testing.assert_array_equal(np.asarray(r["pipe"], np.float32), got)
    env = {**os.environ, "PYTHONPATH": str(base.REPO / "src"),
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", REPRO_PIPE], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    want = np.asarray(json.loads(out.stdout.strip().splitlines()[-1])["out"],
                      np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    rng = np.random.default_rng(0)
    params = (rng.normal(size=(4, 16, 16)) * 0.1).astype(np.float32)
    x = rng.normal(size=(8, 16)).astype(np.float32)
    for s in range(4):
        x = np.tanh(x @ params[s])
    np.testing.assert_allclose(got, x, rtol=1e-5, atol=1e-5)


def test_pipelined_apply_on_one_stage():
    """One pod: no exchange, the stage function over every microbatch
    (a process group of one rank, made here if none exists)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed import pipeline as pp, sharding
    sharding.init_process_group("cpu")
    if dist.get_world_size() != 1:
        pytest.skip("needs a group of one rank")
    mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("pod",))
    w = torch.randn(1, 8, 8)
    x = torch.randn(6, 8)
    got = pp.pipelined_apply(w, x, lambda p, xb: xb @ p, mesh=mesh,
                             num_microbatches=3)
    torch.testing.assert_close(got, x @ w[0])
