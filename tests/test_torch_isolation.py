"""The port stands alone: ``repro_torch`` never imports JAX or ``repro``,
and its entry points run on the GPU unless asked for the CPU."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.hd_space import HDSpace
from repro_torch.pipeline import ProfilerConfig, ProfilingSession

PKG = pathlib.Path(__file__).resolve().parent.parent / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_jax_or_repro_imports_in_the_port():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 20
    names = {str(f.relative_to(PKG)) for f in files}
    assert {"eval.py", "launch/profile_run.py",
            "kernels/am_matmul.py", "kernels/hamming_am.py",
            "kernels/autotune.py", "launch/serve_profiler.py",
            "obs/__init__.py", "obs/metrics.py", "obs/trace.py",
            "serve/__init__.py", "serve/scheduler.py",
            "serve/profiler_service.py", "serve/registry.py",
            "serve/router.py", "serve/fleet/__init__.py",
            "serve/fleet/replica.py", "serve/fleet/controller.py",
            "launch/serve_fleet.py", "pipeline/sharded.py",
            "distributed/__init__.py", "distributed/sharding.py",
            "accel/__init__.py", "accel/substrate.py", "accel/device.py",
            "accel/racetrack.py", "accel/crossbar.py",
            "accel/backend_pcm.py", "accel/cost.py", "accel/codesign.py",
            "accel/sweep.py", "kernels/threefry.py",
            "baselines/__init__.py", "baselines/kmer_table.py",
            "baselines/kraken2_like.py", "baselines/metacache_like.py",
            "baselines/clark_like.py", "baselines/bracken_like.py",
            "config.py", "configs/__init__.py", "configs/stablelm_3b.py",
            "models/__init__.py", "models/layers.py",
            "models/attention.py", "models/moe.py", "models/ssm.py",
            "models/blocks.py", "models/lm.py", "serve/serve_step.py",
            "serve/batching.py", "launch/serve.py", "tree.py",
            "data/__init__.py", "data/lm_data.py", "train/__init__.py",
            "train/optimizer.py", "train/train_step.py",
            "train/compression.py", "checkpoint/__init__.py",
            "checkpoint/checkpointer.py", "distributed/fault_tolerance.py",
            "launch/train.py", "distributed/param_specs.py",
            "distributed/elastic.py", "distributed/pipeline.py",
            "launch/mesh.py", "launch/dryrun.py", "launch/dryrun_hdc.py",
            "configs/shapes.py"} <= names
    bad = [(str(f.relative_to(PKG)), mod) for f in files
           for mod in _imported_modules(f)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad


def test_chip_smoke_imports_no_jax_or_repro():
    smoke = PKG.parent.parent / "chip_smoke.py"
    bad = [m for m in _imported_modules(smoke) if m.split(".")[0] in FORBIDDEN]
    assert not bad


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch, repro_torch.pipeline, repro_torch.convert,"
            " repro_torch.kernels.ops, repro_torch.eval,"
            " repro_torch.launch.profile_run, repro_torch.obs,"
            " repro_torch.serve, repro_torch.kernels.autotune,"
            " repro_torch.launch.serve_profiler, repro_torch.serve.fleet,"
            " repro_torch.launch.serve_fleet, repro_torch.pipeline.sharded,"
            " repro_torch.distributed, repro_torch.accel,"
            " repro_torch.kernels.threefry, repro_torch.baselines,"
            " repro_torch.configs, repro_torch.models,"
            " repro_torch.serve.serve_step, repro_torch.serve.batching,"
            " repro_torch.launch.serve, repro_torch.data,"
            " repro_torch.train.train_step, repro_torch.train.compression,"
            " repro_torch.checkpoint.checkpointer,"
            " repro_torch.distributed.fault_tolerance,"
            " repro_torch.launch.train, repro_torch.distributed.param_specs,"
            " repro_torch.distributed.elastic,"
            " repro_torch.distributed.pipeline, repro_torch.launch.mesh,"
            " repro_torch.launch.dryrun, repro_torch.launch.dryrun_hdc,"
            " repro_torch.configs.shapes; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')))")
    env = {**os.environ, "PYTHONPATH": str(PKG.parent)}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_session_defaults_to_cuda():
    config = ProfilerConfig(space=HDSpace(dim=512, ngram=5))
    if torch.cuda.is_available():
        assert ProfilingSession(config).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            ProfilingSession(config)
    assert ProfilingSession(config, device="cpu").device.type == "cpu"


def test_fused_backend_defaults_to_cuda():
    from repro_torch.pipeline import resolve_backend

    config = ProfilerConfig(space=HDSpace(dim=512, ngram=5),
                            backend="cuda_fused")
    if torch.cuda.is_available():
        assert resolve_backend("cuda_fused", config).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            resolve_backend("cuda_fused", config)


@pytest.mark.parametrize("backend", ["cuda_matmul", "cuda_packed",
                                     "pcm_sim", "racetrack_sim"])
def test_unfused_backends_default_to_cuda(backend):
    from repro_torch.pipeline import resolve_backend

    config = ProfilerConfig(space=HDSpace(dim=512, ngram=5), backend=backend)
    if torch.cuda.is_available():
        assert resolve_backend(backend, config).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            resolve_backend(backend, config)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            ProfilingSession(config)
    assert ProfilingSession(config, device="cpu").device.type == "cpu"


def test_port_tests_collect_without_torch(tmp_path):
    """Where torch cannot be imported (the JAX package's own CI
    environment), every port test module skips at collection: no
    collection error stops a ``-x`` run of the whole suite."""
    (tmp_path / "sitecustomize.py").write_text(
        "import sys\nsys.modules['torch'] = None   # import torch fails\n")
    tests = sorted(str(p) for p in PKG.parent.parent.glob(
        "tests/test_torch_*.py"))
    assert len(tests) > 10
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join([str(tmp_path), str(PKG.parent)])}
    out = subprocess.run(
        [sys.executable, "-c", "import torch"], env=env,
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "import of torch halted" in out.stderr
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "--collect-only", "-q", "-rs",
         "-p", "no:cacheprovider", *tests],
        env=env, cwd=PKG.parent.parent, capture_output=True, text=True,
        timeout=300)
    text = out.stdout + out.stderr
    assert out.returncode == 5, text[-3000:]        # 5: nothing collected
    assert "error" not in text.lower(), text[-3000:]
    skipped = [ln for ln in text.splitlines() if ln.startswith("SKIPPED")]
    assert len(skipped) == len(tests), text[-3000:]
