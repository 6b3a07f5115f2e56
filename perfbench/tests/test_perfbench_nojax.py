"""Nothing the benchmark's command loads imports JAX or the JAX package:
``run.py`` and every traffic driver and metric reader are imported in a
fresh process, whose ``sys.modules`` is then read by top-level name (the
part before the first dot, compared whole: ``repro_torch`` is the port,
``repro`` the JAX package)."""

import json
import subprocess
import sys

from perfbench import paths

PROBE = r"""
import json, pathlib, runpy, sys
root = pathlib.Path.cwd()
sys.argv = ["run.py"]
runpy.run_path(str(root / "perfbench" / "run.py"), run_name="probe")
from perfbench import check, control, harness, paths, system
import repro_torch.pipeline.session
import repro_torch.pipeline.fused
for kind, load in (("mixes", paths.mix), ("metrics", paths.metric)):
    for f in sorted((root / "perfbench" / kind).glob("*.py")):
        load(f.stem)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_no_jax_on_the_benchmark_path():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=paths.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in top and "perfbench" in top
    assert not top & {"jax", "jaxlib", "flax", "repro"}, top


def test_forbidden_names_compare_whole():
    from perfbench import harness

    saved = dict(sys.modules)
    try:
        sys.modules.pop("repro", None)
        sys.modules["repro_torch_like"] = sys
        assert "repro" not in harness.forbidden_modules()
        sys.modules["repro.core"] = sys
        assert harness.forbidden_modules() == ["repro"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
