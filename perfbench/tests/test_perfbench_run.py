"""``run.py`` refuses to run without a card (no CPU fallback) and outside
a checkout of the repository; on a card (``-m cuda``) a short run of the
smallest cell prints a correct result line."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from perfbench import paths

RUN = [sys.executable, "perfbench/run.py", "--workload", "afs20.profile",
       "--seed", "3000000019", "--seconds", "2", "--trace", "0"]


def _no_card_env():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return env


def test_exits_nonzero_without_a_card():
    out = subprocess.run(RUN, cwd=paths.ROOT, capture_output=True,
                         text=True, env=_no_card_env(), timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_exits_nonzero_with_only_the_benchmark(tmp_path):
    """A directory holding only BENCHMARK.json and perfbench/: the program
    is missing, so no result, whatever the card."""
    shutil.copy(paths.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(paths.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(RUN, cwd=tmp_path, capture_output=True, text=True,
                         env=_no_card_env(), timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_short_run_on_a_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(RUN, cwd=paths.ROOT, capture_output=True,
                         text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert set(res["metrics"]) == {"profile_reads_per_s", "setup_s"}
    assert out.stderr.rstrip().splitlines()[-1].startswith("check ")
