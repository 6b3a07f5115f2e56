"""Shared set-up of the benchmark's own tests (run them with
``python -m pytest perfbench/tests`` from the root of the repository).

Puts the repository's root and ``src`` on the path, and gives the tests a
tiny version of each cell that a CPU run holds in seconds.
"""

import copy
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from perfbench import paths  # noqa: E402

TINY_CONFIG = dict(space={"dim": 2048, "ngram": 8}, window=256, stride=256,
                   batch_size=64, num_species=4, genome_len=3000,
                   backend_options={})
TINY_PARAMS = {
    "profile": dict(samples=2, reads_per_sample=160, read_len=40,
                    check_reads=24, check_per_launch=4),
}


def tiny(cell: str) -> tuple[dict, dict]:
    """``(workload, config)`` of ``cell`` at a size a CPU run holds."""
    wl = copy.deepcopy(paths.workload(cell))
    wl["params"].update(TINY_PARAMS[wl["mix"]])
    cfg = paths.config(wl["config"])
    cfg.update(copy.deepcopy(TINY_CONFIG))
    cfg["space"] = dict(paths.config(wl["config"])["space"],
                        **TINY_CONFIG["space"])
    return wl, cfg


@pytest.fixture
def tiny_cell():
    return tiny
