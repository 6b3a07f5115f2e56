"""Where the benchmark's files are, found by name.

Every cell, configuration, traffic driver and per-layer metric lives in a
file of its own, so a later change adds a file and edits none:

* ``configs/<config>.json``  -- a deployment's settings and their source;
* ``workloads/<cell>.json``  -- a cell: its configuration, traffic, driver
  (``mix``), parameters, chips and why;
* ``mixes/<mix>.py``         -- a traffic driver (``prepare``, ``window``,
  ``check``, ``release``);
* ``metrics/<metric>.py``    -- a per-layer metric's reader (``read``).
  A metric split by the end-to-end metric it moves (``<metric>.<part>``)
  is read by ``metrics/<metric>.py`` unless it has a file of its own.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def cache_dir() -> pathlib.Path:
    """The benchmark's own caches and traces, inside the checkout."""
    d = ROOT / "build" / "perfbench"
    d.mkdir(parents=True, exist_ok=True)
    return d


def benchmark(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def config(name: str, base: pathlib.Path = HERE) -> dict:
    return json.loads((base / "configs" / f"{name}.json").read_text())


def workload(name: str, base: pathlib.Path = HERE) -> dict:
    return json.loads((base / "workloads" / f"{name}.json").read_text())


def _module(path: pathlib.Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"no {path}")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def mix(name: str, base: pathlib.Path = HERE):
    return _module(base / "mixes" / f"{name}.py", f"perfbench_mix_{name}")


def metric(name: str, base: pathlib.Path = HERE):
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``, or
    else that of the part of ``name`` before its first dot."""
    for stem in (name, name.split(".")[0]):
        path = base / "metrics" / f"{stem}.py"
        if path.is_file():
            break
    return _module(path, "perfbench_metric_" + stem.replace(".", "_"))
