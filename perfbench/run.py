"""Run one cell of the benchmark of ``repro_torch`` once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout, on a machine with an NVIDIA GPU.  The cell
is ``perfbench/workloads/<cell>.json``; its metrics are listed in
``BENCHMARK.json``.  The last line of standard output is the result, one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and ``checks`` last); the
last lines of standard error are the checks, each number beside its
limit.  Exits non-zero, printing no result, without a card (there is no
CPU fallback), with fewer cards than the cell asks for, or when JAX or
the JAX package ``repro`` was loaded.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def card_line() -> str:
    """The card's name, power limit and clocks, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi not read ({e})"
    return out.splitlines()[0] if out else "nvidia-smi printed nothing"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from perfbench import harness, paths, system

    system.set_cache_env()
    import torch

    workload = paths.workload(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the GPU and has no "
              "CPU fallback", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < workload["chips"]:
        print(f"{args.workload} needs {workload['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    torch.cuda.init()
    print(f"[card] {card_line()} | torch {torch.__version__} | "
          f"{time.perf_counter() - T_PROCESS:.3f} s from process start to "
          f"an initialized card", file=sys.stderr, flush=True)
    out, checks = harness.run_cell(args.workload, args.seed, args.seconds,
                                   bool(args.trace), device="cuda",
                                   t_process=T_PROCESS, workload=workload)
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)} (the benchmark "
              f"runs the port without JAX or the JAX package)",
              file=sys.stderr)
        return 3
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
