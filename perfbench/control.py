"""The control of a cell's check: the reference put in the program's place
at a lower precision, which the check has to find not correct.

    python3 perfbench/control.py --workload <cell> --seconds <s> \\
        --seeds <n> [<n> ...] [--device cuda]

For each seed: the cell's set-up and a short window of the program (at
the cell's own size and load), then the check twice over the same
window -- once of the program's outputs (the lower reading) and once
with the sampled outputs computed by the reference with its step-4
product in bfloat16 (the control, the upper reading).  Prints one JSON
line a seed.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def readings(cell: str, seed: int, seconds: float, device: str, *,
             workload: dict | None = None, config: dict | None = None
             ) -> dict:
    from perfbench import check, harness, paths

    workload = workload or paths.workload(cell)
    config = config or paths.config(workload["config"])
    mix = paths.mix(workload["mix"])
    run = harness.Run(cell, workload, config, seed, seconds, False, device,
                      time.perf_counter())
    state = mix.prepare(run)
    mix.window(run, state)
    mix.release(state)
    ref = check.Reference(config, state.sys.genomes, device)
    ctl = check.Reference(config, state.sys.genomes, device, "bfloat16")
    out = {"cell": cell, "seed": seed}
    for side, control in (("program", None), ("control", ctl)):
        t0 = time.perf_counter()
        out[side] = {c.name: c.value
                     for c in mix.checks(run, state, ref, control)}
        out[side + "_s"] = time.perf_counter() - t0
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from perfbench import system

    system.set_cache_env()
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, args.seconds,
                                  args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
