#!/usr/bin/env python3
"""The full-width LM serve on two trees in turns: same tokens, same memory?

    python3 tools/lm_serve_ab.py PARENT_DIR

``PARENT_DIR`` holds another checkout of the repo (for example a
``git archive`` of the parent commit unpacked under ``build/``).  Runs
``launch.serve.serve("stablelm-3b", smoke=False)`` with chip_smoke
phase 12's 8 prompts of 512 tokens and 32 decode steps, each in its own
process, in the order parent, this tree, this tree, parent, and prints
each run's token digest, ``max_memory_allocated``, prefill and decode
seconds, then whether the tokens are equal and the peaks' relative gap,
with the card's name and power limit.  Exits 1 if the tokens differ.
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CODE = r"""
import hashlib, json, torch
from repro_torch.launch import serve
torch.cuda.reset_peak_memory_stats()
out = serve.serve("stablelm-3b", smoke=False, num_requests=8,
                  prompt_len=512, decode_steps=32)
print(json.dumps({
    "tokens": hashlib.sha256(out["tokens"].tobytes()).hexdigest()[:16],
    "peak": torch.cuda.max_memory_allocated(),
    "prefill_s": out["prefill_s"], "decode_s": out["decode_s"]}))
"""


def main() -> int:
    trees = {"parent": os.path.abspath(sys.argv[1]), "this": ROOT}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    runs = []
    for name in ("parent", "this", "this", "parent"):
        env = {**os.environ, "PYTHONPATH": os.path.join(trees[name], "src")}
        p = subprocess.run([sys.executable, "-c", CODE], env=env,
                           capture_output=True, text=True, timeout=900)
        if p.returncode:
            print(p.stderr[-3000:])
            return 1
        r = dict(json.loads(p.stdout.strip().splitlines()[-1]), tree=name)
        runs.append(r)
        print(f"{name}: tokens {r['tokens']} | max_memory_allocated "
              f"{r['peak']} B | prefill {r['prefill_s'] * 1e3:.1f} ms | "
              f"decode {r['decode_s'] * 1e3:.1f} ms | {card}", flush=True)
    peak = {n: max(r["peak"] for r in runs if r["tree"] == n)
            for n in trees}
    same = len({r["tokens"] for r in runs}) == 1
    print(f"tokens equal: {same} | peak this / parent - 1: "
          f"{peak['this'] / peak['parent'] - 1:+.4%} | {card}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
