#!/usr/bin/env python3
"""Where a full-width training step's device time goes.

    python3 tools/train_step_profile.py [--trace OUT.json]

Builds ``stablelm-3b``'s train state at full width on the card (as
``launch.train`` does: 8 x 512 tokens, loss chunk 512, remat on), takes
two warm-up steps on ``lm_data.batch_at(0)``, then one step under
``torch.profiler`` and prints, with the card's name and power limit:
the step's wall time under the profiler, the span and busy time of its
kernels, and the kernels' time by kind (bf16 and float32 matrix
products, elementwise, copies and casts, reductions, the rest), with
their counts.  ``--trace`` writes the Chrome trace.
"""

import argparse
import collections
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def kind(name: str) -> str:
    if "f32f32_f32f32" in name:
        return "float32 matmul (FFMA)"
    if any(k in name for k in ("nvjet", "gemm", "xmma", "cutlass")):
        return "bf16 matmul"
    if "reduce_kernel" in name:
        return "reduction"
    if "copy" in name:
        return "copy / cast"
    if "elementwise" in name:
        return "elementwise"
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data import lm_data
    from repro_torch.train import train_step as ts

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cfg = get_config("stablelm-3b")
    tc = ts.TrainConfig(loss_chunk=512, q_chunk=512, kv_chunk=512)
    dc = lm_data.DataConfig(vocab=cfg.vocab, seq_len=512, global_batch=8)
    state = ts.init_train_state(0, cfg, tc, device="cuda")
    step = ts.make_train_step(cfg, tc)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in lm_data.batch_at(dc, 0).items()}
    for _ in range(2):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        float(m["loss"])
        wall = time.perf_counter() - t0
    out = args.trace or os.path.join(tempfile.mkdtemp(), "trace.json")
    prof.export_chrome_trace(out)
    with open(out) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") == "kernel"]
    if not events:
        print(f"the profiler recorded no kernel | {card}")
        return 1
    busy = sum(e["dur"] for e in events) / 1e3
    span = (max(e["ts"] + e["dur"] for e in events)
            - min(e["ts"] for e in events)) / 1e3
    ms, n = collections.Counter(), collections.Counter()
    for e in events:
        ms[kind(e["name"])] += e["dur"] / 1e3
        n[kind(e["name"])] += 1
    print(f"step under the profiler {wall * 1e3:.1f} ms | {len(events)} "
          f"kernels over {span:.1f} ms, busy {busy:.1f} ms | {card}")
    for k, v in ms.most_common():
        print(f"  {k}: {v:.1f} ms ({100 * v / busy:.1f} %), {n[k]} kernels")
    return 0


if __name__ == "__main__":
    sys.exit(main())
