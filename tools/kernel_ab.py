#!/usr/bin/env python3
"""Time the two main-path kernels of one checkout, for A/B runs on one card.

    python3 tools/kernel_ab.py TREE LABEL

TREE is the root of a checkout (``src/repro_torch`` inside it); its
kernels are built into ``TREE/build/torch_ext``.  Prints one JSON line:
five rounds of the mean ms a launch (CUDA events) of ``hdc_encoder`` on
256 windows of 8,192 random symbols (10 launches a round) and of
``fused_profile`` at bb 16 / cluster 2 on 256 reads of 150 against 9,780
random prototypes (20 launches a round), at D = 40,960, n = 16, A = 4.
Compare two trees in one call on one card, in turns (parent, change,
change, parent), e.g. with the parent unpacked by ``git archive`` into a
directory ``.gitignore`` lists.
"""

import json
import os
import sys


def main() -> int:
    tree, label = os.path.abspath(sys.argv[1]), sys.argv[2]
    sys.path.insert(0, os.path.join(tree, "src"))
    os.environ["REPRO_TORCH_BUILD_DIR"] = os.path.join(tree, "build",
                                                       "torch_ext")
    import numpy as np
    import torch

    from repro_torch import convert
    from repro_torch.core import item_memory
    from repro_torch.core.hd_space import HDSpace
    from repro_torch.kernels import _build, fused_profile, hdc_encoder

    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA GPU", file=sys.stderr)
        return 2
    _build.build_all()
    dev = torch.device("cuda")
    space = HDSpace()
    n, w = space.ngram, space.num_words
    imr = item_memory.rolled(item_memory.make_item_memory(space, device=dev),
                             n).contiguous()
    tie = item_memory.make_tie_break(space, device=dev)
    rng = np.random.default_rng(2206)
    wins = torch.from_numpy(rng.integers(0, 4, (256, 8192)).astype(
        np.int32)).to(dev)
    wlen = torch.full((256,), 8192, dtype=torch.int32, device=dev)
    starts = rng.integers(0, 8192 - 150, 256).tolist()
    reads = torch.stack([wins[i, s:s + 150]
                         for i, s in enumerate(starts)]).contiguous()
    rlen = torch.full((256,), 150, dtype=torch.int32, device=dev)
    protos = convert.words_to_tensor(rng.integers(
        0, 2 ** 32, (9780, w), dtype=np.uint32), dev)

    def ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    out = {"label": label, "hdc_encoder": [], "fused_profile": []}
    for _ in range(5):
        out["hdc_encoder"].append(ms(lambda: hdc_encoder.hdc_encode(
            wins, wlen, imr, tie), 10))
        out["fused_profile"].append(ms(lambda: fused_profile.fused_profile(
            reads, rlen, imr, tie, protos, dim=space.dim, bb=16, cluster=2),
            20))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
