"""Per-layer metric ``fused_profile_roofline`` (layer: the fused
kernel, ``kernels/fused_profile.py``, ``csrc/fused_profile.cu``).

Source: the least time of the fused launches in the traced stretch
(``perfbench/roofline.py``: the algorithm's encode operations, search
operations and bytes, counted from each launch's shapes, which the
harness's ``classify_batch`` annotation carries) over their device
time in ``torch.profiler``'s trace: the fused kernel and the row
popcount kernel the same launch runs.  Moves ``profile_reads_per_s``.
A launch whose fused kernel is not wholly in the stretch, or is not
attributed to an annotated call, counts on neither side.
"""

from perfbench import roofline

FUSED = r"fused_profile(_wide)?_kernel"
#: The prototypes' row popcounts, which the same launch runs first.
POPCOUNT = r"row_popcount_kernel"


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    space = ctx["config"]["space"]
    calls = {id(k.call): k.call for k in tr.kernels_of(FUSED)
             if k.call is not None}
    busy = sum(k.dur for k in tr.kernels_of(f"{FUSED}|{POPCOUNT}")
               if k.call is not None and id(k.call) in calls)
    least = sum(roofline.fused_least_s(c["B"], c["L"], c["grams"],
                                       ctx["prototypes"], space["dim"])
                for c in calls.values())
    if busy == 0:
        return None
    return 100.0 * least / busy
