"""Per-layer metric ``crossbar_read_roofline`` (layer: the crossbar read,
``accel/crossbar.read_banks``).

Source: the least time of the stretch's read events
(``perfbench/roofline_crossbar.py``: the float32 tile products, the read
noise's draws and the bytes, counted from each call's batch, the
prototypes and the crossbar geometry; one read event a ``classify_batch``
call) over the device time of the kernels launched inside the program's
span ``repro_torch.crossbar.read`` in the traced stretch.  Moves
``profile_reads_per_s``.  Reports nothing where the program has no such
span.
"""

from perfbench import roofline_crossbar, spans

SPAN = "repro_torch.crossbar.read"


def read(ctx):
    sp = spans.load(ctx)
    if sp is None:
        return None
    busy = sp.kernel_time(SPAN)
    calls = ctx["trace"].calls
    if busy == 0 or not calls:
        return None
    opts = ctx["config"].get("backend_options", {})
    least = sum(roofline_crossbar.read_least_s(
        c["B"], ctx["prototypes"], ctx["config"]["space"]["dim"],
        opts.get("rows", 256), opts.get("cols", 256)) for c in calls)
    return 100.0 * least / busy
