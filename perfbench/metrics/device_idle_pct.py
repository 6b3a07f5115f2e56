"""Per-layer metric ``device_idle_pct`` (layer: the device).

Source: the traced stretch's wall time less the union of the device's
kernel, copy and set intervals in it, over the wall time
(``torch.profiler``).  The stretch: the window's second whole
``profile`` call, synchronized at both ends.  Moves ``profile_reads_per_s``.
"""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (tr.window_s - tr.busy_s()) / tr.window_s
