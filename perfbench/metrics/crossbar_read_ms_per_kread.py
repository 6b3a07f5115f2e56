"""Per-layer metric ``crossbar_read_ms_per_kread`` (layer: the crossbar
read, ``accel/crossbar.read_banks`` under ``accel/backend_pcm.py``: the
tile products, the Threefry read noise, the ADC and the sums).

Source: the program's span ``repro_torch.crossbar.read``
(``perfbench/spans.py``): the device time of every kernel launched inside
it in the traced stretch, whatever kernels implement the read, per 1,000
valid reads of the stretch's calls (the harness's ``classify_batch``
annotations).  Moves ``profile_reads_per_s``.  Reports nothing where the
program has no such span.
"""

from perfbench import spans

SPAN = "repro_torch.crossbar.read"


def read(ctx):
    sp = spans.load(ctx)
    if sp is None:
        return None
    reads = sum(c.get("valid", 0) for c in ctx["trace"].calls)
    t = sp.kernel_time(SPAN)
    if reads == 0 or t == 0:
        return None
    return t * 1e3 / (reads / 1e3)
