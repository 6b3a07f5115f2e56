"""Per-layer metric ``profile_host_idle_ms_per_batch`` (layer: the
session, ``pipeline/session.py`` + ``pipeline/source.py``).

Source: the program's spans (``perfbench/spans.py``): the traced
stretch's device-idle time (``Trace.gaps``) whose innermost main-thread
span is one of the session's (``repro_torch.profile.*``,
``repro_torch.classify_batch``, ``repro_torch.to_device`` and the path
taken; not the classifier's species max and threshold), each idle
instant once, over the ``repro_torch.classify_batch`` spans of the
stretch: the session's serial work a batch while the card waits.  Moves
``profile_reads_per_s``.
Reports nothing where the program has no such span.
"""

from perfbench import spans


def read(ctx):
    sp = spans.load(ctx)
    if sp is None:
        return None
    batches = sp.count(spans.BATCH)
    if batches == 0:
        return None
    return sp.host_idle_s(ctx["trace"].gaps()) * 1e3 / batches
