"""Per-layer metric ``dispatch_ms_per_batch`` (layer: the session,
``pipeline/session.py`` + ``pipeline/source.py``).

Source: the program's histogram ``session_classify_batch_seconds``, sum
over count, recorded (in the traced run only) over every batch of the
window.  It times the host's dispatch of ``classify_batch`` with no
synchronize: the hand-off, not the batch's device time.  Moves
``profile_reads_per_s``.
"""

HISTOGRAM = "session_classify_batch_seconds"


def read(ctx):
    reg = ctx.get("registry")
    if reg is None:
        return None
    state = reg.histogram(HISTOGRAM).merged()
    if state.count == 0:
        return None
    return state.sum / state.count * 1e3
