"""Per-layer metric ``refdb_window_s`` (layer: the RefDB build,
``core/assoc_memory.RefDBBuilder``).

Source: the program's histogram ``refdb_build_stage_seconds``, the sum of
its ``stage="window"`` samples over the build in set-up (the host gather
of every genome's windows, ``window_tokens``), recorded into the
registry the harness passes in the traced run.  Moves ``setup_s``.
Reports nothing where the program records no such stage.
"""

HISTOGRAM = "refdb_build_stage_seconds"


def read(ctx):
    reg = ctx.get("registry")
    if reg is None:
        return None
    state = reg.histogram(HISTOGRAM).state(stage="window")
    if state is None or state.count == 0:
        return None
    return state.sum
