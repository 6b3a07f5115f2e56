"""Per-layer metric ``refdb_build_s`` (layer: the RefDB build,
``core/assoc_memory.RefDBBuilder`` + ``kernels/hdc_encoder.py``).

Source: the host clock around ``ProfilingSession.build_refdb`` in
set-up, ending in ``torch.cuda.synchronize``: windowing on the host, the
encoder kernel, the copies back and the assembled AM.  Moves ``setup_s``.
"""


def read(ctx):
    return ctx.get("refdb_build_s")
