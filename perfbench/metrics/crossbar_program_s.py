"""Per-layer metric ``crossbar_program_s`` (layer: crossbar programming,
``accel/backend_pcm.SubstrateBackend.program``: both banks programmed with
their Threefry draws and their read weights cached).

Source: the backend's ``program_seconds`` (host seconds of its last
programming event, ending in a synchronize), which the ``profile_pcm``
traffic driver keeps after set-up (``program_s``); the banks are
programmed once, at the warm-up's first read.  Moves ``setup_s``.
Reports nothing where the program keeps no such time.
"""


def read(ctx):
    return ctx.get("program_s")
