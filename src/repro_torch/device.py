"""Device selection shared by the port's entry points.

Entry points (``ProfilingSession``, the backends, ``build_refdb``) run on
the card unless the caller asks for the CPU: ``device=None`` means
``cuda``, and a machine without a usable GPU raises instead of silently
profiling on the host.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means ``cuda``.

    Raises:
      RuntimeError: a CUDA device was asked for (or defaulted to) but
        ``torch.cuda.is_available()`` is false.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA GPU by default, but "
            "torch.cuda.is_available() is false; pass device=\"cpu\" to run "
            "the plain PyTorch path on the host")
    return dev
