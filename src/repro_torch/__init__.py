"""Demeter on PyTorch and CUDA: the port of :mod:`repro` to an NVIDIA H100.

The module layout mirrors the JAX package so each counterpart is easy to
find (``repro_torch/core/encoder.py`` <-> ``repro/core/encoder.py``, and
so on).  The port imports ``torch`` and numpy only -- never ``jax`` and
nothing of ``repro`` -- so it runs on a GPU machine without JAX.

Conventions shared by every module:

* Packed binary HD vectors are ``int32`` tensors holding the same bit
  patterns as ``repro``'s ``uint32`` words (torch's CPU ``uint32`` has no
  shifts or comparisons).  Convert at the edges with
  ``array.view(np.int32)`` / ``array.view(np.uint32)``.
* Entry points take an explicit ``device`` and default to ``cuda``; they
  raise when no GPU is present unless the caller passes ``device="cpu"``
  (:func:`repro_torch.device.resolve_device`).
* Each of ``repro``'s four TPU kernels (the encoder, the fused
  encode->search kernel and the two standalone AM searches) is
  hand-written CUDA C++ for ``sm_90a`` (:mod:`repro_torch.kernels`); on
  CPU tensors their wrappers run the plain PyTorch versions beside them.
* The baseline profilers (:mod:`repro_torch.baselines`) and the LM
  stack's serving half (:mod:`repro_torch.config`,
  :mod:`repro_torch.configs`, :mod:`repro_torch.models`,
  ``serve.serve_step`` / ``serve.batching``, ``launch.serve``) are plain
  torch, as ``repro``'s are plain numpy / JAX.
"""

__all__ = ["accel", "baselines", "config", "configs", "core", "eval",
           "genomics", "kernels", "launch", "models", "obs", "pipeline",
           "serve"]
