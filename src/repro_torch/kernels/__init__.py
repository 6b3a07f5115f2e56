"""Hand-written CUDA kernels of the port and their plain torch versions.

  hdc_encoder    the n-gram encoder (replaces the TPU ``hdc_encoder``).
  fused_profile  fused encode->search (replaces the TPU ``fused_profile``).
  ops            session-level wrappers (``hdc_encode``, ``fused_agreement``,
                 ``fused_tile_plan``).

Sources live in ``repro_torch/csrc``; :mod:`repro_torch.kernels._build`
compiles them with ``nvcc`` at the first CUDA call.
"""
