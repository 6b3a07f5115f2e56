"""Hand-written CUDA kernels of the port and their plain torch versions.

  hdc_encoder    the n-gram encoder (replaces the TPU ``hdc_encoder``).
  fused_profile  fused encode->search (replaces the TPU ``fused_profile``).
  hamming_am     packed b1 AND + popcount tensor-core search (replaces
                 the TPU ``hamming_am``).
  am_matmul      +-1 tensor-core search, on packed words
                 (``am_matmul_packed``) or +-1 bf16 (``am_matmul``)
                 (replaces the TPU ``am_matmul``).
  species_max    the per-species max of the agreement (``repro`` leaves
                 it to XLA's ``segment_max``).
  threefry       ``jax.random``'s Threefry draws (``repro`` draws its
                 device model's noise with ``jax.random``).
  crossbar_adc   the crossbar read's per-chunk read noise, ADC and sum
                 over row tiles (``repro`` leaves them to
                 ``jax.random`` and XLA).
  _search        the packed search entries' shared operand check.
  ops            session-level wrappers (``hdc_encode``, ``to_pm1``,
                 ``am_agreement``, ``fused_agreement``,
                 ``fused_tile_plan``).

Sources live in ``repro_torch/csrc``; :mod:`repro_torch.kernels._build`
compiles them with ``nvcc`` at the first CUDA call;
``csrc/mma_common.cuh`` holds the search kernels' shared device code,
``csrc/threefry_common.cuh`` the Threefry block function and normal that
``threefry`` and ``crossbar_adc`` share.
"""
