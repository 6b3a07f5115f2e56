"""The LM stack's models: counterpart of :mod:`repro.models`.

``layers`` (norms, MLP, embeddings, RoPE), ``attention`` (blockwise
GQA / MLA), ``moe``, ``ssm`` (Mamba-2 SSD), ``blocks`` (every block kind
and its decode step) and ``lm`` (segment-planned models, prefill and
decode).  Plain torch: ``repro`` has no Pallas kernel here.
"""

from repro_torch.models import attention, blocks, layers, lm, moe, ssm

__all__ = ["attention", "blocks", "layers", "lm", "moe", "ssm"]
