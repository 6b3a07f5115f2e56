"""paligemma-3b [vlm]: 18L d2048 8H (MQA kv=1, head_dim 256) d_ff=16384
vocab 257216; SigLIP tower stubbed -> 256 patch embeddings prefix with
prefix-LM masking. [arXiv:2407.07726]
"""

from repro_torch.config import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    d_ff=16384,
    vocab=257216,
    attn=AttnConfig(num_heads=8, num_kv_heads=1, head_dim=256),
    act="gelu",
    glu=True,
    tie_embeddings=True,
    vlm_prefix=256,
)

SMOKE = ModelConfig(
    name="paligemma-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    d_ff=128,
    vocab=256,
    attn=AttnConfig(num_heads=4, num_kv_heads=1, head_dim=16),
    act="gelu",
    glu=True,
    tie_embeddings=True,
    vlm_prefix=8,
)
