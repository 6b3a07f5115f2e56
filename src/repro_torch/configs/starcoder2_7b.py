"""starcoder2-7b [dense]: 32L d4608 36H (GQA kv=4) d_ff=18432 vocab 49152,
GQA + RoPE, gelu non-GLU MLP. [arXiv:2402.19173]
"""

from repro_torch.config import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    d_ff=18432,
    vocab=49152,
    attn=AttnConfig(num_heads=36, num_kv_heads=4, head_dim=128,
                    rope_theta=100_000.0),
    act="gelu",
    glu=False,
    norm="layernorm",
)

SMOKE = ModelConfig(
    name="starcoder2-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    d_ff=256,
    vocab=256,
    attn=AttnConfig(num_heads=4, num_kv_heads=2, head_dim=16),
    act="gelu",
    glu=False,
    norm="layernorm",
)
