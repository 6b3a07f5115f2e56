"""nemotron-4-15b [dense]: 32L d6144 48H (GQA kv=8) d_ff=24576
vocab 256000, squared-ReLU MLP (no GLU), LayerNorm, RoPE.
[arXiv:2402.16819; unverified]
"""

from repro_torch.config import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    d_ff=24576,
    vocab=256000,
    attn=AttnConfig(num_heads=48, num_kv_heads=8, head_dim=128),
    act="relu2",
    glu=False,
    norm="layernorm",
)

SMOKE = ModelConfig(
    name="nemotron-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    d_ff=256,
    vocab=512,
    attn=AttnConfig(num_heads=4, num_kv_heads=2, head_dim=16),
    act="relu2",
    glu=False,
    norm="layernorm",
)
