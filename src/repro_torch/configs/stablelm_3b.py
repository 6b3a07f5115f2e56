"""stablelm-3b [dense]: 32L d2560 32H (kv=32 -> MHA) d_ff=6912 vocab 50304,
partial RoPE (25%). [hf:stabilityai/stablelm-2; unverified]
"""

from repro_torch.config import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    d_ff=6912,
    vocab=50304,
    attn=AttnConfig(num_heads=32, num_kv_heads=32, head_dim=80,
                    rope_fraction=0.25),
    act="silu",
    glu=True,
    norm="layernorm",
)

SMOKE = ModelConfig(
    name="stablelm-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    d_ff=128,
    vocab=256,
    attn=AttnConfig(num_heads=4, num_kv_heads=4, head_dim=16,
                    rope_fraction=0.25),
    norm="layernorm",
)
