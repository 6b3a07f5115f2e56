"""deepseek-67b [dense]: 95L d8192 64H (GQA kv=8) d_ff=22016 vocab 102400,
llama architecture (silu GLU, RMSNorm, RoPE). [arXiv:2401.02954]
"""

from repro_torch.config import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    n_layers=95,
    d_model=8192,
    d_ff=22016,
    vocab=102400,
    attn=AttnConfig(num_heads=64, num_kv_heads=8, head_dim=128),
    act="silu",
    glu=True,
)

SMOKE = ModelConfig(
    name="deepseek-67b-smoke",
    family="dense",
    n_layers=3,
    d_model=64,
    d_ff=192,
    vocab=256,
    attn=AttnConfig(num_heads=8, num_kv_heads=2, head_dim=8),
)
