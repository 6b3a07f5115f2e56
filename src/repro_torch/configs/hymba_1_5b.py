"""hymba-1.5b [hybrid]: 32L d1600 25H (GQA kv=5) d_ff=5504, parallel
attention+mamba heads, SWA everywhere except 3 global layers,
ssm_state=16. [arXiv:2411.13676]
"""

from repro_torch.config import AttnConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    d_ff=5504,
    vocab=32001,
    attn=AttnConfig(num_heads=25, num_kv_heads=5, head_dim=64, window=1024),
    ssm=SSMConfig(d_state=16, expand=2, head_dim=64),
    act="silu",
    glu=True,
)

SMOKE = ModelConfig(
    name="hymba-smoke",
    family="hybrid",
    n_layers=5,
    d_model=64,
    d_ff=128,
    vocab=256,
    attn=AttnConfig(num_heads=4, num_kv_heads=2, head_dim=16, window=8),
    ssm=SSMConfig(d_state=8, expand=2, head_dim=16, chunk=16),
)
