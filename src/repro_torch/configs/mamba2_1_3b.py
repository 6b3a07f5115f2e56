"""mamba2-1.3b [ssm]: 48L d2048 attn-free, SSD with d_state=128,
expand=2, head_dim=64, vocab 50280. [arXiv:2405.21060]
"""

from repro_torch.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    d_ff=0,
    vocab=50280,
    ssm=SSMConfig(d_state=128, expand=2, head_dim=64, chunk=256),
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2-smoke",
    family="ssm",
    n_layers=3,
    d_model=64,
    d_ff=0,
    vocab=256,
    ssm=SSMConfig(d_state=16, expand=2, head_dim=16, chunk=16),
    tie_embeddings=True,
)
