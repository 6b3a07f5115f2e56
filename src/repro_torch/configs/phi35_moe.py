"""phi3.5-moe-42b-a6.6b [moe]: 32L d4096 32H (GQA kv=8) d_ff(expert)=6400,
16 experts top-2, vocab 32064. [hf:microsoft/Phi-3.5-MoE-instruct]
"""

from repro_torch.config import AttnConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    d_ff=6400,
    vocab=32064,
    attn=AttnConfig(num_heads=32, num_kv_heads=8, head_dim=128),
    moe=MoEConfig(num_experts=16, top_k=2, d_expert=6400),
    act="silu",
    glu=True,
)

SMOKE = ModelConfig(
    name="phi3.5-moe-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    d_ff=96,
    vocab=256,
    attn=AttnConfig(num_heads=4, num_kv_heads=2, head_dim=16),
    moe=MoEConfig(num_experts=4, top_k=2, d_expert=96, group_size=64,
                  capacity_factor=2.0),
)
