"""deepseek-v2-lite-16b [moe]: 27L d2048, MLA kv_lora=512, 64 routed top-6
+ 2 shared experts, d_expert=1408, first layer dense (d_ff=10944).
[arXiv:2405.04434; hf]  (Assignment note "160 routed" belongs to full V2 —
see DESIGN.md §Config discrepancy.)
"""

from repro_torch.config import AttnConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    d_ff=1408,
    vocab=102400,
    attn=AttnConfig(kind="mla", num_heads=16, num_kv_heads=16, head_dim=128,
                    kv_lora=512, rope_head_dim=64, v_head_dim=128,
                    rope_theta=10_000.0),
    moe=MoEConfig(num_experts=64, top_k=6, d_expert=1408, num_shared=2),
    n_dense_layers=1,
    dense_d_ff=10944,
    act="silu",
    glu=True,
)

SMOKE = ModelConfig(
    name="deepseek-v2-lite-smoke",
    family="moe",
    n_layers=3,
    d_model=64,
    d_ff=48,
    vocab=256,
    attn=AttnConfig(kind="mla", num_heads=4, num_kv_heads=4, head_dim=16,
                    kv_lora=32, rope_head_dim=8, v_head_dim=16),
    moe=MoEConfig(num_experts=8, top_k=2, d_expert=48, num_shared=1,
                  group_size=64, capacity_factor=4.0),
    n_dense_layers=1,
    dense_d_ff=128,
)
