"""whisper-tiny [audio]: 4L enc + 4L dec, d384 6H d_ff=1536 vocab 51865,
enc-dec with stub conv frontend (input_specs provides frame embeddings).
[arXiv:2212.04356; unverified]
"""

from repro_torch.config import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,
    n_enc_layers=4,
    d_model=384,
    d_ff=1536,
    vocab=51865,
    attn=AttnConfig(num_heads=6, num_kv_heads=6, head_dim=64),
    act="gelu",
    glu=False,
    norm="layernorm",
    pos="sinusoidal",
    dec_len_train=512,
)

SMOKE = ModelConfig(
    name="whisper-smoke",
    family="audio",
    n_layers=2,
    n_enc_layers=2,
    d_model=64,
    d_ff=128,
    vocab=256,
    attn=AttnConfig(num_heads=4, num_kv_heads=4, head_dim=16),
    act="gelu",
    glu=False,
    norm="layernorm",
    pos="sinusoidal",
    dec_len_train=16,
)
