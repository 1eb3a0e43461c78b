"""qwen2-7b [dense] — GQA with QKV bias.

[arXiv:2407.10671] 28L, d_model 3584, 28 q heads / 4 KV, d_ff 18944
(SwiGLU), vocab 152064, rope base 1e6, untied head. 28 heads are NOT
divisible by the 16-way model axis — exercises GSPMD uneven sharding
(padding waste is visible in the §Roofline useful-FLOPs ratio).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b",
    family="dense",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18944,
    vocab_size=152_064,
    qkv_bias=True,
    rope_base=1e6,
    tie_embeddings=False,
    param_dtype="bfloat16",
    act_dtype="bfloat16",
    source="arXiv:2407.10671",
)
