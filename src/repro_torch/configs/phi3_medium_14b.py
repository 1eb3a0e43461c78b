"""phi3-medium-14b [dense] — RoPE + SwiGLU + GQA.

[arXiv:2404.14219] 40L, d_model 5120, 40 q heads / 10 KV, d_ff 17920,
vocab 100352 (per the assigned table). 40 heads / 10 KV are not divisible
by the 16-way model axis — uneven-sharding padding case.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=10,
    d_ff=17920,
    vocab_size=100_352,
    tie_embeddings=False,
    param_dtype="bfloat16",
    act_dtype="bfloat16",
    source="arXiv:2404.14219",
)
