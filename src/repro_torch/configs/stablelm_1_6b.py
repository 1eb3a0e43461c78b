"""stablelm-1.6b [dense] — LayerNorm, partial rotary (25%).

[hf:stabilityai/stablelm-2-1_6b] 24L, d_model 2048, 32 heads / 32 KV (MHA),
d_ff 5632 (SwiGLU), vocab 100352, rope over 25% of head_dim, untied head.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=5632,
    vocab_size=100_352,
    norm="layernorm",
    mlp="swiglu",
    rope_pct=0.25,
    tie_embeddings=False,
    param_dtype="bfloat16",
    act_dtype="bfloat16",
    source="hf:stabilityai/stablelm-2-1_6b",
)
