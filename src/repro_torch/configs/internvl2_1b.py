"""internvl2-1b [vlm] — InternViT (stub) + Qwen2-0.5B-style LM backbone.

[arXiv:2404.16821] LM: 24L, d_model 896, 14 q heads / 2 KV, d_ff 4864,
vocab 151655, QKV bias, tied embeddings. The vision encoder is a STUB per
the assignment carve-out: input_specs() supplies 256 precomputed patch
embeddings of dim 1024 (InternViT-300M output); the linear projector into
the LM and the full LM are implemented.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151_655,
    qkv_bias=True,
    rope_base=1e6,
    tie_embeddings=True,
    num_patches=256,
    patch_embed_dim=1024,
    param_dtype="bfloat16",
    act_dtype="bfloat16",
    source="arXiv:2404.16821",
)
