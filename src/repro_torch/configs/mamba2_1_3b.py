"""mamba2-1.3b [ssm] — SSD (state-space duality), attention-free.

[arXiv:2405.21060] 48L, d_model 2048, d_inner 4096 (expand 2), 64 SSD
heads of headdim 64, ssm_state 128, vocab 50280, tied embeddings.
O(1)-state decode ⇒ long_500k eligible (the flagship long-context arch).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=64,
    num_kv_heads=64,
    d_ff=0,
    vocab_size=50_280,
    ssm_state=128,
    ssm_headdim=64,
    tie_embeddings=True,
    long_context_ok=True,
    param_dtype="bfloat16",
    act_dtype="bfloat16",
    source="arXiv:2405.21060",
)
