"""mixtral-8x7b [moe] — 8 experts top-2, sliding-window attention.

[arXiv:2401.04088] 32L, d_model 4096, 32 q heads / 8 KV, d_ff 14336 per
expert, vocab 32000, SWA window 4096 (rolling cache ⇒ long_500k eligible).
Experts are tensor-parallel (d_ff on "model"); expert dim unsharded in the
federated regime (each client slice computes its own 8 experts).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32_000,
    attn_pattern=("local",),
    window=4096,
    moe_num_experts=8,
    moe_top_k=2,
    moe_d_ff=14336,
    tie_embeddings=False,
    long_context_ok=True,
    param_dtype="bfloat16",
    act_dtype="bfloat16",
    source="arXiv:2401.04088",
)
