"""gemma2-9b [dense] — local+global alternating attention, logit softcaps.

[arXiv:2408.00118] Gemma 2: 42L, d_model 3584, 16 q heads / 8 KV (GQA),
head_dim 256, d_ff 14336 (GeGLU), vocab 256000, SWA window 4096 on odd
layers, attn-logit softcap 50, final-logit softcap 30, pre+post norms,
tied + sqrt(d)-scaled embeddings. long_500k eligible via the local/global
split (global layers hold a true 500k cache; decode is linear per token).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256_000,
    mlp="geglu",
    attn_pattern=("local", "global"),
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    post_norms=True,
    emb_scale=True,
    tie_embeddings=True,
    long_context_ok=True,
    param_dtype="bfloat16",
    act_dtype="bfloat16",
    source="arXiv:2408.00118",
)
