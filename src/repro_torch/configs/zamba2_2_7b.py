"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention block.

[arXiv:2411.15242] 54 block slots, d_model 2560, ssm_state 64; the shared
transformer block (32 heads / 32 KV, d_ff 10240) is stored ONCE and invoked
every 6th slot (9 invocations, per-invocation KV caches). Simplification
recorded in DESIGN.md: Zamba2's concat-with-embedding input and per-
invocation LoRA deltas on the shared block are omitted; the shared-weight
structure and cache pattern are kept. SSM ⇒ long_500k eligible.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,
    vocab_size=32_000,
    ssm_state=64,
    ssm_headdim=64,
    hybrid_group=6,
    tie_embeddings=True,
    long_context_ok=True,
    param_dtype="bfloat16",
    act_dtype="bfloat16",
    source="arXiv:2411.15242",
)
