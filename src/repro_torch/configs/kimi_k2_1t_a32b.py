"""kimi-k2-1t-a32b [moe] — trillion-param MoE, 384 experts top-8.

[arXiv:2501.kimi2 paper-table] 61L (first layer dense), d_model 7168,
64 q heads / 8 KV (head_dim 112), per-expert d_ff 2048, vocab 163840.
The dense first block uses d_ff 18432 (Kimi K2 model card; the assigned
table lists only the expert width).

Regime: ``fedsgd_sharded`` — one bf16 copy is ≈2 TB, so per-client
personalized copies are physically impossible on a 16-chip client slice
(DESIGN.md §6). Experts are expert-parallel over the "data" axis
(384/16 = 24 per slice) with d_ff tensor-parallel over "model"
(2048/16 = 128); gradient sync is a synchronous all-reduce (FedSGD), and
user-centric personalization applies to the tiny per-client router/norm
parameters only. Training uses momentum-free SGD (HBM headroom; recorded
in §Roofline).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=112,
    d_ff=18432,
    vocab_size=163_840,
    moe_num_experts=384,
    moe_top_k=8,
    moe_d_ff=2048,
    first_dense=1,
    rope_base=50000.0,
    tie_embeddings=False,
    regime="fedsgd_sharded",
    expert_axis="data",
    momentum=0.0,
    param_dtype="bfloat16",
    act_dtype="bfloat16",
    source="arXiv:2501.kimi2 (paper-table)",
)
