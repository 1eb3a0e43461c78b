"""whisper-large-v3 [audio] — encoder-decoder, conv frontend STUB.

[arXiv:2212.04356] 32 encoder + 32 decoder layers, d_model 1280,
20 heads (MHA), d_ff 5120 (GELU), vocab 51866, LayerNorm, no RoPE,
1500 encoder frames (stub mel+conv frontend provides embeddings).
decode_32k is a beyond-spec stress shape (real cap: 448 decoder
positions) — the learned position table is sized 32768 to lower it;
long_500k is skipped (architecturally meaningless), see DESIGN.md.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    d_ff=5120,
    vocab_size=51_866,
    norm="layernorm",
    mlp="gelu",
    encoder_layers=32,
    encoder_seq=1500,
    max_pos=32_768,
    tie_embeddings=True,
    param_dtype="bfloat16",
    act_dtype="bfloat16",
    source="arXiv:2212.04356",
)
