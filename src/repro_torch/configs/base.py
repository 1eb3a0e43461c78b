"""Architecture config schema + input-shape suite (a copy of ``repro.configs.base``).

Every assigned architecture gets one ``ModelConfig`` (exact, cited) plus a
``reduced()`` smoke variant (≤2 layers, d_model ≤ 512, ≤4 experts) that runs
a real forward/train step on CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    norm: str = "rmsnorm"
    mlp: str = "swiglu"
    qkv_bias: bool = False
    rope_base: float = 10000.0
    rope_pct: float = 1.0
    tie_embeddings: bool = True
    emb_scale: bool = False  # gemma: multiply embeddings by sqrt(d_model)
    post_norms: bool = False  # gemma2 post-attn/post-mlp norms
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    attn_pattern: Tuple[str, ...] = ("global",)  # cycled; "local" uses window
    window: Optional[int] = None
    # --- MoE ---
    moe_num_experts: int = 0
    moe_top_k: int = 2
    moe_d_ff: Optional[int] = None  # per-expert hidden
    first_dense: int = 0  # leading dense layers (kimi)
    capacity_factor: float = 1.25
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_chunk: int = 256
    ssm_expand: int = 2
    hybrid_group: int = 0  # zamba2: group = (hybrid_group−1) mamba + 1 shared attn
    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 0
    max_pos: int = 0  # learned-position table size (whisper decoder)
    # --- VLM ---
    num_patches: int = 0
    patch_embed_dim: int = 0
    # --- distribution ---
    regime: str = "federated"  # "federated" | "fedsgd_sharded"
    expert_axis: Optional[str] = None  # mesh axis for the expert dim
    long_context_ok: bool = False  # eligible for long_500k
    # deployment padding (set by .for_mesh(); 1 = no padding, CPU/smoke)
    head_pad: int = 1  # pad/replicate heads to divide the model axis
    vocab_pad: int = 1  # pad vocab rows to divide the model axis
    # --- numerics / optimizer ---
    param_dtype: str = "float32"
    act_dtype: str = "float32"
    remat: bool = True
    remat_policy: str = "full"  # "full" | "dots" (§Perf: skip dot recompute)
    momentum: float = 0.9  # kimi uses 0.0 (HBM headroom, DESIGN.md §6)
    # --- provenance ---
    source: str = ""

    # ------------------------------------------------------------ derived
    def for_mesh(self, model_axis: int = 16) -> "ModelConfig":
        """Deployment transform: exact-semantics head/vocab padding so
        every sharded dim divides the model axis (see attention.plan_heads
        and DESIGN.md §6). The padding waste is intentional and measured."""
        return dataclasses.replace(self, head_pad=model_axis,
                                   vocab_pad=model_axis)

    @property
    def padded_vocab(self) -> int:
        v, p = self.vocab_size, max(self.vocab_pad, 1)
        return -(-v // p) * p

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def pattern_len(self) -> int:
        if self.family in ("ssm",):
            return 1
        if self.family == "hybrid":
            return self.hybrid_group
        return len(self.attn_pattern)

    @property
    def scan_layers(self) -> int:
        return self.num_layers - self.first_dense

    @property
    def num_groups(self) -> int:
        assert self.scan_layers % self.pattern_len == 0, (
            self.name, self.scan_layers, self.pattern_len)
        return self.scan_layers // self.pattern_len

    @property
    def param_tdtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.param_dtype]

    @property
    def act_tdtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.act_dtype]

    def reduced(self, **over) -> "ModelConfig":
        """Smoke-test variant: tiny but same family/code path."""
        scan = self.pattern_len if self.pattern_len > 1 else 2
        kw = dict(
            name=self.name + "-smoke",
            num_layers=scan + self.first_dense,
            d_model=min(self.d_model, 128),
            num_heads=min(self.num_heads, 4),
            num_kv_heads=min(self.num_kv_heads, 2),
            head_dim=32,
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            moe_num_experts=min(self.moe_num_experts, 4),
            moe_top_k=min(self.moe_top_k, 2),
            moe_d_ff=min(self.moe_d_ff, 128) if self.moe_d_ff else None,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_headdim=16 if self.ssm_state else self.ssm_headdim,
            ssm_chunk=32,
            window=min(self.window, 64) if self.window else None,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 32),
            max_pos=min(self.max_pos, 512),
            num_patches=min(self.num_patches, 8),
            patch_embed_dim=min(self.patch_embed_dim, 64),
            param_dtype="float32",
            act_dtype="float32",
            remat=False,
        )
        # keep layer count compatible with grouping
        if self.family == "hybrid":
            kw["num_layers"] = self.hybrid_group
        kw.update(over)
        return dataclasses.replace(self, **kw)
