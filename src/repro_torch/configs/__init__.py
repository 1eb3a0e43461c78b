"""Architecture registry (a copy of ``repro.configs``): ``--arch <id>`` resolves here."""
from __future__ import annotations

from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig  # noqa: F401

from repro_torch.configs.gemma2_9b import CONFIG as _gemma2
from repro_torch.configs.stablelm_1_6b import CONFIG as _stablelm
from repro_torch.configs.mixtral_8x7b import CONFIG as _mixtral
from repro_torch.configs.zamba2_2_7b import CONFIG as _zamba2
from repro_torch.configs.qwen2_7b import CONFIG as _qwen2
from repro_torch.configs.kimi_k2_1t_a32b import CONFIG as _kimi
from repro_torch.configs.phi3_medium_14b import CONFIG as _phi3
from repro_torch.configs.internvl2_1b import CONFIG as _internvl2
from repro_torch.configs.whisper_large_v3 import CONFIG as _whisper
from repro_torch.configs.mamba2_1_3b import CONFIG as _mamba2

ARCHITECTURES = {
    c.name: c
    for c in (
        _gemma2, _stablelm, _mixtral, _zamba2, _qwen2,
        _kimi, _phi3, _internvl2, _whisper, _mamba2,
    )
}


def get(name: str) -> ModelConfig:
    if name not in ARCHITECTURES:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(ARCHITECTURES)}"
        )
    return ARCHITECTURES[name]

