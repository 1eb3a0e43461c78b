"""PyTorch + CUDA port of the UCFL reproduction (``repro``) for one NVIDIA H100.

The package mirrors ``repro`` module by module (``repro.core.ucfl`` ↔
``repro_torch.core.ucfl``) and imports neither ``jax`` nor ``repro``.
Entry points run on ``torch.device("cuda")`` unless the caller passes
``device="cpu"``; on the CPU every kernel op takes its plain torch version.
"""
