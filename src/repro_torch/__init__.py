"""PyTorch + CUDA port of the UCFL reproduction (``repro``) for one NVIDIA H100.

The package mirrors ``repro`` module by module (``repro.core.ucfl`` ↔
``repro_torch.core.ucfl``) and imports neither ``jax`` nor ``repro``.
Entry points run on ``torch.device("cuda")`` unless the caller passes
``device="cpu"``; on the CPU every kernel op takes its plain torch version.

Ported so far: Algorithm 1 (``ucfl``, ``ucfl_k4``, ``"auto"``) at full
participation and, through ``repro_torch.core.ParticipationConfig`` and
``Cohort``, at partial participation (the masked cohort round); and
personalized serving of the dense transformer family
(``repro_torch.launch.serve``: prefill and decode, one model per client).
"""
