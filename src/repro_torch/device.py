"""Device selection shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA. Raises when CUDA is asked for but missing.

    There is no silent CPU fallback: a caller that wants the CPU (the
    parity tests) passes ``device="cpu"`` explicitly.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: CUDA is not available; pass device='cpu' to run "
            "the plain torch path on the CPU")
    return dev


def check_generator(who: str, gen, device: torch.device):
    """Raise ``ValueError`` unless ``gen`` lives on ``device``; the ``meta``
    device, which draws nothing, also takes None."""
    if gen is None and device.type == "meta":
        return
    if gen.device.type != device.type or (device.index is not None
                                          and gen.device.index != device.index):
        raise ValueError(f"{who}: the generator lives on {gen.device}, the params on {device}")
