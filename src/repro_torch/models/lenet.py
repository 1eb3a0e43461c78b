"""LeNet-5 as plain functions on tensors (paper §V-A).

The weights keep the reference's storage: HWIO convolution kernels and
(in, out) dense matrices, so a params dict ravels to the reference's slab
column for column. Input and activations are NHWC, so the flatten runs in
(h, w, c) order like the reference's (``repro/models/lenet.py:60``) and
the rows of ``f1_w`` mean the same in both.

``apply_stacked`` runs U models at once, one per client: every leaf has a
leading unit axis and the input is (U, B, H, W, C). Every layer is one
batched product over the unit axis: a convolution gathers its 5×5 patches
in NHWC order (``Tensor.unfold``, channel-major within a patch) and
multiplies them by the unit's (C·25, Cout) kernel matrix, so activations
stay NHWC from input to flatten and one step costs a few dozen launches
whatever U is. (Grouped ``conv2d`` with ``groups=U`` computes the same,
but cuDNN's backward for it launches once per group.)
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device


def _glorot(gen, shape, device):
    fan_in = 1
    for s in shape[:-1]:
        fan_in *= s
    limit = (6.0 / (fan_in + shape[-1])) ** 0.5
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    return u * (2.0 * limit) - limit


def init(gen: torch.Generator, *, input_hw=(28, 28), channels=1,
         num_classes=47, device=None) -> dict:
    """Glorot-uniform weights and zero biases, drawn from ``gen``.

    The draws are torch's, so they differ from ``repro.models.lenet.init``
    with any key; parity tests hand the reference's weights over through
    :func:`repro_torch.interop.params_from_numpy` instead.
    """
    dev = resolve_device(device)
    h, w = input_hw
    h1, w1 = h - 4, w - 4
    h2, w2 = h1 // 2 - 4, w1 // 2 - 4
    flat = (h2 // 2) * (w2 // 2) * 16

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=dev)

    return {
        "c1_w": _glorot(gen, (5, 5, channels, 6), dev),
        "c1_b": zeros(6),
        "c2_w": _glorot(gen, (5, 5, 6, 16), dev),
        "c2_b": zeros(16),
        "f1_w": _glorot(gen, (flat, 120), dev),
        "f1_b": zeros(120),
        "f2_w": _glorot(gen, (120, 84), dev),
        "f2_b": zeros(84),
        "f3_w": _glorot(gen, (84, num_classes), dev),
        "f3_b": zeros(num_classes),
    }


def _conv(y, w, b):
    """Valid 5×5 convolution, one kernel per unit, NHWC in and out.

    y (U, B, H, W, Cin); w (U, kh, kw, Cin, Cout) HWIO; b (U, Cout).
    """
    units, batch, h, wd, cin = y.shape
    _, kh, kw, _, cout = w.shape
    ho, wo = h - kh + 1, wd - kw + 1
    # (U, B, ho, wo, Cin, kh, kw): a view; the reshape gathers the patches
    patches = y.unfold(2, kh, 1).unfold(3, kw, 1)
    patches = patches.reshape(units, batch, ho * wo, cin * kh * kw)
    kernel = w.permute(0, 3, 1, 2, 4).reshape(units, 1, cin * kh * kw, cout)
    # one product per (unit, sample): the kernel's gradient is then U·B
    # short products summed over B, not U products over B·ho·wo rows
    out = torch.matmul(patches, kernel) + b[:, None, None, :]
    return out.reshape(units, batch, ho, wo, cout)


def _avg_pool(y):
    """2×2 mean pool, stride 2, NHWC: (U, B, H, W, C) -> (U, B, H/2, W/2, C)."""
    u, b, h, w, c = y.shape
    return y.reshape(u, b, h // 2, 2, w // 2, 2, c).mean(dim=(3, 5))


def _dense(y, w, b):
    """y (U, B, in); w (U, in, out); b (U, out)."""
    return torch.baddbmm(b[:, None, :], y, w)


def apply_stacked(params: dict, x: torch.Tensor) -> torch.Tensor:
    """U models on their own inputs: x (U, B, H, W, C) -> logits (U, B, K)."""
    units, batch = x.shape[:2]
    y = _avg_pool(torch.tanh(_conv(x, params["c1_w"], params["c1_b"])))
    y = _avg_pool(torch.tanh(_conv(y, params["c2_w"], params["c2_b"])))
    y = y.reshape(units, batch, -1)  # NHWC flatten, as the reference's
    y = torch.tanh(_dense(y, params["f1_w"], params["f1_b"]))
    y = torch.tanh(_dense(y, params["f2_w"], params["f2_b"]))
    return _dense(y, params["f3_w"], params["f3_b"])


def apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """One model: x (batch, H, W, C) float32 -> logits (batch, num_classes)."""
    stacked = {k: v.unsqueeze(0) for k, v in params.items()}
    return apply_stacked(stacked, x.unsqueeze(0))[0]
