"""Carry arrays over from the reference package, as numpy only.

Both converters take numpy arrays (``np.asarray`` of the reference's jax
arrays), so the parity tests can run the two packages on the same weights
and data without this package importing ``jax``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.data.synthetic import FederatedData
from repro_torch.device import resolve_device


def params_from_numpy(tree: dict, *, device=None) -> dict:
    """A flat dict of numpy arrays (e.g. a LeNet params tree) -> tensors."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.array(v), device=dev)
            for k, v in tree.items()}


def data_from_numpy(x, y, x_test, y_test, group, n, *, device=None) -> FederatedData:
    """The six arrays of a reference ``FederatedData`` -> the port's.

    Images stay float32 NHWC; labels, groups and sizes become int64 (torch
    indexes and takes cross-entropy targets as int64).
    """
    dev = resolve_device(device)

    def f32(a):
        return torch.as_tensor(np.array(a, np.float32), device=dev)

    def i64(a):
        return torch.as_tensor(np.array(a, np.int64), device=dev)

    return FederatedData(f32(x), i64(y), f32(x_test), i64(y_test), i64(group), i64(n))
