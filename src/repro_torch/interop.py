"""Carry arrays over from the reference package, as numpy only.

The converters take numpy arrays (``np.asarray`` of the reference's jax
arrays), so the parity tests can run the two packages on the same weights
and data without this package importing ``jax``. The state converter
(:func:`state_to_reference`, :func:`state_from_reference`) carries a
strategy state across the packages' checkpoint files, where the two hold
some buffers at other shapes.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.data.synthetic import FederatedData
from repro_torch.device import resolve_device
from repro_torch.federated import mesh as mesh_lib


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


def _tensor(a, dev) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: carry the bits over
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()).view(
            torch.bfloat16).to(dev)
    return torch.as_tensor(np.array(a), device=dev)


def transformer_params_from_numpy(tree: dict, *, device=None) -> dict:
    """A nested dict of numpy arrays (a reference transformer's params:
    stacked blocks, and a leading client axis where there is one) -> the
    same nested dict of tensors, each leaf's dtype kept: bfloat16, and the
    f32 leaves of a bf16 tree (the MoE router, the SSM's A_log, D and
    dt_bias)."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _tensor(node, dev)

    return conv(tree)


def cache_from_numpy(tree: dict, *, device=None) -> dict:
    """A reference cache tree of numpy arrays -> tensors, for decode
    parity: ``{"blocks": {"l{i}": ...}}`` with an attention slot's k, v and
    pos, a mamba slot's h (f32) and conv, and ``first_block``'s k, v and
    pos where there is one; whisper's ``{"self": {"k", "v", "pos"},
    "cross_kv"}`` as it is."""
    return transformer_params_from_numpy(tree, device=device)


# ------------------------------------------------- strategy state converter
def state_to_reference(state: dict, dim: int) -> dict:
    """A port strategy state in the reference's shapes (ROADMAP C2), the
    tensors kept (views, no copy): the refresh direction buffer's first
    ``dim`` columns (the port's is slab-wide, (m, dim_aligned)), the async
    buffer's ``upd`` without its spare row ((B + 1, W) in the port), and no
    ``labels_host`` (a host copy of ``labels`` the reference does not
    keep). Saved with :func:`repro_torch.checkpoint.save`, it is the file
    the reference's ``restore`` reads into its own state; as ``like`` of
    ``restore``, it reads a file the reference wrote. A row-sharded state
    (``FedConfig.shard_state``) is gathered first, on every rank of its
    mesh (``mesh.gather_state``): the whole state, as the replicated run
    holds it."""
    state = mesh_lib.gather_state(state)
    out = dict(state)
    if state.get("refresh") is not None:
        out["refresh"] = dict(state["refresh"], grads=state["refresh"]["grads"][:, :dim])
    if state.get("abuf") is not None:
        out["abuf"] = dict(state["abuf"], upd=state["abuf"]["upd"][:-1])
    if "labels_host" in state:
        out["labels_host"] = None
    return out


def state_from_reference(tree: dict, like: dict) -> dict:
    """A state in the reference's shapes (restored into
    ``state_to_reference(like, dim)``) as the port holds it, shaped as
    ``like``: the refresh directions zero-padded to the slab width, a zero
    spare row under ``upd`` and ``labels_host`` copied from ``labels``.
    The dtypes are ``tree``'s (``restore`` gives ``like``'s)."""
    out = dict(tree)
    if like.get("refresh") is not None:
        g = tree["refresh"]["grads"]
        width = like["refresh"]["grads"].shape[1]
        out["refresh"] = dict(tree["refresh"], grads=torch.nn.functional.pad(
            g, (0, width - g.shape[1])))
    if like.get("abuf") is not None:
        upd = tree["abuf"]["upd"]
        out["abuf"] = dict(tree["abuf"], upd=torch.cat([upd, upd.new_zeros((1,) + upd.shape[1:])]))
    if like.get("labels_host") is not None:
        out["labels_host"] = tree["labels"].cpu().numpy()
    return out
