"""Msgpack checkpoints of trees of tensors (``repro.checkpoint.io``).

The file is the reference's: a msgpack map ``{"treedef": str, "leaves":
[...]}`` whose leaves are ``{b"__nd__": True, b"dtype": str, b"shape":
[...], b"data": bytes}`` records (C order, little-endian, the dtype's
numpy name, bfloat16 as "bfloat16"), in the order in which ``jax.tree``
flattens the tree (:func:`repro_torch.core.pytree.leaves`: dict keys
sorted at every level, lists and tuples in order, ``None`` and empty
containers holding no leaf). So either package
reads the other's files. Python numbers and 0-d tensors are saved as 0-d
arrays. The msgpack is :mod:`repro_torch.checkpoint._msgpack`; the
``msgpack`` package is not needed.

Crash safety: :func:`save` is atomic. The payload goes to a uniquely named
temp file in the target directory, flushed and fsynced, then ``os.replace``
puts it over the destination (POSIX rename is atomic), and the directory
entry itself is fsynced. A run killed at any point leaves either the
previous complete checkpoint or the new one, at worst with an orphaned
``.tmp.*`` file beside it, which :func:`restore` never reads.
"""
from __future__ import annotations

import os
import uuid

import numpy as np
import torch

from repro_torch.checkpoint import _msgpack
from repro_torch.core import pytree
from repro_torch.federated import mesh as mesh_lib

# torch dtype -> the numpy name the file records
_NAMES = {torch.float32: "float32", torch.float64: "float64", torch.float16: "float16",
          torch.bfloat16: "bfloat16", torch.int8: "int8", torch.int16: "int16",
          torch.int32: "int32", torch.int64: "int64", torch.uint8: "uint8", torch.bool: "bool"}
_TORCH = {v: k for k, v in _NAMES.items()}


def _record(leaf) -> dict:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        if t.dtype not in _NAMES:
            raise TypeError(f"checkpoint: no file dtype for {t.dtype}")
        name, shape = _NAMES[t.dtype], list(t.shape)
        raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        data = raw.numpy().tobytes()
    else:
        a = np.asarray(leaf)
        name, shape, data = str(a.dtype), [int(s) for s in a.shape], a.tobytes(order="C")
    return {b"__nd__": True, b"dtype": name, b"shape": shape, b"data": data}


def save(path: str, tree) -> None:
    """Write ``tree`` to ``path`` atomically. A row-sharded state
    (``FedConfig.shard_state``, marked ``mesh.ROW_KEY``) is gathered first
    (every rank of its mesh calls ``save``): its slabs' blocks are
    all-gathered in rank order, rank 0 writes the whole state without the
    mark, the file the replicated run writes, and every rank waits for it
    on a barrier."""
    rows = mesh_lib.row_mesh(tree)
    if rows is not None:
        whole = mesh_lib.gather_state(tree)
        if rows.rank == 0:
            _write(path, whole)
        del whole
        mesh_lib.barrier(rows)
        return
    _write(path, tree)


def _write(path: str, tree) -> None:
    # the structure, "*" for a leaf (neither package reads it back)
    flat = pytree.leaves(tree)
    treedef = f"PyTreeDef({pytree.unflatten(tree, ['*'] * len(flat))!r})"
    payload = {"treedef": treedef, "leaves": [_record(x) for x in flat]}
    # a unique temp name: two concurrent savers (or a crashed one's
    # leftover) never clobber each other's half-written payload
    tmp = f"{path}.tmp.{os.getpid()}.{uuid.uuid4().hex[:8]}"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    try:
        with open(tmp, "wb") as f:
            f.write(_msgpack.packb(payload))
            f.flush()
            os.fsync(f.fileno())  # the data is durable BEFORE the rename
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    # fsync the directory, so that the rename itself survives a power cut
    dirfd = os.open(os.path.dirname(os.path.abspath(path)), os.O_RDONLY)
    try:
        os.fsync(dirfd)
    finally:
        os.close(dirfd)


def _decode(obj):
    if isinstance(obj, dict) and obj.get(b"__nd__"):
        name = obj[b"dtype"]
        return (name.decode() if isinstance(name, bytes) else name, tuple(obj[b"shape"]),
                obj[b"data"])
    return obj


def _leaf(record, like):
    """One saved leaf in ``like``'s type: a tensor on like's device in
    like's dtype, a numpy array in like's dtype, or a Python number."""
    name, shape, data = record
    if isinstance(like, torch.Tensor):
        if name == "bfloat16":
            t = torch.frombuffer(bytearray(data), dtype=torch.bfloat16)
        elif name in _TORCH:
            t = torch.from_numpy(np.frombuffer(data, dtype=np.dtype(name)).copy())
        else:
            raise TypeError(f"checkpoint: no tensor dtype for the file's {name!r}")
        return t.reshape(shape).to(device=like.device, dtype=like.dtype)
    if name == "bfloat16":  # numpy names it through ml_dtypes only
        t = torch.frombuffer(bytearray(data), dtype=torch.bfloat16).float()
        a = t.numpy().reshape(shape)
    else:
        a = np.frombuffer(data, dtype=np.dtype(name)).reshape(shape)
    if isinstance(like, np.ndarray):
        return a.astype(like.dtype)
    return type(like)(a.item())


def restore(path: str, like):
    """Restore into the structure of ``like``: its leaf count and every
    leaf's shape must match the file (ValueError), and each leaf comes
    back as ``like``'s does (a tensor on its device in its dtype). A
    row-sharded ``like`` reads the whole state's file and keeps this
    rank's block of each of its slabs (``mesh.commit_state``), marked as
    ``like``."""
    if mesh_lib.row_mesh(like) is not None:
        return mesh_lib.commit_state(restore(path, mesh_lib.whole_like(like)), like)
    with open(path, "rb") as f:
        payload = _msgpack.unpackb(f.read(), object_hook=_decode)
    want = pytree.leaves(like)
    saved = payload["leaves"]
    if len(saved) != len(want):
        raise ValueError(f"checkpoint has {len(saved)} leaves, expected {len(want)}")
    out = []
    for rec, leaf in zip(saved, want):
        if tuple(rec[1]) != tuple(np.shape(leaf)):
            raise ValueError(f"shape mismatch {tuple(rec[1])} vs {tuple(np.shape(leaf))}")
        out.append(_leaf(rec, leaf))
    return pytree.unflatten(like, out)
