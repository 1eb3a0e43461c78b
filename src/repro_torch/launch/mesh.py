"""Rank meshes over ``torch.distributed`` (``repro.launch.mesh``).

A mesh names the axes of the default process group's ranks, laid out
row-major as ``jax.make_mesh`` lays out devices: with axes ("data",
"model") of sizes (D, M), rank r sits at data r // M, model r % M. Axis
semantics are the reference's:

  * "model" — tensor parallelism inside one federated client (the MoE
    experts' d_ff);
  * "data"  — the FL client axis: one slice per client (the MoE experts
    under expert parallelism);
  * "pod"   — a second pod; pod × data enumerates the clients.

Every rank runs the same host program (SPMD). A :class:`RankMesh` holds,
for each axis, the ranks that share every other coordinate with this rank
as a :class:`repro_torch.federated.mesh.ClientMesh` (its process group,
this rank's coordinate and the axis size), so the client mesh's
collectives (``all_to_all``, ``axis_sum``, ``axis_mean``,
``all_gather_rows``, ...) run on one axis. Building a mesh of more than
one rank creates one ``dist.new_group`` per axis slice, which every rank
of the default group calls in the same order. A mesh of one rank needs no
process group: its collectives are the identity. An axis of size 1 has no
group either. :func:`make_dry_mesh` gives a rank's view of a mesh with no
process group at all, for counting a step on the meta device
(:mod:`repro_torch.launch.dryrun`).
"""
from __future__ import annotations

import dataclasses
import itertools
import math

import torch.distributed as dist

from repro_torch.federated.mesh import ClientMesh, DryGroup


@dataclasses.dataclass(frozen=True, eq=False)
class RankMesh:
    """This rank's view of an N-D mesh: the axis names and sizes
    (``shape``, as ``jax.sharding.Mesh.shape``), its coordinates and each
    axis's 1-D view (:meth:`axis`)."""

    axis_names: tuple
    shape: dict
    coords: dict
    axes: dict  # name -> ClientMesh over this rank's slice of the axis
    rank: int

    def axis(self, name: str) -> ClientMesh:
        """The 1-D mesh of the ranks that differ from this one only along
        ``name``: their group (None at size 1), this rank's coordinate on
        it and its size."""
        return self.axes[name]

    def clients(self) -> ClientMesh:
        """The 1-D mesh of the client axes (:func:`client_axes`: "data", or
        "pod" and "data" together, pod-major), this rank's client index on
        it: the ranks that hold the other clients at this rank's model
        coordinate."""
        return self.axes[_CLIENTS]

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


_CLIENTS = "clients"  # the joint (pod, data) view's key in RankMesh.axes


def _slices(shape, names, strides, along):
    """Every slice of the mesh along the axes ``along`` (the ranks that
    share every other coordinate), each as its ranks in row-major order."""
    fixed_names = [nm for nm in names if nm not in along]
    along_sizes = [shape[names.index(nm)] for nm in along]
    for fixed in itertools.product(*(range(shape[names.index(nm)]) for nm in fixed_names)):
        base = sum(c * strides[nm] for nm, c in zip(fixed_names, fixed))
        yield [base + sum(c * strides[nm] for nm, c in zip(along, cs))
               for cs in itertools.product(*(range(n) for n in along_sizes))]


def _view(shape, names, strides, along, rank, coords, dry=False):
    """The ClientMesh of this rank's slice along ``along``: one
    ``dist.new_group`` per slice, created in the same order on every rank
    (None where the slice holds one rank; a :class:`DryGroup` of the
    slice's size on a dry mesh)."""
    size = math.prod(shape[names.index(nm)] for nm in along)
    group = None
    if size > 1 and dry:
        group = DryGroup(size)
    elif size > 1:
        for ranks in _slices(shape, names, strides, along):
            g = dist.new_group(ranks)
            if rank in ranks:
                group = g
    index = 0
    for nm in along:
        index = index * shape[names.index(nm)] + coords[nm]
    return ClientMesh(group, index, size)


def _world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(shape, axis_names) -> RankMesh:
    """A mesh of ``shape`` over the default group, ranks row-major. Every
    rank of the group must belong to it (``ValueError`` otherwise: a rank
    outside the mesh would have no coordinates in an SPMD program); a mesh
    of one rank needs no group."""
    shape = tuple(int(s) for s in shape)
    names = tuple(axis_names)
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} and axes {names} differ in length")
    world, rank = _world()
    size = math.prod(shape)
    if size != world:
        raise ValueError(f"a {' x '.join(map(str, shape))} mesh has {size} ranks, the process "
                         f"group {world}: every rank of the group must be one mesh position")
    return _mesh(shape, names, rank)


def make_dry_mesh(shape, axis_names, rank: int = 0) -> RankMesh:
    """Rank ``rank``'s view of a mesh of ``shape`` with no process group:
    every axis slice of more than one rank holds a
    :class:`repro_torch.federated.mesh.DryGroup`, whose collectives return
    meta tensors of the real results' shapes and record themselves in the
    active :func:`repro_torch.launch.op_analysis.counting`. For counting one
    rank's step on the meta device (:mod:`repro_torch.launch.dryrun`)."""
    shape = tuple(int(s) for s in shape)
    names = tuple(axis_names)
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} and axes {names} differ in length")
    if not 0 <= rank < math.prod(shape):
        raise ValueError(f"rank {rank} is outside a {' x '.join(map(str, shape))} mesh")
    return _mesh(shape, names, rank, dry=True)


def _mesh(shape, names, rank, dry=False) -> RankMesh:
    coords = {}
    rest = rank
    for name, n in reversed(list(zip(names, shape))):
        coords[name] = rest % n
        rest //= n
    coords = {name: coords[name] for name in names}
    strides = {name: math.prod(shape[i + 1:]) for i, name in enumerate(names)}
    axes = {name: _view(shape, names, strides, (name,), rank, coords, dry) for name in names}
    along = tuple(a for a in ("pod", "data") if a in names)
    axes[_CLIENTS] = (_view(shape, names, strides, along, rank, coords, dry) if len(along) > 1
                      else axes[along[0]] if along else ClientMesh(None, 0, 1))
    return RankMesh(names, dict(zip(names, shape)), coords, axes, rank)


def make_production_mesh(*, multi_pod: bool = False, dry: bool = False) -> RankMesh:
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data", "model"):
    needs a process group of 256 or 512 ranks (``ValueError`` otherwise);
    ``dry`` gives rank 0's view with no process group
    (:func:`make_dry_mesh`)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_dry_mesh(shape, axes) if dry else make_mesh(shape, axes)


def make_host_mesh(*, data: int = 1, model: int = 1) -> RankMesh:
    """A small ("data", "model") mesh clamped to the world size as the
    reference clamps it to its devices: data ≤ world, model ≤ world // data."""
    n, _ = _world()
    data = min(data, n)
    model = max(min(model, n // data), 1)
    return make_mesh((data, model), ("data", "model"))


def client_axes(mesh) -> tuple:
    """Mesh axes that enumerate federated clients."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def num_clients(mesh) -> int:
    return math.prod(mesh.shape[a] for a in client_axes(mesh))


def num_chips(mesh) -> int:
    return math.prod(mesh.shape[a] for a in mesh.axis_names)
