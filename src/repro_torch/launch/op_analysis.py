"""Op counts of a step on the ``meta`` device: the port's counterpart of
``repro.launch.hlo_analysis``.

The reference parses XLA's partitioned HLO text with trip counts. There is
no HLO in torch. Here the port's own step runs once on ``meta`` tensors
under :class:`Counter`, a ``TorchDispatchMode``: nothing is allocated and
nothing computes, and every aten op that the step dispatches passes
through the mode with its shapes and dtypes. Per rank it counts:

  * ``dot_flops`` — matmul and convolution FLOPs, 2 · prod(result) ·
    prod(contracted dims) (``torch.utils.flop_counter``'s formulas, so
    ``FlopCounterMode`` gives the same count for the same step on the
    card), by the operands' dtype (``flops_by_kind``), plus each
    hand-written kernel's FLOPs;
  * ``hbm_bytes`` — operand + result bytes of every aten op that is not a
    view. This is an unfused upper bound: eager PyTorch runs each op as a
    kernel of its own, so it is the traffic when nothing stays in L2. Plus
    each kernel call's bytes from its work function
    (:mod:`repro_torch.launch.roofline`: each input read once, each output
    written once) and each collective's result;
  * ``kernel_calls`` — the calls of each hand-written kernel, under the
    name of the launch counter its wrapper adds one to on the card
    (``gram``, ``mix_aggregate``, ``kmeans_assign``, ``cohort_gather``,
    ``masked_mix_scatter``, ``flash_attention_prefill`` (the tile),
    ``flash_attention_decode``, ``flash_attention_fma``). Every
    :mod:`repro_torch.kernels.ops` entry runs as it runs on the card,
    down to the ``*_cuda`` wrapper, which is replaced by a stand-in that
    counts one call by the kernel's work function and returns outputs of
    the kernel's shapes and layout. Nothing of the plain version runs, so a
    kernel's work reads the same whichever implementation computes it;
  * ``collectives`` — the calls of :mod:`repro_torch.federated.mesh` on a
    dry mesh (:func:`repro_torch.launch.mesh.make_dry_mesh`), by kind,
    result bytes and group size S, with the reference's ring accounting
    (``parse_collectives``): all-gather res·(S−1)/S, all-reduce
    2·res·(S−1)/S, all-to-all res·(S−1)/S;
  * live bytes: every storage from its first op to its last reference,
    with the step's arguments live from the start (``peak_bytes``).

Each aten op, kernel call and collective is also recorded by the
``repro_torch`` function that issued it (the nearest frame in the package)
for :mod:`repro_torch.launch.attribute`.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import sys
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

import repro_torch
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_route
from repro_torch.launch import roofline

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")
FLASH_COUNTERS = {"tc": "flash_attention_prefill", "decode": "flash_attention_decode",
                  "fma": "flash_attention_fma"}

_aten = torch.ops.aten
# shape and layout queries: no op runs (FlopCounterMode skips them too)
_QUERIES = {_aten.sym_is_contiguous.default, _aten.is_contiguous.default,
            _aten.is_contiguous.memory_format, _aten.is_strides_like_format.default,
            _aten.is_non_overlapping_and_dense.default, _aten.size.default,
            _aten.sym_size.default, _aten.stride.default, _aten.sym_stride.default,
            _aten.storage_offset.default, _aten.sym_storage_offset.default,
            _aten.numel.default, _aten.sym_numel.default, _aten.dim.default,
            torch.ops.prim.layout.default, torch.ops.prim.device.default}
# ops that allocate without moving data
_NO_BYTES = {_aten.empty.memory_format, _aten.empty_strided.default, _aten.empty_like.default,
             _aten.new_empty.default, _aten.new_empty_strided.default, _aten.lift_fresh.default}

_PKG = os.path.dirname(os.path.abspath(repro_torch.__file__)) + os.sep
_KERNELS = os.path.join(_PKG, "kernels") + os.sep
_SELF = os.path.abspath(__file__)

_ACTIVE: list = []


def current():
    """The innermost active :class:`Counter`, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def ring_moved(kind: str, result_bytes: float, size: int) -> float:
    """Bytes a rank moves for one collective of ``result_bytes`` per rank
    over a group of ``size`` (the reference's ``parse_collectives``)."""
    s = max(size, 1)
    if kind == "all-gather":
        return result_bytes * (s - 1) / s
    if kind == "all-reduce":
        return 2.0 * result_bytes * (s - 1) / s
    if kind == "reduce-scatter":
        return float(result_bytes) * (s - 1)
    if kind == "all-to-all":
        return result_bytes * (s - 1) / s
    return float(result_bytes)  # collective-permute


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from tensors(x)


def _issuer(skip_kernels: bool) -> str:
    """``module:function`` of the nearest ``repro_torch`` frame (outside
    this module, and outside ``kernels/`` when ``skip_kernels``)."""
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if fn.startswith(_PKG) and fn != _SELF and not (skip_kernels and fn.startswith(_KERNELS)):
            mod = fn[len(_PKG):-3].replace(os.sep, ".")
            return f"{mod}:{getattr(f.f_code, 'co_qualname', f.f_code.co_name)}"
        f = f.f_back
    return "(outside repro_torch)"


@dataclasses.dataclass
class Analysis:
    """One rank's counts of a step; the reference's field names where they
    have a meaning here (``dot_flops``, ``hbm_bytes``, ``collectives``,
    ``collective_bytes``)."""
    dot_flops: float = 0.0
    hbm_bytes: float = 0.0
    collectives: Dict[str, dict] = dataclasses.field(default_factory=lambda: {
        c: {"count": 0, "result_bytes": 0.0, "moved_bytes": 0.0} for c in COLLECTIVE_OPS})
    flops_by_kind: Dict[str, float] = dataclasses.field(default_factory=dict)
    aten_flops: float = 0.0  # the matmul and convolution FLOPs of aten ops alone
    kernel_calls: Dict[str, int] = dataclasses.field(default_factory=dict)
    kernel_flops: float = 0.0
    kernel_flops_full: float = 0.0  # attention's masked pairs counted too
    kernel_bytes: float = 0.0
    argument_bytes: int = 0
    peak_bytes: int = 0
    memory: dict = dataclasses.field(default_factory=dict)
    # (kind "aten" | "kernel" | "collective", op, issuer) -> [flops, bytes, count, moved]
    table: dict = dataclasses.field(default_factory=lambda: collections.defaultdict(
        lambda: [0.0, 0.0, 0, 0.0]))

    @property
    def collective_bytes(self) -> float:
        return sum(v["moved_bytes"] for v in self.collectives.values())

    @property
    def dot_flops_full(self) -> float:
        """``dot_flops`` with every attention call's masked pairs added back
        (the reference's ``_attend`` computes the full Sq × Sk products)."""
        return self.aten_flops + self.kernel_flops_full

    def op_rows(self):
        """The table as JSON-ready rows, largest FLOPs first."""
        rows = [dict(kind=k, op=op, issuer=who, flops=v[0], bytes=v[1], count=v[2],
                     moved_bytes=v[3]) for (k, op, who), v in self.table.items()]
        return sorted(rows, key=lambda r: (-r["flops"], -r["bytes"]))


class Counter(TorchDispatchMode):
    """The dispatch mode that counts a step run on meta tensors (see the
    module docstring); :func:`counting` activates it."""

    def __init__(self):
        super().__init__()
        self.analysis = Analysis()
        self._live = WeakIdKeyDictionary()
        self._bytes_live = 0
        self._open = False

    # ------------------------------------------------------------ memory
    def _free(self, n):
        if self._open:
            self._bytes_live -= n

    def _hold(self, t):
        st = t.untyped_storage()
        if st in self._live:
            return 0
        n = st.nbytes()
        self._live[st] = n
        weakref.finalize(st, self._free, n)
        self._bytes_live += n
        self.analysis.peak_bytes = max(self.analysis.peak_bytes, self._bytes_live)
        return n

    def track(self, tree) -> int:
        """Count the storages of ``tree``'s tensors as live (the step's
        arguments); returns their bytes, shared storages once."""
        n = sum(self._hold(t) for t in tensors(tree))
        self.analysis.argument_bytes += n
        return n

    def live_bytes(self) -> int:
        return self._bytes_live

    # ------------------------------------------------------------ aten ops
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _QUERIES:
            return func(*args, **kwargs)
        if func._overloadpacket not in flop_registry:
            with self:  # as FlopCounterMode: count what a composite decomposes to
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        a = self.analysis
        flops = 0.0
        if func._overloadpacket in flop_registry:
            flops = float(flop_registry[func._overloadpacket](*args, **kwargs, out_val=out))
            kind = str(next(tensors(args)).dtype).replace("torch.", "")
            a.flops_by_kind[kind] = a.flops_by_kind.get(kind, 0.0) + flops
            a.aten_flops += flops
            a.dot_flops += flops
        outs = list(tensors(out))
        nbytes = 0.0
        if not func.is_view and func not in _NO_BYTES:
            nbytes = float(sum(_nbytes(t) for t in tensors((args, kwargs)))
                           + sum(_nbytes(t) for t in outs))
            a.hbm_bytes += nbytes
        for t in outs:
            self._hold(t)
        rec = a.table["aten", str(func._overloadpacket).replace("aten.", ""), _issuer(False)]
        rec[0] += flops
        rec[1] += nbytes
        rec[2] += 1
        return out

    # ------------------------------------------------------------ kernels
    def kernel(self, counter: str, work: roofline.Work, outs):
        """One call of the kernel behind launch counter ``counter``."""
        a = self.analysis
        a.kernel_calls[counter] = a.kernel_calls.get(counter, 0) + 1
        a.kernel_flops += work.flops
        a.kernel_flops_full += work.flops if work.flops_full is None else work.flops_full
        a.kernel_bytes += work.bytes
        a.dot_flops += work.flops
        a.hbm_bytes += work.bytes
        a.flops_by_kind[work.kind] = a.flops_by_kind.get(work.kind, 0.0) + work.flops
        for t in tensors(outs):
            self._hold(t)
        rec = a.table["kernel", counter, _issuer(True)]
        rec[0] += work.flops
        rec[1] += work.bytes
        rec[2] += 1

    # ------------------------------------------------------------ collectives
    def collective(self, kind: str, out, size: int):
        """One collective of ``kind`` whose per-rank result is ``out`` over a
        group of ``size`` ranks."""
        a = self.analysis
        res = float(_nbytes(out))
        moved = ring_moved(kind, res, size)
        rec = a.collectives[kind]
        rec["count"] += 1
        rec["result_bytes"] += res
        rec["moved_bytes"] += moved
        a.hbm_bytes += res  # collective results also traverse HBM
        self._hold(out)
        row = a.table["collective", kind, _issuer(True)]
        row[1] += res
        row[2] += 1
        row[3] += moved


def record_collective(kind: str, out, size: int):
    """Called by :mod:`repro_torch.federated.mesh` for a collective on a dry
    mesh: records it in the active counter. Raises ``RuntimeError`` outside
    a counter or on tensors that are not meta (a dry mesh has no process to
    exchange with)."""
    c = current()
    if c is None or not out.is_meta:
        raise RuntimeError(f"a {kind} on a dry mesh runs only on meta tensors under "
                           "repro_torch.launch.op_analysis.Counter (a dry mesh has no "
                           "process group)")
    c.collective(kind, out, size)


# ------------------------------------------------------------ stand-ins
def _meta_impl(orig):
    def impl(impl, tensor):
        if tensor.is_meta and impl in (None, "cuda"):
            return "cuda"
        return orig(impl, tensor)
    return impl


def _meta(*ts):
    if not all(t.is_meta for t in ts):
        raise ValueError("op_analysis: a kernel stand-in got a tensor that is not on the meta "
                         "device")


def _new(shape, dtype, like):
    with _disable_current_modes():
        return torch.empty(shape, dtype=dtype, device=like.device)


def _gram(g):
    _meta(g)
    m, d = g.shape
    out = _new((m, m), torch.float32, g)
    if m and d:
        current().kernel("gram", roofline.gram_work(m, d, g.element_size()), out)
    return out


def _mix(w, theta):
    _meta(w, theta)
    (k, m), d = w.shape, theta.shape[1]
    out = _new((k, d), theta.dtype, theta)
    if k and d and m:
        current().kernel("mix_aggregate",
                         roofline.mix_aggregate_work(k, m, d, theta.element_size()), out)
    return out


def _kmeans(points, centroids):
    _meta(points, centroids)
    (m, f), k = points.shape, centroids.shape[0]
    labels, dist = _new((m,), torch.int32, points), _new((m,), torch.float32, points)
    if m:
        current().kernel("kmeans_assign", roofline.kmeans_assign_work(m, k, f), (labels, dist))
    return labels, dist


def _gather(full, idx):
    _meta(full, idx)
    c, d = idx.shape[0], full.shape[1]
    out = _new((c, d), torch.float32, full)
    if c and d:
        current().kernel("cohort_gather", roofline.cohort_gather_work(c, d), out)
    return out


def _scatter(w, theta, idx, mask, full):
    _meta(w, theta, idx, mask, full)
    c, d = w.shape[0], full.shape[1]
    if c and d:  # written in place, as the kernel writes it
        current().kernel("masked_mix_scatter", roofline.masked_mix_scatter_work(c, d), ())
    return full


def _flash(q, k, v, *, causal=True, window=None, softcap=None):
    _meta(q, k, v)
    b, hq, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    # the kernel's output: a (B, Hq, Sq, Dh) view over (B, Sq, Hq, Dh) memory
    out = _new((b, sq, hq, dh), q.dtype, q).transpose(1, 2)
    if b and hq and sq:
        current().kernel(FLASH_COUNTERS[flash_route(q, k, v)], roofline.flash_attention_work(
            b, hq, hkv, sq, sk, dh, causal, q.element_size()), out)
    return out


_STANDINS = {"gram_cuda": _gram, "mix_aggregate_cuda": _mix, "kmeans_assign_cuda": _kmeans,
             "cohort_gather_cuda": _gather, "masked_mix_scatter_cuda": _scatter,
             "flash_attention_cuda": _flash}


@contextlib.contextmanager
def counting():
    """``with counting() as c: c.track(args); out = step(*args)``: counts
    what the block dispatches on meta tensors into ``c.analysis``. While it
    is open, every ``kernels.ops`` entry called on meta tensors takes the
    card's route to a counting stand-in, and the collectives of a dry mesh
    record themselves in ``c``."""
    c = Counter()
    saved = {name: getattr(ops, name) for name in (*_STANDINS, "_impl")}
    for name, fn in _STANDINS.items():
        setattr(ops, name, fn)
    ops._impl = _meta_impl(saved["_impl"])
    _ACTIVE.append(c)
    c._open = True
    try:
        with c:
            yield c
    finally:
        c._open = False
        _ACTIVE.remove(c)
        for name, fn in saved.items():
            setattr(ops, name, fn)


def count(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), Analysis)`` of one call on meta tensors, the
    arguments' storages live from the start."""
    with counting() as c:
        c.track((args, kwargs))
        out = fn(*args, **kwargs)
    return out, c.analysis
