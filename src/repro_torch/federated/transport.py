"""Quantized wire transport (``FedConfig.transport``) over declared streams.

Every strategy declares a :class:`WireSchema`: named uplink and downlink
:class:`Stream` slices of the 128-aligned slab, each with its own coding
and its own slice of the direction's error-feedback (EF) accumulator.
:func:`make_wire_stage` builds the per-stream quantize→dequantize stage of
one direction; ``transport=None`` builds none, so every strategy keeps
its stage-free round, bit for bit.

Stream codings
--------------
  * ``"delta"`` — a per-receiver model or state delta: quantized int8 or
    fp8-e4m3 per chunk with error feedback (the only coding that owns EF
    state).
  * ``"raw"``   — never compressed: 4 B a coordinate on the wire and a
    pass-through in the stage (the receiver holds no shared reference to
    delta-code against).
  * ``"relay"`` — the receiver downloads a payload another hop already
    quantized (FedFomo's peers fetch the cohort's quantized uploads):
    priced at the compressed width, with no second stage.

The streams of each strategy (as each strategy declares them)
-------------------------------------------------------------
=============  ==============================  =============================
strategy       uplink streams                  downlink streams
=============  ==============================  =============================
fedavg         delta                           model: delta (server EF row)
fedprox        delta                           model: delta (server EF row)
local          delta                           — (no downlink)
oracle         delta                           group_models: raw
ucfl (full)    delta                           personalized: delta (a server
                                               EF row per client)
ucfl_k{k}      delta                           centroids: raw
scaffold       delta + control_delta           model: delta, control: delta
                                               (one shared server EF row)
ditto          delta (the global model's;      model: delta (server EF row)
               the personal model never
               leaves the client)
pfedme         delta (of w)                    average: raw
fedfomo        delta                           peer_models: relay
cfl            delta (the split statistics     cluster_models: raw
               read the dequantized deltas)
=============  ==============================  =============================

Error feedback: each direction keeps one f32 accumulator spanning the
concatenated aligned stream widths: ``(m, Σ width_aligned)`` a client on
the uplink, ``(1, Σ)`` (broadcast) or ``(m, Σ)`` (one row a receiver) on
the server for the downlink. A round quantizes ``delta + ef`` per stream
and carries each stream's residual forward, so on a constant delta the
applied values telescope to the truth within one quantization step, per
stream.

Wire format: a ``delta`` (or ``relay``) stream ships ``width`` payload
bytes (1 B a coordinate, int8 and fp8 alike) plus one f32 scale a
``chunk`` coordinates, ``width + 4·ceil(width/chunk)`` against
``4·width`` raw; :func:`repro_torch.core.comm_model.wire_bytes` prices it.

The stage is plain torch tensor ops on the tensors' device: 15 launches a
stream in int8, 13 in fp8. On the CPU it gives the reference's bits:
the same ops in the same order, with round-half-even and a division by a
tensor (a CUDA division by a Python scalar multiplies by its reciprocal,
which can move the last bit).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.ops import aligned_dim

_QMAX = {"int8": 127.0, "fp8": 448.0}  # fp8 = the e4m3fn finite max

_CODINGS = ("delta", "raw", "relay")


@dataclasses.dataclass(frozen=True)
class TransportConfig:
    """Wire compression knobs (both directions share one config).

    kind: ``"int8"`` (symmetric round-to-nearest-even) or ``"fp8"``
      (an e4m3fn cast, each chunk rescaled to the e4m3 range).
    chunk: coordinates sharing one f32 scale. Must divide every
      ``delta`` stream's aligned slab width; the default 128 equals the
      slab alignment (``ops.ALIGN``), so any stream chunks evenly.
    """

    kind: str = "int8"
    chunk: int = 128

    def __post_init__(self):
        if self.kind not in _QMAX:
            raise ValueError(
                f"TransportConfig.kind must be one of {sorted(_QMAX)}, got {self.kind!r}",
            )
        if int(self.chunk) <= 0:
            raise ValueError("TransportConfig.chunk must be positive")


@dataclasses.dataclass(frozen=True)
class Stream:
    """One named slice of a direction's wire slab.

    width: the TRUE coordinate count (what the wire prices); the slab
      slice is the 128-aligned ``width_aligned``, whose zero tail
      quantizes to exact zeros.
    coding: ``"delta"``, ``"raw"`` or ``"relay"`` (module docstring).
    """

    name: str
    width: int
    coding: str = "delta"

    def __post_init__(self):
        if self.coding not in _CODINGS:
            raise ValueError(
                f"Stream.coding must be one of {_CODINGS}, got {self.coding!r}",
            )
        if int(self.width) < 0:
            raise ValueError(f"Stream.width must be >= 0, got {self.width}")

    @property
    def width_aligned(self) -> int:
        return aligned_dim(int(self.width)) if self.width else 0


@dataclasses.dataclass(frozen=True)
class WireSchema:
    """A strategy's declared wire layout (see the module docstring)."""

    strategy: str
    uplink: tuple = ()
    downlink: tuple = ()

    def streams(self, direction: str) -> tuple:
        if direction not in ("uplink", "downlink"):
            raise ValueError(f"unknown wire direction {direction!r}")
        return self.uplink if direction == "uplink" else self.downlink

    def width(self, direction: str) -> int:
        """TRUE coordinate count of the direction's concatenated streams."""
        return sum(int(s.width) for s in self.streams(direction))

    def width_aligned(self, direction: str) -> int:
        """Slab width of the direction's concatenated aligned slices."""
        return sum(s.width_aligned for s in self.streams(direction))

    def slices(self, direction: str) -> tuple:
        """(lo, hi) aligned-slab slice of each stream, in declaration order."""
        out, lo = [], 0
        for s in self.streams(direction):
            out.append((lo, lo + s.width_aligned))
            lo += s.width_aligned
        return tuple(out)


def single_delta_schema(strategy: str, dim: int, *, downlink=()) -> WireSchema:
    """The common one-uplink-delta schema (the FedAvg family, ucfl, ...)."""
    return WireSchema(
        strategy,
        uplink=(Stream("delta", dim),),
        downlink=downlink,
    )


def unsupported(transport, strategy: str, why: str):
    """The construction-time error of a strategy that declares no
    :class:`WireSchema` (``ucfl_parallel`` in the reference); no error
    when ``transport`` is None."""
    if transport is not None:
        raise NotImplementedError(
            f"FedConfig.transport is not supported by {strategy}: {why} — "
            "this strategy declares no WireSchema (see the per-strategy "
            "stream/capability matrix in repro_torch/federated/transport.py)"
        )


def quantize(x, cfg: TransportConfig):
    """(…, d) f32 -> (q, scale): q (…, d/chunk, chunk) in the wire dtype
    (int8 or float8_e4m3fn), scale (…, d/chunk, 1) f32 per chunk."""
    d = x.shape[-1]
    chunk = int(cfg.chunk)
    if d % chunk:
        msg = f"transport chunk {chunk} does not divide the slab width {d}"
        raise ValueError(msg + " (the aligned slab always chunks evenly at chunk=128)")
    xs = x.reshape(tuple(x.shape[:-1]) + (d // chunk, chunk))
    qmax = torch.full((), _QMAX[cfg.kind], dtype=torch.float32, device=x.device)
    scale = torch.amax(torch.abs(xs), dim=-1, keepdim=True) / qmax
    # all-zero chunks (e.g. the slab's aligned tail) quantize to exact 0
    scale = torch.clamp_min(scale, torch.finfo(torch.float32).tiny)
    if cfg.kind == "int8":
        q = torch.clamp(torch.round(xs / scale), -127.0, 127.0).to(torch.int8)
    else:  # fp8
        q = (xs / scale).to(torch.float8_e4m3fn)
    return q, scale


def dequantize(q, scale):
    """Inverse of :func:`quantize` up to the quantization error."""
    xs = q.to(torch.float32) * scale
    return xs.reshape(tuple(xs.shape[:-2]) + (xs.shape[-2] * xs.shape[-1],))


def roundtrip(x, cfg: TransportConfig):
    """What the receiver decodes from payload ``x``."""
    return dequantize(*quantize(x, cfg))


def _check_transport(transport):
    if not isinstance(transport, TransportConfig):
        got = type(transport).__name__
        raise TypeError(f"FedConfig.transport must be a TransportConfig or None, got {got}")


def make_stage(transport):
    """The single-slab transport stage, or ``None`` when off.

    ``stage(pre, post, ef) -> (post', ef')`` over (rows, d) slabs:
    quantize ``(post - pre) + ef`` as the wire delta, reconstruct
    ``post' = pre + dequant`` (what the receiver decodes), and carry the
    residual in ``ef'``.
    """
    if transport is None:
        return None
    _check_transport(transport)

    def stage(pre, post, ef):
        carry = (post - pre) + ef
        deq = roundtrip(carry, transport)
        return pre + deq, carry - deq

    return stage


def make_wire_stage(schema: WireSchema, transport, direction: str = "uplink"):
    """One direction's per-stream transport stage, or ``None``.

    ``None`` when ``transport`` is off, or when the direction declares no
    ``delta`` stream (nothing to quantize: a raw or relay direction keeps
    its stage-free round).

    The returned ``stage(pre, post, ef) -> (post', ef')`` runs on the
    direction's CONCATENATED wire slab, ``(rows,
    schema.width_aligned(direction))``, and applies, per stream slice:
    ``delta`` → the quantize→dequantize→EF fold of :func:`make_stage`;
    ``raw``/``relay`` → pass-through, with a zero EF slice. A chunk that
    does not divide a ``delta`` stream's aligned width raises here, at
    construction, naming the strategy, the stream and the widths. A
    single-stream schema's stage is :func:`make_stage`'s.
    """
    if transport is None:
        return None
    _check_transport(transport)
    streams = schema.streams(direction)
    chunk = int(transport.chunk)
    for s in streams:
        if s.coding == "delta" and s.width_aligned % chunk:
            raise ValueError(
                f"TransportConfig.chunk={chunk} does not divide the "
                f"{schema.strategy!r} {direction} stream {s.name!r}: "
                f"width {s.width} aligns to a {s.width_aligned}-wide slab "
                f"slice ({schema.strategy} {direction} wire is "
                f"{schema.width_aligned(direction)} wide) — pick a chunk "
                "dividing the aligned stream width (128 always does)"
            )
    if not any(s.coding == "delta" for s in streams):
        return None
    slices = schema.slices(direction)
    if len(streams) == 1:
        return make_stage(transport)

    def stage(pre, post, ef):
        outs, efs = [], []
        for s, (lo, hi) in zip(streams, slices):
            p, q, e = pre[..., lo:hi], post[..., lo:hi], ef[..., lo:hi]
            if s.coding == "delta" and hi > lo:
                carry = (q - p) + e
                deq = roundtrip(carry, transport)
                outs.append(p + deq)
                efs.append(carry - deq)
            else:
                outs.append(q)
                efs.append(torch.zeros_like(e))
        return torch.cat(outs, dim=-1), torch.cat(efs, dim=-1)

    return stage
