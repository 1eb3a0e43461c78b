"""Communication/straggler timing model of §V-D (numpy only, no torch).

Round time of a federated system with m clients served by m_t downlink
streams, parametrized by

  * ρ = T_ul / T_dl — UL/DL model-transmission-time asymmetry (base station
    transmits faster than edge devices; typical wireless ρ ∈ [2, 4]);
  * shifted-exponential per-client compute time
      P[T_i > t] = 1 − 1(t ≥ T_min)(1 − e^{−μ(t−T_min)}),
    whose m-way max has mean  T_comp = T_min + H_m / μ;
  * scheme — who transmits what:
      - "broadcast"      (FedAvg):        1 DL stream, m UL uploads
                                          (UL is parallel on orthogonal
                                          resources, so counted once);
      - "groupcast"      (clustered UCFL): m_t DL streams;
      - "unicast"        (full UCFL):      m DL streams;
      - "client_mixing"  (FedFomo):        every client downloads all m
                                           models ⇒ m DL streams *per
                                           client*; we charge m·T_dl like
                                           the paper's Fig. 5 does.

Partial participation: every cost function takes ``cohort_size`` (None =
full participation, the paper's regime). With a cohort of c clients the
straggler max runs over c compute times (H_c, not H_m), unicast needs c
streams, client mixing charges c downloads, and groupcast needs at most
min(m_t, c) distinct streams. This is what makes round cost O(cohort)
instead of O(m) on the wireless side.

Buffered-async rounds (``FedConfig.async_buffer``): the server applies
the pending uploads as soon as the K-th lands, so the wait term is the
K-th ORDER STATISTIC of the c shifted-exponential completion times —
``T_min + (H_c − H_{c−K})/μ`` in expectation — instead of the c-way max
``T_min + H_c/μ`` (:func:`expected_kth_compute_time`,
:func:`async_round_time`), and the downlink serves only the applied
batch. :func:`sample_arrival_times` draws per-client completion times
from the same shifted-exponential compute + ρ-asymmetric link model for
trace replays that want realized (not expected) arrivals.

Quantized wire transport (``FedConfig.transport``): a quantized stream
carries 1 B/param plus one float32 scale per chunk instead of 4 B/param.
Pricing is per STREAM via the strategy's declared wire schema
(:func:`wire_bytes` — duck-typed on ``.width``/``.coding`` so this
module stays numpy-only): ``delta`` and ``relay`` streams compress,
``raw`` streams ship 4 B/coordinate regardless of transport. Every
round-time/bytes function takes an optional ``schema``; the uplink AND
the downlink terms scale by the schema's compressed/raw byte ratio, so
a compressed broadcast (server-side EF) shrinks Tdl exactly like the
quantized upload shrinks Tul. ``schema=None`` prices the payload as one
single-delta model stream (``transport_ul_scale`` on the uplink, raw
downlink) — exactly what the deleted scalar ``transport_payload_bytes``
charged.

Per-tier link budgets (``SystemParams.tiers``, a :class:`TierParams`):
the two-tier topology (``FedConfig.topology``) splits every link price
into a client↔edge tier and an edge↔PS backhaul tier. The client↔edge
terms keep the flat ``t_dl``/``ρ·t_dl`` rates (edges are near the
clients); the backhaul adds ``backhaul_dl·t_dl`` per model transmission
(UL asymmetry ``backhaul_rho``), multiplied by a LOAD-DEPENDENT
congestion factor ``1 + congestion·(e_active − 1)`` on the PS links —
the more edges talk to the PS at once, the slower each PS link runs.
Only ``broadcast``/``groupcast`` schemes tier (per-client ``unicast`` /
``client_mixing`` mixes read every cohort column at the PS and do not
factorize over edge aggregates — they raise, matching the engine's
capability guard). The flat-equivalence contract, pinned by tests:
``tiers=None`` leaves every price byte-identical to the single-link
model, and so does the degenerate ``TierParams(backhaul_dl=0,
congestion=0)`` (a free backhaul collapses the two tiers into one).
What the topology buys is counted by :func:`ps_uplink_bytes_per_round` /
:func:`ps_downlink_bytes_per_round`: the PS-side backhaul carries
``e_active·k`` edge aggregates per round instead of ``c`` client
uploads.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


def harmonic(m: int) -> float:
    return sum(1.0 / i for i in range(1, m + 1))


@dataclasses.dataclass(frozen=True)
class _FallbackStream:
    """Duck-typed single-delta stream for schema-less byte pricing.

    ``width`` may be fractional (``model_bytes / 4`` for a payload that
    is not 4-byte aligned) so the raw price round-trips to exactly
    ``model_bytes``; declared :class:`~repro_torch.federated.transport.Stream`
    widths are always integers.
    """

    width: float
    coding: str = "delta"


@dataclasses.dataclass(frozen=True)
class _FallbackSchema:
    uplink: tuple
    downlink: tuple = ()


def _model_schema(model_bytes: int) -> _FallbackSchema:
    """Price a bare ``model_bytes`` payload as one delta model stream.

    Strategies without a declared wire schema upload exactly one model
    delta and download raw models, so the schema-less fallback is the
    single-stream schema with ``width = model_bytes/4`` float32
    coordinates (delta up, raw down) — :func:`wire_bytes` then
    reproduces the pre-schema scalar pricing exactly, including for
    payloads that are not 4-byte aligned (the width stays fractional and
    only the final byte total is ceiled).
    """
    w = int(model_bytes) / 4.0
    return _FallbackSchema(uplink=(_FallbackStream(w),),
                           downlink=(_FallbackStream(w, "raw"),))


def wire_bytes(schema, transport=None, direction: str = "uplink") -> int:
    """Bytes ONE transmission of a direction's declared streams costs.

    The ONE byte-pricing primitive (schema-less payloads route through
    it too, via :func:`_model_schema`): each stream of
    ``schema.uplink``/``schema.downlink`` is priced by its TRUE
    coordinate count and coding — ``raw`` streams (and every stream when
    ``transport`` is None) cost ``4·width`` (float32); quantized
    ``delta`` streams, and ``relay`` streams (whose payload some other
    hop already quantized), cost ``width + 4·ceil(width/chunk)``
    (1 B/coordinate + one f32 scale per chunk). Duck-typed on the
    stream's ``width``/``coding`` and the transport's ``chunk`` so this
    module stays numpy-only.

    A transmission is one emission of the direction's streams: per
    uploading client on the uplink; per downlink stream-slot (broadcast
    = 1, groupcast = m_t, unicast/client_mixing = per receiver) on the
    downlink — the scheme multiplicity lives in
    :func:`uplink_bytes_per_round` / :func:`downlink_bytes_per_round`.
    """
    streams = schema.uplink if direction == "uplink" else schema.downlink
    total = 0.0
    for s in streams:
        # declared Stream widths are ints; the schema-less fallback may
        # carry a fractional float32 width (unaligned model_bytes)
        w = s.width
        if transport is None or s.coding == "raw":
            total += 4 * w
        else:
            chunk = int(transport.chunk)
            if chunk <= 0:
                raise ValueError(
                    f"transport.chunk must be positive, got {chunk}")
            total += w + 4 * math.ceil(w / chunk)
    return int(math.ceil(total))


def _wire_scale(schema, transport, direction: str) -> float:
    """Compressed/raw byte ratio of a direction (1.0 when inapplicable)."""
    if schema is None:
        return transport_ul_scale(transport) if direction == "uplink" else 1.0
    raw = wire_bytes(schema, None, direction)
    if raw == 0:
        return 1.0
    return wire_bytes(schema, transport, direction) / raw


def transport_ul_scale(transport=None) -> float:
    """Multiplier on UL transmission time/bytes under ``transport``.

    ``(1 + 4/chunk) / 4`` — the asymptotic compressed/raw ratio of a
    quantized delta stream (exact when ``chunk`` divides the parameter
    count, which the slab layout's 128-lane alignment guarantees for
    the default chunk). ``None`` = 1.
    """
    if transport is None:
        return 1.0
    chunk = int(transport.chunk)
    if chunk <= 0:
        raise ValueError(f"transport.chunk must be positive, got {chunk}")
    return (1.0 + 4.0 / chunk) / 4.0


@dataclasses.dataclass(frozen=True)
class TierParams:
    """Edge↔PS backhaul budget for the two-tier topology.

    ``backhaul_dl`` is the PS→edge transmission time of one model in
    units of the client-tier ``t_dl`` (0 = free backhaul — the
    flat-equivalence degenerate); ``backhaul_rho`` the backhaul's UL/DL
    asymmetry (wired backhauls are usually symmetric, hence 1.0, unlike
    the wireless client tier's ρ≈4); ``congestion`` the load penalty γ —
    every PS link runs ``1 + γ·(e_active − 1)`` slower when ``e_active``
    edges transact simultaneously.
    """

    num_edges: int
    backhaul_dl: float = 0.25
    backhaul_rho: float = 1.0
    congestion: float = 0.0

    def __post_init__(self):
        if self.num_edges < 1:
            raise ValueError(f"num_edges must be >= 1, got {self.num_edges}")
        if self.backhaul_dl < 0 or self.backhaul_rho <= 0 or \
                self.congestion < 0:
            raise ValueError(
                "need backhaul_dl >= 0, backhaul_rho > 0, congestion >= 0; "
                f"got {self.backhaul_dl}, {self.backhaul_rho}, "
                f"{self.congestion}")


@dataclasses.dataclass(frozen=True)
class SystemParams:
    m: int  # number of clients
    rho: float = 4.0  # T_ul / T_dl
    t_dl: float = 1.0  # downlink transmission time of one model
    t_min: float = 1.0  # minimum compute time (in units of t_dl)
    inv_mu: float = 1.0  # mean extra straggler delay 1/μ (0 ⇒ reliable)
    tiers: TierParams | None = None  # edge↔PS budget; None = flat single-link


def _active(m: int, cohort_size: int | None) -> int:
    return m if cohort_size is None else max(1, min(cohort_size, m))


def _require_streams(num_streams, scheme: str) -> int:
    """Groupcast pricing is undefined without a stream count.

    A bare ``assert`` here would be stripped under ``python -O`` and the
    groupcast costs would silently misprice (``min(None, c)`` raising a
    TypeError at best) — this must stay a real runtime check.
    """
    if num_streams is None:
        raise ValueError(
            f"{scheme!r} pricing needs num_streams (the m_t downlink "
            "stream count); got None")
    return int(num_streams)


def _tier_streams(scheme: str, num_streams, served: int) -> int:
    """Downlink stream count k of a tiered round (broadcast/groupcast)."""
    if scheme == "broadcast":
        return 1
    if scheme == "groupcast":
        return min(_require_streams(num_streams, scheme), max(served, 1))
    raise ValueError(
        f"{scheme!r} does not tier: per-client unicast/client-mixing "
        "downlinks read every cohort column at the PS and cannot "
        "factorize over edge aggregates (SystemParams.tiers supports "
        "broadcast and groupcast schemes only — the same capability "
        "boundary as FedConfig.topology)")


def _tier_terms(p: SystemParams, scheme: str, num_streams, c: int,
                served: int, dl_scale: float, ul_scale: float):
    """(downlink, extra backhaul-uplink) time of a tiered round.

    The downlink is the PS→edge backhaul (k model streams, congested by
    the active-edge load) plus the edge→client last hop at the flat
    ``t_dl`` rate; the returned uplink term is the NEW edge→PS leg (k
    aggregates per edge link, congested) that rides on top of the flat
    client→edge upload. With ``backhaul_dl = 0`` both backhaul legs
    vanish and the round prices exactly like the flat single-link model
    — the flat-equivalence contract.
    """
    tiers = p.tiers
    e = min(tiers.num_edges, c)
    cf = 1.0 + tiers.congestion * max(e - 1, 0)
    t_bh = tiers.backhaul_dl * p.t_dl
    k = _tier_streams(scheme, num_streams, served)
    dl = k * (t_bh * cf + p.t_dl) * dl_scale
    ul_bh = k * tiers.backhaul_rho * t_bh * cf * ul_scale
    return dl, ul_bh


def expected_compute_time(p: SystemParams,
                          cohort_size: int | None = None) -> float:
    """E[max over the active clients] = T_min + H_c/μ for shifted exps."""
    if p.inv_mu == 0.0:
        return p.t_min
    return p.t_min + harmonic(_active(p.m, cohort_size)) * p.inv_mu


def round_time(p: SystemParams, scheme: str, num_streams: int | None = None,
               cohort_size: int | None = None, *,
               transport=None, schema=None) -> float:
    """Wall-clock time of one communication round under §V-D.

    ``cohort_size`` prices a partial-participation round: only the cohort
    computes (straggler max over c), and only the cohort is served on the
    downlink. ``transport`` (a quantized-wire config, None = raw f32)
    shrinks the UL transmission term — and, with ``schema`` (the
    strategy's wire schema), BOTH link terms by the per-direction
    compressed/raw byte ratio of :func:`wire_bytes`; ``schema=None``
    keeps the pre-schema pricing (UL by :func:`transport_ul_scale`,
    downlink full-precision). With ``p.tiers`` the link terms split into
    client↔edge + congested edge↔PS backhaul legs (see
    :func:`_tier_terms`); ``tiers=None`` is byte-identical to the flat
    single-link price.
    """
    c = _active(p.m, cohort_size)
    ul_scale = _wire_scale(schema, transport, "uplink")
    dl_scale = _wire_scale(schema, transport, "downlink")
    t_ul = p.rho * p.t_dl * ul_scale
    t_dl = p.t_dl * dl_scale
    t_comp = expected_compute_time(p, cohort_size)
    if p.tiers is not None:
        dl, ul_bh = _tier_terms(p, scheme, num_streams, c, c,
                                dl_scale, ul_scale)
        return dl + t_comp + t_ul + ul_bh
    if scheme == "broadcast":
        dl = t_dl
    elif scheme == "groupcast":
        dl = min(_require_streams(num_streams, scheme), c) * t_dl
    elif scheme == "unicast":
        dl = c * t_dl
    elif scheme == "client_mixing":  # FedFomo-style client-side aggregation
        dl = c * t_dl
    else:
        raise ValueError(f"unknown scheme {scheme!r}")
    return dl + t_comp + t_ul


def deadline_round_time(p: SystemParams, scheme: str,
                        num_streams: int | None = None,
                        cohort_size: int | None = None, *,
                        deadline: float = math.inf, compute=None,
                        transport=None, schema=None):
    """:func:`round_time` with a straggler deadline; returns the price
    AND who got cut.

    The fault model's timeout (``FaultConfig.deadline``) is a PRICING
    fault: a client whose compute time exceeds ``deadline`` is dropped
    from the round (its upload never lands — the device round sees it as
    a mid-round drop), and the server stops waiting at the deadline
    instead of the straggler max.

    Args:
      p / scheme / num_streams / cohort_size: as :func:`round_time`.
      deadline: compute-time ceiling, in the same units as ``t_min``
        (``inf`` = no timeouts — bit-identical to :func:`round_time`).
      compute: optional (c,) realized per-client compute times (e.g.
        from :func:`sample_arrival_times`'s compute term). ``None`` uses
        the deterministic expected order-statistic profile — client k's
        time is the expected k-th smallest of c shifted exponentials
        (``expected_kth_compute_time``), whose max (k = c) is EXACTLY
        the ``H_c`` straggler mean :func:`round_time` charges, giving
        the deadline=inf bit-identity the regression test pins.

    Returns:
      ``(time, dropped)`` — the §V-D round price and the (c,) bool mask
      of clients cut by the deadline (ordered by the order-statistic
      profile when ``compute`` is None). With every client cut, no
      upload lands and no downlink is served (the round degrades to
      skip-round semantics: deadline wait + nothing).
    """
    c = _active(p.m, cohort_size)
    if compute is None:
        compute = np.array([expected_kth_compute_time(p, k, cohort_size)
                            for k in range(1, c + 1)])
    else:
        compute = np.asarray(compute, float)
        c = compute.shape[0]
    dropped = compute > deadline
    survivors = int((~dropped).sum())
    ul_scale = _wire_scale(schema, transport, "uplink")
    dl_scale = _wire_scale(schema, transport, "downlink")
    t_ul = p.rho * p.t_dl * ul_scale
    t_dl = p.t_dl * dl_scale
    if survivors == 0:
        # everyone timed out: the server waits out the deadline (or the
        # fastest client under an infinite one) and serves nobody
        return float(min(deadline, compute.min())), dropped
    t_comp = float(deadline) if dropped.any() else float(compute.max())
    if p.tiers is not None:
        dl, ul_bh = _tier_terms(p, scheme, num_streams, c, survivors,
                                dl_scale, ul_scale)
        return dl + t_comp + t_ul + ul_bh, dropped
    if scheme == "broadcast":
        dl = t_dl
    elif scheme == "groupcast":
        dl = min(_require_streams(num_streams, scheme), survivors) * t_dl
    elif scheme in ("unicast", "client_mixing"):
        dl = survivors * t_dl
    else:
        raise ValueError(f"unknown scheme {scheme!r}")
    return dl + t_comp + t_ul, dropped


def sample_arrival_times(p: SystemParams, rng, cohort_size: int | None = None):
    """Draw per-client upload completion times for one round.

    Each active client downloads (``t_dl``), computes for a
    shifted-exponential ``T_min + Exp(1/μ)``, and uploads over the
    ρ-asymmetric link (``ρ·t_dl``); the returned (c,) array is when each
    upload lands at the PS. A buffered-async server flushes at the K-th
    smallest of these; the bulk-synchronous barrier waits for the max.

    Args:
      p: §V-D system parameters.
      rng: ``numpy.random.Generator``.
      cohort_size: active clients this round (None = all m).
    """
    c = _active(p.m, cohort_size)
    compute = np.full(c, p.t_min, float)
    if p.inv_mu > 0.0:
        compute = compute + rng.exponential(p.inv_mu, size=c)
    return p.t_dl + compute + p.rho * p.t_dl


def expected_kth_compute_time(p: SystemParams, k: int,
                              cohort_size: int | None = None) -> float:
    """E[k-th order statistic of the active clients' compute times].

    For c iid shifted exponentials the k-th smallest has mean
    ``T_min + (H_c − H_{c−k})/μ`` (partial sums of the exponential
    spacings); ``k = c`` recovers :func:`expected_compute_time`'s
    straggler max ``T_min + H_c/μ``.
    """
    c = _active(p.m, cohort_size)
    k = max(1, min(int(k), c))
    if p.inv_mu == 0.0:
        return p.t_min
    tail = harmonic(c - k) if k < c else 0.0
    return p.t_min + (harmonic(c) - tail) * p.inv_mu


def async_round_time(p: SystemParams, scheme: str,
                     num_streams: int | None = None,
                     cohort_size: int | None = None, *, flush_k: int,
                     applied: int | None = None,
                     transport=None, schema=None) -> float:
    """Wall-clock §V-D price of one buffered-async round.

    Same ``dl + compute + ul`` structure as :func:`round_time`, with two
    substitutions: the server stops waiting at the ``flush_k``-th
    arrival (the K-th order statistic of the c active compute times, not
    the straggler max), and the downlink serves only the APPLIED batch:

      * ``applied`` is how many uploads the flush shipped back (the
        buffer may hold more than K when earlier rounds deposited
        without flushing); ``None`` means exactly the flush threshold.
      * ``applied=0`` prices a deposit-only round: nothing is served
        (dl = 0) but the round still spans the arrivals it banked — the
        full c-way max, like a barrier round without its downlink.
      * ``flush_k >= c`` with ``applied = c`` degrades to
        :func:`round_time` exactly, so async pricing is never optimistic
        on availability-starved rounds.

    Strictly below :func:`round_time` whenever ``flush_k < c`` and
    stragglers exist (``inv_mu > 0``) — the trade the paper's Fig. 5
    studies, bought at the accuracy cost of staleness-discounted
    aggregation.
    """
    c = _active(p.m, cohort_size)
    # the async UPLINK compresses per schema like the barrier round; the
    # async DOWNLINK stays raw f32 (a flush rewrites arbitrary row
    # subsets — no per-receiver reference to delta-code against), so the
    # dl terms below deliberately keep the raw t_dl
    ul_scale = _wire_scale(schema, transport, "uplink")
    t_ul = p.rho * p.t_dl * ul_scale
    if applied is not None and applied <= 0:
        return expected_compute_time(p, cohort_size) + t_ul
    b = min(min(int(flush_k), c) if applied is None else int(applied), p.m)
    t_comp = expected_kth_compute_time(p, min(int(flush_k), c), cohort_size)
    if p.tiers is not None:
        # the raw async downlink tiers too (dl_scale 1.0); the flush's
        # applied batch sets the served stream count on both backhaul legs
        dl, ul_bh = _tier_terms(p, scheme, num_streams, c, b, 1.0, ul_scale)
        return dl + t_comp + t_ul + ul_bh
    if scheme == "broadcast":
        dl = p.t_dl
    elif scheme == "groupcast":
        dl = min(_require_streams(num_streams, scheme), b) * p.t_dl
    elif scheme in ("unicast", "client_mixing"):
        dl = b * p.t_dl
    else:
        raise ValueError(f"unknown scheme {scheme!r}")
    return dl + t_comp + t_ul


def rounds_to_time(p: SystemParams, scheme: str, num_rounds: int,
                   num_streams: int | None = None,
                   cohort_size: int | None = None, *, transport=None,
                   schema=None):
    """Cumulative time axis (length num_rounds) for accuracy-vs-time plots."""
    rt = round_time(p, scheme, num_streams, cohort_size, transport=transport,
                    schema=schema)
    return [rt * (t + 1) for t in range(num_rounds)]


def downlink_bytes_per_round(model_bytes: int, scheme: str, m: int,
                             num_streams: int | None = None,
                             cohort_size: int | None = None, *,
                             transport=None, schema=None) -> int:
    """DL payload per round — the wireless quantity the paper trades.

    One downlink transmission costs ``model_bytes`` raw, or the schema's
    per-stream :func:`wire_bytes` when the strategy declares one (a
    compressed ``delta`` broadcast with server-side EF is cheaper than
    raw; a ``raw``-coded downlink like the clustered centroids is not);
    the scheme then sets how many transmissions a round needs.
    """
    c = _active(m, cohort_size)
    unit = (wire_bytes(schema, transport, "downlink")
            if schema is not None else int(model_bytes))
    if scheme == "broadcast":
        return unit
    if scheme == "groupcast":
        return min(_require_streams(num_streams, scheme), c) * unit
    if scheme in ("unicast", "client_mixing"):
        return c * unit
    raise ValueError(f"unknown scheme {scheme!r}")


def uplink_bytes_per_round(model_bytes: int, scheme: str, m: int,
                           cohort_size: int | None = None, *,
                           transport=None, schema=None) -> int:
    """UL payload per round: every active client uploads ONE model.

    This holds for every scheme — broadcast/groupcast/unicast servers and
    FedFomo-style client mixing all consume exactly one locally-updated
    model per participant (``ucfl_parallel`` is the deliberate exception,
    the §V-E upper bound, and is priced by its own m× factor elsewhere).
    The streaming W refresh (``FedConfig.w_refresh``) re-estimates Δ/σ²
    from these same c uploads, so refreshed and stale-W runs have
    IDENTICAL per-round uplink bytes — pinned by a regression test.

    ``transport`` prices the quantized wire per client (1 B/param + one
    f32 scale per chunk); ``None`` is the raw float32 payload,
    unchanged. With a ``schema`` the per-client unit is the schema's
    per-stream :func:`wire_bytes` — SCAFFOLD's two-stream upload
    honestly costs twice a model, quantized or not; without one the
    payload prices as a single delta model stream (the same
    :func:`wire_bytes` path, see :func:`_model_schema`).
    """
    if scheme not in ("broadcast", "groupcast", "unicast", "client_mixing"):
        raise ValueError(f"unknown scheme {scheme!r}")
    unit = wire_bytes(schema if schema is not None
                      else _model_schema(model_bytes), transport, "uplink")
    return _active(m, cohort_size) * unit


def ps_uplink_bytes_per_round(model_bytes: int, scheme: str, m: int,
                              num_streams: int | None = None,
                              cohort_size: int | None = None, *,
                              num_edges: int | None = None,
                              transport=None, schema=None) -> int:
    """Edge↔PS uplink bytes — the backhaul the two-tier engine relieves.

    Flat (``num_edges=None``): every client upload transits the PS link,
    so this equals :func:`uplink_bytes_per_round`. Tiered: each of the
    ``e = min(num_edges, c)`` active edges ships its tier-1 aggregates
    once — ``k`` model-sized streams for a k-stream groupcast policy,
    one for broadcast — so the PS ingests ``e·k`` units instead of
    ``c``. That ``c / (e·k)`` ratio is the hierarchical replay's
    headline metric.
    """
    unit = wire_bytes(schema if schema is not None
                      else _model_schema(model_bytes), transport, "uplink")
    c = _active(m, cohort_size)
    if num_edges is None:
        if scheme not in ("broadcast", "groupcast", "unicast",
                          "client_mixing"):
            raise ValueError(f"unknown scheme {scheme!r}")
        return c * unit
    e = min(int(num_edges), c)
    return e * _tier_streams(scheme, num_streams, c) * unit


def ps_downlink_bytes_per_round(model_bytes: int, scheme: str, m: int,
                                num_streams: int | None = None,
                                cohort_size: int | None = None, *,
                                num_edges: int | None = None,
                                transport=None, schema=None) -> int:
    """Edge↔PS downlink bytes (PS egress over the backhaul links).

    Flat: equals :func:`downlink_bytes_per_round`. Tiered: the PS sends
    each active edge the round's ``k`` downlink streams once
    (``e·k`` units) and the edges fan out to their clients over the
    client tier — broadcast replication across e backhaul links can make
    this LARGER than the flat single broadcast; the topology's win is
    the uplink counter above, and reporting both keeps the replay
    honest.
    """
    unit = wire_bytes(schema if schema is not None
                      else _model_schema(model_bytes), transport, "downlink")
    c = _active(m, cohort_size)
    if num_edges is None:
        return downlink_bytes_per_round(
            model_bytes, scheme, m, num_streams, cohort_size,
            transport=transport, schema=schema)
    e = min(int(num_edges), c)
    return e * _tier_streams(scheme, num_streams, c) * unit


def ici_collective_bytes(model_bytes: int, scheme: str, m: int,
                         num_streams: int | None = None,
                         cohort_size: int | None = None) -> int:
    """Closed-form mixing-collective volume over the client axis across
    devices, per round.

    FedAvg  = all-reduce           ≈ 2·model_bytes (ring),
    UCFL    = all-gather + local mix ≈ (m−1)/m·m·model_bytes ≈ m·model_bytes,
    cluster = m_t weighted reduce+bcast ≈ 2·m_t·model_bytes.
    The reference checks these closed forms against the collectives
    parsed from its compiled programs (its ``launch/roofline.py``, not
    ported yet: ROADMAP queue A).
    """
    c = _active(m, cohort_size)
    if scheme == "broadcast":
        return 2 * model_bytes
    if scheme == "groupcast":
        return 2 * min(_require_streams(num_streams, scheme), c) * model_bytes
    if scheme in ("unicast", "client_mixing"):
        return c * model_bytes
    raise ValueError(f"unknown scheme {scheme!r}")
