"""Cohort sampling for partial-participation rounds.

A :class:`ParticipationConfig` says how many clients take part in a round
and how they are drawn; :func:`sample_cohort` turns it into a
:class:`Cohort`, a fixed-shape ``(indices, mask)`` pair that the masked
round engine threads through gather, local SGD, mix and scatter.

Fixed-shape contract
--------------------
Every cohort of a policy has exactly ``resolve_size(m)`` slots, whatever
the sampler draws. Real members form a sorted prefix of ``indices`` with
``mask`` True; the slots after them are *pad slots* holding the
out-of-range sentinel ``m`` with ``mask`` False. Gathers clamp the
sentinel, every masked rule gives pad slots zero weight, and the scatter
drops them, so a padded cohort gives the result of the unpadded one.

Samplers
--------
``uniform``       uniform without replacement;
``weighted``      without replacement, inclusion mass proportional to the
                  local dataset size ``n`` (zero-size clients never drawn;
                  fewer positive-mass clients than slots take them all and
                  pad the rest);
``round_robin``   round t takes clients ``[t*c, (t+1)*c) mod m``;
``availability``  uniform over the clients that the (m, period) trace
                  marks up in phase ``(t-1) mod period``, padded when
                  fewer than c are up (none up: an all-masked cohort,
                  which the simulation loop skips);
``pareto``        without replacement, mass from a :class:`SelectionConfig`
                  (compute speed, link quality, data value, sharpened by
                  ``bias`` and gated by a battery trace), with one slot a
                  round reserved for a round-robin fairness lane over the
                  clients of positive static mass.

The numpy seed streams are the reference's
(``repro.federated.participation``), so both packages draw the same
cohorts index for index.

Full participation (``fraction=1.0`` outside the availability and pareto
samplers) is a ``None`` cohort, so the engine keeps the dense path.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

SAMPLERS = ("uniform", "weighted", "round_robin", "availability", "pareto")


@dataclasses.dataclass(frozen=True)
class Cohort:
    """A fixed-shape padded cohort.

    ``indices`` (slots,) int32: real members as a sorted prefix, pad slots
    the sentinel ``m``. ``mask`` (slots,) bool: True exactly on that prefix.
    Construction checks that both are 1-D of one length, that the mask is
    a prefix, and that the real members strictly increase.
    """

    indices: np.ndarray
    mask: np.ndarray

    def __post_init__(self):
        idx = np.asarray(self.indices, np.int32)
        mask = np.asarray(self.mask, bool)
        if idx.ndim != 1 or mask.shape != idx.shape:
            raise ValueError(
                f"indices/mask must be 1-D and the same length, got shapes "
                f"{idx.shape} and {mask.shape}")
        if mask.size and np.any(mask[1:] & ~mask[:-1]):
            raise ValueError(
                "mask must be a sorted prefix: every real slot (mask True) "
                "must precede every pad slot (mask False)")
        members = idx[mask]
        if members.size > 1 and not np.all(np.diff(members) > 0):
            raise ValueError(
                "real member indices must be strictly increasing "
                f"(sorted, unique), got {members.tolist()}")
        object.__setattr__(self, "indices", idx)
        object.__setattr__(self, "mask", mask)

    def __len__(self) -> int:
        """Number of REAL members (pad slots excluded)."""
        return int(self.mask.sum())

    @property
    def num_slots(self) -> int:
        return int(self.indices.shape[0])

    @property
    def members(self) -> np.ndarray:
        """The real member indices (sorted, unpadded)."""
        return self.indices[self.mask]


def as_cohort(cohort, m: int) -> Cohort | None:
    """``None`` stays None (dense path), a :class:`Cohort` passes through,
    and a plain index array becomes an unpadded all-real cohort."""
    if cohort is None or isinstance(cohort, Cohort):
        return cohort
    idx = np.asarray(cohort, np.int32)
    return Cohort(indices=idx, mask=np.ones(idx.shape[0], bool))


def pad_slots(cohort: Cohort, slots: int, m: int) -> Cohort:
    """Extend ``cohort`` with sentinel pad slots up to ``slots`` in all.

    Raises ``ValueError`` when ``slots`` is below the cohort's slot count:
    padding only extends.
    """
    extra = slots - cohort.num_slots
    if extra < 0:
        raise ValueError(
            f"cannot pad a {cohort.num_slots}-slot cohort down to {slots} "
            "slots; pad_slots only extends")
    if extra == 0:
        return cohort
    return Cohort(
        indices=np.concatenate([cohort.indices, np.full(extra, m, np.int32)]),
        mask=np.concatenate([cohort.mask, np.zeros(extra, bool)]))


def _pad(members: np.ndarray, slots: int, m: int) -> Cohort:
    members = np.sort(np.asarray(members, np.int32))
    take = members.shape[0]
    idx = np.full(slots, m, np.int32)
    idx[:take] = members
    mask = np.zeros(slots, bool)
    mask[:take] = True
    return Cohort(indices=idx, mask=mask)


def _host(n) -> np.ndarray:
    """Dataset sizes as host float64 (a tensor is copied off the device)."""
    if isinstance(n, torch.Tensor):
        n = n.cpu().numpy()
    return np.asarray(n, np.float64)


@dataclasses.dataclass(frozen=True)
class SelectionConfig:
    """Pareto-biased cohort selection mass for the ``pareto`` sampler.

    Each knob weights one per-client utility; a round's sampling mass is
    their product, sharpened by ``bias`` and gated by the battery trace::

        mass_i(t) = (compute_i · link_i · n_i^[data_value])^bias
                    · battery[i, (t − 1) mod period]

    compute, link: optional (m,) nonnegative relative compute speeds and
      link qualities; battery: optional (m, period) bool availability
      trace (:func:`battery_trace`, :func:`diurnal_trace`), a client in a
      down phase has zero mass that round; data_value: multiply by the
      local dataset size n; bias: exponent > 0 on the static mass;
      fairness_lane: one slot a round goes to the clients of positive
      static mass in round-robin turn (skipped when that client is
      battery-gated), so none of them starves under a sharp bias.
    """

    compute: np.ndarray | None = None
    link: np.ndarray | None = None
    battery: np.ndarray | None = None
    data_value: bool = False
    bias: float = 1.0
    fairness_lane: bool = True

    def __post_init__(self):
        if not self.bias > 0.0:
            raise ValueError(f"bias must be > 0, got {self.bias}")
        for name in ("compute", "link"):
            v = getattr(self, name)
            if v is None:
                continue
            v = np.asarray(v, np.float64)
            if v.ndim != 1:
                raise ValueError(f"{name} must be 1-D (m,), got {v.shape}")
            if np.any(v < 0) or not np.all(np.isfinite(v)):
                raise ValueError(f"{name} must be finite and nonnegative")
            object.__setattr__(self, name, v)
        if self.battery is not None:
            b = np.asarray(self.battery, bool)
            if b.ndim != 2:
                raise ValueError(f"battery must be an (m, period) trace, got {b.shape}")
            object.__setattr__(self, "battery", b)

    def static_mass(self, m: int, n=None) -> np.ndarray:
        """The round-independent mass (before battery gating)."""
        mass = np.ones(m, np.float64)
        for name in ("compute", "link"):
            v = getattr(self, name)
            if v is not None:
                if v.shape[0] != m:
                    raise ValueError(f"{name} has {v.shape[0]} entries for m={m} clients")
                mass = mass * v
        if self.data_value:
            if n is None:
                raise ValueError("SelectionConfig.data_value needs per-client sizes n")
            nn = np.clip(_host(n), 0.0, None)
            if nn.shape[0] != m:
                raise ValueError(f"n has {nn.shape[0]} entries for m={m} clients")
            mass = mass * nn
        return mass ** self.bias

    def mass(self, rnd: int, m: int, n=None) -> np.ndarray:
        """Round ``rnd``'s sampling mass (static mass, battery-gated)."""
        mass = self.static_mass(m, n)
        if self.battery is not None:
            if self.battery.shape[0] != m:
                raise ValueError(f"battery trace has {self.battery.shape[0]} rows for "
                                 f"m={m} clients")
            mass = mass * self.battery[:, (rnd - 1) % self.battery.shape[1]]
        return mass


def _pareto_members(sel: SelectionConfig, rng, rnd: int, c: int, m: int,
                    n=None) -> np.ndarray:
    """The ``pareto`` sampler's members for one round."""
    mass = sel.mass(rnd, m, n)
    pos = np.flatnonzero(mass > 0)
    if pos.size == 0:
        # every client gated off this phase: an all-masked cohort
        return np.empty(0, np.int64)
    if pos.size <= c:
        return pos
    picks = []
    p = mass.copy()
    if sel.fairness_lane:
        static_pos = np.flatnonzero(sel.static_mass(m, n) > 0)
        lane = int(static_pos[(rnd - 1) % static_pos.size])
        if p[lane] > 0:  # the lane client may be battery-gated this round
            picks.append(lane)
            p[lane] = 0.0
    rest = rng.choice(m, size=c - len(picks), replace=False, p=p / p.sum())
    return np.concatenate([np.asarray(picks, np.int64), rest])


def with_selection(pcfg: "ParticipationConfig | None", selection: SelectionConfig | None):
    """Thread a ``FedConfig.selection`` into a participation policy: None
    returns ``pcfg`` untouched; otherwise the policy (or a fresh
    full-participation one) switches to the ``pareto`` sampler carrying
    the selection."""
    if selection is None:
        return pcfg
    base = pcfg if pcfg is not None else ParticipationConfig()
    return dataclasses.replace(base, sampler="pareto", selection=selection)


@dataclasses.dataclass(frozen=True)
class ParticipationConfig:
    """Who participates each round.

    ``fraction`` of m (1.0: everyone), or ``cohort_size`` when set;
    ``sampler`` one of :data:`SAMPLERS`; ``availability`` the (m, period)
    bool trace of the ``availability`` sampler; ``selection`` the
    :class:`SelectionConfig` that the ``pareto`` sampler needs (and only
    it reads); ``seed`` salts the sampling stream, which is independent of
    the training randomness.
    """

    fraction: float = 1.0
    cohort_size: int | None = None
    sampler: str = "uniform"
    availability: np.ndarray | None = None
    selection: SelectionConfig | None = None
    seed: int = 0

    def __post_init__(self):
        if self.sampler not in SAMPLERS:
            raise ValueError(
                f"unknown sampler {self.sampler!r}; expected one of {SAMPLERS}")
        if self.cohort_size is None and not (0.0 < self.fraction <= 1.0):
            raise ValueError(f"fraction must be in (0, 1], got {self.fraction}")
        if self.sampler == "availability" and self.availability is None:
            raise ValueError("availability sampler needs an availability trace")
        if self.sampler == "pareto" and self.selection is None:
            raise ValueError("pareto sampler needs a SelectionConfig "
                             "(ParticipationConfig.selection)")

    def resolve_size(self, m: int) -> int:
        """Cohort slots for ``m`` clients: ``cohort_size`` clamped to
        [1, m], else ``ceil(fraction * m)`` clamped to [1, m]. The product
        is rounded to 9 decimals first, so float fuzz (0.1 * 130 ==
        13.000000000000002) cannot add a slot."""
        if self.cohort_size is not None:
            return max(1, min(int(self.cohort_size), m))
        return max(1, min(m, math.ceil(round(self.fraction * m, 9))))

    def is_full(self, m: int) -> bool:
        # the availability and pareto samplers can mask slots (gated
        # clients) at any size, so they never take the dense path
        return (self.sampler not in ("availability", "pareto")
                and self.resolve_size(m) == m)


def _rng(cfg: ParticipationConfig, rnd: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([cfg.seed, rnd, 0x5EED]))


# Deterministic (m, period) availability traces. Both generators make every
# client up in at least one phase, and promise nothing per phase: a phase
# where nobody is up is a legitimate all-offline round.


def diurnal_trace(m: int, period: int = 24, *, peak: float = 0.9,
                  trough: float = 0.1, spread: bool = True,
                  seed: int = 0) -> np.ndarray:
    """Time-of-day availability: client i is up in phase t with a cosine
    probability between ``trough`` and ``peak``, shifted by a per-client
    offset when ``spread`` is True."""
    if not 0.0 <= trough <= peak <= 1.0:
        raise ValueError(f"need 0 <= trough <= peak <= 1, got {trough}, {peak}")
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xD1E1]))
    offsets = rng.integers(0, period, m) if spread else np.zeros(m, int)
    t = (np.arange(period)[None, :] + offsets[:, None]) % period
    up_p = trough + (peak - trough) * 0.5 * (1.0 + np.cos(2.0 * np.pi * t / period))
    trace = rng.random((m, period)) < up_p
    return _ensure_each_client_up(trace, rng)


def battery_trace(m: int, period: int = 24, *, duty: int = 3,
                  recharge: int = 2, seed: int = 0) -> np.ndarray:
    """Charge-limited duty cycles: ``duty`` phases up, then ``recharge``
    down, from a random initial phase per client."""
    if duty < 1 or recharge < 0:
        raise ValueError(f"need duty >= 1 and recharge >= 0, got {duty}, {recharge}")
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xBA77]))
    cycle = duty + recharge
    phase0 = rng.integers(0, cycle, m)
    t = (np.arange(period)[None, :] + phase0[:, None]) % cycle
    return _ensure_each_client_up(t < duty, rng)


def _ensure_each_client_up(trace: np.ndarray, rng) -> np.ndarray:
    trace = np.asarray(trace, bool)
    never = np.flatnonzero(~trace.any(axis=1))
    if never.size:
        trace[never, rng.integers(0, trace.shape[1], never.size)] = True
    return trace


def sample_cohort(cfg: ParticipationConfig | None, rnd: int, m: int,
                  n=None) -> Cohort | None:
    """Round ``rnd``'s (1-based) cohort of ``m`` clients, or ``None`` for
    full participation. ``n`` ((m,) dataset sizes, array or tensor) is
    needed by the ``weighted`` sampler, and by ``pareto`` under
    ``data_value``. Every cohort of a policy has
    ``cfg.resolve_size(m)`` slots."""
    if cfg is None or cfg.is_full(m):
        return None
    c = cfg.resolve_size(m)
    rng = _rng(cfg, rnd)
    if cfg.sampler == "uniform":
        members = rng.choice(m, size=c, replace=False)
    elif cfg.sampler == "weighted":
        if n is None:
            raise ValueError("weighted sampler needs per-client sizes n")
        p = np.clip(_host(n), 0.0, None)
        pos = np.flatnonzero(p > 0)
        if pos.size == 0:
            raise ValueError(
                "weighted sampler: every client has zero dataset size, so "
                "no inclusion probability can be formed (n must have at "
                "least one positive entry)")
        if pos.size <= c:
            # every positive-mass client participates; the rest are pads
            members = pos
        else:
            members = rng.choice(m, size=c, replace=False, p=p / p.sum())
    elif cfg.sampler == "round_robin":
        start = ((rnd - 1) * c) % m
        members = (start + np.arange(c)) % m
    elif cfg.sampler == "pareto":
        members = _pareto_members(cfg.selection, rng, rnd, c, m, n)
    else:  # availability
        trace = np.asarray(cfg.availability, bool)
        up = np.flatnonzero(trace[:, (rnd - 1) % trace.shape[1]])
        members = rng.choice(up, size=min(c, up.size), replace=False)
    return _pad(members, c, m)


def cohort_schedule(cfg: ParticipationConfig | None, rounds: int, m: int, n=None):
    """The cohorts of rounds 1..``rounds`` (diagnostics and tests)."""
    return [sample_cohort(cfg, r, m, n) for r in range(1, rounds + 1)]
