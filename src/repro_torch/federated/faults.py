"""Fault injection and graceful degradation for cohort rounds
(``FedConfig.faults``, with ``FedConfig.robust`` the upload stage).

Every fault is a masked rewrite of what the cohort round already holds:
the (c, W) upload slab ``post`` (the strategy's uplink wire slab, after
the wire stage), its round-start rows ``pre`` and the slot arrays
``idx``/``mask``. Nothing changes shape and nothing syncs with the card:

  * Byzantine uploads (``attack``: ``sign_flip``, ``scaled_noise``,
    ``nan``, ``inf``) replace the attacker slots' rows; the attacker set
    is static, drawn once from ``seed`` (:func:`attacker_mask`);
  * a dropped upload demotes its slot to a masked pad slot after local
    SGD: mask False, index the sentinel m, so its client keeps its
    previous rows and weighs nothing in the mix;
  * the finite guard (:func:`finite_guard`) demotes and zeroes every row
    that is not finite in some stream of the wire (0 · NaN would still
    poison the mix), so a round survives any number of poisoned uploads.

Randomness: the reference draws its faults from ``jax.random`` streams,
which torch cannot reproduce. :func:`draw` makes them client-indexed for
all m clients from ``seed`` and the round's counter (the state's
``fault_round``, which the cohort engine advances), never from the
training generator: the batch orders are the same with faults on and off,
and a slot's faults depend on its client id alone, so padding stays
invisible. The drop uniforms come from numpy on the host and the noise
from a torch generator on the slab's device. :func:`inject` takes the
draws as arrays (:class:`FaultDraws`), so the parity tests hand it the
reference's. The attacker set agrees with the reference's in its size
only.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import aggregation

_FOLD = 0xFA117  # the fault stream's domain separator


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Opt-in fault model.

    seed: draws the static attacker set and every round's faults.
    byzantine_frac: the attackers' share of the m clients
      (``round(frac · m)`` of them, fixed for the run).
    attack: ``sign_flip`` (the update inverted and scaled by
      ``attack_scale``), ``scaled_noise`` (the round-start model plus
      Gaussian noise of scale ``attack_scale``), ``nan`` or ``inf``.
    drop_rate: the probability that a real upload is lost mid-round.
    deadline: the straggler compute-time ceiling of the comm model's
      pricing (``comm_model.deadline_round_time``); ``inf``: no timeouts.
    """

    seed: int = 0
    byzantine_frac: float = 0.0
    attack: str = "sign_flip"
    attack_scale: float = 10.0
    drop_rate: float = 0.0
    deadline: float = math.inf

    _ATTACKS = ("sign_flip", "scaled_noise", "nan", "inf")

    def __post_init__(self):
        if self.attack not in self._ATTACKS:
            raise ValueError(f"unknown attack {self.attack!r} (expected one of {self._ATTACKS})")
        if not 0.0 <= self.byzantine_frac <= 1.0:
            raise ValueError(f"byzantine_frac must be in [0, 1], got {self.byzantine_frac}")
        if not 0.0 <= self.drop_rate <= 1.0:
            raise ValueError(f"drop_rate must be in [0, 1], got {self.drop_rate}")


class FaultDraws(NamedTuple):
    """One round's fault randomness, client-indexed, on the slab's device:
    ``attacker`` (m,) bool, ``uniforms`` (m,) f32 (a slot drops when its
    client's is below ``drop_rate``), ``noise`` (m, W) f32 standard normals
    (``scaled_noise`` only, else None)."""

    attacker: torch.Tensor
    uniforms: torch.Tensor
    noise: torch.Tensor | None


def num_attackers(cfg: FaultConfig, m: int) -> int:
    return int(round(cfg.byzantine_frac * m))


def attacker_mask(cfg: FaultConfig, m: int) -> np.ndarray:
    """The static (m,) bool attacker set, a function of (seed, m) alone."""
    out = np.zeros(m, bool)
    k = num_attackers(cfg, m)
    if k:
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, _FOLD]))
        out[rng.permutation(m)[:k]] = True
    return out


def _to(arr: np.ndarray, device):
    t = torch.from_numpy(arr)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def draw(cfg: FaultConfig, m: int, width: int, rnd: int, device) -> FaultDraws:
    """Round ``rnd``'s draws for all m clients (module docstring)."""
    device = torch.device(device)
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, int(rnd), _FOLD]))
    uniforms = rng.random(m, dtype=np.float32)
    noise = None
    if cfg.byzantine_frac > 0.0 and cfg.attack == "scaled_noise":
        gen = torch.Generator(device=device)
        gen.manual_seed(int(rng.integers(2**62)))
        noise = torch.randn((m, width), generator=gen, device=device)
    return FaultDraws(_to(attacker_mask(cfg, m), device), _to(uniforms, device), noise)


def inject(cfg: FaultConfig, pre_flat, post_flat, idx, mask, m: int, draws: FaultDraws):
    """The round's faults on the upload slab: returns ``(post', idx',
    mask')``. ``pre_flat``/``post_flat`` (c, W), ``idx``/``mask`` (c,), the
    client-indexed ``draws`` gathered at the slots."""
    safe = aggregation.safe_gather_index(idx, m).long()
    live = mask.bool()
    if cfg.byzantine_frac > 0.0:
        atk = draws.attacker[safe] & live
        if cfg.attack == "sign_flip":
            bad = pre_flat - cfg.attack_scale * (post_flat - pre_flat)
        elif cfg.attack == "scaled_noise":
            bad = pre_flat + cfg.attack_scale * draws.noise[safe]
        else:
            bad = torch.full_like(post_flat, math.nan if cfg.attack == "nan" else math.inf)
        post_flat = torch.where(atk[:, None], bad, post_flat)
    if cfg.drop_rate > 0.0:
        drop = (draws.uniforms[safe] < cfg.drop_rate) & live
        live = live & ~drop
        idx = torch.where(drop, torch.full_like(idx, m), idx)
    return post_flat, idx, live


def finite_guard(flat_c, idx, mask, m: int, schema=None):
    """Demote the rows that are not finite: mask False, index m, and the
    row zeroed (a zero column weight times NaN is still NaN). ``schema``
    (the strategy's wire schema) checks each uplink stream's slice and
    ANDs them: any stream going non-finite demotes the whole slot.
    Returns ``(flat_c', idx', mask')``."""
    if schema is None:
        finite = torch.all(torch.isfinite(flat_c), dim=-1)
    else:
        finite = torch.ones(flat_c.shape[:-1], dtype=torch.bool, device=flat_c.device)
        for lo, hi in schema.slices("uplink"):
            finite &= torch.all(torch.isfinite(flat_c[..., lo:hi]), dim=-1)
    finite = finite & mask.bool()
    return (torch.where(finite[:, None], flat_c, 0.0),
            torch.where(finite, idx, torch.full_like(idx, m)), finite)


def upload_stage(faults_cfg: FaultConfig | None, robust_cfg=None, schema=None):
    """Inject → finite guard → robust rule, as one stage ``stage(pre_flat,
    post_flat, idx, mask, m, rnd) -> (post', idx', mask')`` over the
    strategy's uplink wire slab, or ``None`` when both knobs are off (the
    round keeps its stage-free path). The finite guard runs whenever the
    stage does. Anything but a :class:`FaultConfig` raises ``TypeError``."""
    if faults_cfg is not None and not isinstance(faults_cfg, FaultConfig):
        raise TypeError(f"FedConfig.faults must be a FaultConfig or None, "
                        f"got {type(faults_cfg).__name__}")
    rstage = aggregation.robust_stage(robust_cfg)
    if faults_cfg is None and rstage is None:
        return None

    def stage(pre_flat, post_flat, idx, mask, m, rnd):
        if faults_cfg is not None:
            draws = draw(faults_cfg, m, post_flat.shape[1], rnd, post_flat.device)
            post_flat, idx, mask = inject(faults_cfg, pre_flat, post_flat, idx, mask, m, draws)
        post_flat, idx, mask = finite_guard(post_flat, idx, mask, m, schema)
        if rstage is not None:
            post_flat, idx, mask = rstage(post_flat, idx, mask, m)
        return post_flat, idx, mask

    return stage
