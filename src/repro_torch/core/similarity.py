"""Collaboration coefficients (paper §IV-A, Eq. 9-10).

The special pre-training round: the PS broadcasts θ⁰; every client k
uploads its full local gradient ∇ℓ(θ⁰, D_k) and a variance estimate σ_k²
over a partition of D_k into K minibatches (Eq. 10). The PS forms the
pairwise squared gradient distances Δ_{i,j} (Gram kernel) and the
normalized-Gaussian-kernel mixing weights (Eq. 9):

    w_{i,j} ∝ (n_j / n_i) · exp(−Δ_{i,j} / (2 σ_i σ_j)),   Σ_j w_{i,j} = 1.

Rows are stochastic; homogeneous clients (Δ→0, equal n) give FedAvg;
σ_i → 0 gives local training (w_{i,i} → 1).

Streaming W refresh (``FedConfig.w_refresh``, :class:`RefreshConfig`)
---------------------------------------------------------------------
The paper computes W once. With the refresh on, every cohort round
re-estimates the cohort's statistics from the uploads the PS already has:
a slot's model delta ``θ_pre − θ_post`` is its gradient proxy
(:func:`grad_proxy`), and every running statistic lives in a scale-free
space: unit gradient directions ĝ, Δ̂ = ‖ĝ_i − ĝ_j‖² = 2(1 − cos) and
σ̂² = σ²/‖g‖² (:func:`init_refresh_state` converts the special round's
statistics once). :func:`streaming_refresh` folds the cohort's directions
into the (m, d) direction buffer and its directional drift into σ̂²,
recomputes the cohort's rows and columns of Δ̂, ages the per-client
staleness counters and recomputes W. The buffers are slab-wide (d =
dim_aligned, the tail columns zero), so the special round's Gram of the
unit directions reads them where they lie; the zero columns add nothing
to any norm, product or distance.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core import aggregation
from repro_torch.kernels import ops


def sigma_sq(minibatch_grads, full_grad):
    """Eq. 10 — σ² of stacked clients.

    minibatch_grads (..., K, d), full_grad (..., d) -> (...) σ².
    """
    diff = minibatch_grads.float() - full_grad.float().unsqueeze(-2)
    return torch.mean(torch.sum(diff * diff, dim=-1), dim=-1)


def pairwise_delta(grads):
    """Δ_{i,j} = ||g_i − g_j||² over stacked (m, d) client gradients."""
    return ops.pairwise_delta(grads)


def mixing_weights(delta, sigma_sq_vec, n, *, eps=1e-12):
    """Eq. 9 — (m, m) row-stochastic collaboration coefficients.

    delta (m, m) squared gradient distances, sigma_sq_vec (m,), n (m,)
    local dataset sizes.
    """
    delta = delta.float()
    sig = torch.sqrt(torch.clamp_min(sigma_sq_vec.float(), 0.0))
    n = n.float()
    # 2 σ_i σ_j denominator; guard σ→0: exponent → −inf off-diagonal,
    # 0 on the diagonal (Δ_ii = 0), recovering local training.
    denom = 2.0 * sig[:, None] * sig[None, :]
    zero = torch.zeros((), device=delta.device)
    ninf = torch.full((), float("-inf"), device=delta.device)
    expo = torch.where(denom > eps, -delta / torch.clamp_min(denom, eps),
                       torch.where(delta <= eps, zero, ninf))
    # row-wise max subtraction (softmax-style); the n_j/n_i prefactor folds
    # into log-space, and 1/n_i cancels but is kept as in Eq. 9
    logits = expo + torch.log(n)[None, :] - torch.log(n)[:, None]
    logits = logits - torch.amax(logits, dim=1, keepdim=True)
    un = torch.exp(logits)
    return un / torch.sum(un, dim=1, keepdim=True)


SIGMA_CHUNK = 2**24  # columns of the (m, K, d) gradients taken to f32 at a time


def collaboration_round(per_client_minibatch_grads, n):
    """The whole special round on stacked arrays.

    per_client_minibatch_grads (m, K, d), any float dtype: K minibatch
    gradients per client (the paper's variance-estimation partition); n
    (m,) dataset sizes. Returns full_grads (m, d) f32 (a client's full
    gradient, the f32 mean of its partition's), sigma_sq (m,) f32, delta
    (m, m) and W (m, m). At most :data:`SIGMA_CHUNK` columns are converted
    to f32 at a time, so a wide bf16 (m, K, d) never becomes an f32 copy
    of itself: σ² sums each chunk's squared differences, per client and
    minibatch, into f32 partial sums. Where d
    is a 128 multiple (a zero-tailed slab width), the Gram kernel reads
    the full gradients where they lie.
    """
    g = per_client_minibatch_grads
    m, k, d = g.shape
    step = SIGMA_CHUNK
    full = torch.empty((m, d), dtype=torch.float32, device=g.device)
    sq = torch.zeros((m, k), dtype=torch.float32, device=g.device)
    for c0 in range(0, d, step):
        part = g[:, :, c0: c0 + step].to(torch.float32)
        mean = torch.mean(part, dim=1)
        full[:, c0: c0 + step] = mean
        diff = part - mean.unsqueeze(1)
        sq += torch.sum(diff * diff, dim=-1)
        del part, diff
    sig = torch.mean(sq, dim=-1)
    delta = pairwise_delta(full)
    return {"full_grads": full, "sigma_sq": sig, "delta": delta,
            "W": mixing_weights(delta, sig, n)}


# ---------------------------------------------------------- streaming refresh


@dataclasses.dataclass(frozen=True)
class RefreshConfig:
    """Streaming W-refresh policy: ``alpha`` the EWMA weight of a new
    direction observation in the (m, d) direction buffer (1.0 replaces),
    ``sigma_alpha`` that of a new σ̂² (directional drift) observation."""

    alpha: float = 0.25
    sigma_alpha: float = 0.25

    def __post_init__(self):
        for name in ("alpha", "sigma_alpha"):
            v = getattr(self, name)
            if not 0.0 < v <= 1.0:
                raise ValueError(f"{name} must be in (0, 1], got {v}")


def unit_rows(x, eps=1e-12):
    """Each row of (r, d) ``x`` on the unit sphere, in f32."""
    x = x.to(torch.float32)
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=-1, keepdim=True), eps)


def init_refresh_state(collab, m, *, eps=1e-12, width=None):
    """The refresh buffers from the special round's statistics: ``grads``
    the (m, width) unit directions ĝ = g/‖g‖ (``width`` pads the (m, d)
    full gradients with zero columns, e.g. to the slab width, so that the
    Gram kernel reads them where they lie), ``sigma_sq`` σ²/‖g‖², ``delta``
    Δ̂ of the directions (one Gram launch) and ``staleness`` (m,) int32
    zeros. Every buffer is a new tensor, never a view of ``collab``'s."""
    g = collab["full_grads"].to(torch.float32)
    if width is not None and width > g.shape[1]:
        g = F.pad(g, (0, width - g.shape[1]))
    norm_sq = torch.clamp_min(torch.sum(g * g, dim=-1), eps)
    ghat = unit_rows(g, eps).contiguous()
    return {"grads": ghat,
            "sigma_sq": collab["sigma_sq"].to(torch.float32) / norm_sq,
            "delta": ops.pairwise_delta(ghat),
            "staleness": torch.zeros((m,), dtype=torch.int32, device=g.device)}


def grad_proxy(pre_flat, post_flat):
    """The (c, d) gradient proxies of a cohort's uploads, ``θ_pre − θ_post``
    (the heavy-ball scale (1 − β)/(η·T) cancels on the unit sphere)."""
    return pre_flat.to(torch.float32) - post_flat.to(torch.float32)


def streaming_refresh(refresh, obs, idx, mask, n, *, cfg: RefreshConfig, eps=1e-12,
                      real=None):
    """Fold one cohort's gradient proxies ``obs`` (c, d) into the running
    buffers and recompute W; returns ``(refresh', W')``.

    The order is fixed, as the reference's: the proxy goes to its unit
    direction; σ̂² observes its drift from the direction buffer before the
    update; the direction buffer folds it in (renormalized); the observed
    rows and columns of Δ̂ are recomputed against the updated buffer; the
    staleness counters age; W comes last. ``idx``/``mask``/``real`` are the
    write slots of :mod:`repro_torch.core.aggregation`: pads and demoted
    slots leave every buffer as it was. On the card the buffers are
    written in place."""
    grads, sig = refresh["grads"], refresh["sigma_sq"]
    m = grads.shape[0]
    safe = aggregation.safe_gather_index(idx, m).long()
    obs = unit_rows(obs, eps)
    sig_obs = torch.sum((obs - grads[safe]) ** 2, dim=-1)
    grads = aggregation.masked_unit_ewma_rows(grads, obs, idx, mask, cfg.alpha, eps, real=real)
    sig = aggregation.masked_ewma_rows(sig, sig_obs, idx, mask, cfg.sigma_alpha, real=real)
    delta = aggregation.masked_delta_rows(refresh["delta"], grads, idx, mask, real=real)
    stale = aggregation.staleness_update(refresh["staleness"], idx, mask, real=real)
    new = {"grads": grads, "sigma_sq": sig, "delta": delta, "staleness": stale}
    return new, mixing_weights(delta, sig, n, eps=eps)


def attacker_mixing_mass(w, attacker):
    """The mean W mass that honest rows put on attacker columns: 0 is a
    perfect quarantine, about k/m the attacker share of a uniform mix.
    ``attacker`` (m,) bool (:func:`repro_torch.federated.faults.attacker_mask`)."""
    w = torch.as_tensor(w, dtype=torch.float32)
    atk = torch.as_tensor(attacker, dtype=torch.bool, device=w.device)
    honest = (~atk).to(torch.float32)
    mass = torch.sum(w * atk.to(torch.float32)[None, :], dim=1)
    return torch.sum(mass * honest) / torch.clamp_min(torch.sum(honest), 1.0)
