"""Collaboration coefficients (paper §IV-A, Eq. 9-10).

The special pre-training round: the PS broadcasts θ⁰; every client k
uploads its full local gradient ∇ℓ(θ⁰, D_k) and a variance estimate σ_k²
over a partition of D_k into K minibatches (Eq. 10). The PS forms the
pairwise squared gradient distances Δ_{i,j} (Gram kernel) and the
normalized-Gaussian-kernel mixing weights (Eq. 9):

    w_{i,j} ∝ (n_j / n_i) · exp(−Δ_{i,j} / (2 σ_i σ_j)),   Σ_j w_{i,j} = 1.

Rows are stochastic; homogeneous clients (Δ→0, equal n) give FedAvg;
σ_i → 0 gives local training (w_{i,i} → 1). The streaming refresh of the
reference comes with a later slice (the engine knobs, ROADMAP queue A).
"""
from __future__ import annotations

import torch

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


def collaboration_round(per_client_minibatch_grads, n):
    """The whole special round on stacked arrays.

    per_client_minibatch_grads (m, K, d): K minibatch gradients per client
    (the paper's variance-estimation partition); n (m,) dataset sizes.
    Returns full_grads (m, d), sigma_sq (m,), delta (m, m) and W (m, m).
    """
    g = per_client_minibatch_grads
    full = torch.mean(g, dim=1)  # a client's full gradient: the mean of its partition's
    sig = sigma_sq(g, full)
    delta = pairwise_delta(full)
    return {"full_grads": full, "sigma_sq": sig, "delta": delta,
            "W": mixing_weights(delta, sig, n)}
