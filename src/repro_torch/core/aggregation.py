"""PS-side dense aggregation rules (paper Eq. 1/8 and the §IV-B variant).

Every rule takes a client-stacked state, either a dict of (m, ...) leaves
or one (m, d) slab, and returns the same kind:

  * ``fedavg``        — Eq. 1: one convex combination, broadcast to all m;
  * ``user_centric``  — Eq. 8: θ_i ← Σ_j W[i,j] θ_j (m downlink streams);
  * ``clustered``     — §IV-B: m_t centroid rules, group-cast to members.

The mix is a (rules, m) × (m, d) product in the ``mix_aggregate`` kernel.
The rules are column-independent, so a slab is mixed in ONE launch over all
its columns, where the reference launches once per leaf.

Partial participation: the fixed-shape ``masked_*`` rules below express
every cohort rule as per-slot (c, c) rows over a padded cohort (pad slots
carry the sentinel index m and mask False, and get zero column weight
before the row renormalization), and the round-end PS step is ONE
``masked_mix_scatter`` kernel pass over the (c, d) upload slab
(:func:`mix_scatter_flat`); the round starts with ONE ``cohort_gather``
(:func:`cohort_gather`) of each slab it reads. A strategy without a PS
mix writes its real slots back with :func:`scatter_rows`.
``cohort_mixing_matrix``, ``cohort_column_mixing``, ``fedavg_cohort``,
``user_centric_cohort`` and ``clustered_cohort`` are the unpadded rules
that the padded ones must reproduce.

The streaming W refresh folds a cohort's observations into running (m, ·)
buffers with ``masked_ewma_rows``, ``masked_unit_ewma_rows``,
``masked_delta_rows`` and ``staleness_update``; the Byzantine-robust rules
(``RobustConfig``, ``robust_stage``) rewrite the (c, d) upload slab and
may demote slots. Both are in plain torch, in f32.

Write slots: a rule that writes the rows of a running buffer takes the
slot arrays ``idx``/``mask`` and writes slot i's row where ``mask[i]``.
``real`` (a host int) says that the slots ``[0, real)`` hold distinct
client ids (a cohort's sorted real prefix, before any upload stage
demoted some of them): those rows are written, a slot whose mask went
False writes its row's own value back, and nothing syncs with the card.
Without ``real`` the slots whose index is below m are found with one
sync, so the reference's contract (a demoted slot carries the sentinel
m) holds too. On the card a buffer is written in place, as the slab is by
:func:`scatter_rows`; on the CPU a new tensor is returned.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.core import pytree
from repro_torch.kernels import ops


def _mix_tree(w, stacked):
    """Apply mixing matrix w (k, m) to a slab or to each leaf of a tree:
    the mix of the leaf's (m, numel) view in its storage dtype where the
    kernel takes it (f32 or bf16: f32 sums, out in the leaf's dtype, as the
    reference's kernel reads and writes θ), else of an f32 copy cast back."""

    def leaf(x):
        flat = x.reshape(x.shape[0], -1)
        if x.dtype in ops.MIX_DTYPES:
            out = ops.mix_aggregate(w, flat)
        else:
            out = ops.mix_aggregate(w, flat.float()).to(x.dtype)
        return out.reshape((w.shape[0],) + tuple(x.shape[1:]))

    return pytree.tree_map(leaf, stacked)


def fedavg(stacked, n):
    """Eq. 1 with w_i = n_i / Σ n_j, result broadcast back to all clients."""
    m = n.shape[0]
    w = (n / torch.sum(n)).float()[None, :]  # (1, m)
    mixed = _mix_tree(w, stacked)
    return pytree.tree_map(lambda x: x.expand((m,) + tuple(x.shape[1:])).clone(), mixed)


def user_centric(stacked, w):
    """Eq. 8 — full per-client personalization; w is the (m, m) matrix."""
    return _mix_tree(w, stacked)


def centroid_rules(w, labels, num_clusters):
    """(m_t, m) centroid rules: the mean of the W rows of each cluster."""
    onehot = F.one_hot(labels.long(), num_clusters).float()  # (m, m_t)
    counts = torch.clamp_min(onehot.sum(dim=0), 1.0)
    return (onehot.T @ w) / counts[:, None]


def clustered(stacked, w, labels, num_clusters):
    """§IV-B — m_t centroid aggregation rules, group-cast to members.

    stacked: slab or dict of locally optimized models; w (m, m); labels
    (m,) cluster assignment from K-means over rows of w; num_clusters m_t.
    Client i receives the mix of its cluster's centroid rule.
    """
    return mix_centroids(stacked, centroid_rules(w, labels, num_clusters), labels)


def mix_centroids(stacked, rules, labels):
    """Client i receives the mix of its cluster's rule: ``rules`` (m_t, m),
    labels (m,)."""
    mixed = _mix_tree(rules, stacked)
    idx = labels.long()
    return pytree.tree_map(lambda x: x[idx], mixed)


def renormalize_rows(w, eps: float = 1e-12):
    """Rescale rows to sum to 1; all-zero rows stay zero (0/eps)."""
    return w / torch.clamp_min(torch.sum(w, dim=1, keepdim=True), eps)


def cohort_mixing_matrix(w, cohort):
    """W sliced to the cohort's rows and columns, rows renormalized.

    (c, c), row-stochastic up to float error; a row with no mass on the
    cohort falls back to the identity row (that client keeps its own
    locally updated model).
    """
    cohort = cohort.long()
    wc = w[cohort][:, cohort]
    s = torch.sum(wc, dim=1, keepdim=True)
    eye = torch.eye(wc.shape[0], dtype=wc.dtype, device=wc.device)
    return torch.where(s > 1e-12, wc / torch.clamp_min(s, 1e-12), eye)


def cohort_column_mixing(w, cohort):
    """W's columns sliced to the cohort, every row renormalized: (m, c),
    plus the (m,) bool marking rows with any mass on the cohort (a row
    without it is the caller's cue to keep the previous model)."""
    cols = w[:, cohort.long()]
    s = torch.sum(cols, dim=1, keepdim=True)
    return cols / torch.clamp_min(s, 1e-12), s[:, 0] > 1e-12


def fedavg_cohort(stacked_cohort, n_cohort, m):
    """Eq. 1 over the cohort's uploads (unpadded); the new global is
    broadcast to all m clients."""
    w = (n_cohort / torch.sum(n_cohort)).float()[None, :]  # (1, c)
    mixed = _mix_tree(w, stacked_cohort)
    return pytree.tree_map(lambda x: x.expand((m,) + tuple(x.shape[1:])).clone(), mixed)


def user_centric_cohort(stacked_cohort, w, cohort):
    """Eq. 8 restricted to the cohort (unpadded): the (c, ...) mix."""
    return _mix_tree(cohort_mixing_matrix(w, cohort), stacked_cohort)


def clustered_cohort(theta_c, w, labels, num_clusters, cohort):
    """§IV-B with centroid rules rebuilt from the cohort (unpadded), on
    the (c, d) cohort slab.

    Each centroid rule sums the W rows of its participating members over
    the cohort columns and is renormalized; a participant whose rule has
    no mass on the cohort keeps its own locally updated model.
    """
    cohort = cohort.long()
    lc = labels.long()[cohort]
    onehot = F.one_hot(lc, num_clusters).to(w.dtype)  # (c, mt)
    raw = onehot.T @ w[cohort][:, cohort]  # (mt, c)
    mixed = ops.mix_aggregate(renormalize_rows(raw), theta_c)
    alive = (torch.sum(raw, dim=1) > 1e-12)[lc]  # (c,)
    return torch.where(alive[:, None], mixed[lc], theta_c)


def safe_gather_index(idx, m):
    """Clamp the pad sentinel for gathers (pad slots read row m-1)."""
    return torch.clamp_max(idx, m - 1)


def masked_cohort_matrix(w, idx, mask, weights=None):
    """Fixed-shape :func:`cohort_mixing_matrix`: (c, c) with zeroed pad
    columns, rows renormalized; degenerate rows fall back to identity.

    ``weights`` (c,) replaces the binary mask as the column weight (the
    buffered-async flush's staleness discounts, 0 on empty slots); None is
    bit for bit the mask path."""
    safe = safe_gather_index(idx, w.shape[0]).long()
    colw = mask.to(w.dtype) if weights is None else weights
    wc = w[safe][:, safe] * colw[None, :]
    s = torch.sum(wc, dim=1, keepdim=True)
    eye = torch.eye(wc.shape[0], dtype=wc.dtype, device=wc.device)
    return torch.where(s > 1e-12, wc / torch.clamp_min(s, 1e-12), eye)


def masked_clustered_rows(w, labels, num_clusters, idx, mask, weights=None):
    """Fixed-shape :func:`clustered_cohort` as per-slot (c, c) rows.

    Slot i's row is its cluster's centroid rule rebuilt from the real
    members (renormalized over real columns); a slot whose rule has no
    mass on the cohort gets the identity row; pad rows are don't-care.
    ``weights`` (c,) replaces the mask as the uploads' column weight (the
    staleness discounts); cluster membership stays the mask's. None is bit
    for bit the mask path.
    """
    fmask = mask.to(w.dtype)
    colw = fmask if weights is None else weights
    safe = safe_gather_index(idx, w.shape[0]).long()
    lc = labels.long()[safe]
    onehot = F.one_hot(lc, num_clusters).to(w.dtype) * fmask[:, None]
    raw = onehot.T @ (w[safe][:, safe] * colw[None, :])  # (mt, c)
    rules = renormalize_rows(raw)
    alive = (torch.sum(raw, dim=1) > 1e-12)[lc]  # (c,)
    eye = torch.eye(safe.shape[0], dtype=w.dtype, device=w.device)
    return torch.where(alive[:, None], rules[lc], eye)


def masked_group_rows(assignment_c, n_c, mask):
    """Fixed-shape per-group FedAvg rows (the CFL/Oracle cohort rule):
    slot i averages the real slots of its group, weighted by n."""
    fmask = mask.to(torch.float32)
    same = (assignment_c[:, None] == assignment_c[None, :]).to(torch.float32)
    w = same * n_c.to(torch.float32)[None, :] * fmask[None, :]
    s = torch.sum(w, dim=1, keepdim=True)
    eye = torch.eye(w.shape[0], dtype=w.dtype, device=w.device)
    return torch.where(s > 1e-12, w / torch.clamp_min(s, 1e-12), eye)


def masked_fedavg_weights(n_c, mask, weights=None):
    """Fixed-shape Eq. 1 weights over the cohort: (1, c), pad slots 0; an
    all-masked cohort gives all-zero weights (0/eps), not NaN. ``weights``
    (c,) replaces the mask (the staleness discounts, 0 on empty slots);
    None is bit for bit the mask path."""
    wn = n_c.to(torch.float32) * (mask.to(torch.float32) if weights is None else weights)
    return (wn / torch.clamp_min(torch.sum(wn), 1e-12))[None, :]


def masked_column_mixing(w, idx, mask):
    """W's columns sliced to the real cohort slots, rows renormalized:
    (m, c), plus the (m,) bool marking rows with any mass on the cohort."""
    safe = safe_gather_index(idx, w.shape[0]).long()
    cols = w[:, safe] * mask.to(w.dtype)[None, :]
    s = torch.sum(cols, dim=1, keepdim=True)
    return cols / torch.clamp_min(s, 1e-12), s[:, 0] > 1e-12


def _slab(full, what):
    if not isinstance(full, torch.Tensor):
        raise ValueError(
            f"{what}: the stacked state must be one (m, dim_aligned) slab "
            "(repro_torch.core.flat.LayoutTable); a dict of leaves is not "
            "supported on the cohort path")
    return full


def cohort_gather(full, safe):
    """Round-start gather ``full[safe]`` of the slab in ONE
    ``cohort_gather`` launch; ``safe`` is pre-clamped
    (:func:`safe_gather_index`)."""
    return ops.cohort_gather(_slab(full, "cohort_gather"), safe)


def scatter_rows(full, idx, rows, real):
    """``full[idx[i]] = rows[i]`` for the cohort's ``real`` members, the
    slots of its sorted prefix; the pad slots after them write nothing.
    ``real`` is a host int, so the scatter needs no sync. On the card the
    slab is written in place; on the CPU a new tensor is returned. The
    caller uses the return value either way."""
    return _write_rows(_slab(full, "scatter_rows"), idx, rows, real)


def _write_slots(idx, m, real):
    """The slots that write: the prefix ``[0, real)`` when the host counted
    it, else the slots whose index is below m (one sync)."""
    if real is not None:
        return slice(0, int(real))
    return torch.nonzero(idx.long() < m).squeeze(1)


def _own(buf):
    """``buf`` itself on the card (written in place), a copy on the CPU."""
    return buf if buf.is_cuda else buf.clone()


def _write_rows(buf, idx, rows, real):
    """``buf[idx[i]] = rows[i]`` for the write slots (module docstring)."""
    sel = _write_slots(idx, buf.shape[0], real)
    return _own(buf).index_copy_(0, idx[sel].long(), rows[sel].to(buf.dtype))


# ------------------------------------------------------- streaming W refresh


def masked_ewma_rows(buf, obs, idx, mask, alpha, *, real=None):
    """EWMA-fold per-slot observations into rows of a running buffer:
    real slot i rewrites row ``idx[i]`` as ``(1 − α)·buf + α·obs``; other
    slots leave the buffer as it was. ``buf`` (m, ...), ``obs`` (c, ...);
    the refresh's (m,) σ̂² buffer."""
    safe = safe_gather_index(idx, buf.shape[0]).long()
    prev = buf[safe]
    fmask = mask.reshape((-1,) + (1,) * (obs.dim() - 1)).to(buf.dtype)
    blended = prev + fmask * alpha * (obs.to(buf.dtype) - prev)
    rows = torch.where(mask.reshape(fmask.shape).bool(), blended, prev)
    return _write_rows(buf, idx, rows, real)


def masked_unit_ewma_rows(buf, obs, idx, mask, alpha, eps=1e-12, *, real=None):
    """:func:`masked_ewma_rows` of the (m, d) unit-direction buffer, each
    blend projected back onto the unit sphere (an EWMA of two unit vectors
    is shorter than 1, and would shrink every later distance)."""
    safe = safe_gather_index(idx, buf.shape[0]).long()
    prev = buf[safe]
    blended = prev + alpha * (obs.to(buf.dtype) - prev)
    blended = blended / torch.clamp_min(torch.linalg.vector_norm(blended, dim=-1, keepdim=True),
                                        eps)
    rows = torch.where(mask.bool()[:, None], blended, prev)
    return _write_rows(buf, idx, rows, real)


def masked_delta_rows(delta, grads, idx, mask, *, real=None):
    """Refresh the observed clients' rows and columns of the (m, m) Δ̂
    buffer: ``Δ̂[idx_i, j] = ‖grads[idx_i] − grads[j]‖²`` against the whole
    (already refreshed) direction buffer, clamped at 0, written to the
    rows and then to the symmetric columns (so the cohort × cohort block
    holds the column write); entries between two absent clients keep
    their value. The (c, d)·(d, m) product is plain f32 (TF32 off)."""
    m = delta.shape[0]
    safe = safe_gather_index(idx, m).long()
    g = grads[safe].to(torch.float32)
    gm = grads.to(torch.float32)
    sq = (torch.sum(g * g, dim=-1)[:, None] + torch.sum(gm * gm, dim=-1)[None, :]
          - 2.0 * (g @ gm.T))
    live = mask.bool()
    rows = torch.where(live[:, None], torch.clamp_min(sq, 0.0), delta[safe])
    sel = _write_slots(idx, m, real)
    cols = idx[sel].long()
    out = _own(delta).index_copy_(0, cols, rows[sel])
    # a slot that writes no column puts the column's current values back
    return out.index_copy_(1, cols, torch.where(live[sel][None, :], rows[sel].T, out[:, cols]))


def staleness_update(stale, idx, mask, *, real=None):
    """Every client's counter (rounds since its Δ̂/σ̂² were observed) goes
    up by one; the real cohort slots then reset to 0."""
    bumped = stale + 1
    safe = safe_gather_index(idx, stale.shape[0]).long()
    reset = torch.where(mask.bool(), torch.zeros_like(bumped[safe]), bumped[safe])
    sel = _write_slots(idx, stale.shape[0], real)
    return bumped.index_copy_(0, idx[sel].long(), reset[sel])


def mix_scatter(full, cohort_updated, rows, idx, mask):
    """:func:`mix_scatter_flat` of a cohort-stacked update tree, raveled
    once to a (c, d) matrix in sorted-key column order."""
    return mix_scatter_flat(full, pytree.stacked_ravel(cohort_updated), rows, idx, mask)


def mix_scatter_flat(full, flat_c, rows, idx, mask):
    """Apply the per-slot (c, c) ``rows`` to the (c, d) uploads and
    scatter the real slots into the (m, d) slab, in ONE
    ``masked_mix_scatter`` launch.

    ``flat_c`` wider than the slab is sliced back (its tail columns are
    zero padding). On the card the slab is written in place: the caller
    uses the return value and does not reuse ``full``. Pad slots rely on
    the sentinel contract: ``mask`` is False wherever ``idx`` is m.
    """
    full = _slab(full, "mix_scatter")
    d = full.shape[1]
    if flat_c.shape[1] > d:
        flat_c = flat_c[:, :d].contiguous()
    return ops.masked_mix_scatter(rows, flat_c, idx, mask, full)


# ------------------------------------------------------- Byzantine-robust rules
#
# Each rule rewrites the masked upload stage ``(flat_c, idx, mask) ->
# (flat_c', idx', mask')`` before the (c, c)-row mix: the value rules
# (trimmed mean, median, norm clip) rewrite the (c, d) upload slab, the
# selection rules (Krum, multi-Krum) demote slots to masked pad slots
# (mask False, sentinel index m), and trimmed mean does both (it also
# demotes rows that are coordinate outliers almost everywhere). A rule at
# its neutral parameter (``trim_k=0``, ``clip=inf``, multi-Krum keeping
# every real slot) passes the slab through bit for bit. Every rule expects
# a finite slab: the finite guard runs first
# (:func:`repro_torch.federated.faults.finite_guard`).

_BIG = 1e30  # a finite stand-in for +inf (inf · 0 would put NaN in a sort)


@dataclasses.dataclass(frozen=True)
class RobustConfig:
    """Byzantine-robust aggregation policy (``FedConfig.robust``).

    rule: ``trimmed_mean`` | ``median`` | ``norm_clip`` | ``krum`` |
      ``multi_krum``.
    trim_k: values trimmed (winsorized) from each tail of a coordinate
      (trimmed_mean); rows outside the inlier range in at least 75 % of
      the coordinates are demoted. 0 passes the slab through.
    clip: the ceiling of a row's distance from the masked cohort mean
      (norm_clip). ``inf`` passes the slab through.
    f: the Byzantine count assumed by the Krum score (a sum over the
      ``c_real − f − 2`` nearest neighbours).
    q: the slots multi_krum keeps (``krum`` keeps 1; ``None`` under
      multi_krum keeps ``c_real − f``); ``q >= c_real`` keeps them all.
    """

    rule: str = "trimmed_mean"
    trim_k: int = 1
    clip: float = math.inf
    f: int = 1
    q: int | None = None

    _RULES = ("trimmed_mean", "median", "norm_clip", "krum", "multi_krum")

    def __post_init__(self):
        if self.rule not in self._RULES:
            raise ValueError(f"unknown robust rule {self.rule!r} (expected one of {self._RULES})")
        if self.trim_k < 0:
            raise ValueError(f"trim_k must be >= 0, got {self.trim_k}")
        if self.clip <= 0:
            raise ValueError(f"clip must be > 0, got {self.clip}")


def _order_stat(svals, i):
    """Row ``i`` (a device scalar) of the column-sorted slab, as (1, d)."""
    return svals.index_select(0, i.reshape(1))


def _real_count(mask):
    return torch.sum(mask.to(torch.int64))


def masked_trimmed_mean(flat_c, mask, trim_k: int):
    """Coordinate-wise winsorized trimmed mean over the real rows: in every
    coordinate, the ``min(trim_k, (c_real − 1) // 2)`` smallest and largest
    real values are clamped to the range of the values left between them.
    In-range values pass through; masked rows are left as they are."""
    if trim_k == 0:
        return flat_c
    lo, hi, fmask = _winsor_bounds(flat_c, mask, trim_k)
    return torch.where(fmask, torch.clamp(flat_c, lo, hi), flat_c)


def _winsor_bounds(flat_c, mask, trim_k: int):
    """(lo, hi, fmask): the per-coordinate inlier range, (1, d) each, the
    ``trim_eff``-th and ``(c_real − 1 − trim_eff)``-th order statistics of
    the real rows, and the (c, 1) bool row mask."""
    c = flat_c.shape[0]
    fmask = mask.bool()[:, None]
    n_real = _real_count(mask)
    trim_eff = torch.clamp_max(torch.clamp_min(n_real - 1, 0) // 2, trim_k)
    # ascending, masked rows pushed past every real value
    svals = torch.sort(torch.where(fmask, flat_c, _BIG), dim=0).values
    lo_i = torch.clamp(trim_eff, 0, c - 1)
    hi_i = torch.clamp(n_real - 1 - trim_eff, 0, c - 1)
    return _order_stat(svals, lo_i), _order_stat(svals, hi_i), fmask


def trimmed_outlier_rows(flat_c, mask, trim_k: int, frac: float = 0.75):
    """(c,) bool: the real rows outside the winsorization range in at least
    ``frac`` of the coordinates (a sign-flip or noise row is, an honest
    one is not). Winsorizing such a row leaves it its full mixing mass at
    the edge of the honest range; the stage demotes it instead."""
    lo, hi, fmask = _winsor_bounds(flat_c, mask, trim_k)
    out = fmask & ((flat_c < lo) | (flat_c > hi))
    d = max(flat_c.shape[1], 1)
    out_frac = torch.sum(out.to(torch.float32), dim=1) / d
    return mask.bool() & (out_frac >= frac)


def masked_median_rows(flat_c, mask):
    """Every real row replaced by the coordinate-wise median of the real
    rows (an even count averages the two central values), so any convex
    mix of them is the median itself."""
    c = flat_c.shape[0]
    n_real = _real_count(mask)
    svals = torch.sort(torch.where(mask.bool()[:, None], flat_c, _BIG), dim=0).values
    k_lo = torch.clamp((n_real - 1) // 2, 0, c - 1)
    k_hi = torch.clamp(n_real // 2, 0, c - 1)
    med = 0.5 * (_order_stat(svals, k_lo) + _order_stat(svals, k_hi))
    return torch.where(mask.bool()[:, None], med, flat_c)


def masked_norm_clip(flat_c, mask, clip: float):
    """Each real row's deviation from the masked cohort mean clipped to
    ``clip``: rows within it pass through bit for bit, the others move
    onto the ``clip`` sphere around the mean."""
    live = mask.bool()[:, None]
    fmask = live.to(flat_c.dtype)
    cnt = torch.clamp_min(torch.sum(fmask), 1.0)
    mu = torch.sum(flat_c * fmask, dim=0, keepdim=True) / cnt
    dev = flat_c - mu
    norm = torch.sqrt(torch.sum(dev * dev, dim=1, keepdim=True))
    scaled = mu + dev * (clip / torch.clamp_min(norm, 1e-12))
    return torch.where((norm <= clip) | ~live, flat_c, scaled)


def krum_scores(flat_c, mask, f: int):
    """Krum scores (lower is more central): the sum of a real slot's
    ``max(c_real − f − 2, 1)`` smallest squared distances to the other real
    slots; masked slots score ``_BIG``. The (c, c) distances come from one
    f32 product (TF32 off)."""
    c = flat_c.shape[0]
    live = mask.bool()
    x = torch.where(live[:, None], flat_c, 0.0).to(torch.float32)
    sq = torch.sum(x * x, dim=1)
    d2 = torch.clamp_min(sq[:, None] + sq[None, :] - 2.0 * (x @ x.T), 0.0)
    eye = torch.eye(c, dtype=torch.bool, device=flat_c.device)
    pair_ok = live[:, None] & live[None, :] & ~eye
    d2 = torch.where(pair_ok, d2, _BIG)
    csum = torch.cumsum(torch.sort(d2, dim=1).values, dim=1)
    k = torch.clamp(_real_count(mask) - f - 2, 1, c - 1)
    score = csum.index_select(1, (k - 1).reshape(1))[:, 0]
    return torch.where(live, score, _BIG)


def masked_krum_select(flat_c, idx, mask, m: int, f: int, q: int | None = None):
    """(multi-)Krum as a slot rewrite: the ``q`` lowest-scoring real slots
    stay (``q=None`` keeps ``c_real − f``), the others become masked pad
    slots (sentinel index m). The rank is a double stable argsort, so ties
    go to the lower slot, as the reference's. Returns ``(idx', mask')``."""
    score = krum_scores(flat_c, mask, f)
    n_real = _real_count(mask)
    keep_n = (torch.clamp_min(n_real - f, 1) if q is None
              else min(max(int(q), 1), flat_c.shape[0]))
    rank = torch.argsort(torch.argsort(score, stable=True), stable=True)
    selected = mask.bool() & (rank < keep_n)
    return torch.where(selected, idx, torch.full_like(idx, m)), selected


def robust_stage(cfg: RobustConfig | None):
    """The robust upload rewrite ``stage(flat_c, idx, mask, m) -> (flat_c',
    idx', mask')`` over the (c, d) upload slab, or ``None`` when the knob
    is off. Anything but a :class:`RobustConfig` raises ``TypeError``."""
    if cfg is None:
        return None
    if not isinstance(cfg, RobustConfig):
        raise TypeError(f"FedConfig.robust must be a RobustConfig or None, "
                        f"got {type(cfg).__name__}")
    if cfg.rule == "trimmed_mean":
        def stage(flat_c, idx, mask, m):
            out = masked_trimmed_mean(flat_c, mask, cfg.trim_k)
            if cfg.trim_k == 0:  # neutral: the slab passes through
                return out, idx, mask
            keep = mask.bool() & ~trimmed_outlier_rows(flat_c, mask, cfg.trim_k)
            return out, torch.where(keep, idx, torch.full_like(idx, m)), keep
    elif cfg.rule == "median":
        def stage(flat_c, idx, mask, m):
            return masked_median_rows(flat_c, mask), idx, mask
    elif cfg.rule == "norm_clip":
        def stage(flat_c, idx, mask, m):
            return masked_norm_clip(flat_c, mask, cfg.clip), idx, mask
    else:  # krum / multi_krum
        q = 1 if cfg.rule == "krum" else cfg.q

        def stage(flat_c, idx, mask, m):
            idx, mask = masked_krum_select(flat_c, idx, mask, m, cfg.f, q)
            return flat_c, idx, mask
    return stage
