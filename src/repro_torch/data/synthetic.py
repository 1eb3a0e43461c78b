"""Procedural federated datasets with the paper's heterogeneity (§V-A).

The same three scenarios as ``repro.data.synthetic``, drawn from explicit
generators: a ``numpy.random.Generator`` on the host for the Dirichlet
class proportions, the label draws and the group label permutations, and
a ``torch.Generator`` on the device for the prototypes and the pixel
noise (the bulk of the data is made where it is used).

  * label shift      — per-client class proportions ~ Dirichlet(α);
  * covariate shift  — client groups see inputs rotated by {0,90,180,270}°;
  * concept shift    — client groups use different label permutations.

The streams differ from ``jax.random``'s, and torch's bicubic resize
(Keys a = −0.75) is not ``jax.image.resize``'s (a = −0.5), so agreement
with the reference is statistical, not bitwise; parity tests hand the
reference's arrays over with :func:`repro_torch.interop.data_from_numpy`.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device


class FederatedData(NamedTuple):
    x: torch.Tensor  # (m, n, H, W, C) float32
    y: torch.Tensor  # (m, n) int64
    x_test: torch.Tensor  # (m, n_test, H, W, C)
    y_test: torch.Tensor  # (m, n_test) int64
    group: torch.Tensor  # (m,) int64 — ground-truth heterogeneity group
    n: torch.Tensor  # (m,) int64 — local dataset sizes (all equal here)

    @property
    def num_clients(self):
        return self.x.shape[0]


def _generators(rng, device):
    """(numpy host generator, torch device generator) from a seed or a
    numpy Generator; the torch seed is drawn from the numpy stream."""
    rng = np.random.default_rng(rng)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(0, 2**62)))
    return rng, gen


def make_prototypes(gen, num_classes, hw=(28, 28), channels=1, *,
                    symmetric_frac=0.3, device=None):
    """Smooth class prototypes (N, H, W, C); a fraction are 180°-symmetric."""
    dev = resolve_device(device)
    low = torch.randn((num_classes, channels, 7, 7), generator=gen, device=dev)
    proto = F.interpolate(low, size=tuple(hw), mode="bicubic",
                          align_corners=False).permute(0, 2, 3, 1)
    proto = proto / (proto.std(dim=(1, 2, 3), keepdim=True, unbiased=False) + 1e-6)
    n_sym = int(num_classes * symmetric_frac)
    if n_sym:
        head = proto[:n_sym]
        proto[:n_sym] = 0.5 * (head + torch.rot90(head, 2, dims=(1, 2)))
    return proto


def _dirichlet_labels(rng, m, n, num_classes, alpha):
    """(m, n) int64 labels with per-client Dirichlet(α) class proportions."""
    props = rng.dirichlet(alpha * np.ones(num_classes), size=m)
    return np.stack([rng.choice(num_classes, size=n, p=p) for p in props])


def _render(gen, proto, labels, noise=0.8):
    """x = prototype[y] + noise·ε for labels (..., n)."""
    eps = torch.randn(tuple(labels.shape) + tuple(proto.shape[1:]),
                      generator=gen, device=proto.device)
    return proto[labels] + noise * eps


def _rotate_groups(x, group):
    """Rotate client i's images (x is (m, n, H, W, C)) by 90°·group[i].

    ``torch.rot90`` over (H, W) turns the same way as ``jnp.rot90`` with
    ``axes=(1, 2)`` on one client's (n, H, W, C) images.
    """
    out = x.clone()
    for g in range(1, 4):
        sel = group == g
        if bool(sel.any()):
            out[sel] = torch.rot90(x[sel], g, dims=(2, 3))
    return out


def label_shift(rng=0, *, m=20, n=500, n_test=100, num_classes=47,
                alpha=0.4, hw=(28, 28), channels=1, noise=0.8, device=None):
    """Scenario 1 — EMNIST-like user-dependent label shift (α=0.4)."""
    dev = resolve_device(device)
    rng, gen = _generators(rng, dev)
    proto = make_prototypes(gen, num_classes, hw, channels, device=dev)
    y = torch.as_tensor(_dirichlet_labels(rng, m, n, num_classes, alpha), device=dev)
    y_test = torch.as_tensor(_dirichlet_labels(rng, m, n_test, num_classes, alpha),
                             device=dev)
    x = _render(gen, proto, y, noise)
    x_test = _render(gen, proto, y_test, noise)
    group = torch.zeros((m,), dtype=torch.int64, device=dev)
    nvec = torch.full((m,), n, dtype=torch.int64, device=dev)
    return FederatedData(x, y, x_test, y_test, group, nvec)


def covariate_label_shift(rng=0, *, m=100, n=1000, n_test=100, num_classes=47,
                          alpha=8.0, groups=4, hw=(28, 28), channels=1,
                          noise=0.8, device=None):
    """Scenario 2 — label shift (α=8) + group rotations {0,90,180,270}°."""
    base = label_shift(rng, m=m, n=n, n_test=n_test, num_classes=num_classes,
                       alpha=alpha, hw=hw, channels=channels, noise=noise,
                       device=device)
    group = torch.arange(m, device=base.x.device) % groups
    return base._replace(x=_rotate_groups(base.x, group),
                         x_test=_rotate_groups(base.x_test, group), group=group)


def concept_shift(rng=0, *, m=20, n=500, n_test=100, num_classes=10,
                  groups=4, hw=(32, 32), channels=3, noise=0.6, device=None):
    """Scenario 3 — CIFAR-like group-dependent label permutation."""
    rng = np.random.default_rng(rng)
    perms = np.stack([rng.permutation(num_classes) for _ in range(groups)])
    base = label_shift(rng, m=m, n=n, n_test=n_test, num_classes=num_classes,
                       alpha=100.0, hw=hw, channels=channels, noise=noise,
                       device=device)
    dev = base.x.device
    group = torch.arange(m, device=dev) % groups
    pt = torch.as_tensor(perms, device=dev)[group]  # (m, C)
    return base._replace(y=torch.gather(pt, 1, base.y),
                         y_test=torch.gather(pt, 1, base.y_test), group=group)


SCENARIOS = {
    "label_shift": label_shift,
    "covariate_label_shift": covariate_label_shift,
    "concept_shift": concept_shift,
}
