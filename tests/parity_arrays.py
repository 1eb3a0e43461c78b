"""The numpy inputs of the port's parity tests, without jax: the small
federated task and LeNet-5 weights that ``torch_parity`` feeds both
packages, and that the spawned ranks of the mesh tests
(``torch_mesh_ranks``) build again in each process."""
from __future__ import annotations

import functools

import numpy as np

# the small federated task every slice-level parity test shares
SMALL = dict(m=6, n=80, n_test=20, num_classes=6, hw=(16, 16))
BATCH = 20
VAR_BATCH = 20


def _glorot(rng, shape):
    limit = (6.0 / (int(np.prod(shape[:-1])) + shape[-1])) ** 0.5
    return rng.uniform(-limit, limit, size=shape).astype(np.float32)


def lenet_params(rng, hw, classes, *, bias=0.0):
    """numpy LeNet-5 weights in the reference's shapes (HWIO convs):
    Glorot-uniform as ``repro.models.lenet.init``, biases set to ``bias``."""
    h, w = hw
    flat = ((h - 4) // 2 - 4) // 2 * (((w - 4) // 2 - 4) // 2) * 16
    shapes = {"c1_w": (5, 5, 1, 6), "c2_w": (5, 5, 6, 16), "f1_w": (flat, 120),
              "f2_w": (120, 84), "f3_w": (84, classes)}
    params = {}
    for k, shape in shapes.items():
        params[k] = _glorot(rng, shape)
        params[k.replace("_w", "_b")] = np.full((shape[-1],), bias, np.float32)
    return params


@functools.lru_cache(maxsize=None)
def small_arrays(seed=0, m=None):
    """numpy (data arrays, LeNet params) of the SMALL covariate-shift task.

    Built with numpy alone, the way ``repro.data.synthetic`` builds its
    scenario 2 (class prototypes + noise, Dirichlet labels, 90°·group
    rotations) and ``repro.models.lenet.init`` its weights, so neither
    package's generator is under test here. ``m`` clients (SMALL's 6 by
    default).
    """
    rng = np.random.default_rng(seed)
    nn, nt, c, (h, w) = (SMALL[k] for k in ("n", "n_test", "num_classes", "hw"))
    m = SMALL["m"] if m is None else m
    low = rng.normal(size=(c, h // 4, w // 4, 1))
    proto = np.repeat(np.repeat(low, 4, axis=1), 4, axis=2)
    proto /= proto.std(axis=(1, 2, 3), keepdims=True)

    def labels(count):
        props = rng.dirichlet(8.0 * np.ones(c), size=m)
        return np.stack([rng.choice(c, size=count, p=p) for p in props]).astype(np.int32)

    group = (np.arange(m) % 4).astype(np.int32)

    def render(y):
        x = proto[y] + 0.8 * rng.normal(size=y.shape + proto.shape[1:])
        return np.stack([np.rot90(xc, g, axes=(1, 2)) for xc, g in zip(x, group)]
                        ).astype(np.float32)

    y, y_test = labels(nn), labels(nt)
    arrays = (render(y), y, render(y_test), y_test, group, np.full((m,), nn, np.int32))
    params = lenet_params(rng, (h, w), c)
    return arrays, params
