"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``).

Inputs are built once as numpy arrays from a seed; the reference
(``repro``, jax on the CPU) and the port (``repro_torch``, torch on the
CPU) both run on them. TF32 is off, so CUDA runs of these helpers compute
in full f32 like the reference.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import synthetic as ref_synthetic
from repro_torch import interop

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CPU = "cpu"

# the small federated task every slice-level parity test shares
SMALL = dict(m=6, n=80, n_test=20, num_classes=6, hw=(16, 16))
BATCH = 20
VAR_BATCH = 20


@pytest.fixture
def one_torch_thread():
    """Run a test's torch CPU ops on one thread, then restore the count.
    Under pytest-xdist several workers share the cores, and torch's
    default of one OpenMP thread a core oversubscribes them: its threads
    spin at every barrier, so a heavy file runs several times slower than
    on one thread. Results stay within the tests' stated tolerances."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


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
def small_arrays(seed=0):
    """numpy (data arrays, LeNet params) of the SMALL covariate-shift task.

    Built with numpy alone, the way ``repro.data.synthetic`` builds its
    scenario 2 (class prototypes + noise, Dirichlet labels, 90°·group
    rotations) and ``repro.models.lenet.init`` its weights, so neither
    package's generator is under test here.
    """
    rng = np.random.default_rng(seed)
    m, nn, nt, c, (h, w) = (SMALL[k] for k in ("m", "n", "n_test", "num_classes", "hw"))
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


def small_task(seed=0):
    """(reference FederatedData, port FederatedData, reference params0,
    port params0) of the SMALL task, from the same numpy arrays."""
    arrays, params = small_arrays(seed)
    data = ref_synthetic.FederatedData(*(jnp.asarray(a) for a in arrays))
    tdata = interop.data_from_numpy(*arrays, device=CPU)
    return (data, tdata, {k: jnp.asarray(v) for k, v in params.items()},
            interop.params_from_numpy(params, device=CPU))


def ref_client_permutations(client_keys, epochs, n, batch_size):
    """The batch orders the reference's ``make_local_sgd`` draws from each
    client key: split(key, epochs) per epoch, then
    permutation(., n)[:steps·B] (``loader.py:18``).
    Returns (len(client_keys), epochs, steps·B) int64 numpy."""
    steps = n // batch_size
    out = np.empty((len(client_keys), epochs, steps * batch_size), np.int64)
    for i, ck in enumerate(client_keys):
        for e, ek in enumerate(jax.random.split(ck, epochs)):
            out[i, e] = np.asarray(jax.random.permutation(ek, n))[: steps * batch_size]
    return out


def ref_permutations(key, m, epochs, n, batch_size):
    """The batch orders of the reference's federated local SGD under round
    key ``key``: one client key each from split(key, m) (``client.py:160``)."""
    return ref_client_permutations(jax.random.split(key, m), epochs, n, batch_size)


def t(a, dtype=None):
    """numpy (or jax) array -> CPU tensor."""
    return torch.as_tensor(np.array(a, dtype))


def n(x):
    """tensor or jax array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def f32(a):
    return jnp.asarray(np.asarray(a, np.float32))


def np_tree(tree):
    """A nested dict of jax arrays -> the same of numpy arrays."""
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def jax_tree(tree):
    if isinstance(tree, dict):
        return {k: jax_tree(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def perturbed(tree, rng, scale=0.05):
    """Every leaf plus ``scale · N(0, 1)`` from ``rng``, so zero-initialised
    norms and biases carry values too (f32 leaves only; int leaves kept)."""
    if isinstance(tree, dict):
        return {k: perturbed(tree[k], rng, scale) for k in sorted(tree)}
    if tree.dtype != np.float32:
        return tree
    return (tree + scale * rng.normal(size=tree.shape)).astype(np.float32)


def stack_clients(trees):
    """Stack same-shaped numpy trees on a new leading client axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_clients([t_[k] for t_ in trees]) for k in first}
    return np.stack(trees)


def assert_tree_close(got, want, **tol):
    """Every leaf of a torch tree against the same leaf of a numpy/jax tree."""
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    for k in got:
        if isinstance(got[k], dict):
            assert_tree_close(got[k], want[k], **tol)
        else:
            np.testing.assert_allclose(n(got[k]), np.asarray(want[k]), err_msg=k, **tol)


def padded_cohorts(members=((0, 2, 5), (1, 2, 3, 4)), slots=5, m=None):
    """The slice tests' cohorts: three, then four real members, each padded
    to ``slots`` slots (port ``Cohort`` objects)."""
    from repro_torch.federated import participation
    m = SMALL["m"] if m is None else m
    return [participation.pad_slots(participation.as_cohort(np.asarray(mem), m), slots, m)
            for mem in members]


def key_schedule(cohorts, seed=1):
    """(init key, [(round key, cohort)]): the key stream of
    ``repro.federated.simulation.run``, one split for init, one a round."""
    key = jax.random.PRNGKey(seed)
    key, ikey = jax.random.split(key)
    rounds = []
    for cohort in cohorts:
        key, rkey = jax.random.split(key)
        rounds.append((rkey, cohort))
    return ikey, rounds


def ref_cohort(cohort):
    """A port ``Cohort`` as the reference's."""
    from repro.federated import participation as ref_part
    return None if cohort is None else ref_part.Cohort(indices=cohort.indices, mask=cohort.mask)


def ref_stream_permutations(key, m, epochs, n, batch_size):
    """ucfl_parallel's batch orders under round key ``key``: stream i's
    client j trains on the orders of split(split(key, m)[i], m)[j]
    (``repro/core/ucfl.py:564`` and ``:587``). Returns (m, m, epochs,
    steps·B) int64 numpy."""
    return np.stack([ref_permutations(k, m, epochs, n, batch_size)
                     for k in jax.random.split(key, m)])


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _ref_fault_keys(rkey, fold, m, width):
    keys = jax.random.split(jax.random.fold_in(rkey, fold), m)
    u = jax.vmap(lambda k: jax.random.uniform(jax.random.fold_in(k, 2)))(keys)
    noise = jax.vmap(lambda k: jax.random.normal(jax.random.fold_in(k, 1), (width,)))(keys)
    return u, noise


def ref_fault_draws(ref_cfg, rkey, m, width):
    """The reference's fault draws of the round under ``rkey``, client by
    client (``repro/federated/faults.py:123-170``): the attacker set, the
    drop uniforms and the unscaled noise rows, as a port
    :class:`~repro_torch.federated.faults.FaultDraws` on the CPU."""
    from repro.federated import faults as ref_faults
    from repro_torch.federated import faults
    u, noise = _ref_fault_keys(rkey, ref_faults._FOLD, m, width)
    return faults.FaultDraws(torch.as_tensor(np.asarray(ref_faults.attacker_mask(ref_cfg, m))),
                             torch.as_tensor(np.asarray(u)),
                             torch.as_tensor(np.asarray(noise)))
