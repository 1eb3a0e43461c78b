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

from parity_arrays import BATCH, SMALL, VAR_BATCH, lenet_params, small_arrays  # noqa: F401
from repro.data import synthetic as ref_synthetic
from repro_torch import interop

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CPU = "cpu"


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


# the ten strategies of the reference's tests/test_sharded_state.py, at
# their reference defaults and the shared small batch
MESH_NAMES = ["cfl", "ditto", "fedavg", "fedfomo", "fedprox", "local", "oracle", "pfedme",
              "scaffold", "ucfl"]
_MESH_CFG = {"scaffold": dict(lr=0.01, momentum=0.0, epochs=5),
             "pfedme": dict(lr=0.01, momentum=0.0, epochs=1)}


def mesh_cfg(name):
    """``name``'s ``FedConfig`` fields in the mesh tests."""
    return dict(_MESH_CFG.get(name, {}), batch_size=BATCH)


def mesh_kw(name):
    """``name``'s strategy keywords in the mesh tests."""
    return {"var_batch_size": VAR_BATCH} if name.startswith("ucfl") else {}


def round_orders(name, rkey, m, epochs):
    """The batch orders the reference's round of ``name`` draws under
    ``rkey`` for m clients, as the port's ``round(perms=)`` takes them:
    Ditto's two stacked, FedFomo's over its train split, ucfl_parallel's
    (m streams, m clients, epochs, steps·B)."""
    nn = SMALL["n"]
    if name == "ditto":
        return np.stack([ref_permutations(k, m, epochs, nn, BATCH)
                         for k in jax.random.split(rkey)])
    if name == "fedfomo":
        return ref_permutations(rkey, m, epochs, nn - int(nn * 0.2), BATCH)
    if name == "ucfl_parallel":
        return ref_stream_permutations(rkey, m, epochs, nn, BATCH)
    return ref_permutations(rkey, m, epochs, nn, BATCH)


def mesh_run(name, m, members, slots=5):
    """A run of the mesh tests (``torch_mesh_ranks.play``): ``name``'s
    config, the cohorts of ``members`` (one tuple a round) padded to
    ``slots`` slots, and the reference's batch orders from
    :func:`key_schedule`'s round keys; and those (round key, cohort)."""
    from repro_torch.federated import participation
    cohorts = [participation.pad_slots(participation.as_cohort(np.asarray(mem), m), slots, m)
               for mem in members]
    _, rounds = key_schedule(cohorts)
    epochs = mesh_cfg(name).get("epochs", 1)
    run = dict(name=name, cfg=mesh_cfg(name), kw=mesh_kw(name),
               cohorts=[(c.indices, c.mask) for _, c in rounds],
               perms=[round_orders(name, k, m, epochs) for k, _ in rounds])
    return run, rounds

