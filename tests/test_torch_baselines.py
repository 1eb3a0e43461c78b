"""The paper's nine baselines in both packages.

Each strategy runs ``init``, two dense rounds and two padded-cohort rounds
(5 slots, 3 and 4 members) in the reference and in the port, from the same
params0, data, cohorts and batch orders (derived from the round keys as
``repro.federated.simulation.run`` splits them; Ditto's two orders a round
from its key split, FedFomo's over the train split). Tolerances (f32 on
the CPU, sums in another order): every state slab (``params``,
``personal``, ``c_i``, ``c``) atol 1e-4 after each round, as for ``ucfl``;
``streams`` and ``cohort_size`` exact; CFL's cluster assignment exact;
FedFomo's (c, c) mixing weights atol 1e-4 every round; per-client
accuracy of ``eval_params`` within one test sample (1/n_test). Within the
port, a padded cohort gives the unpadded one's slabs within atol 1e-6 (the
CPU's sums may group a 3- and a 5-slot row differently). The reference's
runs are shared through module-level caches, so each runs once.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as ref_core
from repro.core import FedConfig as RefFedConfig
from repro.core import aggregation as ref_agg
from repro.core import similarity as ref_similarity
from repro.core.baselines import common as ref_common
from repro.federated import client as ref_client
from repro.federated import participation as ref_part
from repro.federated import simulation as ref_simulation
from repro.kernels import ops as ref_ops
from repro.models import lenet as ref_lenet
from repro_torch.core import REGISTRY, Cohort, FedConfig, aggregation, flat, similarity
from repro_torch.core.baselines import common, fedfomo
from repro_torch.federated import client, participation, simulation
from repro_torch.models import lenet
from torch_parity import (BATCH, SMALL, n, one_torch_thread,  # noqa: F401
                          ref_permutations, small_task, t)

# every test on one torch thread (torch_parity.one_torch_thread)
pytestmark = pytest.mark.usefixtures("one_torch_thread")

NAMES = ["fedavg", "fedprox", "local", "oracle", "scaffold", "ditto", "pfedme", "fedfomo", "cfl"]
SLABS = ("params", "personal", "c_i", "c")
SLOTS = 5
# each strategy's FedConfig: its reference defaults at the shared small batch
CFG = {"scaffold": dict(lr=0.01, momentum=0.0, epochs=5),
       "pfedme": dict(lr=0.01, momentum=0.0, epochs=1)}
N_VAL = int(SMALL["n"] * 0.2)  # FedFomo's validation split


def _cfgs(name):
    kw = dict(CFG.get(name, {}), batch_size=BATCH)
    return RefFedConfig(**kw), FedConfig(**kw)


def _cohorts(m):
    """Rounds 3 and 4: three, then four real members, each padded to 5 slots."""
    return [participation.pad_slots(participation.as_cohort(np.asarray(mem), m), SLOTS, m)
            for mem in ([0, 2, 5], [1, 2, 3, 4])]


def _perms(name, rkey, epochs):
    """The batch orders the reference's round draws under ``rkey``."""
    m, nn = SMALL["m"], SMALL["n"]
    if name == "ditto":  # split(key) -> one order for the global, one for the personal model
        return t(np.stack([ref_permutations(k, m, epochs, nn, BATCH)
                           for k in jax.random.split(rkey)]))
    if name == "fedfomo":
        return t(ref_permutations(rkey, m, epochs, nn - N_VAL, BATCH))
    return t(ref_permutations(rkey, m, epochs, nn, BATCH))


def _slabs(state):
    return {k: np.array(state[k]) for k in SLABS if k in state}


def _schedule():
    """(round key, cohort or None) of the four rounds, and the init key."""
    key = jax.random.PRNGKey(1)
    key, ikey = jax.random.split(key)
    rounds = []
    for cohort in [None, None] + _cohorts(SMALL["m"]):
        key, rkey = jax.random.split(key)
        rounds.append((rkey, cohort))
    return ikey, rounds


def _eval_ref(params):
    data, _, _, _ = small_task()
    return np.asarray(jax.jit(lambda p: ref_client.evaluate(ref_lenet.apply, p, data.x_test,
                                                            data.y_test))(params))


@functools.lru_cache(maxsize=None)
def ref_run(name, **kw):
    """The reference's slabs and metrics after each round, its final
    accuracies, its CFL assignments and its FedFomo weights."""
    data, _, params0, _ = small_task()
    rcfg, _ = _cfgs(name)
    strat = ref_core.REGISTRY[name](ref_lenet.apply, params0, rcfg, **kw)
    ikey, rounds = _schedule()
    weights = []

    def capture(w, theta, *, impl=None):
        # FedFomo's only mix_aggregate call takes its (c, c) weights
        jax.debug.callback(lambda a: weights.append(np.array(a)), w, ordered=True)
        return mix(w, theta, impl=impl)

    mix = ref_ops.mix_aggregate
    with pytest.MonkeyPatch.context() as mp:
        if name == "fedfomo":
            mp.setattr(ref_ops, "mix_aggregate", capture)
        # the oracle's and CFL's init read host values; the rest compile as one program
        state = (strat.init(ikey, data) if name in ("oracle", "cfl")
                 else jax.jit(strat.init)(ikey, data))
        out = []
        for rkey, cohort in rounds:
            rc = None if cohort is None else ref_part.Cohort(indices=cohort.indices,
                                                             mask=cohort.mask)
            state, met = strat.round(ref_simulation.donation_safe_copy(state), data, rkey, rc)
            jax.block_until_ready(state["params"])
            out.append(dict(slabs=_slabs(state), streams=int(met["streams"]),
                            cohort_size=int(met["cohort_size"]),
                            assignment=np.array(state["assignment"]) if name == "cfl" else None))
    acc = _eval_ref(strat.eval_params(state))
    return dict(rounds=out, acc=acc, weights=weights, name=strat.name,
                comm=(strat.comm_scheme, strat.num_streams))


@functools.lru_cache(maxsize=None)
def port_run(name, **kw):
    """The port's run of :func:`ref_run`'s schedule on the CPU."""
    _, tdata, _, tparams = small_task()
    _, cfg = _cfgs(name)
    strat = REGISTRY[name](lenet.apply_stacked, tparams, cfg, device="cpu", **kw)
    ikey, rounds = _schedule()
    weights = []
    real_weights = fedfomo.fomo_weights

    def capture(lmat, flat_, col_mask=None):
        w = real_weights(lmat, flat_, col_mask)
        weights.append(n(w))
        return w

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fedfomo, "fomo_weights", capture)
        state = strat.init(None, tdata)
        out = []
        for rkey, cohort in rounds:
            perms = _perms(name, rkey, cfg.epochs)
            state, met = strat.round(state, tdata, None, cohort, perms=perms)
            out.append(dict(slabs={k: n(v) for k, v in _slabs(state).items()},
                            streams=met["streams"], cohort_size=met["cohort_size"],
                            assignment=np.array(state["assignment"]) if name == "cfl" else None))
    acc = n(client.evaluate(lenet.apply_stacked, strat.eval_params(state), tdata.x_test,
                            tdata.y_test))
    return dict(rounds=out, acc=acc, weights=weights, name=strat.name,
                comm=(strat.comm_scheme, strat.num_streams))


def _assert_rounds_match(name, got, want, which):
    for r in which:
        g, w = got["rounds"][r], want["rounds"][r]
        assert sorted(g["slabs"]) == sorted(w["slabs"]), (r, sorted(g["slabs"]))
        for k in g["slabs"]:
            np.testing.assert_allclose(g["slabs"][k], w["slabs"][k], atol=1e-4,
                                       err_msg=f"{name} round {r + 1} {k}")
        assert (g["streams"], g["cohort_size"]) == (w["streams"], w["cohort_size"]), r
        assert isinstance(g["streams"], int)
        if name == "cfl":
            np.testing.assert_array_equal(g["assignment"], w["assignment"])
        if name == "fedfomo":
            np.testing.assert_allclose(got["weights"][r], want["weights"][r], atol=1e-4,
                                       err_msg=f"fedfomo round {r + 1} weights")


@pytest.mark.parametrize("name", NAMES)
def test_dense_rounds_match_reference(name):
    _assert_rounds_match(name, port_run(name), ref_run(name), [0, 1])


@pytest.mark.parametrize("name", NAMES)
def test_cohort_rounds_match_reference(name):
    got, want = port_run(name), ref_run(name)
    _assert_rounds_match(name, got, want, [2, 3])
    if name == "fedfomo":  # one weight matrix a round: (m, m) dense, (slots, slots) masked
        assert [w.shape for w in got["weights"]] == [w.shape for w in want["weights"]]
    np.testing.assert_allclose(got["acc"], want["acc"], atol=1.0 / SMALL["n_test"] + 1e-6)


@pytest.mark.parametrize("name", NAMES)
def test_strategy_fields_match_reference(name):
    got, want = port_run(name), ref_run(name)
    assert got["name"] == want["name"] and got["comm"] == want["comm"]


def test_cfl_splits_match_reference():
    """With no warm-up and eps1_rel = 1, every cluster of at least two
    members splits every round, so both packages run the bipartition."""
    kw = dict(warmup_rounds=1, eps1_rel=1.0, min_cluster=2)
    got, want = port_run("cfl", **kw), ref_run("cfl", **kw)
    assert len(np.unique(want["rounds"][-1]["assignment"])) > 2
    _assert_rounds_match("cfl", got, want, [0, 1, 2, 3])


def test_registry_names_match_reference():
    assert set(REGISTRY) == set(ref_core.REGISTRY)
    assert set(NAMES) < set(REGISTRY)


# ------------------------------------------- padded cohorts within the port

# the slabs whose rows outside the cohort a cohort round leaves as they
# were (the FedAvg family's broadcast rewrites every row of the global
# model, and SCAFFOLD's server control every row of c)
UNTOUCHED = {"fedavg": (), "fedprox": (), "scaffold": ("c_i",), "ditto": ("personal",),
             "pfedme": ("params", "personal")}


@pytest.mark.parametrize("name", NAMES)
def test_padded_cohort_equals_unpadded_within_the_port(name):
    _, tdata, _, tparams = small_task()
    _, cfg = _cfgs(name)
    s = REGISTRY[name](lenet.apply_stacked, tparams, cfg, device="cpu")
    m = SMALL["m"]
    state, _ = s.round(s.init(None, tdata), tdata, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    perms = _perms(name, jax.random.PRNGKey(3), cfg.epochs)
    members = np.asarray([1, 3, 5], np.int32)
    padded = participation.pad_slots(Cohort(members, np.ones(3, bool)), SLOTS, m)
    su, mu = s.round(simulation.clone_state(state), tdata, gen, members, perms=perms)
    sp, mp = s.round(simulation.clone_state(state), tdata, gen, padded, perms=perms)
    assert mu == mp
    for k, v in _slabs(su).items():
        np.testing.assert_allclose(n(sp[k]), n(v), rtol=0, atol=1e-6, err_msg=k)
    for k in UNTOUCHED.get(name, ("params",)):
        assert torch.equal(sp[k][[0, 2, 4]], state[k][[0, 2, 4]]), k
        assert not torch.equal(sp[k][members], state[k][members]), k
    if name == "cfl":
        np.testing.assert_array_equal(sp["assignment"], su["assignment"])


def test_cohort_round_draws_from_gen_without_perms():
    _, tdata, _, tparams = small_task()
    _, cfg = _cfgs("ditto")
    s = REGISTRY["ditto"](lenet.apply_stacked, tparams, cfg, device="cpu")
    state = s.init(None, tdata)
    a, _ = s.round(simulation.clone_state(state), tdata, torch.Generator().manual_seed(4),
                   np.arange(3))
    b, _ = s.round(simulation.clone_state(state), tdata, torch.Generator().manual_seed(4),
                   np.arange(3))
    assert torch.equal(a["personal"], b["personal"]) and torch.equal(a["params"], b["params"])
    with pytest.raises(ValueError, match="gen= or perms="):
        s.round(state, tdata, None, np.arange(3))


# -------------------------------------------------------- the library pieces

def _old_local_sgd(apply_stacked, layout, *, lr, momentum, epochs, batch_size):
    """``make_local_sgd`` as it was before the grad hook, the reference for
    the no-hook path's bits."""
    from repro_torch.optim.sgd import sgd_init, sgd_update_

    def local_sgd(slab, x, y, perms):
        units, nn = y.shape
        steps = nn // batch_size
        p = slab.detach().clone().requires_grad_(True)
        buf = sgd_init(p, momentum=momentum)
        rows = torch.arange(units)[:, None]
        for e in range(epochs):
            order = perms[:, e, : steps * batch_size]
            for s in range(steps):
                idx = order[:, s * batch_size: (s + 1) * batch_size]
                loss = client.stacked_loss(apply_stacked, layout.unravel(p), x[rows, idx],
                                           y[rows, idx])
                (g,) = torch.autograd.grad(loss, p)
                sgd_update_(p, g, buf, lr=lr, momentum=momentum)
        return p.detach()

    return local_sgd


@pytest.mark.parametrize("momentum,epochs", [(0.9, 1), (0.0, 2)])
def test_no_grad_hook_keeps_the_bits(momentum, epochs):
    _, tdata, _, tparams = small_task()
    layout = flat.LayoutTable.build(tparams)
    slab = layout.slab(tparams, SMALL["m"])
    perms = t(ref_permutations(jax.random.PRNGKey(5), SMALL["m"], epochs, SMALL["n"], BATCH))
    kw = dict(lr=0.1, momentum=momentum, epochs=epochs, batch_size=BATCH)
    want = _old_local_sgd(lenet.apply_stacked, layout, **kw)(slab, tdata.x, tdata.y, perms)
    got = client.make_local_sgd(lenet.apply_stacked, layout, **kw)(slab, tdata.x, tdata.y, perms)
    assert torch.equal(got, want)
    # an identity hook changes nothing either, and every step gets the hook state
    seen = []

    def identity(g, p, h):
        seen.append(h)
        return g

    hooked = client.make_local_sgd(lenet.apply_stacked, layout, grad_hook=identity, **kw)
    assert torch.equal(hooked(slab, tdata.x, tdata.y, perms, "state"), want)
    assert seen == ["state"] * (epochs * (SMALL["n"] // BATCH))


def test_chunked_hook_state_follows_its_rows():
    """FedProx's hook through chunks of 4 clients gives the unchunked result."""
    _, tdata, _, tparams = small_task()
    layout = flat.LayoutTable.build(tparams)
    slab = layout.slab(tparams, SMALL["m"]) + 0.01 * torch.arange(SMALL["m"])[:, None]
    perms = t(ref_permutations(jax.random.PRNGKey(6), SMALL["m"], 1, SMALL["n"], BATCH))

    def prox(g, p, center):
        return g + 0.1 * (p - center)

    outs = [client.make_federated_local_sgd(lenet.apply_stacked, layout, batch_size=BATCH,
                                            grad_hook=prox, chunk_size=cs)(
        slab, tdata.x, tdata.y, slab * 0.5, perms=perms) for cs in (None, 4)]
    np.testing.assert_allclose(n(outs[1]), n(outs[0]), rtol=0, atol=1e-6)


def _ref_slab(tree, layout):
    """A reference tree with a leading axis -> the port's slab columns."""
    return layout.ravel({k: t(np.asarray(v)) for k, v in tree.items()})


def test_full_and_minibatch_gradients_match_reference():
    data, tdata, params0, tparams = small_task()
    layout = flat.LayoutTable.build(tparams)
    rng = np.random.default_rng(7)
    stacked = {k: np.stack([v + 0.01 * rng.normal(size=v.shape).astype(np.float32)
                            for _ in range(SMALL["m"])]) for k, v in params0.items()}
    slab = layout.ravel({k: t(v) for k, v in stacked.items()})
    jstacked = {k: jnp.asarray(v) for k, v in stacked.items()}
    want = jax.jit(lambda p: ref_client.full_gradients(ref_lenet.apply, p, data.x, data.y))(
        jstacked)
    got = client.full_gradients(lenet.apply_stacked, layout, slab, tdata.x, tdata.y)
    np.testing.assert_allclose(n(got), n(_ref_slab(want, layout)), atol=1e-5)
    k, b = 4, SMALL["n"] // 4
    xb = data.x.reshape((SMALL["m"], k, b) + data.x.shape[2:])
    yb = data.y.reshape(SMALL["m"], k, b)
    want = jax.jit(lambda p: ref_client.minibatch_gradients(ref_lenet.apply, p, xb, yb))(
        jstacked)
    got = client.minibatch_gradients(lenet.apply_stacked, layout, slab,
                                     tdata.x.reshape(xb.shape), tdata.y.reshape(yb.shape))
    assert tuple(got.shape) == (SMALL["m"], k, layout.dim_aligned)
    np.testing.assert_allclose(n(got), n(_ref_slab(want, layout)), atol=1e-5)


def test_collaboration_round_matches_reference():
    rng = np.random.default_rng(8)
    base = rng.normal(size=(3, 1, 200)).astype(np.float32)
    g = (base[np.arange(6) % 3] + 0.3 * rng.normal(size=(6, 5, 200))).astype(np.float32)
    nn = np.array([50, 80, 80, 120, 60, 90], np.int32)
    want = jax.jit(ref_similarity.collaboration_round)(jnp.asarray(g), jnp.asarray(nn))
    got = similarity.collaboration_round(t(g), t(nn))
    assert sorted(got) == sorted(want)
    scale = float(np.asarray(want["delta"]).max())
    for k, tol in (("full_grads", 1e-6), ("sigma_sq", 1e-4), ("delta", 1e-5 * scale),
                   ("W", 1e-5)):
        np.testing.assert_allclose(n(got[k]), np.asarray(want[k]), rtol=1e-5, atol=tol,
                                   err_msg=k)


def _cohort_inputs(seed=9):
    rng = np.random.default_rng(seed)
    m, c, d = 7, 4, 33
    w = rng.random((m, m)).astype(np.float32)
    w[2, [0, 3, 5, 6]] = 0.0  # row 2 has no mass on the cohort's columns
    w /= w.sum(axis=1, keepdims=True)
    cohort = np.array([0, 3, 5, 6], np.int32)
    theta = {"a": rng.normal(size=(c, 3, 5)).astype(np.float32),
             "b": rng.normal(size=(c, 18)).astype(np.float32)}
    return w, cohort, theta, rng.integers(10, 90, size=c).astype(np.int32), m, d


def test_unpadded_cohort_rules_match_reference():
    w, cohort, theta, n_c, m, _ = _cohort_inputs()
    jt = {k: jnp.asarray(v) for k, v in theta.items()}
    tt = {k: t(v) for k, v in theta.items()}
    gw, galive = aggregation.cohort_column_mixing(t(w), t(cohort))
    ww, walive = ref_agg.cohort_column_mixing(jnp.asarray(w), jnp.asarray(cohort))
    np.testing.assert_allclose(n(gw), np.asarray(ww), atol=1e-6)
    np.testing.assert_array_equal(n(galive), np.asarray(walive))
    assert not n(galive)[2]
    got = aggregation.fedavg_cohort(tt, t(n_c), m)
    want = jax.jit(lambda x, nc: ref_agg.fedavg_cohort(x, nc, m))(jt, jnp.asarray(n_c))
    for k in theta:
        assert tuple(got[k].shape) == (m,) + theta[k].shape[1:]
        np.testing.assert_allclose(n(got[k]), np.asarray(want[k]), atol=1e-6, err_msg=k)
    got = aggregation.user_centric_cohort(tt, t(w), t(cohort))
    want = jax.jit(ref_agg.user_centric_cohort)(jt, jnp.asarray(w), jnp.asarray(cohort))
    for k in theta:
        np.testing.assert_allclose(n(got[k]), np.asarray(want[k]), atol=1e-6, err_msg=k)


def test_tree_mix_scatter_matches_reference():
    w, cohort, theta, _, m, _ = _cohort_inputs()
    c = len(cohort)
    d = sum(int(np.prod(v.shape[1:])) for v in theta.values())
    full = np.random.default_rng(10).normal(size=(m, d)).astype(np.float32)
    idx = np.array([0, 3, 5, m], np.int32)
    mask = np.array([1, 1, 1, 0], bool)
    rows = np.random.default_rng(11).random((c, c)).astype(np.float32) * mask[None, :]
    jt = {k: jnp.asarray(v) for k, v in theta.items()}
    args = (jnp.asarray(rows), jnp.asarray(idx), jnp.asarray(mask))
    want = jax.jit(ref_agg.mix_scatter)(jnp.asarray(full), jt, *args)
    targs = (t(rows), t(idx), t(mask))
    tt = {k: t(v) for k, v in theta.items()}
    got = aggregation.mix_scatter(t(full), tt, *targs)
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="one"):  # the state is one slab, not a tree
        aggregation.mix_scatter({"a": t(full), "b": t(full)}, tt, *targs)


def test_group_rules_match_reference():
    rng = np.random.default_rng(12)
    assignment = np.array([0, 2, 0, 1, 2, 2, 1], np.int32)
    nn = rng.integers(10, 90, size=7).astype(np.int32)
    theta = rng.normal(size=(7, 40)).astype(np.float32)
    want = ref_common.group_mixing_matrix(jnp.asarray(assignment), jnp.asarray(nn))
    got = common.group_mixing_matrix(t(assignment), t(nn))
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-6)
    want = jax.jit(ref_common.group_average)(jnp.asarray(theta), jnp.asarray(assignment),
                                             jnp.asarray(nn))
    got = common.group_average(t(theta), t(assignment), t(nn))
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-6)


def test_scatter_rows_writes_the_real_prefix_only():
    full = torch.arange(12.0).view(6, 2)
    idx = torch.tensor([4, 1, 6, 6], dtype=torch.int32)
    out = aggregation.scatter_rows(full, idx, -torch.ones(4, 2), 2)
    assert torch.equal(full, torch.arange(12.0).view(6, 2)), "the CPU version writes a copy"
    want = full.clone()
    want[[4, 1]] = -1.0
    assert torch.equal(out, want)


def test_fedfomo_loss_matrix_is_chunk_invariant():
    _, tdata, _, tparams = small_task()
    layout = flat.LayoutTable.build(tparams)
    slab = layout.slab(tparams, 5) + 0.05 * torch.randn(5, layout.dim_aligned,
                                                        generator=torch.Generator().manual_seed(0))
    slab[:, layout.dim:] = 0.0
    xv, yv = tdata.x[:5, :7], tdata.y[:5, :7]
    whole = fedfomo.loss_matrix(lenet.apply_stacked, layout, slab, xv, yv, 5)
    for chunk in (1, 2):
        np.testing.assert_allclose(
            n(fedfomo.loss_matrix(lenet.apply_stacked, layout, slab, xv, yv, chunk)),
            n(whole), rtol=1e-6)
    # column j: model j on every client's rows, averaged per client
    logits = lenet.apply_stacked(layout.unravel(slab[2:3]), xv[1:2])
    ce = torch.nn.functional.cross_entropy(logits[0], yv[1])
    np.testing.assert_allclose(float(whole[1, 2]), float(ce), rtol=1e-6)


def test_fedfomo_weights_are_row_stochastic_over_real_columns():
    rng = np.random.default_rng(13)
    lmat = t(rng.random((5, 5)).astype(np.float32))
    flat_ = t(rng.normal(size=(5, 64)).astype(np.float32))
    mask = t(np.array([1, 1, 1, 0, 0], np.float32))
    w = fedfomo.fomo_weights(lmat, flat_, mask)
    assert float(w[:, 3:].abs().max()) == 0.0 and float(torch.diagonal(w).abs().max()) == 0.0
    sums = n(w.sum(dim=1))
    assert np.all((np.abs(sums - 1) < 1e-6) | (sums == 0))
