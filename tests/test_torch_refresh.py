"""The streaming W refresh (``FedConfig.w_refresh``) in both packages.

The rules (``masked_ewma_rows``, ``masked_unit_ewma_rows``,
``masked_delta_rows``, ``staleness_update``) and ``streaming_refresh`` on
numpy inputs from a seed, each with the reference's slot arrays (a
demoted slot carries the sentinel m) and with the engine's (the pre-stage
prefix, a host count, and the final mask): unit-direction buffers within
1e-6, Δ̂, σ̂² and W within 1e-5, staleness exact. The port's buffers are
slab-wide (128-aligned) with a zero tail; the reference's are the true
width.

Trajectories: ``ucfl`` and its clustered variant with ``RefreshConfig()``,
init plus two padded-cohort rounds from the reference's batch orders,
against the reference within 1e-4 (slab, W, every buffer), staleness
exact. Within the port: pads and demoted slots leave every buffer as it
was, a skipped round ages staleness, a padded cohort equals the unpadded
one, and the knob changes nothing where it does not apply (the dense
round, strategies without a W), bit for bit.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FedConfig as RefFedConfig
from repro.core import aggregation as ref_agg
from repro.core import clustering as ref_clustering
from repro.core import similarity as ref_similarity
from repro.core import ucfl as ref_ucfl
from repro.core.baselines import common as ref_common
from repro.federated import simulation as ref_simulation
from repro.models import lenet as ref_lenet
from repro_torch.core import REGISTRY, FedConfig, aggregation, similarity, ucfl
from repro_torch.core.similarity import RefreshConfig
from repro_torch.federated import participation, simulation
from repro_torch.models import lenet
from torch_parity import (BATCH, SMALL, VAR_BATCH, key_schedule, n,  # noqa: F401
                          one_torch_thread, padded_cohorts, ref_cohort, ref_permutations,
                          small_task, t)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

M, D, C = 8, 40, 5
D_AL = 128
CLUSTERS = 4
# the reference's slot arrays (slot 1 demoted, slot 4 a pad) and the
# engine's: the pre-stage prefix of 4 real members with the final mask
REF_IDX = np.array([1, M, 4, 6, M], np.int32)
PRE_IDX = np.array([1, 3, 4, 6, M], np.int32)
MASK = np.array([1, 0, 1, 1, 0], bool)
REAL = 4


def _unit(a):
    return (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    grads = _unit(rng.normal(size=(M, D)))
    obs = _unit(rng.normal(size=(C, D)))
    delta = np.abs(rng.normal(size=(M, M))).astype(np.float32)
    sig = np.abs(rng.normal(size=(M,))).astype(np.float32)
    stale = rng.integers(0, 5, size=M).astype(np.int32)
    return grads, obs, delta, sig, stale


def _slots(kind):
    if kind == "reference":
        return t(REF_IDX), t(MASK), None
    return t(PRE_IDX), t(MASK), REAL


@pytest.mark.parametrize("slots", ["reference", "prefix"])
@pytest.mark.parametrize("rule", ["masked_ewma_rows", "masked_unit_ewma_rows",
                                  "masked_delta_rows", "staleness_update"])
def test_refresh_rule_matches_reference(rule, slots):
    grads, obs, delta, sig, stale = _inputs()
    idx, mask, real = _slots(slots)
    ref_slots = (jnp.asarray(REF_IDX), jnp.asarray(MASK))
    if rule == "masked_ewma_rows":
        want = jax.jit(ref_agg.masked_ewma_rows, static_argnums=4)(sig, obs[:, 0] ** 2,
                                                                   *ref_slots, 0.25)
        got = aggregation.masked_ewma_rows(t(sig), t(obs[:, 0] ** 2), idx, mask, 0.25, real=real)
        tol = 1e-5
    elif rule == "masked_unit_ewma_rows":
        want = jax.jit(ref_agg.masked_unit_ewma_rows, static_argnums=4)(grads, obs, *ref_slots,
                                                                        0.25)
        got = aggregation.masked_unit_ewma_rows(t(grads), t(obs), idx, mask, 0.25, real=real)
        tol = 1e-6
    elif rule == "masked_delta_rows":
        want = jax.jit(ref_agg.masked_delta_rows)(delta, grads, *ref_slots)
        got = aggregation.masked_delta_rows(t(delta), t(grads), idx, mask, real=real)
        tol = 1e-5
    else:
        want = jax.jit(ref_agg.staleness_update)(stale, *ref_slots)
        got = aggregation.staleness_update(t(stale), idx, mask, real=real)
        tol = 0
    np.testing.assert_allclose(n(got), n(want), atol=tol, rtol=0)


def _collab(rng, d=D):
    full = rng.normal(size=(M, d)).astype(np.float32)
    sig = np.abs(rng.normal(size=(M,))).astype(np.float32) * 3.0
    return full, sig


def _ref_refresh(full, sig, obs_rounds, cfg):
    refresh = jax.jit(ref_similarity.init_refresh_state, static_argnums=1)(
        {"full_grads": full, "sigma_sq": sig}, M)
    step = jax.jit(functools.partial(ref_similarity.streaming_refresh, cfg=cfg))
    out = []
    for obs in obs_rounds:
        refresh, w = step(refresh, obs, jnp.asarray(REF_IDX), jnp.asarray(MASK),
                          jnp.full((M,), 50.0))
        out.append((jax.tree.map(np.asarray, refresh), np.asarray(w)))
    return out


def _port_refresh(full, sig, obs_rounds, cfg, slots):
    idx, mask, real = _slots(slots)
    refresh = similarity.init_refresh_state({"full_grads": t(full), "sigma_sq": t(sig)}, M,
                                            width=D_AL)
    out = []
    for obs in obs_rounds:
        wide = np.zeros((C, D_AL), np.float32)
        wide[:, :D] = obs
        refresh, w = similarity.streaming_refresh(refresh, t(wide), idx, mask,
                                                  torch.full((M,), 50.0), cfg=cfg, real=real)
        out.append(({k: n(v) for k, v in refresh.items()}, n(w)))
    return out


def _assert_buffers_match(got, want):
    assert got["grads"].shape == (M, D_AL)
    assert not got["grads"][:, D:].any()  # the slab-wide tail stays zero
    np.testing.assert_allclose(got["grads"][:, :D], want["grads"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(got["sigma_sq"], want["sigma_sq"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["delta"], want["delta"], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got["staleness"], want["staleness"])


@pytest.mark.parametrize("slots", ["reference", "prefix"])
@pytest.mark.parametrize("alpha", [0.25, 1.0])
def test_streaming_refresh_matches_reference(alpha, slots):
    rng = np.random.default_rng(3)
    full, sig = _collab(rng)
    obs_rounds = [rng.normal(size=(C, D)).astype(np.float32) * s for s in (1e-2, 3.0)]
    want = _ref_refresh(full, sig, obs_rounds, ref_similarity.RefreshConfig(alpha, alpha))
    got = _port_refresh(full, sig, obs_rounds, RefreshConfig(alpha, alpha), slots)
    for (gb, gw), (wb, ww) in zip(got, want):
        _assert_buffers_match(gb, wb)
        np.testing.assert_allclose(gw, ww, atol=1e-5, rtol=0)
        np.testing.assert_allclose(gw.sum(axis=1), 1.0, atol=1e-5)


def test_init_refresh_state_matches_reference_and_is_a_copy():
    rng = np.random.default_rng(4)
    full, sig = _collab(rng)
    collab = {"full_grads": t(full), "sigma_sq": t(sig)}
    got = similarity.init_refresh_state(collab, M, width=D_AL)
    want = jax.jit(ref_similarity.init_refresh_state, static_argnums=1)(
        {"full_grads": full, "sigma_sq": sig}, M)
    _assert_buffers_match({k: n(v) for k, v in got.items()}, jax.tree.map(np.asarray, want))
    assert got["grads"].is_contiguous() and got["staleness"].dtype == torch.int32
    assert got["sigma_sq"].data_ptr() != collab["sigma_sq"].data_ptr()
    # the true-width buffers give the same numbers
    narrow = similarity.init_refresh_state(collab, M)
    np.testing.assert_array_equal(n(narrow["grads"]), n(got["grads"])[:, :D])


def test_pads_and_demoted_slots_leave_buffers_untouched():
    rng = np.random.default_rng(5)
    full, sig = _collab(rng, D_AL)
    refresh = similarity.init_refresh_state({"full_grads": t(full), "sigma_sq": t(sig)}, M)
    before = {k: v.clone() for k, v in refresh.items()}
    obs = t(rng.normal(size=(C, D_AL)).astype(np.float32) * 1e3)
    idx, mask, real = _slots("prefix")
    new, _ = similarity.streaming_refresh(refresh, obs, idx, mask, torch.full((M,), 50.0),
                                          cfg=RefreshConfig(), real=real)
    live = PRE_IDX[MASK]
    still = np.setdiff1d(np.arange(M), live)  # absent, demoted (3) and never-sampled clients
    for k in ("grads", "sigma_sq"):
        assert torch.equal(new[k][still], before[k][still]), k
        assert not torch.equal(new[k][live], before[k][live]), k
    d_new, d_old = n(new["delta"]), n(before["delta"])
    np.testing.assert_array_equal(d_new[np.ix_(still, still)], d_old[np.ix_(still, still)])
    assert np.allclose(d_new, d_new.T, atol=1e-5) and np.all(np.diag(d_new) <= 1e-5)
    np.testing.assert_array_equal(n(new["staleness"])[live], 0)
    np.testing.assert_array_equal(n(new["staleness"])[still], n(before["staleness"])[still] + 1)


def test_skip_round_ages_staleness():
    _, tdata, _, tparams = small_task()
    s = ucfl.make_ucfl(lenet.apply_stacked, tparams,
                       FedConfig(batch_size=BATCH, w_refresh=RefreshConfig()),
                       var_batch_size=VAR_BATCH, device="cpu")
    state = s.init(None, tdata)
    state["refresh"]["staleness"] = torch.arange(SMALL["m"], dtype=torch.int32)
    aged = s.skip_round(state)
    np.testing.assert_array_equal(n(aged["refresh"]["staleness"]), np.arange(SMALL["m"]) + 1)
    ref = ref_common.refresh_skip_round({"refresh": {"staleness": jnp.arange(SMALL["m"])}})
    np.testing.assert_array_equal(n(aged["refresh"]["staleness"]),
                                  np.asarray(ref["refresh"]["staleness"]))
    assert torch.equal(aged["params"], state["params"])
    plain = ucfl.make_ucfl(lenet.apply_stacked, tparams, FedConfig(batch_size=BATCH),
                           var_batch_size=VAR_BATCH, device="cpu")
    assert plain.skip_round is None and "refresh" not in plain.init(None, tdata)


def test_simulation_skips_an_offline_round_and_logs_staleness(capsys):
    _, tdata, _, tparams = small_task()
    m = SMALL["m"]
    trace = np.ones((m, 3), bool)
    trace[:, 1] = False  # round 2 is all-offline
    pcfg = participation.ParticipationConfig(cohort_size=3, sampler="availability",
                                             availability=trace)
    s = ucfl.make_ucfl(lenet.apply_stacked, tparams,
                       FedConfig(batch_size=BATCH, w_refresh=RefreshConfig()),
                       var_batch_size=VAR_BATCH, device="cpu")
    hist = simulation.run(s, lenet.apply_stacked, tdata, 0, rounds=3, participation=pcfg,
                          device="cpu", verbose=True)
    assert hist.metrics[1].get("skipped")
    stale = n(hist.state["refresh"]["staleness"])
    members = participation.sample_cohort(pcfg, 3, m).members
    np.testing.assert_array_equal(stale[members], 0)
    assert stale.max() == 3  # sampled in no round: round 1, the skip and round 3
    lines = [ln for ln in capsys.readouterr().out.splitlines() if "stale_max=" in ln]
    assert len(lines) == 2 and "stale_max=3" in lines[-1]


# ---------------------------------------------------------------- trajectories


def _ref_strategy(name):
    _, _, params0, _ = small_task()
    cfg = RefFedConfig(batch_size=BATCH, w_refresh=ref_similarity.RefreshConfig())
    return ref_ucfl.make_ucfl(ref_lenet.apply, params0, cfg,
                                   num_streams=None if name == "ucfl" else CLUSTERS,
                                   var_batch_size=VAR_BATCH)


def _port_strategy(name, **kw):
    _, _, _, tparams = small_task()
    cfg = FedConfig(batch_size=BATCH, **kw)
    return ucfl.make_ucfl(lenet.apply_stacked, tparams, cfg,
                          num_streams=None if name == "ucfl" else CLUSTERS,
                          var_batch_size=VAR_BATCH, device="cpu")


def _buffers(state):
    out = {"params": np.array(state["params"]), "W": np.array(state["W"])}
    out.update({k: np.array(v) for k, v in state["refresh"].items()})
    return out


@functools.lru_cache(maxsize=None)
def ref_run(name):
    data, _, _, _ = small_task()
    strat = _ref_strategy(name)
    ikey, rounds = key_schedule(padded_cohorts())
    state = dict(jax.jit(strat.init)(ikey, data), streams=None if name == "ucfl" else CLUSTERS)
    seeds = None
    if name == "clustered":
        seeds = np.asarray(jax.jit(ref_clustering._plusplus_init, static_argnums=2)(
            ikey, state["W"].astype(jnp.float32), CLUSTERS))
    out, metrics = [_buffers(state)], []
    for rkey, cohort in rounds:
        state, met = strat.round(ref_simulation.donation_safe_copy(state), data, rkey,
                                 ref_cohort(cohort))
        out.append(_buffers(state))
        metrics.append({k: np.asarray(met[k]) for k in ("streams", "staleness_max",
                                                        "staleness_mean")})
    return dict(states=out, metrics=metrics, seeds=seeds)


def _port_run(name, cohorts, **kw):
    _, tdata, _, _ = small_task()
    strat = _port_strategy(name, w_refresh=RefreshConfig(), **kw)
    seeds = ref_run(name)["seeds"]
    state = strat.init(None, tdata, kmeans_init=None if seeds is None else t(seeds))
    _, rounds = key_schedule(padded_cohorts())
    out, metrics = [_buffers(state)], []
    for (rkey, _), cohort in zip(rounds, cohorts):
        perms = t(ref_permutations(rkey, SMALL["m"], 1, SMALL["n"], BATCH))
        state, met = strat.round(state, tdata, None, cohort, perms=perms)
        out.append(_buffers(state))
        metrics.append(met)
    return dict(states=out, metrics=metrics)


@pytest.mark.parametrize("name", ["ucfl", "clustered"])
def test_refresh_trajectory_matches_reference(name):
    want, got = ref_run(name), _port_run(name, padded_cohorts())
    for r, (g, w) in enumerate(zip(got["states"], want["states"])):
        dim = w["grads"].shape[1]
        assert not g["grads"][:, dim:].any()
        for k in ("params", "W", "grads", "sigma_sq", "delta"):
            gv = g[k][:, :dim] if k == "grads" else g[k]
            np.testing.assert_allclose(gv, w[k], atol=1e-4, rtol=0, err_msg=f"{name} {r} {k}")
        np.testing.assert_array_equal(g["staleness"], w["staleness"])
    for g, w in zip(got["metrics"], want["metrics"]):
        assert g["streams"] == int(w["streams"])
        assert int(g["staleness_max"]) == int(w["staleness_max"])
        assert float(g["staleness_mean"]) == pytest.approx(float(w["staleness_mean"]))


@pytest.mark.parametrize("name", ["ucfl", "clustered"])
def test_refresh_padded_cohort_equals_unpadded(name):
    padded = padded_cohorts()
    plain = [participation.as_cohort(c.members, SMALL["m"]) for c in padded]
    a, b = _port_run(name, padded), _port_run(name, plain)
    for sa, sb in zip(a["states"], b["states"]):
        for k in sa:
            np.testing.assert_allclose(sa[k], sb[k], atol=1e-6, rtol=0, err_msg=k)


OFF_NAMES = ["ucfl", "clustered", "ucfl_parallel", "fedavg", "fedprox", "local", "oracle",
             "scaffold", "ditto", "pfedme", "fedfomo", "cfl"]
OFF_CFG = {"scaffold": dict(lr=0.01, momentum=0.0, epochs=5),
           "pfedme": dict(lr=0.01, momentum=0.0, epochs=1)}


def make_port(name, **kw):
    """Strategy ``name`` at its reference defaults and the small batch, with
    the ``FedConfig`` knobs ``kw``, on the CPU."""
    _, _, _, tparams = small_task()
    cfg = FedConfig(**OFF_CFG.get(name, {}), batch_size=BATCH, **kw)
    if name in ("ucfl", "clustered"):
        return _port_strategy(name, **kw)
    if name == "ucfl_parallel":
        return REGISTRY[name](lenet.apply_stacked, tparams, cfg, var_batch_size=VAR_BATCH,
                              device="cpu")
    return REGISTRY[name](lenet.apply_stacked, tparams, cfg, device="cpu")


@pytest.mark.parametrize("name", OFF_NAMES)
def test_refresh_changes_nothing_where_it_does_not_apply(name):
    """The W owners' dense round never refreshes; the strategies without a
    W ignore the knob in their cohort rounds: bit for bit the run without
    ``w_refresh``."""
    _, tdata, _, _ = small_task()
    runs = []
    for kw in ({}, {"w_refresh": RefreshConfig()}):
        strat = make_port(name, **kw)
        state = strat.init(torch.Generator().manual_seed(0), tdata)
        cohort = None if name in ("ucfl", "clustered", "ucfl_parallel") else padded_cohorts()[0]
        state, _ = strat.round(state, tdata, torch.Generator().manual_seed(1), cohort)
        runs.append(state)
    for k, v in runs[0].items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, runs[1][k]), k
