"""Fault injection, the finite guard and the robust rules
(``FedConfig.faults``/``robust``) in both packages.

Rules, on numpy slabs from a seed: trimmed mean, median and the Krum
selections bit for bit against the reference (compiled), norm clip within
1e-6, Krum scores within rtol 1e-5; ``inject`` and ``finite_guard`` bit
for bit against the reference's op-by-op path, fed the reference's own
draws (``torch_parity.ref_fault_draws``); the properties of the
reference's ``tests/test_faults.py`` (there hypothesis tests, here a few
seeds each).

Strategies: ucfl, its clustered variant and the nine baselines (CFL also
past its warm-up, where the final mask comes to the host), each under
sign-flip attackers and drops with ``RobustConfig("trimmed_mean")``: two
padded-cohort rounds against the reference within 1e-4 (every slab),
streams exact, the port fed the reference's batch orders and fault draws.
Within the port: ``FaultConfig()`` (no attack, no drop) and every neutral
robust rule give the run without the knob bit for bit; a padded cohort
equals the unpadded one under faults; a NaN upload never reaches the
state; a dense round with the stage raises ``ValueError``; ``run`` stands
its finite check down when the strategy injects faults.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as ref_core
from repro.core import FedConfig as RefFedConfig
from repro.core import aggregation as ref_agg
from repro.core import clustering as ref_clustering
from repro.core import similarity as ref_similarity
from repro.core import ucfl as ref_ucfl
from repro.federated import faults as ref_faults
from repro.federated import simulation as ref_simulation
from repro.models import lenet as ref_lenet
from repro_torch.core import REGISTRY, FedConfig, aggregation, similarity, ucfl
from repro_torch.core.aggregation import RobustConfig
from repro_torch.federated import faults, participation, simulation, transport
from repro_torch.models import lenet
from torch_parity import (BATCH, SMALL, VAR_BATCH, key_schedule, n,  # noqa: F401
                          one_torch_thread, padded_cohorts, ref_cohort, ref_fault_draws,
                          ref_permutations, small_task, t)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NAMES = ["ucfl", "clustered", "fedavg", "fedprox", "local", "oracle", "scaffold", "ditto",
         "pfedme", "fedfomo", "cfl"]
SLABS = ("params", "personal", "c_i", "c")
CLUSTERS = 4
CFG = {"scaffold": dict(lr=0.01, momentum=0.0, epochs=5),
       "pfedme": dict(lr=0.01, momentum=0.0, epochs=1)}
N_VAL = int(SMALL["n"] * 0.2)  # FedFomo's validation split
# two attackers of six, a drop now and then; trimmed mean demotes the flips
FAULTS = dict(seed=0, byzantine_frac=0.34, attack="sign_flip", drop_rate=0.25)
ROBUST = dict(rule="trimmed_mean", trim_k=1)
NEUTRAL = {"trimmed_mean": dict(rule="trimmed_mean", trim_k=0),
           "norm_clip": dict(rule="norm_clip", clip=math.inf),
           "multi_krum": dict(rule="multi_krum", q=5)}


def _slab(seed, c=6, d=16, scale=1.0):
    return (np.random.default_rng(seed).normal(size=(c, d)) * scale).astype(np.float32)


# ------------------------------------------------------------------- rules

RULE_MASKS = [np.ones(6, bool), np.array([1, 1, 0, 1, 1, 1], bool),
              np.array([1, 0, 1, 1, 0, 1], bool), np.array([1, 1, 1, 0, 0, 0], bool)]


def _ref_stage(cfg):
    return jax.jit(ref_agg.robust_stage(ref_agg.RobustConfig(**cfg)), static_argnums=3)


@pytest.mark.parametrize("mask_i", range(len(RULE_MASKS)))
@pytest.mark.parametrize("rule", ["trimmed_mean", "trimmed_mean_k2", "median", "norm_clip",
                                  "krum", "multi_krum"])
def test_robust_stage_matches_reference(rule, mask_i):
    cfg = {"trimmed_mean": dict(rule="trimmed_mean", trim_k=1),
           "trimmed_mean_k2": dict(rule="trimmed_mean", trim_k=2),
           "median": dict(rule="median"), "norm_clip": dict(rule="norm_clip", clip=2.0),
           "krum": dict(rule="krum", f=1), "multi_krum": dict(rule="multi_krum", f=1)}[rule]
    flat = _slab(10 + mask_i, d=64)
    flat[2] = -30.0 * np.abs(flat[2]) - 30.0  # an outlier row in every coordinate
    mask = RULE_MASKS[mask_i]
    idx = np.where(mask, np.arange(6), 8).astype(np.int32)
    want = _ref_stage(cfg)(flat, idx, mask, 8)
    got = aggregation.robust_stage(RobustConfig(**cfg))(t(flat), t(idx), t(mask), 8)
    if rule == "norm_clip":
        np.testing.assert_allclose(n(got[0]), np.asarray(want[0]), atol=1e-6, rtol=0)
    else:
        np.testing.assert_array_equal(n(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(n(got[1]), np.asarray(want[1]))
    np.testing.assert_array_equal(n(got[2]), np.asarray(want[2]))


@pytest.mark.parametrize("seed", range(3))
def test_krum_scores_match_reference(seed):
    flat = _slab(seed, scale=0.5)
    flat[3] += 100.0
    mask = np.array([1, 1, 1, 1, 0, 1], bool)
    want = np.asarray(jax.jit(ref_agg.krum_scores, static_argnums=2)(flat, mask, 1))
    got = n(aggregation.krum_scores(t(flat), t(mask), 1))
    np.testing.assert_allclose(got[mask], want[mask], rtol=1e-5)
    np.testing.assert_array_equal(got[~mask], want[~mask])


def test_robust_config_validation_and_types():
    with pytest.raises(ValueError, match="unknown robust rule"):
        RobustConfig(rule="mean")
    with pytest.raises(ValueError, match="trim_k"):
        RobustConfig(trim_k=-1)
    with pytest.raises(ValueError, match="clip"):
        RobustConfig(rule="norm_clip", clip=0.0)
    assert aggregation.robust_stage(None) is None
    with pytest.raises(TypeError, match="RobustConfig"):
        aggregation.robust_stage(ref_agg.RobustConfig())
    with pytest.raises(TypeError, match="FaultConfig"):
        faults.upload_stage(ref_faults.FaultConfig())
    assert faults.upload_stage(None, None) is None


# the properties of the reference's tests/test_faults.py:293-370

def test_trimmed_stage_demotes_supermajority_outlier():
    flat = _slab(3, c=6, d=64)
    flat[1] = -50.0 * np.abs(flat[1]) - 50.0
    idx = np.arange(6, dtype=np.int32)
    out, idx2, mask2 = aggregation.robust_stage(RobustConfig("trimmed_mean", trim_k=1))(
        t(flat), t(idx), t(np.ones(6, bool)), 8)
    np.testing.assert_array_equal(n(mask2), [1, 0, 1, 1, 1, 1])
    assert n(idx2)[1] == 8 and (n(idx2)[n(mask2)] == idx[n(mask2)]).all()
    assert np.isfinite(n(out)).all()


@pytest.mark.parametrize("seed,trim_k", [(0, 0), (1, 1), (2, 2), (3, 1)])
def test_trimmed_mean_permutation_invariant(seed, trim_k):
    flat = _slab(seed)
    mask = np.asarray([1, 1, 1, 1, 0, 1], bool)
    perm = np.random.default_rng(seed + 1).permutation(6)
    a = n(aggregation.masked_trimmed_mean(t(flat), t(mask), trim_k))
    b = n(aggregation.masked_trimmed_mean(t(flat[perm]), t(mask[perm]), trim_k))
    np.testing.assert_allclose(a[perm], b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed,evil_scale", [(0, 1.0), (1, 1e3), (2, 1e6)])
def test_median_breakdown_bounded_by_honest_range(seed, evil_scale):
    rng = np.random.default_rng(seed)
    c, d = 7, 4
    flat = rng.normal(size=(c, d)).astype(np.float32)
    evil = rng.permutation(c)[:(c - 1) // 2]
    honest = np.setdiff1d(np.arange(c), evil)
    flat[evil] = rng.normal(size=(len(evil), d)).astype(np.float32) * evil_scale
    out = n(aggregation.masked_median_rows(t(flat), t(np.ones(c, bool))))
    assert (out[honest[0]] >= flat[honest].min(axis=0) - 1e-5).all()
    assert (out[honest[0]] <= flat[honest].max(axis=0) + 1e-5).all()


@pytest.mark.parametrize("seed", range(3))
def test_norm_clip_noop_on_inlier_rows(seed):
    flat = _slab(seed, scale=0.1)
    out = aggregation.masked_norm_clip(t(flat), t(np.ones(6, bool)), 1e6)
    np.testing.assert_array_equal(n(out), flat)


@pytest.mark.parametrize("seed", range(3))
def test_multi_krum_keeps_central_drops_outlier(seed):
    flat = _slab(seed, scale=0.5)
    flat[3] += 100.0
    _, idx2, mask2 = aggregation.robust_stage(RobustConfig("multi_krum", f=1))(
        t(flat), t(np.arange(6, dtype=np.int32)), t(np.ones(6, bool)), 8)
    assert not n(mask2)[3] and n(idx2)[3] == 8
    assert n(mask2).sum() == 5


# --------------------------------------------------- injection and the guard

@pytest.mark.parametrize("attack", ["sign_flip", "scaled_noise", "nan", "inf"])
def test_inject_and_finite_guard_match_reference(attack):
    """Bit for bit against the reference's op-by-op path (jit off), fed the
    reference's own draws of the round."""
    kw = dict(seed=2, byzantine_frac=0.5, attack=attack, attack_scale=3.0, drop_rate=0.3)
    rcfg, cfg = ref_faults.FaultConfig(**kw), faults.FaultConfig(**kw)
    rng = np.random.default_rng(7)
    pre = rng.normal(size=(6, 32)).astype(np.float32)
    post = pre + 0.1 * rng.normal(size=(6, 32)).astype(np.float32)
    idx = np.array([0, 1, 3, 4, 6, 7], np.int32)
    mask = np.array([1, 1, 1, 1, 1, 0], bool)
    idx[5] = 8
    key = jax.random.PRNGKey(11)
    with jax.disable_jit():
        want = ref_faults.inject(rcfg, jnp.asarray(pre), jnp.asarray(post), jnp.asarray(idx),
                                 jnp.asarray(mask), key, 8)
        want_g = ref_faults.finite_guard(*want, 8)
    draws = ref_fault_draws(rcfg, key, 8, 32)
    got = faults.inject(cfg, t(pre), t(post), t(idx), t(mask), 8, draws)
    got_g = faults.finite_guard(*got, 8)
    for g, w in zip(got + got_g, want + want_g):
        np.testing.assert_array_equal(n(g), np.asarray(w))
    assert np.isfinite(n(got_g[0])).all()
    assert faults.num_attackers(cfg, 8) == ref_faults.num_attackers(rcfg, 8) == 4


def test_finite_guard_checks_every_stream():
    schema = transport.WireSchema("scaffold", uplink=(transport.Stream("delta", 100),
                                                      transport.Stream("control_delta", 100)))
    flat = _slab(0, c=4, d=256)
    flat[1, 200] = np.nan  # the control stream only
    flat[2, 3] = np.inf
    out, idx, mask = faults.finite_guard(t(flat), t(np.arange(4, dtype=np.int32)),
                                         t(np.ones(4, bool)), 9, schema)
    np.testing.assert_array_equal(n(mask), [1, 0, 0, 1])
    np.testing.assert_array_equal(n(idx), [0, 9, 9, 3])
    assert not n(out)[[1, 2]].any() and np.array_equal(n(out)[[0, 3]], flat[[0, 3]])


def test_draws_are_static_client_indexed_and_sized_as_the_reference():
    cfg = faults.FaultConfig(seed=4, byzantine_frac=0.3, attack="scaled_noise", drop_rate=0.5)
    a, b = faults.draw(cfg, 10, 16, 3, "cpu"), faults.draw(cfg, 10, 16, 3, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    c = faults.draw(cfg, 10, 16, 4, "cpu")
    assert torch.equal(a.attacker, c.attacker) and not torch.equal(a.uniforms, c.uniforms)
    assert int(a.attacker.sum()) == int(np.asarray(
        ref_faults.attacker_mask(ref_faults.FaultConfig(seed=4, byzantine_frac=0.3), 10)).sum())
    assert tuple(a.noise.shape) == (10, 16)
    assert faults.draw(faults.FaultConfig(), 10, 16, 0, "cpu").noise is None
    with pytest.raises(ValueError, match="attack"):
        faults.FaultConfig(attack="lie")
    with pytest.raises(ValueError, match="drop_rate"):
        faults.FaultConfig(drop_rate=1.5)


def test_attacker_mixing_mass_matches_reference():
    rng = np.random.default_rng(1)
    w = rng.random((6, 6)).astype(np.float32)
    w /= w.sum(axis=1, keepdims=True)
    atk = np.array([0, 1, 0, 0, 1, 0], bool)
    want = float(jax.jit(ref_similarity.attacker_mixing_mass)(w, atk))
    assert float(similarity.attacker_mixing_mass(t(w), atk)) == pytest.approx(want, abs=1e-7)


# -------------------------------------------------------------- strategies

def _kw(name):
    return dict(CFG.get(name, {}), batch_size=BATCH)


def _base(name):
    return "cfl" if name == "cfl_split" else name


# CFL past its warm-up from round 2 on, every cluster of two splitting
SPLIT = dict(warmup_rounds=1, eps1_rel=1.0, min_cluster=2)


def _extra(name):
    return SPLIT if name == "cfl_split" else {}


def _ref_strategy(name):
    _, _, params0, _ = small_task()
    cfg = RefFedConfig(**_kw(_base(name)), faults=ref_faults.FaultConfig(**FAULTS),
                       robust=ref_agg.RobustConfig(**ROBUST))
    if name in ("ucfl", "clustered"):
        return ref_ucfl.make_ucfl(ref_lenet.apply, params0, cfg,
                                  num_streams=None if name == "ucfl" else CLUSTERS,
                                  var_batch_size=VAR_BATCH)
    return ref_core.REGISTRY[_base(name)](ref_lenet.apply, params0, cfg, **_extra(name))


def make_port(name, **knobs):
    _, _, _, tparams = small_task()
    cfg = FedConfig(**_kw(_base(name)), **knobs)
    if name in ("ucfl", "clustered"):
        return ucfl.make_ucfl(lenet.apply_stacked, tparams, cfg,
                              num_streams=None if name == "ucfl" else CLUSTERS,
                              var_batch_size=VAR_BATCH, device="cpu")
    return REGISTRY[_base(name)](lenet.apply_stacked, tparams, cfg, device="cpu",
                                 **_extra(name))


def _perms(name, rkey):
    m, nn, epochs = SMALL["m"], SMALL["n"], _kw(_base(name)).get("epochs", 1)
    if name == "ditto":
        return t(np.stack([ref_permutations(k, m, epochs, nn, BATCH)
                           for k in jax.random.split(rkey)]))
    if name == "fedfomo":
        return t(ref_permutations(rkey, m, epochs, nn - N_VAL, BATCH))
    return t(ref_permutations(rkey, m, epochs, nn, BATCH))


def _slabs(state):
    return {k: np.array(state[k]) for k in SLABS if k in state}


@functools.lru_cache(maxsize=None)
def ref_run(name):
    data, _, _, _ = small_task()
    strat = _ref_strategy(name)
    ikey, rounds = key_schedule(padded_cohorts())
    seeds = None
    if name in ("ucfl", "clustered"):
        state = dict(jax.jit(strat.init)(ikey, data),
                     streams=None if name == "ucfl" else CLUSTERS)
        if name == "clustered":
            seeds = np.asarray(jax.jit(ref_clustering._plusplus_init, static_argnums=2)(
                ikey, state["W"].astype(jnp.float32), CLUSTERS))
    elif _base(name) in ("oracle", "cfl"):  # their init reads host values
        state = strat.init(ikey, data)
    else:
        state = jax.jit(strat.init)(ikey, data)
    out = []
    for rkey, cohort in rounds:
        state, met = strat.round(ref_simulation.donation_safe_copy(state), data, rkey,
                                 ref_cohort(cohort))
        out.append(dict(slabs=_slabs(state), streams=int(met["streams"]),
                        assignment=np.array(state["assignment"]) if "assignment" in state
                        else None))
    return dict(rounds=out, seeds=seeds, injects=strat.injects_faults)


def port_run(name, cohorts, *, ref_draws=True, **knobs):
    """The port's init and two cohort rounds under ``knobs``, from the
    reference's batch orders (and, with ``ref_draws``, its fault draws)."""
    _, tdata, _, _ = small_task()
    strat = make_port(name, **knobs)
    ikey, rounds = key_schedule(padded_cohorts())
    rcfg = ref_faults.FaultConfig(**FAULTS)
    seeds = ref_run(name)["seeds"] if name == "clustered" else None
    state = (strat.init(None, tdata, kmeans_init=t(seeds)) if seeds is not None
             else strat.init(None, tdata))
    out = []
    with pytest.MonkeyPatch.context() as mp:
        if ref_draws:
            mp.setattr(faults, "draw", lambda cfg, m, width, rnd, device: ref_fault_draws(
                rcfg, rounds[rnd][0], m, width))
        for (rkey, _), cohort in zip(rounds, cohorts):
            state, met = strat.round(state, tdata, None, cohort, perms=_perms(name, rkey))
            out.append(dict(slabs={k: n(v) for k, v in _slabs(state).items()},
                            streams=int(met["streams"]), state=state,
                            assignment=np.array(state["assignment"]) if "assignment" in state
                            else None))
    return dict(rounds=out, strat=strat)


FAULT_NAMES = NAMES + ["cfl_split"]


@pytest.mark.parametrize("name", FAULT_NAMES)
def test_faulted_cohort_rounds_match_reference(name):
    want = ref_run(name)
    got = port_run(name, padded_cohorts(), faults=faults.FaultConfig(**FAULTS),
                   robust=RobustConfig(**ROBUST))
    assert got["strat"].injects_faults and want["injects"]
    for r, (g, w) in enumerate(zip(got["rounds"], want["rounds"])):
        assert sorted(g["slabs"]) == sorted(w["slabs"])
        for k in g["slabs"]:
            np.testing.assert_allclose(g["slabs"][k], w["slabs"][k], atol=1e-4, rtol=0,
                                       err_msg=f"{name} round {r + 1} {k}")
            assert np.isfinite(g["slabs"][k]).all()
        assert g["streams"] == w["streams"], (r, g["streams"], w["streams"])
        if w["assignment"] is not None:
            np.testing.assert_array_equal(g["assignment"], w["assignment"])
    assert got["rounds"][-1]["state"]["fault_round"] == 2


def _off_run(name, **knobs):
    """A padded cohort round from seeded generators (the port's own draws)."""
    _, tdata, _, _ = small_task()
    strat = make_port(name, **knobs)
    state = strat.init(torch.Generator().manual_seed(0), tdata)
    state, met = strat.round(state, tdata, torch.Generator().manual_seed(1), padded_cohorts()[1])
    return {k: n(v) for k, v in _slabs(state).items()}, int(met["streams"])


_off_plain = functools.lru_cache(maxsize=None)(_off_run)


@pytest.mark.parametrize("knob", ["no_faults"] + list(NEUTRAL))
@pytest.mark.parametrize("name", NAMES)
def test_neutral_knob_is_bit_identical(name, knob):
    """``FaultConfig()`` (no attacker, no drop) and each neutral robust rule
    run the stage (the finite guard included) and change no bit."""
    knobs = ({"faults": faults.FaultConfig()} if knob == "no_faults"
             else {"robust": RobustConfig(**NEUTRAL[knob])})
    got, want = _off_run(name, **knobs), _off_plain(name)
    assert got[1] == want[1]
    for k in want[0]:
        np.testing.assert_array_equal(got[0][k], want[0][k], err_msg=k)


@pytest.mark.parametrize("name", NAMES)
def test_padded_cohort_equals_unpadded_under_faults(name):
    padded = padded_cohorts()
    plain = [participation.as_cohort(c.members, SMALL["m"]) for c in padded]
    knobs = dict(faults=faults.FaultConfig(**FAULTS), robust=RobustConfig(**ROBUST))
    a = port_run(name, padded, ref_draws=False, **knobs)
    b = port_run(name, plain, ref_draws=False, **knobs)
    for ra, rb in zip(a["rounds"], b["rounds"]):
        assert ra["streams"] == rb["streams"]
        for k in ra["slabs"]:
            np.testing.assert_allclose(ra["slabs"][k], rb["slabs"][k], atol=1e-6, rtol=0,
                                       err_msg=k)


@pytest.mark.parametrize("name", ["ucfl", "fedavg", "scaffold", "fedfomo"])
def test_nan_uploads_never_reach_the_state(name):
    """Every attacker uploads NaN and no robust rule runs: the finite guard
    alone keeps the state finite, and an attacker's rows stay as they were."""
    _, tdata, _, _ = small_task()
    nan = faults.FaultConfig(byzantine_frac=0.5, attack="nan")
    strat = make_port(name, faults=nan)
    state = strat.init(torch.Generator().manual_seed(0), tdata)
    atk = np.nonzero(faults.attacker_mask(nan, SMALL["m"]))[0]
    before = simulation.clone_state(state)
    gen = torch.Generator().manual_seed(1)
    for cohort in padded_cohorts():
        state, _ = strat.round(state, tdata, gen, cohort)
    for k, v in _slabs(state).items():
        assert np.isfinite(v).all(), k
    if name in ("ucfl", "fedfomo"):  # no broadcast: an attacker keeps its own row
        assert torch.equal(state["params"][atk], before["params"][atk])


@pytest.mark.parametrize("name", NAMES)
def test_dense_round_with_the_stage_raises(name):
    _, tdata, _, _ = small_task()
    for knobs in ({"faults": faults.FaultConfig()}, {"robust": RobustConfig()}):
        strat = make_port(name, **knobs)
        state = strat.init(torch.Generator().manual_seed(0), tdata)
        with pytest.raises(ValueError, match="faults/robust require cohort rounds"):
            strat.round(state, tdata, torch.Generator().manual_seed(1))
        assert strat.injects_faults == ("faults" in knobs)


def test_run_stands_its_finite_check_down_under_faults(monkeypatch):
    _, tdata, _, _ = small_task()
    calls = []
    real = simulation._check_finite_state
    monkeypatch.setattr(simulation, "_check_finite_state",
                        lambda s, st, rnd: calls.append(rnd) or real(s, st, rnd))
    pcfg = participation.ParticipationConfig(fraction=0.5)
    nan = faults.FaultConfig(byzantine_frac=0.5, attack="nan")
    hist = simulation.run(make_port("fedavg", faults=nan), lenet.apply_stacked, tdata, 0,
                          rounds=2, participation=pcfg, device="cpu")
    assert calls == [] and np.isfinite(hist.avg_acc).all()
    simulation.run(make_port("fedavg", faults=nan), lenet.apply_stacked, tdata, 0, rounds=2,
                   participation=pcfg, device="cpu", check_finite=True)
    assert calls == [1, 2]
    simulation.run(make_port("fedavg", robust=RobustConfig()), lenet.apply_stacked, tdata, 0,
                   rounds=1, participation=pcfg, device="cpu")
    assert calls == [1, 2, 1]  # robust alone injects nothing: the check stays on
