"""The buffered-async server (``FedConfig.async_buffer``) in both packages.

The buffer itself (``repro_torch.federated.async_buffer``) on the
reference's unit cases: deposits append, pads deposit nothing, a client
with an upload pending overwrites it in place, rows are 128-aligned (or
the wire schema's width), staleness weights are ``(1+τ)^−α`` on valid
slots and 0 elsewhere, a flush resets the buffer; each against the
reference's function on the same numpy inputs, on the first B rows of
``upd`` (the port's buffer has one spare row that the deposits of pad
slots write and nothing reads).

Trajectories: ``ucfl``, its clustered variant, ``fedavg`` and ``fedprox``
with ``AsyncConfig(flush_k=3, alpha=0.5)``: init and three padded-cohort
rounds (a flush, a deposit-only round, then a flush with τ > 0 for the
user-centric rules, whose buffer holds a deduped overwrite and live ids
out of order), from the reference's batch orders, against the reference:
every slab within 1e-4, the buffer's ``idx``, ``ver``, ``count``,
``version`` and ``last_sync`` equal and its ``upd`` within 1e-4, the round
metrics equal. The same under the int8 wire (the wire's tolerance of
``tests/test_torch_wire_strategies.py``) and under sign flips and drops
with trimmed mean (the reference's fault draws).

Within the port: ``flush_k=1`` is bit for bit the barrier cohort round
for ucfl and its clustered variant (the whole trajectory at α = 0, the
first round at α = 0.5), and the FedAvg family's within float
association; a deposit-only round leaves ``params``
bit-identical; ``async_buffer=None`` is the barrier engine; the refused
combinations raise the reference's error types.
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
from repro.core import clustering as ref_clustering
from repro.core import ucfl as ref_ucfl
from repro.federated import async_buffer as ref_async
from repro.federated import faults as ref_faults
from repro.federated import simulation as ref_simulation
from repro.federated import transport as ref_transport
from repro.models import lenet as ref_lenet
from repro_torch.core import REGISTRY, FedConfig, ucfl
from repro_torch.core.aggregation import RobustConfig
from repro_torch.core.similarity import RefreshConfig
from repro_torch.federated import async_buffer, faults, participation, simulation, transport
from repro_torch.kernels import ops
from repro_torch.models import lenet
from test_torch_wire_strategies import _assert_wire_close, _steps
from torch_parity import (BATCH, SMALL, VAR_BATCH, key_schedule, n,  # noqa: F401
                          one_torch_thread, ref_cohort, ref_fault_draws, ref_permutations,
                          small_task, t)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

M = SMALL["m"]
SLOTS = 5
CLUSTERS = 4
FLUSH_K, ALPHA = 3, 0.5
# a flush (3 uploads), a deposit-only round (client 1), then a flush of
# clients 1 (overwritten in place, base version 0), 0 (base 1) and 4 (base
# 0): live ids [1, 0, 4] out of order, τ = 1, 0, 1 under the user-centric
# rules
MEMBERS = ([0, 2, 5], [1], [0, 1, 4])
FAULTS = dict(seed=0, byzantine_frac=0.34, attack="sign_flip", drop_rate=0.25)
ROBUST = dict(rule="trimmed_mean", trim_k=1)
NAMES = ["ucfl", "clustered", "fedavg", "fedprox"]
KNOBS = ["raw", "int8", "faults"]
BUF_KEYS = ("idx", "ver", "count", "version", "last_sync")
METRICS = ("flushed", "applied", "buffer_fill", "tau_max", "tau_mean", "streams")


def cohorts(members=MEMBERS):
    return [participation.pad_slots(participation.as_cohort(np.asarray(mem), M), SLOTS, M)
            for mem in members]


# --------------------------------------------------------------- the buffer


def _rows(vals, d=3):
    return np.outer(vals, np.ones(d)).astype(np.float32)


def _ref_deposit(buf, rows, idx, mask, ver, m):
    return jax.jit(ref_async.deposit, static_argnums=5)(
        buf, jnp.asarray(rows), jnp.asarray(idx, jnp.int32), jnp.asarray(mask, bool),
        jnp.asarray(ver, jnp.int32), m)


def _port_deposit(buf, rows, idx, mask, ver, m):
    return async_buffer.deposit(buf, t(rows), t(idx, np.int32), t(mask, bool),
                                t(ver, np.int32), m)


def _assert_buffer_equal(got, want, upd_atol=0.0):
    b = np.asarray(want["idx"]).shape[0]
    assert tuple(got["upd"].shape) == (b + 1, np.asarray(want["upd"]).shape[1])
    np.testing.assert_allclose(n(async_buffer.rows(got)), np.asarray(want["upd"]),
                               atol=upd_atol, rtol=0)
    for k in BUF_KEYS:
        np.testing.assert_array_equal(n(got[k]), np.asarray(want[k]), err_msg=k)
        assert got[k].dtype == torch.int32, k


def test_async_config_validation():
    for mod in (ref_async, async_buffer):
        with pytest.raises(ValueError):
            mod.AsyncConfig(flush_k=0)
        with pytest.raises(ValueError):
            mod.AsyncConfig(alpha=-0.5)
        assert mod.AsyncConfig(flush_k=3, alpha=0.0).capacity(slots=4) == 6


def test_deposit_appends_and_pads_invisible():
    cfg, rcfg = async_buffer.AsyncConfig(flush_k=3), ref_async.AsyncConfig(flush_k=3)
    rows = _rows([1.0, 2.0])
    a = _port_deposit(async_buffer.init_buffer(cfg, M, 4, 3), rows, [1, 4], [1, 1], [0, 0], M)
    padded = np.concatenate([rows, np.full((2, 3), 99.0, np.float32)])
    b = _port_deposit(async_buffer.init_buffer(cfg, M, 4, 3), padded, [1, 4, M, M],
                      [1, 1, 0, 0], [0, 0, 0, 0], M)
    want = _ref_deposit(ref_async.init_buffer(rcfg, M, 4, 3), padded, [1, 4, M, M],
                        [1, 1, 0, 0], [0, 0, 0, 0], M)
    for k in BUF_KEYS:
        np.testing.assert_array_equal(n(a[k]), n(b[k]), err_msg=k)
    np.testing.assert_array_equal(n(async_buffer.rows(a)), n(async_buffer.rows(b)))
    _assert_buffer_equal(b, want)
    assert int(a["count"]) == 2 and n(a["idx"]).tolist()[:2] == [1, 4]
    assert n(async_buffer.valid_mask(a, M)).tolist() == [True, True] + [False] * 4


def test_deposit_dedupe_overwrites_in_place():
    cfg, rcfg = async_buffer.AsyncConfig(flush_k=4), ref_async.AsyncConfig(flush_k=4)
    buf, ref = async_buffer.init_buffer(cfg, M, 2, 3), ref_async.init_buffer(rcfg, M, 2, 3)
    for rows, idx, ver in ((_rows([1.0, 2.0]), [1, 4], [0, 0]),
                           (_rows([7.0, 3.0]), [4, 5], [2, 1]),  # client 4 again
                           (_rows([5.0, 6.0]), [5, 0], [3, 3])):  # then 5, and 0 appended
        buf = _port_deposit(buf, rows, idx, [1, 1], ver, M)
        ref = _ref_deposit(ref, rows, idx, [1, 1], ver, M)
        _assert_buffer_equal(buf, ref)
    assert int(buf["count"]) == 4
    assert n(buf["idx"]).tolist() == [1, 4, 5, 0, M]  # arrival order, 4 and 5 in place
    np.testing.assert_allclose(n(buf["upd"])[1, :3], 7.0)
    np.testing.assert_array_equal(n(buf["ver"])[:4], [0, 2, 3, 3])
    assert not n(buf["upd"])[:, 3:].any()  # the aligned tail stays zero
    valid = n(async_buffer.valid_mask(buf, M))
    assert len(set(n(buf["idx"])[valid])) == int(valid.sum())


def test_buffer_rows_at_aligned_or_schema_width():
    cfg = async_buffer.AsyncConfig(flush_k=3)
    buf = async_buffer.init_buffer(cfg, 6, slots=4, dim=300)
    assert tuple(buf["upd"].shape) == (cfg.capacity(4) + 1, ops.aligned_dim(300))
    assert ops.aligned_dim(300) == 384
    schema = transport.single_delta_schema("x", 300, downlink=())
    wide = async_buffer.init_buffer(cfg, 6, slots=4, dim=7, schema=schema)
    assert tuple(wide["upd"].shape) == (cfg.capacity(4) + 1, schema.width_aligned("uplink"))
    want = ref_async.init_buffer(ref_async.AsyncConfig(flush_k=3), 6, 4, 300)
    _assert_buffer_equal(buf, want)


@pytest.mark.parametrize("alpha", [1.0, 0.5, 0.0])
def test_staleness_weights_and_reset(alpha):
    cfg, rcfg = async_buffer.AsyncConfig(2, alpha), ref_async.AsyncConfig(2, alpha)
    buf = dict(async_buffer.init_buffer(cfg, M, 2, 3), version=torch.tensor(3, dtype=torch.int32))
    ref = dict(ref_async.init_buffer(rcfg, M, 2, 3), version=jnp.asarray(3, jnp.int32))
    buf = _port_deposit(buf, _rows([1.0, 2.0]), [1, 4], [1, 1], [3, 1], M)
    ref = _ref_deposit(ref, _rows([1.0, 2.0]), [1, 4], [1, 1], [3, 1], M)
    assert n(async_buffer.staleness(buf)).tolist()[:2] == [0, 2]
    np.testing.assert_array_equal(n(async_buffer.staleness(buf)),
                                  np.asarray(ref_async.staleness(ref)))
    w = n(async_buffer.staleness_weights(buf, M, alpha))
    np.testing.assert_allclose(w, np.asarray(ref_async.staleness_weights(ref, M, alpha)),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(w[:2], [1.0, 3.0 ** -alpha], rtol=1e-6)
    assert (w[2:] == 0.0).all() and w[0] == 1.0  # empty slots 0, τ = 0 exactly 1
    out = async_buffer.flush_reset(buf, M)
    _assert_buffer_equal(out, jax.jit(ref_async.flush_reset, static_argnums=1)(ref, M))
    assert int(out["version"]) == 4 and int(out["count"]) == 0
    ls = n(out["last_sync"]).tolist()
    assert ls[1] == 4 and ls[4] == 4 and ls[0] == 0
    # predicated: a False flush gives the buffer back as it was
    kept = async_buffer.flush_reset(buf, M, torch.tensor(False))
    for k in BUF_KEYS:
        assert torch.equal(kept[k], buf[k]), k
    done = async_buffer.flush_reset(buf, M, torch.tensor(True))
    for k in BUF_KEYS:
        assert torch.equal(done[k], out[k]), k


def test_flush_metrics_match_reference():
    rng = np.random.default_rng(0)
    tau = rng.integers(0, 4, 7).astype(np.int32)
    w = np.where(rng.random(7) < 0.6, 1.0 / (1.0 + tau), 0.0).astype(np.float32)
    for flushed in (True, False):
        got = async_buffer.flush_metrics(torch.tensor(flushed), torch.tensor(5, dtype=torch.int32),
                                         t(tau), t(w), torch.tensor(2, dtype=torch.int32))
        want = ref_async.flush_metrics(jnp.asarray(flushed), jnp.asarray(5, jnp.int32),
                                       jnp.asarray(tau), jnp.asarray(w),
                                       jnp.asarray(2, jnp.int32))
        for k in want:
            np.testing.assert_allclose(n(got[k]), np.asarray(want[k]), rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("rule", ["cohort", "clustered", "fedavg"])
def test_weighted_rules_match_reference(rule):
    """The masked rules with ``weights=`` (the staleness discounts) against
    the reference's, and ``weights=None`` bit for bit the mask path."""
    rng = np.random.default_rng(1)
    m, c = 8, 6
    w = rng.random((m, m)).astype(np.float32)
    w /= w.sum(axis=1, keepdims=True)
    idx = np.array([3, 1, 6, 0, m, m], np.int32)
    mask = idx < m
    weights = np.where(mask, rng.random(c), 0.0).astype(np.float32)
    labels = rng.integers(0, 3, m).astype(np.int32)
    nn = rng.integers(10, 50, m).astype(np.int32)
    from repro_torch.core import aggregation
    if rule == "cohort":
        def port(wt):
            return aggregation.masked_cohort_matrix(t(w), t(idx), t(mask), wt)
        want = ref_agg.masked_cohort_matrix(w, idx, mask, jnp.asarray(weights))
    elif rule == "clustered":
        def port(wt):
            return aggregation.masked_clustered_rows(t(w), t(labels), 3, t(idx), t(mask), wt)
        want = jax.jit(ref_agg.masked_clustered_rows, static_argnums=2)(
            w, labels, 3, idx, mask, jnp.asarray(weights))
    else:
        safe = np.minimum(idx, m - 1)

        def port(wt):
            return aggregation.masked_fedavg_weights(t(nn[safe]), t(mask), wt)
        want = ref_agg.masked_fedavg_weights(nn[safe], mask, jnp.asarray(weights))
    np.testing.assert_allclose(n(port(t(weights))), np.asarray(want), atol=1e-6, rtol=0)
    assert torch.equal(port(None), port(t(mask.astype(np.float32))))


# ----------------------------------------------------------- trajectories


def _kw(name):
    return dict(batch_size=BATCH)


def _ref_strategy(name, knob, acfg):
    _, _, params0, _ = small_task()
    extra = {}
    if knob == "int8":
        extra["transport"] = ref_transport.TransportConfig("int8")
    elif knob == "faults":
        extra.update(faults=ref_faults.FaultConfig(**FAULTS),
                     robust=ref_agg.RobustConfig(**ROBUST))
    cfg = RefFedConfig(**_kw(name), async_buffer=acfg, **extra)
    if name in ("ucfl", "clustered"):
        return ref_ucfl.make_ucfl(ref_lenet.apply, params0, cfg,
                                  num_streams=None if name == "ucfl" else CLUSTERS,
                                  var_batch_size=VAR_BATCH)
    return ref_core.REGISTRY[name](ref_lenet.apply, params0, cfg)


def make_port(name, **knobs):
    _, _, _, tparams = small_task()
    cfg = FedConfig(**_kw(name), **knobs)
    if name in ("ucfl", "clustered"):
        return ucfl.make_ucfl(lenet.apply_stacked, tparams, cfg,
                              num_streams=None if name == "ucfl" else CLUSTERS,
                              var_batch_size=VAR_BATCH, device="cpu")
    return REGISTRY[name](lenet.apply_stacked, tparams, cfg, device="cpu")


def _port_knobs(knob):
    if knob == "int8":
        return dict(transport=transport.TransportConfig("int8"))
    if knob == "faults":
        return dict(faults=faults.FaultConfig(**FAULTS), robust=RobustConfig(**ROBUST))
    return {}


def _record(state, met):
    out = {k: np.array(state[k]) for k in ("params", "ef") if k in state}
    out["abuf"] = {k: np.array(v) for k, v in state["abuf"].items()}
    out["metrics"] = {k: float(met[k]) for k in METRICS}
    return out


def _schedule():
    return key_schedule(cohorts())


@functools.lru_cache(maxsize=None)
def ref_run(name, knob):
    data, _, _, _ = small_task()
    strat = _ref_strategy(name, knob, ref_async.AsyncConfig(FLUSH_K, ALPHA))
    ikey, rounds = _schedule()
    seeds = None
    if name in ("ucfl", "clustered"):
        state = dict(jax.jit(strat.init)(ikey, data),
                     streams=None if name == "ucfl" else CLUSTERS)
        if name == "clustered":
            seeds = np.asarray(jax.jit(ref_clustering._plusplus_init, static_argnums=2)(
                ikey, state["W"].astype(jnp.float32), CLUSTERS))
    else:
        state = jax.jit(strat.init)(ikey, data)
    out = []
    for rkey, cohort in rounds:
        state, met = strat.round(ref_simulation.donation_safe_copy(state), data, rkey,
                                 ref_cohort(cohort))
        out.append(_record(state, met))
    return dict(rounds=out, seeds=seeds)


def port_run(name, knob, *, acfg=async_buffer.AsyncConfig(FLUSH_K, ALPHA), members=MEMBERS,
             **extra):
    """The port's init and the schedule's cohort rounds, from the
    reference's batch orders and, under faults, its fault draws."""
    _, tdata, _, _ = small_task()
    strat = make_port(name, async_buffer=acfg, **_port_knobs(knob), **extra)
    ikey, rounds = key_schedule(cohorts(members))
    if name == "clustered":
        state = strat.init(None, tdata, kmeans_init=t(ref_run(name, "raw")["seeds"]))
    else:
        state = strat.init(None, tdata)
    rcfg = ref_faults.FaultConfig(**FAULTS)
    out = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(faults, "draw", lambda cfg, m, width, rnd, device: ref_fault_draws(
            rcfg, rounds[rnd][0], m, width))
        for rkey, cohort in rounds:
            perms = t(ref_permutations(rkey, M, 1, SMALL["n"], BATCH))
            state, met = strat.round(state, tdata, None, cohort, perms=perms)
            out.append(dict(_record(state, met), state=state))
    return out


@pytest.mark.parametrize("knob", KNOBS)
@pytest.mark.parametrize("name", NAMES)
def test_async_trajectory_matches_reference(name, knob):
    want, got = ref_run(name, knob)["rounds"], port_run(name, knob)
    wire = [dict(ef=w["ef"]) if "ef" in w else {} for w in want]
    for r, (g, w) in enumerate(zip(got, want)):
        what = f"{name} {knob} round {r + 1}"
        for k in BUF_KEYS:
            np.testing.assert_array_equal(g["abuf"][k], w["abuf"][k], err_msg=f"{what} {k}")
        b = w["abuf"]["upd"].shape[0]
        assert g["abuf"]["upd"].shape == (b + 1, w["abuf"]["upd"].shape[1])
        pairs = [("params", g["params"], w["params"]), ("upd", g["abuf"]["upd"][:b],
                                                        w["abuf"]["upd"])]
        if knob == "int8":
            pairs.append(("ef", g["ef"], w["ef"]))
            step = _steps([{}] + wire, r + 1, w["params"].shape[1])
            for k, gv, wv in pairs:
                _assert_wire_close(gv, wv, step, f"{what} {k}")
        else:
            for k, gv, wv in pairs:
                np.testing.assert_allclose(gv, wv, atol=1e-4, rtol=0, err_msg=f"{what} {k}")
        for k in METRICS:
            assert g["metrics"][k] == pytest.approx(w["metrics"][k], abs=1e-6), (what, k)
    flushed = [g["metrics"]["flushed"] for g in got]
    if knob != "faults":  # a flush, a deposit-only round, a flush
        assert flushed == [1, 0, 1]
        if name in ("ucfl", "clustered"):
            assert got[-1]["metrics"]["tau_max"] == 1.0
            assert 0 < got[-1]["metrics"]["tau_mean"] < 1
        else:  # the FedAvg family's τ is 0 by construction
            assert got[-1]["metrics"]["tau_max"] == 0.0


@pytest.mark.parametrize("name", NAMES)
def test_deposit_only_round_keeps_params_bit_identical(name):
    out = port_run(name, "raw")
    assert out[1]["metrics"]["flushed"] == 0 and out[1]["metrics"]["streams"] == 0
    np.testing.assert_array_equal(out[1]["params"], out[0]["params"])
    assert out[1]["metrics"]["buffer_fill"] == 1


def _barrier_run(name, members, **knobs):
    _, tdata, _, _ = small_task()
    strat = make_port(name, **knobs)
    if name == "clustered":
        state = strat.init(None, tdata, kmeans_init=t(ref_run(name, "raw")["seeds"]))
    else:
        state = strat.init(None, tdata)
    _, rounds = key_schedule(cohorts(members))
    out = []
    for rkey, cohort in rounds:
        perms = t(ref_permutations(rkey, M, 1, SMALL["n"], BATCH))
        state, met = strat.round(state, tdata, None, cohort, perms=perms)
        out.append((n(state["params"]), int(met["streams"])))
    return out


FLUSH1_MEMBERS = ([0, 2, 5], [1, 2, 3, 4], [0, 3])


@pytest.mark.parametrize("alpha", [0.0, 0.5])
@pytest.mark.parametrize("name", NAMES)
def test_flush1_equals_the_barrier_round(name, alpha):
    """flush_k=1 applies each round's uploads as they land. Without the
    discount (α = 0) the user-centric rules give the barrier trajectory
    bit for bit (B equals the slot count, every weight exactly 1); with
    α = 0.5 so does the first round, whose uploads are all fresh, but from
    the second on a client whose row no flush has rewritten since version 0
    uploads with τ > 0 and weighs less: the reference's rule, and why its
    own flush-1 trajectory test fails at α = 0.5 (ROADMAP C3). The FedAvg
    family's τ is 0 throughout, and its delta form θ + Σ w̃(u − θ) equals
    Σ w̃ u within float association."""
    barrier = _barrier_run(name, FLUSH1_MEMBERS)
    buffered = port_run(name, "raw", acfg=async_buffer.AsyncConfig(flush_k=1, alpha=alpha),
                        members=FLUSH1_MEMBERS)
    user_centric = name in ("ucfl", "clustered")
    for r, ((want, streams), got) in enumerate(zip(barrier, buffered)):
        assert got["metrics"]["flushed"] == 1
        assert int(got["metrics"]["streams"]) == streams
        if not user_centric:
            assert got["metrics"]["tau_max"] == 0
            np.testing.assert_allclose(got["params"], want, rtol=1e-5, atol=1e-6)
        elif alpha == 0.0 or r == 0:
            np.testing.assert_array_equal(got["params"], want)
        else:  # clients 1, 3 and 4 were last rewritten at version 0
            assert got["metrics"]["tau_max"] >= 1
            assert not np.array_equal(got["params"], want)
            np.testing.assert_allclose(got["params"], want, atol=1e-2, rtol=0)


def test_flush1_run_is_the_barrier_run():
    """Whole ``simulation.run`` trajectories: ucfl under
    ``AsyncConfig(flush_k=1, alpha=0.0)`` and the barrier ucfl give the
    same accuracies, and the same slab bit for bit."""
    _, tdata, _, _ = small_task()
    pcfg = participation.ParticipationConfig(cohort_size=3, seed=2)
    hs = simulation.run(make_port("ucfl"), lenet.apply_stacked, tdata, 1, rounds=3,
                        participation=pcfg, device="cpu")
    acfg = async_buffer.AsyncConfig(flush_k=1, alpha=0.0)
    ha = simulation.run(make_port("ucfl", async_buffer=acfg), lenet.apply_stacked, tdata, 1,
                        rounds=3, participation=pcfg, device="cpu")
    assert hs.avg_acc == ha.avg_acc and hs.worst_acc == ha.worst_acc
    assert torch.equal(hs.state["params"], ha.state["params"])
    assert "abuf" in ha.state and "abuf" not in hs.state


@pytest.mark.parametrize("name", NAMES)
def test_async_none_is_the_barrier_engine(name):
    a = _barrier_run(name, MEMBERS)
    b = _barrier_run(name, MEMBERS, async_buffer=None)
    for (pa, sa), (pb, sb) in zip(a, b):
        np.testing.assert_array_equal(pa, pb)
        assert sa == sb
    assert FedConfig().async_buffer is None


def test_warmup_leaves_no_buffer_and_warmup_false_is_the_same_run():
    _, tdata, _, _ = small_task()
    pcfg = participation.ParticipationConfig(cohort_size=3, seed=4)
    runs = [simulation.run(make_port("ucfl", async_buffer=async_buffer.AsyncConfig(flush_k=4)),
                           lenet.apply_stacked, tdata, 5, rounds=3, participation=pcfg,
                           device="cpu", warmup=w) for w in (True, False)]
    assert runs[0].avg_acc == runs[1].avg_acc
    for k in ("idx", "ver", "count", "version", "last_sync", "upd"):
        assert torch.equal(runs[0].state["abuf"][k], runs[1].state["abuf"][k]), k
    assert torch.equal(runs[0].state["params"], runs[1].state["params"])
    flushed = [int(mt["flushed"]) for mt in runs[0].metrics]
    assert flushed == [int(mt["flushed"]) for mt in runs[1].metrics]
    assert flushed[0] == 0 and 1 in flushed  # 3 uploads do not reach flush_k 4


# --------------------------------------------------------------- refusals


@pytest.mark.parametrize("name", ["local", "oracle", "scaffold", "ditto", "pfedme", "fedfomo",
                                  "cfl", "ucfl_parallel"])
def test_strategy_without_a_buffered_rule_raises(name):
    _, _, params0, tparams = small_task()
    kw = {"var_batch_size": VAR_BATCH} if name == "ucfl_parallel" else {}
    with pytest.raises(NotImplementedError, match="buffered-async"):
        ref_core.REGISTRY[name](ref_lenet.apply, params0,
                                RefFedConfig(async_buffer=ref_async.AsyncConfig()), **kw)
    with pytest.raises(NotImplementedError, match="buffered-async"):
        REGISTRY[name](lenet.apply_stacked, tparams,
                       FedConfig(async_buffer=async_buffer.AsyncConfig()), device="cpu", **kw)


@pytest.mark.parametrize("name", NAMES)
def test_dense_round_under_async_raises(name):
    _, tdata, _, _ = small_task()
    strat = make_port(name, async_buffer=async_buffer.AsyncConfig(flush_k=2))
    state = strat.init(torch.Generator().manual_seed(0), tdata)
    with pytest.raises(ValueError, match="buffered-async"):
        strat.round(state, tdata, torch.Generator().manual_seed(1), None)


@pytest.mark.parametrize("name", ["ucfl", "clustered"])
def test_async_with_w_refresh_raises(name):
    with pytest.raises(ValueError, match="w_refresh"):
        make_port(name, async_buffer=async_buffer.AsyncConfig(), w_refresh=RefreshConfig())
