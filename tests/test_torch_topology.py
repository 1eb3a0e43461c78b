"""The two-tier topology (``FedConfig.topology``) in both packages.

``Topology`` (validation, constructors, per-edge slot bound),
``edge_ids``/``edge_onehot``/``edge_partition`` and
``tiered_fedavg_weights`` against the reference's on the same slot arrays
(exact: integer work and one division a weight, in the same order).
``edge_partition`` also keeps the cohort's invariants per edge: real slots
a prefix, members increasing, every member on exactly one edge, pads the
sentinels.

Trajectories: ``fedavg``, ``fedprox`` and the clustered ``ucfl`` (4
streams) over ``Topology.contiguous(6, 3)``, init and two padded-cohort
rounds from the reference's batch orders: every slab within 1e-4 of the
reference's, and of the port's own flat run (the tiered mixes factorize
the flat rules up to float association); the clustered variant also with
``w_refresh``, and FedAvg also under the int8 wire, whose downlink EF
composes (the wire's tolerance of ``tests/test_torch_wire_strategies.py``).
``topology=None`` is bit for bit the default. The refusals: every
strategy whose PS rule does not factorize (``NotImplementedError`` naming
the topology), topology with ``async_buffer``, a dense round
(``ValueError``), a value that is no ``Topology`` (``TypeError``), a
client count that differs (``ValueError`` at init).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as ref_core
from repro.core import FedConfig as RefFedConfig
from repro.core import clustering as ref_clustering
from repro.core import ucfl as ref_ucfl
from repro.core.baselines import common as ref_common
from repro.core.similarity import RefreshConfig as RefRefreshConfig
from repro.federated import simulation as ref_simulation
from repro.federated import topology as ref_topology
from repro.federated import transport as ref_transport
from repro.models import lenet as ref_lenet
from repro_torch.core import REGISTRY, FedConfig, ucfl
from repro_torch.core.baselines import common
from repro_torch.core.similarity import RefreshConfig
from repro_torch.federated import async_buffer, topology, transport
from repro_torch.federated.topology import Topology
from repro_torch.models import lenet
from test_torch_wire_strategies import _assert_wire_close, _steps
from torch_parity import (BATCH, SMALL, VAR_BATCH, key_schedule, n,  # noqa: F401
                          one_torch_thread, padded_cohorts, ref_cohort, ref_permutations,
                          small_task, t)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

M = SMALL["m"]
CLUSTERS = 4
TOPO = dict(m=M, num_edges=3)
TIERED = ["fedavg", "fedprox", "clustered"]
CELLS = [("fedavg", "plain"), ("fedprox", "plain"), ("clustered", "plain"),
         ("clustered", "refresh"), ("fedavg", "int8")]


# ----------------------------------------------------------- Topology itself


def test_topology_validates():
    for mod in (ref_topology, topology):
        with pytest.raises(ValueError, match="num_edges"):
            mod.Topology((0, 0), 0)
        with pytest.raises(ValueError, match="edge ids"):
            mod.Topology((0, 3), 2)
        with pytest.raises(ValueError, match="at least one client"):
            mod.Topology((), 2)


def test_topology_constructors_match_reference():
    for labels in ([1, 0, 2, 1], np.array([0, 0, 3])):
        a, b = Topology.from_labels(labels), ref_topology.Topology.from_labels(labels)
        assert (a.edge_of, a.num_edges) == (b.edge_of, b.num_edges)
    assert Topology.from_labels(torch.tensor([2, 0, 1])).num_edges == 3
    for m, e in ((8, 3), (100, 4), (6, 6), (5, 2)):
        a, b = Topology.contiguous(m, e), ref_topology.Topology.contiguous(m, e)
        assert (a.edge_of, a.num_edges) == (b.edge_of, b.num_edges)
        assert list(a.edge_of) == sorted(a.edge_of) and a.num_clients == m
        for c in (1, 2, 5, m):
            assert a.slots_per_edge(c) == b.slots_per_edge(c)
    t8 = Topology.contiguous(8, 3)
    assert t8.edge_array().dtype == torch.int32 and n(t8.edge_array()).tolist() == list(t8.edge_of)
    for mod, topo in ((ref_topology, ref_topology.Topology.contiguous(8, 3)), (topology, t8)):
        with pytest.raises(ValueError, match="assigns 8 clients"):
            topo.check_clients(5, "fedavg")


def _partition_cases():
    rng = np.random.default_rng(0)
    cases = [([0, 0, 1, 2, 1, 0, 2, 1], 3, [0, 2, 3, 7, 8, 8], 4),
             ([0, 0, 0, 0, 0, 0, 0, 2], 3, [0, 2, 3, 7, 8, 8], 4),  # an edge with no member
             ([0, 1] * 4, 2, [8, 8, 8, 8], 0)]  # an all-pad cohort
    for _ in range(12):
        m = int(rng.integers(2, 13))
        e = int(rng.integers(1, 6))
        c = int(rng.integers(1, m + 1))
        take = int(rng.integers(0, c + 1))
        idx = np.full(c, m, np.int32)
        idx[:take] = np.sort(rng.choice(m, take, replace=False))
        cases.append((rng.integers(0, e, m).tolist(), e, idx.tolist(), take))
    return cases


@pytest.mark.parametrize("case", range(len(_partition_cases())))
def test_edge_partition_matches_reference(case):
    edge_of, e, idx, take = _partition_cases()[case]
    m, c = len(edge_of), len(idx)
    idx = np.asarray(idx, np.int32)
    mask = np.arange(c) < take
    topo = Topology(tuple(edge_of), e)
    slots = topo.slots_per_edge(c)
    got = topology.edge_partition(topo.edge_array(), e, slots, t(idx), t(mask))
    ref_arr = ref_topology.Topology(tuple(edge_of), e).edge_array()
    want = jax.jit(ref_topology.edge_partition, static_argnums=(1, 2))(ref_arr, e, slots, idx,
                                                                       mask)
    for g, w, dtype in zip(got, want, (torch.int32, torch.bool, torch.int32)):
        assert g.dtype == dtype
        np.testing.assert_array_equal(n(g), np.asarray(w))
    np.testing.assert_array_equal(
        n(topology.edge_onehot(topo.edge_array(), e, t(idx), t(mask))),
        np.asarray(ref_topology.edge_onehot(ref_arr, e, idx, mask)))
    # the cohort's invariants one level down
    eidx, emask, eslot = (n(x) for x in got)
    seen = []
    for k in range(e):
        mk = emask[k]
        assert not np.any(mk[1:] & ~mk[:-1])
        members = eidx[k][mk]
        assert np.all(np.diff(members) > 0) and all(edge_of[i] == k for i in members)
        assert np.array_equal(idx[eslot[k][mk]], members)
        assert np.all(eidx[k][~mk] == m) and np.all(eslot[k][~mk] == c)
        seen.extend(members.tolist())
    assert sorted(seen) == sorted(idx[mask].tolist())


@pytest.mark.parametrize("case", [0, 1, 2, 5, 9])
def test_tiered_fedavg_weights_match_reference(case):
    edge_of, e, idx, take = _partition_cases()[case]
    c = len(idx)
    idx = np.asarray(idx, np.int32)
    mask = np.arange(c) < take
    nn = np.random.default_rng(case).integers(5, 60, len(edge_of)).astype(np.int32)
    topo = Topology(tuple(edge_of), e)
    slots = topo.slots_per_edge(c)
    wpe, w2 = common.tiered_fedavg_weights(topo.edge_array(), e, slots, t(idx), t(mask), t(nn))
    rw, r2 = jax.jit(ref_common.tiered_fedavg_weights, static_argnums=(1, 2))(
        ref_topology.Topology(tuple(edge_of), e).edge_array(), e, slots, idx, mask, nn)
    np.testing.assert_allclose(n(wpe), np.asarray(rw), atol=1e-7, rtol=0)
    np.testing.assert_allclose(n(w2), np.asarray(r2), atol=1e-7, rtol=0)
    if take:  # w2[e]·wpe[e, j] is the flat mean's weight n_j / Σn
        flat = np.where(mask, nn[np.minimum(idx, len(edge_of) - 1)], 0).astype(np.float64)
        np.testing.assert_allclose(n(w2) @ n(wpe), flat / flat.sum(), atol=1e-6)


# ---------------------------------------------------------------- trajectories


def _kw(name):
    return dict(batch_size=BATCH)


def _ref_strategy(name, knob, topo):
    _, _, params0, _ = small_task()
    extra = {}
    if knob == "refresh":
        extra["w_refresh"] = RefRefreshConfig()
    elif knob == "int8":
        extra["transport"] = ref_transport.TransportConfig("int8")
    cfg = RefFedConfig(**_kw(name), topology=topo, **extra)
    if name == "clustered":
        return ref_ucfl.make_ucfl(ref_lenet.apply, params0, cfg, num_streams=CLUSTERS,
                                  var_batch_size=VAR_BATCH)
    return ref_core.REGISTRY[name](ref_lenet.apply, params0, cfg)


def make_port(name, knob="plain", **kw):
    _, _, _, tparams = small_task()
    extra = {}
    if knob == "refresh":
        extra["w_refresh"] = RefreshConfig()
    elif knob == "int8":
        extra["transport"] = transport.TransportConfig("int8")
    cfg = FedConfig(**_kw(name), **extra, **kw)
    if name in ("ucfl", "clustered"):
        return ucfl.make_ucfl(lenet.apply_stacked, tparams, cfg,
                              num_streams=None if name == "ucfl" else CLUSTERS,
                              var_batch_size=VAR_BATCH, device="cpu")
    return REGISTRY[name](lenet.apply_stacked, tparams, cfg, device="cpu")


def _slabs(state):
    return {k: np.array(state[k]) for k in ("params", "ef", "ef_dl", "W") if k in state}


@functools.lru_cache(maxsize=None)
def ref_run(name, knob):
    data, _, _, _ = small_task()
    strat = _ref_strategy(name, knob, ref_topology.Topology.contiguous(**TOPO))
    ikey, rounds = key_schedule(padded_cohorts())
    seeds = None
    if name == "clustered":
        state = dict(jax.jit(strat.init)(ikey, data), streams=CLUSTERS)
        seeds = np.asarray(jax.jit(ref_clustering._plusplus_init, static_argnums=2)(
            ikey, state["W"].astype(jnp.float32), CLUSTERS))
    else:
        state = jax.jit(strat.init)(ikey, data)
    out = []
    for rkey, cohort in rounds:
        state, met = strat.round(ref_simulation.donation_safe_copy(state), data, rkey,
                                 ref_cohort(cohort))
        out.append(dict(slabs=_slabs(state), streams=int(met["streams"])))
    return dict(rounds=out, seeds=seeds)


@functools.lru_cache(maxsize=None)
def port_run(name, knob, tiered=True):
    _, tdata, _, _ = small_task()
    topo = Topology.contiguous(**TOPO) if tiered else None
    strat = make_port(name, knob, topology=topo)
    if name == "clustered":
        state = strat.init(None, tdata, kmeans_init=t(ref_run(name, "plain")["seeds"]))
    else:
        state = strat.init(None, tdata)
    _, rounds = key_schedule(padded_cohorts())
    out = []
    for rkey, cohort in rounds:
        perms = t(ref_permutations(rkey, M, 1, SMALL["n"], BATCH))
        state, met = strat.round(state, tdata, None, cohort, perms=perms)
        out.append(dict(slabs={k: n(v) for k, v in _slabs(state).items()},
                        streams=int(met["streams"])))
    return out


@pytest.mark.parametrize("name,knob", CELLS)
def test_tiered_rounds_match_reference_and_flat(name, knob):
    want, got, flat = ref_run(name, knob)["rounds"], port_run(name, knob), \
        port_run(name, knob, tiered=False)
    for r, (g, w, f) in enumerate(zip(got, want, flat)):
        what = f"{name} {knob} round {r + 1}"
        assert g["streams"] == w["streams"] == f["streams"], what
        assert sorted(g["slabs"]) == sorted(w["slabs"]), what
        for k in w["slabs"]:
            if knob == "int8":
                wire = [{}] + [x["slabs"] for x in want]
                step = _steps(wire, r + 1, w["slabs"]["params"].shape[1])
                _assert_wire_close(g["slabs"][k], w["slabs"][k], step, f"{what} {k}")
                _assert_wire_close(g["slabs"][k], f["slabs"][k], step, f"{what} {k} flat")
            else:
                np.testing.assert_allclose(g["slabs"][k], w["slabs"][k], atol=1e-4, rtol=0,
                                           err_msg=f"{what} {k}")
                np.testing.assert_allclose(g["slabs"][k], f["slabs"][k], atol=1e-4, rtol=0,
                                           err_msg=f"{what} {k} flat")


def test_tiered_rounds_touch_only_the_cohort():
    """The clustered tiered round rewrites the cohort's rows and no other."""
    _, tdata, _, _ = small_task()
    strat = make_port("clustered", topology=Topology.contiguous(**TOPO))
    state = strat.init(torch.Generator().manual_seed(0), tdata)
    before = state["params"].clone()
    cohort = padded_cohorts()[0]
    new, _ = strat.round(state, tdata, torch.Generator().manual_seed(1), cohort)
    outside = np.setdiff1d(np.arange(M), cohort.members)
    assert torch.equal(new["params"][outside], before[outside])
    assert not torch.equal(new["params"][cohort.members], before[cohort.members])


@pytest.mark.parametrize("name", TIERED)
def test_topology_none_is_bit_identical(name):
    _, tdata, _, _ = small_task()
    runs = []
    for kw in ({}, {"topology": None}):
        strat = make_port(name, **kw)
        state = strat.init(torch.Generator().manual_seed(0), tdata)
        for cohort in padded_cohorts():
            state, met = strat.round(state, tdata, torch.Generator().manual_seed(1), cohort)
        runs.append((state, met))
    assert runs[0][1] == runs[1][1]
    for k, v in runs[0][0].items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, runs[1][0][k]), k
    assert FedConfig().topology is None


# ------------------------------------------------------------------- refusals

UNSUPPORTED = ["ucfl", "ucfl_parallel", "local", "oracle", "scaffold", "ditto", "pfedme",
               "fedfomo", "cfl"]


@pytest.mark.parametrize("name", UNSUPPORTED)
def test_unsupported_strategy_raises_at_construction(name):
    _, _, params0, tparams = small_task()
    kw = {"var_batch_size": VAR_BATCH} if name.startswith("ucfl") else {}
    with pytest.raises(NotImplementedError, match="topology") as want:
        ref_core.REGISTRY[name](ref_lenet.apply, params0,
                                RefFedConfig(topology=ref_topology.Topology.contiguous(M, 3)),
                                **kw)
    with pytest.raises(NotImplementedError, match="topology") as got:
        REGISTRY[name](lenet.apply_stacked, tparams,
                       FedConfig(topology=Topology.contiguous(M, 3)), device="cpu", **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", TIERED)
def test_topology_with_async_raises(name):
    with pytest.raises(NotImplementedError, match="async_buffer"):
        make_port(name, topology=Topology.contiguous(M, 3),
                  async_buffer=async_buffer.AsyncConfig(flush_k=2))


@pytest.mark.parametrize("name", TIERED)
def test_dense_round_with_topology_raises(name):
    _, tdata, _, _ = small_task()
    strat = make_port(name, topology=Topology.contiguous(M, 3))
    state = strat.init(torch.Generator().manual_seed(0), tdata)
    with pytest.raises(ValueError, match="dense"):
        strat.round(state, tdata, torch.Generator().manual_seed(1), None)


@pytest.mark.parametrize("name", TIERED)
def test_non_topology_value_raises_typeerror(name):
    with pytest.raises(TypeError, match="Topology"):
        make_port(name, topology=(0, 0, 1, 1, 2, 2))


@pytest.mark.parametrize("name", TIERED)
def test_topology_client_count_mismatch_raises(name):
    _, tdata, _, _ = small_task()
    strat = make_port(name, topology=Topology.contiguous(5, 2))
    with pytest.raises(ValueError, match="5 clients"):
        strat.init(torch.Generator().manual_seed(0), tdata)


def test_check_composition_passes_none_and_a_topology():
    topo = Topology.contiguous(M, 2)
    assert topology.check_composition(None, "x") is None
    assert topology.check_composition(topo, "x") is topo
    with pytest.raises(NotImplementedError, match="async_buffer"):
        topology.check_composition(topo, "x", async_buffer=async_buffer.AsyncConfig())
