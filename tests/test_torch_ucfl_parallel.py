"""``ucfl_parallel`` (the §V-E upper bound of Fig. 6) in both packages.

Init plus two rounds, dense, at padded cohorts, and at padded cohorts
with ``RefreshConfig()``, from the reference's per-stream batch orders
(``torch_parity.ref_stream_permutations``): the slab, W and the refresh
buffers within 1e-4 of the reference after each round, staleness exact,
``streams`` m. Within the port: the stream groups (``chunk_size``) change
nothing beyond f32 summation, a padded cohort equals the unpadded one,
and the knobs the reference refuses raise at construction.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro import core as ref_core
from repro.core import FedConfig as RefFedConfig
from repro.core import similarity as ref_similarity
from repro.federated import simulation as ref_simulation
from repro.models import lenet as ref_lenet
from repro_torch.core import REGISTRY, FedConfig, ucfl
from repro_torch.core.aggregation import RobustConfig
from repro_torch.core.similarity import RefreshConfig
from repro_torch.federated import (async_buffer, faults, participation, simulation, topology,
                                  transport)
from repro_torch.models import lenet
from torch_parity import (BATCH, SMALL, VAR_BATCH, key_schedule,  # noqa: F401
                          one_torch_thread, padded_cohorts, ref_cohort,
                          ref_stream_permutations, small_task, t)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MODES = ["dense", "cohort", "refresh"]


def _cohorts(mode):
    return [None, None] if mode == "dense" else padded_cohorts()


def _state(state):
    out = {"params": np.array(state["params"]), "W": np.array(state["W"])}
    out.update({k: np.array(v) for k, v in state.get("refresh", {}).items()})
    return out


@functools.lru_cache(maxsize=None)
def ref_run(mode):
    data, _, params0, _ = small_task()
    cfg = RefFedConfig(batch_size=BATCH, w_refresh=ref_similarity.RefreshConfig()
                       if mode == "refresh" else None)
    strat = ref_core.REGISTRY["ucfl_parallel"](ref_lenet.apply, params0, cfg,
                                               var_batch_size=VAR_BATCH)
    ikey, rounds = key_schedule(_cohorts(mode))
    state = jax.jit(strat.init)(ikey, data)
    out, metrics = [_state(state)], []
    for rkey, cohort in rounds:
        state, met = strat.round(ref_simulation.donation_safe_copy(state), data, rkey,
                                 ref_cohort(cohort))
        out.append(_state(state))
        metrics.append(jax.tree.map(np.asarray, met))
    return dict(states=out, metrics=metrics)


def make_port(mode="cohort", **kw):
    _, _, _, tparams = small_task()
    cfg = FedConfig(batch_size=BATCH, w_refresh=RefreshConfig() if mode == "refresh" else None,
                    **kw)
    return ucfl.make_ucfl_parallel(lenet.apply_stacked, tparams, cfg, var_batch_size=VAR_BATCH,
                                   device="cpu")


def port_run(mode, cohorts=None, **kw):
    _, tdata, _, _ = small_task()
    strat = make_port(mode, **kw)
    _, rounds = key_schedule(_cohorts(mode))
    cohorts = _cohorts(mode) if cohorts is None else cohorts
    state = strat.init(None, tdata)
    out, metrics = [_state(state)], []
    for (rkey, _), cohort in zip(rounds, cohorts):
        perms = t(ref_stream_permutations(rkey, SMALL["m"], 1, SMALL["n"], BATCH))
        state, met = strat.round(state, tdata, None, cohort, perms=perms)
        out.append(_state(state))
        metrics.append(met)
    return dict(states=out, metrics=metrics)


@pytest.mark.parametrize("mode", MODES)
def test_rounds_match_reference(mode):
    want, got = ref_run(mode), port_run(mode)
    for r, (g, w) in enumerate(zip(got["states"], want["states"])):
        assert sorted(g) == sorted(w)
        for k in g:
            gv = g[k][:, :w[k].shape[1]] if k == "grads" else g[k]
            if k == "staleness":
                np.testing.assert_array_equal(gv, w[k])
            else:
                np.testing.assert_allclose(gv, w[k], atol=1e-4, rtol=0,
                                           err_msg=f"{mode} {r} {k}")
    for g, w in zip(got["metrics"], want["metrics"]):
        assert g["streams"] == int(w["streams"]) == SMALL["m"]
        if mode == "refresh":
            assert int(g["staleness_max"]) == int(w["staleness_max"])
    # every stream moved in a dense round; a cohort round moves every
    # stream with mass on the cohort
    assert not np.allclose(got["states"][1]["params"], got["states"][0]["params"])


@pytest.mark.parametrize("mode", ["dense", "refresh"])
def test_stream_groups_change_nothing(mode):
    """One stream a group (the default: m units), two, and all six at once."""
    a = port_run(mode)
    b = port_run(mode, chunk_size=10 if mode == "refresh" else 12)  # two streams a group
    c = port_run(mode, chunk_size=10 ** 6)
    for x in (b, c):
        for sa, sb in zip(a["states"], x["states"]):
            for k in sa:
                np.testing.assert_allclose(sa[k], sb[k], atol=1e-6, rtol=0, err_msg=k)


@pytest.mark.parametrize("mode", ["cohort", "refresh"])
def test_padded_cohort_equals_unpadded(mode):
    plain = [participation.as_cohort(c.members, SMALL["m"]) for c in padded_cohorts()]
    a, b = port_run(mode), port_run(mode, cohorts=plain)
    for sa, sb in zip(a["states"], b["states"]):
        for k in sa:
            np.testing.assert_allclose(sa[k], sb[k], atol=1e-6, rtol=0, err_msg=k)


def test_refused_knobs_raise_at_construction():
    _, _, _, tparams = small_task()

    def build(**kw):
        return REGISTRY["ucfl_parallel"](lenet.apply_stacked, tparams, FedConfig(**kw),
                                         device="cpu")

    with pytest.raises(NotImplementedError, match="faults/robust"):
        build(faults=faults.FaultConfig())
    with pytest.raises(NotImplementedError, match="faults/robust"):
        build(robust=RobustConfig())
    with pytest.raises(NotImplementedError, match="ucfl_parallel.*capability matrix"):
        build(transport=transport.TransportConfig())
    with pytest.raises(TypeError, match="RefreshConfig"):
        build(w_refresh=object())
    with pytest.raises(NotImplementedError, match="buffered-async"):
        build(async_buffer=async_buffer.AsyncConfig())
    with pytest.raises(NotImplementedError, match="topology is not supported by ucfl_parallel"):
        build(topology=topology.Topology.contiguous(SMALL["m"], 2))
    with pytest.raises(NotImplementedError, match="shard_state is not supported by ucfl_parallel"):
        build(mesh=1, shard_state=True)
    s = build()
    assert (s.name, s.comm_scheme, s.num_streams, s.wire_schema, s.injects_faults) == \
        ("ucfl_parallel", "unicast", None, None, False)


def test_round_draws_from_gen_and_checks_perms():
    _, tdata, _, _ = small_task()
    s = make_port("refresh")
    state = s.init(None, tdata)
    cohort = padded_cohorts()[0]
    a, _ = s.round(simulation.clone_state(state), tdata, torch.Generator().manual_seed(2),
                   cohort)
    b, _ = s.round(simulation.clone_state(state), tdata, torch.Generator().manual_seed(2),
                   cohort)
    assert torch.equal(a["params"], b["params"]) and torch.equal(a["W"], b["W"])
    with pytest.raises(ValueError, match="gen= or perms="):
        s.round(state, tdata, None, cohort)
    with pytest.raises(ValueError, match="m streams"):
        s.round(state, tdata, None, cohort,
                perms=torch.zeros((SMALL["m"], 1, SMALL["n"]), dtype=torch.long))
    aged = s.skip_round(state)
    assert torch.equal(aged["refresh"]["staleness"], state["refresh"]["staleness"] + 1)
