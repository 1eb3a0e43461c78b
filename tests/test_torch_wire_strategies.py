"""The quantized wire on every strategy, in both packages.

``ucfl``, ``clustered`` (``ucfl_k4``) and the nine baselines, each with
``TransportConfig("int8")`` and ``("fp8")``: init plus two padded-cohort
rounds (5 slots, 3 and 4 members) in the reference and in the port, from
the same params0, data, cohorts and batch orders (the reference's, as
``tests/test_torch_baselines.py`` injects them). After each round every
state slab (``params``, ``personal``, ``c_i``, ``c``) and the EF slabs
``ef`` and ``ef_dl`` are held against the reference's.

Tolerance: each element within 1e-4, or, where an f32 summation
difference flips a rounding of the wire (the reference's round is
compiled, so its local SGD sums, and its scale's last bit, may differ
from the port's), within one quantization step of its chunk. A chunk's
step is taken from the reference's own EF slabs: a residual is at most
half a step, so the step of a column chunk is twice the largest residual
the reference holds there, uplink plus downlink, over the rounds so far.
At most 0.1 % of a slab's elements may take the second clause.

The fp8 runs hold the port against the reference with the reference's
e4m3 cast made on the host by ``ml_dtypes`` (its ``quantize`` otherwise
as it stands): compiled by XLA on the CPU, the reference's cast rounds
f32 → f16 → e4m3 where the cast feeds a later product (the FedAvg mean),
a double rounding one e4m3 step off the correctly rounded cast in about
0.5 % of the elements, which its own op-by-op path, ``ml_dtypes`` and
the port all give (``tests/test_torch_transport.py``).

Within the port: the EF slabs are ``wire_schema.width_aligned`` wide; a
padded cohort equals the unpadded one, EF included; rows outside the
cohort, EF rows included, are bit-identical across a round; an all-pad
FedAvg round leaves ``params`` and ``ef_dl`` as they were;
``transport=None`` runs no stage and its state has no EF key; a dense
round with transport raises ``ValueError``, and a transport that is no
``TransportConfig`` ``TypeError`` when the strategy is built;
``Strategy.wire_schema`` equals the reference's field by field.
"""
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import core as ref_core
from repro.core import FedConfig as RefFedConfig
from repro.core import clustering as ref_clustering
from repro.core import ucfl as ref_ucfl
from repro.federated import participation as ref_part
from repro.federated import simulation as ref_simulation
from repro.federated import transport as ref_transport
from repro.models import lenet as ref_lenet
from repro_torch.core import REGISTRY, Cohort, FedConfig, ucfl
from repro_torch.federated import participation, simulation, transport
from repro_torch.models import lenet
from test_torch_baselines import CFG, SLOTS, _perms
from torch_parity import (BATCH, SMALL, VAR_BATCH, n, one_torch_thread,  # noqa: F401
                          ref_permutations, small_task, t)

# every test on one torch thread (torch_parity.one_torch_thread)
pytestmark = pytest.mark.usefixtures("one_torch_thread")

NAMES = ["ucfl", "clustered", "fedavg", "fedprox", "local", "oracle", "scaffold", "ditto",
         "pfedme", "fedfomo", "cfl"]
KINDS = ["int8", "fp8"]
SLABS = ("params", "personal", "c_i", "c", "ef", "ef_dl")
CLUSTERS = 4
ATOL = 1e-4
FLIP_SHARE = 1e-3


def _cohorts(m):
    """Two rounds: three, then four real members, each padded to 5 slots."""
    return [participation.pad_slots(participation.as_cohort(np.asarray(mem), m), SLOTS, m)
            for mem in ([0, 2, 5], [1, 2, 3, 4])]


def _schedule():
    key = jax.random.PRNGKey(1)
    key, ikey = jax.random.split(key)
    rounds = []
    for cohort in _cohorts(SMALL["m"]):
        key, rkey = jax.random.split(key)
        rounds.append((rkey, cohort))
    return ikey, rounds


def _cfg_kw(name):
    return dict(CFG.get(name, {}), batch_size=BATCH)


def strat_epochs(name):
    return _cfg_kw(name).get("epochs", 1)


def _ref_strategy(name, kind):
    _, _, params0, _ = small_task()
    tr = None if kind is None else ref_transport.TransportConfig(kind)
    cfg = RefFedConfig(**_cfg_kw(name), transport=tr)
    if name in ("ucfl", "clustered"):
        return ref_ucfl.make_ucfl(ref_lenet.apply, params0, cfg,
                                  num_streams=None if name == "ucfl" else CLUSTERS,
                                  var_batch_size=VAR_BATCH)
    return ref_core.REGISTRY[name](ref_lenet.apply, params0, cfg)


def _port_strategy(name, kind):
    _, _, _, tparams = small_task()
    tr = None if kind is None else transport.TransportConfig(kind)
    cfg = FedConfig(**_cfg_kw(name), transport=tr)
    if name in ("ucfl", "clustered"):
        return ucfl.make_ucfl(lenet.apply_stacked, tparams, cfg,
                              num_streams=None if name == "ucfl" else CLUSTERS,
                              var_batch_size=VAR_BATCH, device="cpu")
    return REGISTRY[name](lenet.apply_stacked, tparams, cfg, device="cpu")


def _slabs(state):
    return {k: np.array(state[k]) for k in SLABS if k in state}


def _host_cast_quantize(x, cfg):
    """The reference's ``quantize`` (``repro/federated/transport.py``) with
    its fp8 cast made by ``ml_dtypes`` on the host."""
    d, chunk = x.shape[-1], int(cfg.chunk)
    xs = x.reshape(x.shape[:-1] + (d // chunk, chunk))
    scale = jnp.max(jnp.abs(xs), axis=-1, keepdims=True) / 448.0
    scale = jnp.maximum(scale, jnp.finfo(jnp.float32).tiny)
    v = xs / scale
    q = jax.pure_callback(lambda a: np.asarray(a).astype(ml_dtypes.float8_e4m3fn),
                          jax.ShapeDtypeStruct(v.shape, jnp.float8_e4m3fn), v)
    return q, scale


@functools.lru_cache(maxsize=None)
def ref_run(name, kind):
    """The reference's init state (ucfl: and its K-means seeds) and its
    slabs after each round."""
    with pytest.MonkeyPatch.context() as mp:
        if kind == "fp8":
            mp.setattr(ref_transport, "quantize", _host_cast_quantize)
        return _ref_run(name, kind)


def _ref_run(name, kind):
    data, _, _, _ = small_task()
    strat = _ref_strategy(name, kind)
    ikey, rounds = _schedule()
    seeds = None
    if name in ("ucfl", "clustered"):
        state = dict(jax.jit(strat.init)(ikey, data),
                     streams=None if name == "ucfl" else CLUSTERS)
        if name == "clustered":
            seeds = np.asarray(jax.jit(ref_clustering._plusplus_init, static_argnums=2)(
                ikey, state["W"].astype(jnp.float32), CLUSTERS))
    elif name in ("oracle", "cfl"):  # their init reads host values
        state = strat.init(ikey, data)
    else:
        state = jax.jit(strat.init)(ikey, data)
    out = [_slabs(state)]
    for rkey, cohort in rounds:
        rc = ref_part.Cohort(indices=cohort.indices, mask=cohort.mask)
        state, _ = strat.round(ref_simulation.donation_safe_copy(state), data, rkey, rc)
        out.append(_slabs(state))
    return dict(slabs=out, seeds=seeds)


def _perms_of(name, rkey, epochs):
    if name in ("ucfl", "clustered"):
        return t(ref_permutations(rkey, SMALL["m"], epochs, SMALL["n"], BATCH))
    return _perms(name, rkey, epochs)


def _port_init(name, strat, tdata, kind):
    if name == "clustered":
        return strat.init(None, tdata, kmeans_init=t(ref_run(name, kind)["seeds"]))
    return strat.init(None, tdata)


@functools.lru_cache(maxsize=None)
def port_run(name, kind):
    """The port's run of :func:`ref_run`'s schedule on the CPU; also the
    state before each round, to check the rows outside the cohort."""
    _, tdata, _, _ = small_task()
    strat = _port_strategy(name, kind)
    state = _port_init(name, strat, tdata, kind)
    _, rounds = _schedule()
    out, before = [{k: n(v) for k, v in _slabs(state).items()}], []
    for rkey, cohort in rounds:
        before.append(simulation.clone_state(state))
        state, _ = strat.round(state, tdata, None, cohort,
                               perms=_perms_of(name, rkey, strat_epochs(name)))
        out.append({k: n(v) for k, v in _slabs(state).items()})
    return dict(slabs=out, before=before, state=state, strat=strat)


def _steps(want_rounds, upto, width):
    """The quantization step of each column chunk, as a (width,) array:
    twice the largest residual the reference's uplink EF holds there in
    rounds 1..``upto``, plus the same of its downlink EF (a wire wider
    than the slab, SCAFFOLD's, folds its streams onto the slab columns)."""
    step = np.zeros(width, np.float32)
    for key in ("ef", "ef_dl"):
        peak = np.zeros(width, np.float32)
        for r in range(1, upto + 1):
            ef = want_rounds[r].get(key)
            if ef is not None:
                chunks = np.abs(ef).max(axis=0).reshape(-1, 128).max(axis=1)
                peak = np.maximum(peak, np.repeat(chunks, 128).reshape(-1, width).max(axis=0))
        step += 2 * peak
    return step


def _assert_wire_close(got, want, step, what):
    err = np.abs(got.astype(np.float64) - want)
    flipped = err > ATOL
    bound = ATOL + np.broadcast_to(step, got.shape)
    worst = float((err - bound).max())
    assert worst <= 0, f"{what}: an element off by {worst:.3e} past its step"
    share = float(flipped.mean())
    assert share <= FLIP_SHARE, f"{what}: {share:.4%} of the elements past {ATOL}"


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", NAMES)
def test_cohort_rounds_match_reference(name, kind):
    got, want = port_run(name, kind)["slabs"], ref_run(name, kind)["slabs"]
    assert sorted(got[0]) == sorted(want[0])
    for r in range(len(want)):
        assert sorted(got[r]) == sorted(want[r]), r
        width = want[r]["params"].shape[1]
        step = _steps(want, r, width)
        for k in want[r]:
            g, w = got[r][k], want[r][k]
            assert g.shape == w.shape, (k, g.shape, w.shape)
            wstep = np.tile(step, g.shape[1] // width)
            _assert_wire_close(g, w, wstep, f"{name} {kind} round {r} {k}")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", NAMES)
def test_ef_slabs_are_schema_wide_and_rows_outside_stay(name, kind):
    run = port_run(name, kind)
    schema, state = run["strat"].wire_schema, run["state"]
    m = SMALL["m"]
    assert tuple(state["ef"].shape) == (m, schema.width_aligned("uplink"))
    has_dl = transport.make_wire_stage(schema, transport.TransportConfig(kind), "downlink")
    assert ("ef_dl" in state) == (has_dl is not None)
    if has_dl is not None:
        rows = m if name == "ucfl" else 1
        assert tuple(state["ef_dl"].shape) == (rows, schema.width_aligned("downlink"))
    # the EF rows of clients outside the cohort stay as they were; a
    # per-client slab's params rows too, where the strategy keeps them
    _, rounds = _schedule()
    for (_, cohort), before, after in zip(rounds, run["before"], run["slabs"][1:]):
        outside = np.setdiff1d(np.arange(m), cohort.members)
        keys = ["ef"] + (["ef_dl"] if name == "ucfl" else [])
        if name not in ("fedavg", "fedprox", "scaffold", "ditto"):
            keys.append("params")
        for k in keys:
            np.testing.assert_array_equal(after[k][outside], n(before[k])[outside], err_msg=k)
        assert np.abs(after["ef"][cohort.members]).max() > 0


@pytest.mark.parametrize("name", NAMES)
def test_padded_cohort_equals_unpadded_with_ef(name):
    _, tdata, _, _ = small_task()
    s = _port_strategy(name, "int8")
    state = _port_init(name, s, tdata, "int8")
    perms = _perms_of(name, jax.random.PRNGKey(3), strat_epochs(name))
    state, _ = s.round(state, tdata, None, np.asarray([0, 2, 4], np.int32), perms=perms)
    members = np.asarray([1, 3, 5], np.int32)
    padded = participation.pad_slots(Cohort(members, np.ones(3, bool)), SLOTS, SMALL["m"])
    su, mu = s.round(simulation.clone_state(state), tdata, None, members, perms=perms)
    sp, mp = s.round(simulation.clone_state(state), tdata, None, padded, perms=perms)
    assert mu == mp
    for k in SLABS:
        if k in su:
            # the CPU's sums may group a 3- and a 5-slot row differently
            np.testing.assert_allclose(n(sp[k]), n(su[k]), rtol=0, atol=1e-6, err_msg=k)
    assert torch.equal(sp["ef"][[0, 2, 4]], state["ef"][[0, 2, 4]])


def test_all_pad_fedavg_round_leaves_params_and_ef_dl():
    _, tdata, _, _ = small_task()
    s = _port_strategy("fedavg", "int8")
    state, _ = s.round(s.init(None, tdata), tdata, torch.Generator().manual_seed(0),
                       np.asarray([0, 3], np.int32))
    assert float(state["ef_dl"].abs().max()) > 0
    m = SMALL["m"]
    empty = Cohort(np.full(SLOTS, m, np.int32), np.zeros(SLOTS, bool))
    new, _ = s.round(simulation.clone_state(state), tdata, torch.Generator().manual_seed(1),
                     empty)
    for k in ("params", "ef", "ef_dl"):
        assert torch.equal(new[k], state[k]), k


@pytest.mark.parametrize("name", NAMES)
def test_no_transport_runs_no_stage_and_keeps_no_ef(name, monkeypatch):
    _, tdata, _, _ = small_task()

    def forbidden(*a, **k):
        raise AssertionError("a wire stage ran with transport=None")

    monkeypatch.setattr(transport, "roundtrip", forbidden)
    s = _port_strategy(name, None)
    state = _port_init(name, s, tdata, "int8")
    perms = _perms_of(name, jax.random.PRNGKey(3), strat_epochs(name))
    cohort = participation.pad_slots(Cohort(np.asarray([1, 4], np.int32), np.ones(2, bool)),
                                     SLOTS, SMALL["m"])
    a, _ = s.round(simulation.clone_state(state), tdata, None, cohort, perms=perms)
    b, _ = s.round(simulation.clone_state(state), tdata, None, cohort, perms=perms)
    assert not any(k.startswith("ef") for k in list(state) + list(a))
    for k in SLABS:
        if k in a:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("name", NAMES)
def test_dense_round_with_transport_raises(name):
    _, tdata, _, _ = small_task()
    s = _port_strategy(name, "int8")
    with pytest.raises(ValueError, match="requires cohort rounds"):
        s.round(_port_init(name, s, tdata, "int8"), tdata, torch.Generator().manual_seed(0))


@pytest.mark.parametrize("name", NAMES)
def test_wire_schema_matches_reference(name):
    got = _port_strategy(name, "int8").wire_schema
    want = _ref_strategy(name, "int8").wire_schema
    assert got.strategy == want.strategy
    for direction in ("uplink", "downlink"):
        g, w = got.streams(direction), want.streams(direction)
        assert [(s.name, s.width, s.coding) for s in g] == \
            [(s.name, s.width, s.coding) for s in w], direction
        assert got.width_aligned(direction) == want.width_aligned(direction)


@pytest.mark.parametrize("name", NAMES)
def test_a_transport_that_is_no_transport_config_raises_at_construction(name):
    _, _, _, tparams = small_task()
    for bad in ("int8", ref_transport.TransportConfig("int8")):
        cfg = FedConfig(**_cfg_kw(name), transport=bad)
        with pytest.raises(TypeError, match="TransportConfig"):
            if name in ("ucfl", "clustered"):
                ucfl.make_ucfl(lenet.apply_stacked, tparams, cfg,
                               num_streams=None if name == "ucfl" else CLUSTERS, device="cpu")
            else:
                REGISTRY[name](lenet.apply_stacked, tparams, cfg, device="cpu")
    assert FedConfig().transport is None
    with pytest.raises(ValueError, match="num_shards"):  # no process group of 8 ranks
        ucfl.make_ucfl(lenet.apply_stacked, tparams, FedConfig(mesh=8), device="cpu")
