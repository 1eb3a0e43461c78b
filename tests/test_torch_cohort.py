"""The masked cohort round (partial participation) in both packages.

Kernel ops: the port's plain ``cohort_gather`` / ``masked_mix_scatter``
against the reference's Pallas kernels in interpret mode, both variants
(VMEM slab and HBM-resident); the gather and scatter move values without
arithmetic and the mix is a (c, c) product, so rtol 1e-6. Masked rules:
atol 1e-6 (float sums in another order). ``ucfl`` and ``ucfl_k4``: init
plus two cohort rounds from the reference's params, data, cohorts and
batch orders; the params slab agrees to atol 1e-4 (as for the dense
rounds), ``streams`` exactly, and rows outside the cohort are bit-identical
to the rows before the round. Every cohort here has 3 slots, so the
reference's masked round compiles once per strategy.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FedConfig as RefFedConfig
from repro.core import aggregation as ref_agg
from repro.core import clustering as ref_clustering
from repro.core import ucfl as ref_ucfl
from repro.core.baselines import common as ref_common
from repro.federated import participation as ref_part
from repro.federated import simulation as ref_simulation
from repro.kernels import ops as ref_ops
from repro.models import lenet as ref_lenet
from repro_torch.core import Cohort, FedConfig, ParticipationConfig, aggregation, ucfl
from repro_torch.core.baselines import common
from repro_torch.federated import participation, simulation
from repro_torch.kernels import ops
from repro_torch.models import lenet
from torch_parity import BATCH, SMALL, VAR_BATCH, n, ref_permutations, small_task, t

SLOTS = 3
VARIANTS = ["interpret", "interpret_slab", "interpret_hbm"]


def _scatter_inputs(m, c, d, idx, mask, seed=0):
    rng = np.random.default_rng(seed)
    full = rng.normal(size=(m, d)).astype(np.float32)
    theta = rng.normal(size=(c, d)).astype(np.float32)
    w = rng.random((c, c)).astype(np.float32)
    w[:, ~np.asarray(mask, bool)] = 0.0  # pad columns carry no weight
    return w, theta, np.asarray(idx, np.int32), np.asarray(mask, bool), full


# (m, c, d, idx, mask): pads, an all-pad cohort, a masked slot with an
# in-bounds index, an odd width, and m = 13
SCATTER_CASES = {
    "pads": (13, 5, 97, [1, 4, 9, 13, 13], [1, 1, 1, 0, 0]),
    "all_pad": (13, 4, 97, [13, 13, 13, 13], [0, 0, 0, 0]),
    "masked_in_bounds": (8, 4, 256, [0, 2, 5, 7], [1, 1, 0, 1]),
    "full_cohort": (6, 6, 130, [0, 1, 2, 3, 4, 5], [1, 1, 1, 1, 1, 1]),
}


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("case", sorted(SCATTER_CASES))
def test_masked_mix_scatter_matches_reference(case, variant):
    m, c, d, idx, mask = SCATTER_CASES[case]
    w, theta, idx, mask, full = _scatter_inputs(m, c, d, idx, mask)
    want = ref_ops.masked_mix_scatter(jnp.asarray(w), jnp.asarray(theta), jnp.asarray(idx),
                                      jnp.asarray(mask), jnp.array(full), impl=variant)
    before = t(full)
    got = ops.masked_mix_scatter(t(w), t(theta), t(idx), t(mask), before)
    np.testing.assert_allclose(n(got), n(want), rtol=1e-6, atol=1e-6)
    assert torch.equal(before, t(full)), "the plain version must not write its input"
    live = [int(i) for i, k in zip(idx, mask) if k and i < m]
    untouched = np.setdiff1d(np.arange(m), live)
    np.testing.assert_array_equal(n(got)[untouched], full[untouched])
    if case == "all_pad":
        np.testing.assert_array_equal(n(got), full)


@pytest.mark.parametrize("variant", VARIANTS)
def test_cohort_gather_matches_reference(variant):
    m, d = 13, 97
    full = np.random.default_rng(1).normal(size=(m, d)).astype(np.float32)
    idx = np.asarray([0, 12, 5, 13, 13, 7], np.int32)  # pads read row m-1
    want = ref_ops.cohort_gather(jnp.asarray(full), jnp.asarray(idx), impl=variant)
    for index in (t(idx), t(idx).long()):
        got = ops.cohort_gather(t(full), index)
        np.testing.assert_array_equal(n(got), n(want))
    np.testing.assert_array_equal(n(got)[3:5], full[[12, 12]])


BAD_SHAPES = {  # argument -> a shape that breaks the (c, c), (c, d), (c,), (m, d) contract
    "w_not_square": ("w", (3, 4)), "theta_rows": ("theta", (4, 8)), "idx_len": ("idx", (4,)),
    "mask_len": ("mask", (2,)), "full_1d": ("full", (40,)), "width": ("theta", (3, 9)),
}


@pytest.mark.parametrize("what", sorted(BAD_SHAPES))
def test_masked_mix_scatter_shape_errors(what):
    shapes = dict(w=(3, 3), theta=(3, 8), idx=(3,), mask=(3,), full=(5, 8))
    name, shape = BAD_SHAPES[what]
    shapes[name] = shape
    dtypes = dict(idx=torch.int32, mask=torch.bool)
    args = {k: torch.zeros(s, dtype=dtypes.get(k, torch.float32)) for k, s in shapes.items()}
    with pytest.raises(ValueError, match="upload width" if what == "width" else None):
        ops.masked_mix_scatter(**args)


def test_cohort_gather_shape_errors_and_dict_state():
    with pytest.raises(ValueError, match=r"\(m, d\)"):
        ops.cohort_gather(torch.ones(4), torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match=r"\(c,\)"):
        ops.cohort_gather(torch.ones(4, 3), torch.zeros(2, 1, dtype=torch.int32))
    idx = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="slab"):
        aggregation.cohort_gather({"a": torch.ones(4, 3)}, idx)
    with pytest.raises(ValueError, match="slab"):
        aggregation.mix_scatter_flat({"a": torch.ones(4, 3)}, torch.ones(2, 3),
                                     torch.eye(2), idx, torch.ones(2, dtype=torch.bool))


def test_mix_scatter_flat_slices_a_wide_upload():
    w, theta, idx, mask, full = _scatter_inputs(6, 3, 128, [1, 2, 6], [1, 1, 0])
    wide = np.concatenate([theta, np.zeros((3, 128), np.float32)], axis=1)
    got = aggregation.mix_scatter_flat(t(full), t(wide), t(w), t(idx), t(mask))
    want = ops.masked_mix_scatter(t(w), t(theta), t(idx), t(mask), t(full))
    assert torch.equal(got, want)


# ------------------------------------------------------------ masked rules

def _rule_inputs(seed=0, m=7):
    rng = np.random.default_rng(seed)
    w = rng.random((m, m)).astype(np.float32)
    w /= w.sum(axis=1, keepdims=True)
    w[2, [0, 4, 6]] = 0.0  # client 2 has no mass on the cohort below: identity row
    labels = np.asarray([0, 1, 0, 2, 1, 2, 0], np.int32)
    idx = np.asarray([0, 2, 4, 6, 7, 7], np.int32)
    mask = np.asarray([1, 1, 1, 1, 0, 0], bool)
    return w, labels, idx, mask


def test_masked_rules_match_reference():
    w, labels, idx, mask = _rule_inputs()
    jw, jl, ji, jm = (jnp.asarray(a) for a in (w, labels, idx, mask))
    tw, tl, ti, tm = t(w), t(labels), t(idx), t(mask)
    got = aggregation.masked_cohort_matrix(tw, ti, tm)
    np.testing.assert_allclose(n(got), n(ref_agg.masked_cohort_matrix(jw, ji, jm)), atol=1e-6)
    np.testing.assert_array_equal(n(got)[1], np.eye(6)[1])  # the degenerate row
    np.testing.assert_allclose(n(got)[:, 4:], 0.0)  # pad columns
    got = aggregation.masked_clustered_rows(tw, tl, 3, ti, tm)
    np.testing.assert_allclose(n(got)[:4], n(ref_agg.masked_clustered_rows(jw, jl, 3, ji, jm))[:4],
                               atol=1e-6)
    sizes = np.asarray([5, 9, 2, 7, 3, 3, 1], np.int32)
    nc = sizes[np.minimum(idx, 6)]
    np.testing.assert_allclose(
        n(aggregation.masked_group_rows(t(labels[np.minimum(idx, 6)]), t(nc), tm)),
        n(ref_agg.masked_group_rows(jnp.asarray(labels[np.minimum(idx, 6)]), jnp.asarray(nc), jm)),
        atol=1e-6)
    np.testing.assert_allclose(n(aggregation.masked_fedavg_weights(t(nc), tm)),
                               n(ref_agg.masked_fedavg_weights(jnp.asarray(nc), jm)), atol=1e-6)
    assert float(aggregation.masked_fedavg_weights(t(nc), t(np.zeros(6, bool))).abs().sum()) == 0
    gc, ga = aggregation.masked_column_mixing(tw, ti, tm)
    rc, ra = ref_agg.masked_column_mixing(jw, ji, jm)
    np.testing.assert_allclose(n(gc), n(rc), atol=1e-6)
    np.testing.assert_array_equal(n(ga), n(ra))
    np.testing.assert_array_equal(n(aggregation.safe_gather_index(ti, 7)), np.minimum(idx, 6))


def test_padded_rules_equal_unpadded_oracles():
    w, labels, idx, mask = _rule_inputs()
    members = idx[mask]
    tw, tl = t(w), t(labels)
    theta = np.random.default_rng(3).normal(size=(len(idx), 40)).astype(np.float32)
    rows = aggregation.masked_cohort_matrix(tw, t(idx), t(mask))
    want = aggregation.cohort_mixing_matrix(tw, t(members))
    np.testing.assert_allclose(n(rows)[:4, :4], n(want), atol=1e-6)
    np.testing.assert_allclose(
        n(want), n(ref_agg.cohort_mixing_matrix(jnp.asarray(w), jnp.asarray(members))), atol=1e-6)
    rows = aggregation.masked_clustered_rows(tw, tl, 3, t(idx), t(mask))
    want = aggregation.clustered_cohort(t(theta[:4]), tw, tl, 3, t(members))
    np.testing.assert_allclose(n(rows)[:4] @ theta, n(want), atol=1e-5)
    ref_want = ref_agg.clustered_cohort(jnp.asarray(theta[:4]), jnp.asarray(w),
                                        jnp.asarray(labels), 3, jnp.asarray(members))
    np.testing.assert_allclose(n(want), n(ref_want), atol=1e-5)


def test_fedavg_masked_mix_matches_reference():
    rng = np.random.default_rng(5)
    params = rng.normal(size=(7, 256)).astype(np.float32)
    upd = rng.normal(size=(4, 256)).astype(np.float32)
    idx, sizes = np.asarray([1, 3, 7, 7], np.int32), np.asarray([5, 9, 2, 7, 3, 3, 1], np.int32)
    for mask in (np.asarray([1, 1, 0, 0], bool), np.zeros(4, bool)):
        want = ref_common.fedavg_masked_mix(jnp.asarray(params), jnp.asarray(upd),
                                            jnp.asarray(idx), jnp.asarray(mask), jnp.asarray(sizes))
        got = common.fedavg_masked_mix(t(params), t(upd), t(idx), t(mask), t(sizes))
        np.testing.assert_allclose(n(got), n(want), atol=1e-6)
    np.testing.assert_array_equal(n(got), params)  # all-masked: the previous model


def test_cohort_keys_are_client_indexed():
    perms = torch.arange(5 * 2 * 4).reshape(5, 2, 4)
    safe = torch.tensor([1, 4, 4])
    assert torch.equal(common.cohort_keys(None, 5, safe, epochs=2, n=4, perms=perms), perms[safe])
    with pytest.raises(ValueError, match="rows"):
        common.cohort_keys(None, 6, safe, epochs=2, n=4, perms=perms)
    # drawn orders depend on the client id only, not on the slot count
    a = common.cohort_keys(torch.Generator().manual_seed(0), 5, safe, epochs=2, n=4)
    b = common.cohort_keys(torch.Generator().manual_seed(0), 5, safe[:1], epochs=2, n=4)
    assert torch.equal(a[:1], b)


# ------------------------------------------------- the slice: ucfl cohorts

def _cohorts(m):
    """Round 1: a 3-of-m uniform cohort; round 2: two members and a pad."""
    c1 = participation.sample_cohort(ParticipationConfig(cohort_size=SLOTS), 1, m)
    c2 = Cohort(indices=np.asarray([0, m - 1, m], np.int32), mask=np.asarray([1, 1, 0], bool))
    return [c1, c2]


@pytest.mark.parametrize("num_streams", [None, 4])
def test_ucfl_cohort_rounds_match_reference(num_streams):
    data, tdata, params0, tparams = small_task()
    m, nn = SMALL["m"], SMALL["n"]
    key = jax.random.PRNGKey(1)
    key, ikey = jax.random.split(key)
    ref = ref_ucfl.make_ucfl(ref_lenet.apply, params0, RefFedConfig(batch_size=BATCH),
                             num_streams=num_streams, var_batch_size=VAR_BATCH)
    port = ucfl.make_ucfl(lenet.apply_stacked, tparams, FedConfig(batch_size=BATCH),
                          num_streams=num_streams, var_batch_size=VAR_BATCH, device="cpu")
    rstate = dict(jax.jit(ref.init)(ikey, data), streams=num_streams)
    seeds = None
    if num_streams is not None:
        seeds = t(jax.jit(ref_clustering._plusplus_init, static_argnums=2)(
            ikey, rstate["W"].astype(jnp.float32), num_streams))
    pstate = port.init(None, tdata, kmeans_init=seeds)
    if num_streams is not None:
        np.testing.assert_array_equal(n(pstate["labels"]), n(rstate["labels"]))
        np.testing.assert_array_equal(pstate["labels_host"], n(rstate["labels"]))
    for cohort in _cohorts(m):
        key, rkey = jax.random.split(key)
        rcohort = ref_part.Cohort(indices=cohort.indices, mask=cohort.mask)
        rstate, rmet = ref.round(ref_simulation.donation_safe_copy(rstate), data, rkey, rcohort)
        before = pstate["params"].clone()
        perms = t(ref_permutations(rkey, m, 1, nn, BATCH))
        pstate, pmet = port.round(pstate, tdata, None, cohort, perms=perms)
        assert pmet["streams"] == int(rmet["streams"])
        assert pmet["cohort_size"] == rmet["cohort_size"] == len(cohort)
        outside = np.setdiff1d(np.arange(m), cohort.members)
        assert torch.equal(pstate["params"][outside], before[outside])
        np.testing.assert_allclose(n(pstate["params"]), n(rstate["params"]), atol=1e-4)


def _port_strategy(num_streams=None):
    _, tdata, _, tparams = small_task()
    s = ucfl.make_ucfl(lenet.apply_stacked, tparams, FedConfig(batch_size=BATCH),
                       num_streams=num_streams, var_batch_size=VAR_BATCH, device="cpu")
    return s, tdata


@pytest.mark.parametrize("num_streams", [None, 2])
def test_padded_cohort_equals_unpadded_within_the_port(num_streams):
    s, tdata = _port_strategy(num_streams)
    state = s.init(torch.Generator().manual_seed(0), tdata)
    perms = torch.stack([torch.randperm(SMALL["n"], generator=torch.Generator().manual_seed(i))
                         for i in range(SMALL["m"])])[:, None]
    members = np.asarray([1, 3, 4], np.int32)
    padded = participation.pad_slots(Cohort(members, np.ones(3, bool)), 5, SMALL["m"])
    su, mu = s.round(simulation.clone_state(state), tdata, None, members, perms=perms)
    sp, mp = s.round(simulation.clone_state(state), tdata, None, padded, perms=perms)
    assert mu == mp
    # the CPU's sums may group a 3- and a 5-term row differently; the card's
    # mix kernel is bit-exact (tests/test_torch_cuda.py)
    np.testing.assert_allclose(n(sp["params"]), n(su["params"]), rtol=0, atol=1e-6)
    assert torch.equal(sp["params"][[0, 2, 5]], state["params"][[0, 2, 5]])


def test_simulation_learns_at_half_participation():
    s, tdata = _port_strategy()
    h = simulation.run(s, lenet.apply_stacked, tdata, 0, rounds=3,
                       participation=ParticipationConfig(fraction=0.5), device="cpu")
    assert [mt["cohort_size"] for mt in h.metrics] == [3, 3, 3]
    assert [mt["streams"] for mt in h.metrics] == [3, 3, 3]
    assert h.avg_acc[-1] > 1.0 / SMALL["num_classes"] + 0.1
    assert torch.isfinite(h.state["params"]).all() and min(h.wall_s, h.eval_s) > 0


def test_simulation_all_offline_round_one_warms_up_and_skips():
    s, tdata = _port_strategy()
    m = SMALL["m"]
    trace = np.zeros((m, 2), bool)
    trace[:2, 1] = True  # round 1: nobody up; round 2: clients 0 and 1
    calls = []

    def recording_round(state, data, gen=None, cohort=None, *, perms=None):
        calls.append(cohort)
        return s.round(state, data, gen, cohort, perms=perms)

    skips = []
    s2 = dataclasses.replace(s, round=recording_round,
                             skip_round=lambda st: skips.append(1) or st)
    cfg = ParticipationConfig(cohort_size=SLOTS, sampler="availability", availability=trace)
    h = simulation.run(s2, lenet.apply_stacked, tdata, 0, rounds=3, participation=cfg,
                       device="cpu")
    warm = calls[0]
    np.testing.assert_array_equal(warm.indices, [0, m, m])
    np.testing.assert_array_equal(warm.mask, [True, False, False])
    # the reference's metrics for a skipped round (repro/federated/simulation.py)
    skipped = {"streams": 0, "cohort_size": 0, "skipped": True}
    assert h.metrics[0] == skipped and h.metrics[2] == skipped and len(skips) == 2
    assert h.metrics[1] == {"streams": 2, "cohort_size": 2}
    np.testing.assert_array_equal(calls[1].indices, [0, 1, m])


def test_full_availability_cohort_matches_dense():
    s, tdata = _port_strategy()
    m = SMALL["m"]
    cfg = ParticipationConfig(cohort_size=m, sampler="availability",
                              availability=np.ones((m, 1), bool))
    dense = simulation.run(s, lenet.apply_stacked, tdata, 3, rounds=2, device="cpu")
    full = simulation.run(s, lenet.apply_stacked, tdata, 3, rounds=2, participation=cfg,
                          device="cpu")
    assert [mt["cohort_size"] for mt in full.metrics] == [m, m]
    np.testing.assert_allclose(n(full.state["params"]), n(dense.state["params"]), atol=1e-5)
