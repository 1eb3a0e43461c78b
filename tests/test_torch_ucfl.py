"""The slice as a whole: Algorithm 1 (dense) in both packages, plus the
port's synthesizers and simulation loop.

``make_ucfl`` runs ``init`` then two dense rounds, for full
personalization and for 4 streams, from the reference's params0, data and
per-round batch orders (derived from the same key splits as
``repro.federated.simulation.run``). The clustered port is handed the
reference's K-means++ seeds. Tolerances (f32 on the CPU): W atol 1e-4,
the params slab atol 1e-4 after two rounds (each round is 4 momentum
steps plus a mix, on gradients that agree to about 1e-6), cluster labels
exact, per-client eval accuracy within one test sample (1/n_test).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FedConfig as RefFedConfig
from repro.core import clustering as ref_clustering
from repro.core import ucfl as ref_ucfl
from repro.data import synthetic as ref_synthetic
from repro.federated import client as ref_client
from repro.models import lenet as ref_lenet
from repro_torch.core import REGISTRY, FedConfig, ucfl
from repro_torch.data import synthetic
from repro_torch.federated import client, simulation
from repro_torch.models import lenet
from torch_parity import BATCH, SMALL, VAR_BATCH, n, ref_permutations, small_task, t


@pytest.mark.parametrize("num_streams", [None, 4])
def test_dense_ucfl_two_rounds_match_reference(num_streams):
    data, tdata, params0, tparams = small_task()
    m, nn = SMALL["m"], SMALL["n"]
    # the key stream of repro.federated.simulation.run: split once for
    # init, then once per round
    key = jax.random.PRNGKey(1)
    key, ikey = jax.random.split(key)
    ref = ref_ucfl.make_ucfl(ref_lenet.apply, params0, RefFedConfig(batch_size=BATCH),
                             num_streams=num_streams, var_batch_size=VAR_BATCH)
    port = ucfl.make_ucfl(lenet.apply_stacked, tparams, FedConfig(batch_size=BATCH),
                          num_streams=num_streams, var_batch_size=VAR_BATCH, device="cpu")
    # init under one jit (its eager special round compiles op by op); the
    # stream count comes back as an array and is put back as the int it is
    rstate = dict(jax.jit(ref.init)(ikey, data), streams=num_streams)
    seeds = None
    if num_streams is not None:
        seeds = t(jax.jit(ref_clustering._plusplus_init, static_argnums=2)(
            ikey, rstate["W"].astype(jnp.float32), num_streams))
    pstate = port.init(None, tdata, kmeans_init=seeds)
    np.testing.assert_allclose(n(pstate["W"]), n(rstate["W"]), atol=1e-4)
    if num_streams is not None:
        np.testing.assert_array_equal(n(pstate["labels"]), n(rstate["labels"]))
    for _ in range(2):
        key, rkey = jax.random.split(key)
        rstate, rmet = ref.round(rstate, data, rkey)
        perms = t(ref_permutations(rkey, m, 1, nn, BATCH))
        pstate, pmet = port.round(pstate, tdata, None, perms=perms)
        assert pmet["streams"] == rmet["streams"] and pmet["cohort_size"] == m
    np.testing.assert_allclose(n(pstate["params"]), n(rstate["params"]), atol=1e-4)
    racc = ref_client.evaluate(ref_lenet.apply, ref.eval_params(rstate), data.x_test, data.y_test)
    pacc = client.evaluate(lenet.apply_stacked, port.eval_params(pstate), tdata.x_test,
                           tdata.y_test)
    np.testing.assert_allclose(n(pacc), n(racc), atol=1.0 / SMALL["n_test"] + 1e-6)


def test_cohort_round_and_unported_knobs_raise():
    _, tdata, _, tparams = small_task()
    s = REGISTRY["ucfl"](lenet.apply_stacked, tparams, FedConfig(batch_size=BATCH),
                         var_batch_size=VAR_BATCH, device="cpu")
    state = s.init(torch.Generator().manual_seed(0), tdata)
    before = state["params"].clone()
    # a plain index array is an unpadded cohort: the masked round runs on it
    new, metrics = s.round(simulation.clone_state(state), tdata,
                           torch.Generator().manual_seed(1), cohort=np.arange(3))
    assert metrics == {"streams": 3, "cohort_size": 3}
    assert torch.equal(new["params"][3:], before[3:])
    assert not torch.equal(new["params"][:3], before[:3])
    assert torch.equal(state["params"], before)
    with pytest.raises(ValueError, match="num_shards"):  # no process group of 8 ranks
        ucfl.make_ucfl(lenet.apply_stacked, tparams, FedConfig(mesh=8), device="cpu")
    with pytest.raises(TypeError, match="RefreshConfig"):  # a knob of the wrong type
        ucfl.make_ucfl(lenet.apply_stacked, tparams, FedConfig(w_refresh=object()),
                       device="cpu")
    with pytest.raises(ValueError, match="num_streams"):
        ucfl.make_ucfl(lenet.apply_stacked, tparams, num_streams=0, device="cpu")


def test_simulation_run_learns_and_reports_times():
    _, tdata, _, tparams = small_task()
    for ns in (None, "auto"):
        s = ucfl.make_ucfl(lenet.apply_stacked, tparams, FedConfig(batch_size=BATCH),
                           num_streams=ns, var_batch_size=VAR_BATCH, device="cpu")
        h = simulation.run(s, lenet.apply_stacked, tdata, 0, rounds=3, device="cpu")
        assert h.rounds == [1, 2, 3] and len(h.avg_acc) == 3
        assert h.avg_acc[-1] > 1.0 / SMALL["num_classes"] + 0.2
        assert h.paired_best[0] == max(h.avg_acc)
        assert min(h.init_s, h.wall_s, h.eval_s) > 0
        np.testing.assert_allclose(n(h.state["W"]).sum(axis=1), 1.0, atol=1e-5)
        assert torch.isfinite(h.state["params"]).all()
    assert isinstance(h.state["streams"], int) and 2 <= h.state["streams"] < SMALL["m"]


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("the no-CUDA error path needs a machine without a GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        synthetic.covariate_label_shift(0, m=2, n=4, n_test=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        ucfl.make_ucfl(lenet.apply_stacked, {"a": torch.zeros(1)})


def test_rotation_direction_matches_reference():
    x = np.arange(2 * 3 * 4 * 4, dtype=np.float32).reshape(1, 2 * 3, 4, 4, 1)
    x = np.concatenate([x] * 4)  # 4 clients, groups 0..3
    group = np.arange(4)
    want = ref_synthetic._rotate_groups(jnp.asarray(x), jnp.asarray(group, jnp.int32))
    got = synthetic._rotate_groups(t(x), t(group))
    np.testing.assert_array_equal(n(got), n(want))


@pytest.mark.parametrize("scenario", ["label_shift", "covariate_label_shift", "concept_shift"])
def test_synthetic_scenarios_shapes_and_determinism(scenario):
    m, nn, nt, c, hw = 8, 60, 20, 5, (12, 12)
    got = synthetic.SCENARIOS[scenario](np.random.default_rng(0), m=m, n=nn, n_test=nt,
                                        num_classes=c, hw=hw, channels=1, device="cpu")
    assert tuple(got.x.shape) == (m, nn) + hw + (1,) and tuple(got.y.shape) == (m, nn)
    assert tuple(got.x_test.shape) == (m, nt) + hw + (1,) and tuple(got.y_test.shape) == (m, nt)
    assert got.y.dtype == torch.int64 and 0 <= int(got.y.min()) and int(got.y.max()) < c
    groups = 1 if scenario == "label_shift" else 4
    np.testing.assert_array_equal(n(got.group), np.arange(m) % groups)
    np.testing.assert_array_equal(n(got.n), nn)
    again = synthetic.SCENARIOS[scenario](np.random.default_rng(0), m=m, n=nn, n_test=nt,
                                          num_classes=c, hw=hw, channels=1, device="cpu")
    assert torch.equal(again.x, got.x) and torch.equal(again.y, got.y)


def test_covariate_shift_statistics_match_reference():
    """Scenario 2 at a small size: the same generative model, so the pixel
    spread, the noise around each class prototype, and the label skew agree
    in distribution (the streams and the bicubic kernels differ)."""
    kw = dict(m=8, n=200, n_test=20, num_classes=5, hw=(12, 12), channels=1)
    got = synthetic.covariate_label_shift(np.random.default_rng(0), device="cpu", **kw)
    want = jax.jit(lambda k: ref_synthetic.covariate_label_shift(k, **kw))(jax.random.PRNGKey(0))

    def noise_std(x, y):
        x, y = n(x).reshape(-1, 144), n(y).reshape(-1)
        return np.mean([x[y == c].std(axis=0).mean() for c in range(5) if (y == c).sum() > 50])

    # clients of group 0 are unrotated, so their class means are prototypes
    g0 = slice(0, 8, 4)
    assert abs(noise_std(got.x[g0], got.y[g0]) - noise_std(want.x[g0], want.y[g0])) < 0.05
    assert abs(float(got.x.std()) - float(jnp.std(want.x))) < 0.15
    share = [np.bincount(n(d.y).reshape(-1), minlength=5).max() / n(d.y).size
             for d in (got, want)]  # alpha = 8: mild label skew in both
    assert all(s < 0.4 for s in share)
    proto = synthetic.make_prototypes(torch.Generator().manual_seed(0), 10, (12, 12), 1,
                                      device="cpu")
    np.testing.assert_allclose(n(proto[:3]), n(torch.rot90(proto[:3], 2, dims=(1, 2))),
                               atol=1e-6)
