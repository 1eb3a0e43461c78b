"""The port's evaluation schedule and trial loop against the reference's
(``repro.federated.simulation.run(eval_every=)``, ``run_trials``), and the
device defaults of the transformer entry points.

Both loops drive a scripted strategy on the SMALL LeNet task: round t
replaces the clients' models with the t-th of a fixed numpy sequence, the
same in both packages, so the evaluated rounds, their accuracies and the
paired (avg, worst) metric can be compared directly.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.strategy import Strategy as RefStrategy
from repro.federated import simulation as ref_simulation
from repro.models import lenet as ref_lenet
from repro_torch import configs
from repro_torch.core import FedConfig, ucfl
from repro_torch.core.strategy import Strategy
from repro_torch.federated import simulation
from repro_torch.models import attention, lenet, registry, transformer
from torch_parity import BATCH, CPU, SMALL, VAR_BATCH, lenet_params, small_task


def _model_sequence(trial, rounds):
    """rounds + 1 stacked LeNet models (m clients each) as numpy dicts."""
    rng = np.random.default_rng(100 + trial)
    base = lenet_params(rng, SMALL["hw"], SMALL["num_classes"])
    m = SMALL["m"]
    return [{k: (v[None] + 0.5 * rng.normal(size=(m,) + v.shape)).astype(np.float32)
             for k, v in base.items()} for _ in range(rounds + 1)]


def _scripted(make, to_array, trial, rounds):
    """A strategy whose state after round t is the t-th model of the
    sequence; it learns nothing and draws no randomness."""
    seq = [{k: to_array(v) for k, v in p.items()} for p in _model_sequence(trial, rounds)]

    def round_(state, data, key, cohort=None):
        t = min(state["t"] + 1, rounds)
        return {"t": t, "params": seq[t]}, {"cohort_size": SMALL["m"]}

    return make(name=f"scripted{trial}", init=lambda key, data: {"t": 0, "params": seq[0]},
                round=round_, eval_params=lambda state: state["params"])


def _ref_strategy(trial, rounds):
    return _scripted(RefStrategy, jax.numpy.asarray, trial, rounds)


def _port_strategy(trial, rounds):
    return _scripted(Strategy, torch.as_tensor, trial, rounds)


@pytest.mark.parametrize("rounds,eval_every,want", [(7, 3, [3, 6, 7]), (6, 2, [2, 4, 6]),
                                                    (3, 1, [1, 2, 3]), (2, 5, [2])])
def test_eval_schedule_matches_reference(rounds, eval_every, want):
    data, tdata, _, _ = small_task()
    ref = ref_simulation.run(_ref_strategy(0, rounds), ref_lenet.apply, data,
                             jax.random.PRNGKey(0), rounds=rounds, eval_every=eval_every)
    got = simulation.run(_port_strategy(0, rounds), lenet.apply_stacked, tdata, 0,
                         rounds=rounds, eval_every=eval_every, device=CPU)
    assert ref.rounds == want and got.rounds == want
    assert len(got.metrics) == len(want)
    # per-client accuracy on n_test samples: at most one sample apart
    tol = 1.0 / SMALL["n_test"] + 1e-6
    np.testing.assert_allclose(got.avg_acc, ref.avg_acc, atol=tol)
    np.testing.assert_allclose(got.worst_acc, ref.worst_acc, atol=tol)
    np.testing.assert_allclose(got.paired_best, ref.paired_best, atol=tol)


def test_default_eval_every_evaluates_every_round():
    _, tdata, _, _ = small_task()
    got = simulation.run(_port_strategy(1, 4), lenet.apply_stacked, tdata, 0, rounds=4,
                         device=CPU)
    assert got.rounds == [1, 2, 3, 4] and len(got.avg_acc) == 4


@pytest.mark.parametrize("eval_every", [0, -2])
def test_eval_every_below_one_raises(eval_every):
    _, tdata, _, _ = small_task()
    with pytest.raises(ValueError, match="eval_every"):
        simulation.run(_port_strategy(0, 2), lenet.apply_stacked, tdata, 0, rounds=2,
                       eval_every=eval_every, device=CPU)


def test_ucfl_run_evaluates_on_the_schedule():
    _, tdata, _, tparams = small_task()
    s = ucfl.make_ucfl(lenet.apply_stacked, tparams, FedConfig(batch_size=BATCH),
                       var_batch_size=VAR_BATCH, device=CPU)
    h = simulation.run(s, lenet.apply_stacked, tdata, 0, rounds=7, eval_every=3, device=CPU)
    assert h.rounds == [3, 6, 7] and len(h.avg_acc) == len(h.metrics) == 3
    assert h.wall_s > 0 and h.eval_s > 0
    assert torch.isfinite(h.state["params"]).all()


@pytest.mark.parametrize("avg,worst", [([0.2, 0.7, 0.5], [0.1, 0.3, 0.4]),
                                       ([0.6, 0.6, 0.1], [0.2, 0.5, 0.0]),
                                       ([0.4], [0.4])])
def test_paired_best_matches_reference(avg, worst):
    ref = ref_simulation.History("s", list(range(len(avg))), avg, worst, [])
    got = simulation.History("s", list(range(len(avg))), avg, worst, [])
    assert got.paired_best == ref.paired_best


def test_run_trials_matches_reference():
    data, tdata, _, _ = small_task()
    kw = dict(trials=2, rounds=4, eval_every=2)
    ref = ref_simulation.run_trials(lambda t: _ref_strategy(t, 4), ref_lenet.apply,
                                    lambda key: data, **kw)
    seeds = []

    def data_fn(s):
        seeds.append(s)
        return tdata

    got = simulation.run_trials(lambda t: _port_strategy(t, 4), lenet.apply_stacked, data_fn,
                                seed=3, device=CPU, **kw)
    assert seeds == [3, 1003]
    assert set(got) == set(ref) == {"avg_mean", "avg_std", "worst_mean", "worst_std",
                                    "histories"}
    pairs = [h.paired_best for h in got["histories"]]
    assert all(h.rounds == [2, 4] for h in got["histories"])
    assert got["avg_mean"] == pytest.approx(float(np.mean([a for a, _ in pairs])))
    assert got["worst_std"] == pytest.approx(float(np.std([w for _, w in pairs])))
    tol = 1.0 / SMALL["n_test"] + 1e-6
    for key in ("avg_mean", "avg_std", "worst_mean", "worst_std"):
        assert got[key] == pytest.approx(ref[key], abs=tol), key


def test_run_trials_selection_raises():
    """``selection`` is ported (``tests/test_torch_selection.py``); a value
    that is no ``SelectionConfig`` raises before any trial runs."""
    with pytest.raises(TypeError, match="SelectionConfig"):
        simulation.run_trials(None, None, None, trials=1, rounds=1, selection=object())


# ------------------------------------------------------- device defaults
def _entry_points():
    cfg = configs.get("qwen2-7b").reduced()
    model = registry.build(cfg)
    acfg = transformer.attn_config(cfg)
    return {
        "transformer.init": lambda dev: transformer.init(torch.Generator(), cfg, dev),
        "transformer.init_cache": lambda dev: transformer.init_cache(cfg, 2, 1, 8, dev),
        "attention.init": lambda dev: attention.init(torch.Generator(), acfg, device=dev),
        "attention.init_cache": lambda dev: attention.init_cache(2, 1, 8, acfg, device=dev),
        "Model.init": lambda dev: model.init(torch.Generator(), dev),
        "Model.init_cache": lambda dev: model.init_cache(1, 8, dev),
    }


ENTRY_POINTS = ["transformer.init", "transformer.init_cache", "attention.init",
                "attention.init_cache", "Model.init", "Model.init_cache"]


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_entry_point_without_device_means_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("the no-CUDA error path needs a machine without a GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        _entry_points()[entry](None)


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_entry_point_on_the_cpu_when_asked(entry):
    leaves = _leaves(_entry_points()[entry](CPU))
    assert leaves and all(x.device.type == "cpu" for x in leaves)


def test_transformer_init_refuses_a_generator_on_another_device():
    cfg = configs.get("qwen2-7b").reduced()
    with pytest.raises(ValueError, match="generator"):
        transformer.init(torch.Generator(), cfg, "meta")

