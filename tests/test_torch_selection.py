"""Pareto-biased cohort selection (``FedConfig.selection``) and ``run``'s
remaining arguments, in both packages.

The ``pareto`` sampler's cohorts are host numpy streams, so the port's
must equal the reference's index for index: over 20 rounds under compute
speeds, link qualities, a battery trace, data value (``n`` as a tensor in
the port, an array in the reference), sharp and flat bias, with and
without the fairness lane. Its properties: zero-mass clients never drawn,
the fairness lane bounds every positive-mass client's wait, battery gating
pads the cohort. ``SelectionConfig`` validation and ``with_selection``;
``run(selection=)`` and ``run_trials(selection=)`` draw those cohorts
(every cohort holds the fairness-lane client and no battery-gated one).

``run(warmup=False)`` and ``run(eval_chunk=7)`` give the default run's
accuracies; and ``run(verbose=True)`` prints the reference's round line,
``cohort=`` its cohort size, on the same cohort.
"""
import re

import jax
import numpy as np
import pytest
import torch

from repro.core import FedConfig as RefFedConfig
from repro.core import ucfl as ref_ucfl
from repro.federated import participation as ref_part
from repro.federated import simulation as ref_simulation
from repro.models import lenet as ref_lenet
from repro_torch.core import FedConfig, ucfl
from repro_torch.federated import participation as part
from repro_torch.federated import simulation
from repro_torch.models import lenet
from torch_parity import BATCH, SMALL, VAR_BATCH, one_torch_thread, small_task  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

M = 12


def _profiles():
    rng = np.random.default_rng(3)
    speeds = np.geomspace(0.05, 20.0, M)
    link = rng.uniform(0.0, 2.0, M)
    link[[2, 7]] = 0.0
    battery = part.battery_trace(M, 6, duty=2, recharge=2, seed=1)
    n = rng.integers(0, 90, M)
    n[4] = 0
    return dict(
        compute=dict(compute=speeds, bias=4.0),
        link=dict(link=link),
        battery=dict(battery=battery, bias=2.0),
        data_value=dict(data_value=True, compute=speeds, bias=0.5),
        all=dict(compute=speeds, link=link, battery=battery, data_value=True, bias=2.0),
        no_lane=dict(compute=speeds, bias=4.0, fairness_lane=False),
        no_lane_battery=dict(battery=battery, link=link, fairness_lane=False),
    ), n


@pytest.mark.parametrize("size", [1, 4, 11])
@pytest.mark.parametrize("profile", ["compute", "link", "battery", "data_value", "all",
                                     "no_lane", "no_lane_battery"])
def test_pareto_cohorts_equal_the_reference(profile, size):
    profiles, n = _profiles()
    sel = profiles[profile]
    got_cfg = part.ParticipationConfig(cohort_size=size, sampler="pareto", seed=7,
                                       selection=part.SelectionConfig(**sel))
    want_cfg = ref_part.ParticipationConfig(cohort_size=size, sampler="pareto", seed=7,
                                            selection=ref_part.SelectionConfig(**sel))
    got = part.cohort_schedule(got_cfg, 20, M, torch.as_tensor(n))
    want = ref_part.cohort_schedule(want_cfg, 20, M, n)
    for r, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.indices, w.indices, err_msg=f"round {r + 1}")
        np.testing.assert_array_equal(g.mask, w.mask, err_msg=f"round {r + 1}")
        assert g.num_slots == size
    for rnd in (1, 5, 13):
        np.testing.assert_array_equal(
            got_cfg.selection.mass(rnd, M, torch.as_tensor(n)),
            want_cfg.selection.mass(rnd, M, n))


def test_pareto_never_draws_zero_mass():
    mass = np.asarray([0, 0, 1, 1, 1, 1, 2, 2, 0, 3], float)
    cfg = part.ParticipationConfig(cohort_size=4, sampler="pareto", seed=5,
                                   selection=part.SelectionConfig(compute=mass, bias=2.0))
    for co in part.cohort_schedule(cfg, 30, 10):
        assert not set(co.members.tolist()) & {0, 1, 8}


@pytest.mark.parametrize("lane", [True, False])
def test_pareto_fairness_lane_bounds_starvation(lane):
    """Under a 400× spread of speeds at bias 4, the lane selects every
    client within m rounds; without it the slowest starves."""
    m = 8
    speeds = np.geomspace(0.05, 20.0, m)
    cfg = part.ParticipationConfig(
        cohort_size=2, sampler="pareto", seed=5,
        selection=part.SelectionConfig(compute=speeds, bias=4.0, fairness_lane=lane))
    seen = set()
    for co in part.cohort_schedule(cfg, m, m):
        seen |= set(co.members.tolist())
    assert (seen == set(range(m))) if lane else (0 not in seen)


def test_pareto_battery_gating_and_padding():
    m = 6
    battery = np.zeros((m, 2), bool)
    battery[:2, 0] = True  # phase 0: clients 0 and 1 only
    battery[:, 1] = True
    cfg = part.ParticipationConfig(cohort_size=4, sampler="pareto", seed=5,
                                   selection=part.SelectionConfig(battery=battery))
    sched = part.cohort_schedule(cfg, 2, m)
    assert sched[0].num_slots == 4 and len(sched[0]) == 2
    assert set(sched[0].members.tolist()) == {0, 1} and len(sched[1]) == 4
    # every client gated off: an all-masked cohort, as the availability sampler's
    off = part.ParticipationConfig(cohort_size=3, sampler="pareto", selection=part.SelectionConfig(
        battery=np.zeros((m, 2), bool)))
    assert len(part.sample_cohort(off, 1, m)) == 0
    assert not part.ParticipationConfig(fraction=1.0, sampler="pareto",
                                        selection=part.SelectionConfig()).is_full(m)


def test_selection_config_validation():
    for mod in (ref_part, part):
        with pytest.raises(ValueError, match="bias"):
            mod.SelectionConfig(bias=0.0)
        with pytest.raises(ValueError, match="nonnegative"):
            mod.SelectionConfig(compute=np.asarray([1.0, -1.0]))
        with pytest.raises(ValueError, match="nonnegative"):
            mod.SelectionConfig(link=np.asarray([1.0, np.inf]))
        with pytest.raises(ValueError, match="1-D"):
            mod.SelectionConfig(compute=np.ones((2, 2)))
        with pytest.raises(ValueError, match="period"):
            mod.SelectionConfig(battery=np.ones(3, bool))
        with pytest.raises(ValueError, match="SelectionConfig"):
            mod.ParticipationConfig(sampler="pareto")
        with pytest.raises(ValueError, match="data_value"):
            mod.SelectionConfig(data_value=True).static_mass(4)
        with pytest.raises(ValueError, match="entries for m=5"):
            mod.SelectionConfig(compute=np.ones(4)).static_mass(5)
        with pytest.raises(ValueError, match="rows for m=5"):
            mod.SelectionConfig(battery=np.ones((4, 2), bool)).mass(1, 5)
    assert "pareto" in part.SAMPLERS and part.SAMPLERS == ref_part.SAMPLERS


def test_with_selection_threads_policy():
    sel = part.SelectionConfig(bias=2.0)
    assert part.with_selection(None, None) is None
    base = part.ParticipationConfig(cohort_size=3, seed=9)
    assert part.with_selection(base, None) is base
    got = part.with_selection(None, sel)
    assert got.sampler == "pareto" and got.selection is sel and got.fraction == 1.0
    got = part.with_selection(base, sel)
    assert (got.cohort_size, got.seed, got.sampler, got.selection) == (3, 9, "pareto", sel)


# ------------------------------------------------------------------------ run


def _ucfl():
    _, _, _, tparams = small_task()
    return ucfl.make_ucfl(lenet.apply_stacked, tparams, FedConfig(batch_size=BATCH),
                          var_batch_size=VAR_BATCH, device="cpu")


def _selection(m):
    return part.SelectionConfig(compute=np.linspace(0.5, 3.0, m),
                                battery=part.battery_trace(m, 4, duty=3, recharge=1, seed=2),
                                bias=2.0)


def test_run_with_selection_draws_the_pareto_cohorts():
    _, tdata, _, _ = small_task()
    m = SMALL["m"]
    sel = _selection(m)
    pcfg = part.ParticipationConfig(cohort_size=3, seed=1)
    hist = simulation.run(_ucfl(), lenet.apply_stacked, tdata, 0, rounds=3, participation=pcfg,
                          selection=sel, device="cpu")
    want = part.cohort_schedule(part.with_selection(pcfg, sel), 3, m)
    assert [mt["cohort_size"] for mt in hist.metrics] == [len(c) for c in want]
    static = np.flatnonzero(sel.static_mass(m) > 0)
    for rnd, co in enumerate(want, start=1):
        lane = static[(rnd - 1) % static.size]
        gated = np.flatnonzero(~sel.battery[:, (rnd - 1) % sel.battery.shape[1]])
        assert not set(co.members.tolist()) & set(gated.tolist())
        if sel.battery[lane, (rnd - 1) % sel.battery.shape[1]]:
            assert lane in co.members
    # the same run with the pareto policy spelled out
    same = simulation.run(_ucfl(), lenet.apply_stacked, tdata, 0, rounds=3,
                          participation=part.with_selection(pcfg, sel), device="cpu")
    assert same.avg_acc == hist.avg_acc
    assert torch.equal(same.state["params"], hist.state["params"])


def test_run_trials_with_selection():
    _, tdata, _, _ = small_task()
    sel = _selection(SMALL["m"])
    got = simulation.run_trials(lambda t_: _ucfl(), lenet.apply_stacked, lambda s: tdata,
                                trials=2, rounds=2, participation=part.ParticipationConfig(
                                    cohort_size=3), selection=sel, device="cpu")
    assert len(got["histories"]) == 2
    for h in got["histories"]:
        assert all(mt["cohort_size"] <= 3 for mt in h.metrics)
    with pytest.raises(TypeError, match="SelectionConfig"):
        simulation.run_trials(None, None, None, trials=1, rounds=1, selection=object())
    with pytest.raises(TypeError, match="SelectionConfig"):
        simulation.run(_ucfl(), lenet.apply_stacked, tdata, 0, rounds=1, selection=object(),
                       device="cpu")


def test_run_warmup_and_eval_chunk_keep_the_accuracies():
    _, tdata, _, _ = small_task()
    pcfg = part.ParticipationConfig(cohort_size=4, seed=3)
    runs = {kw: simulation.run(_ucfl(), lenet.apply_stacked, tdata, 2, rounds=3,
                               participation=pcfg, device="cpu", **dict([kw]) if kw else {})
            for kw in (None, ("warmup", False), ("eval_chunk", 7), ("eval_chunk", 4))}
    base = runs[None]
    for kw, h in runs.items():
        assert h.avg_acc == base.avg_acc and h.worst_acc == base.worst_acc, kw
        assert torch.equal(h.state["params"], base.state["params"]), kw


# ----------------------------------------------------------------------- C6


def _line(out):
    lines = [ln for ln in out.splitlines() if ln.startswith("[ucfl] round")]
    assert len(lines) == 1, out
    return lines[0]


def test_verbose_line_prints_the_cohort_size_as_the_reference(capsys):
    """One round of ucfl in each package on the same 3-member cohort: the
    same line, ``cohort=3`` at its end, and accuracies within 1/n_test."""
    data, tdata, params0, tparams = small_task()
    pcfg = dict(cohort_size=3, seed=11)
    ref_strat = ref_ucfl.make_ucfl(ref_lenet.apply, params0, RefFedConfig(batch_size=BATCH),
                                   var_batch_size=VAR_BATCH)
    ref_simulation.run(ref_strat, ref_lenet.apply, data, jax.random.PRNGKey(0), rounds=1,
                       participation=ref_part.ParticipationConfig(**pcfg), verbose=True,
                       warmup=False)
    want = _line(capsys.readouterr().out)
    simulation.run(_ucfl(), lenet.apply_stacked, tdata, 0, rounds=1,
                   participation=part.ParticipationConfig(**pcfg), verbose=True, device="cpu")
    got = _line(capsys.readouterr().out)
    pattern = r"avg=([0-9.]+) worst=([0-9.]+)"
    assert re.sub(pattern, "", got) == re.sub(pattern, "", want)
    assert got.endswith(" cohort=3")
    for a, b in zip(re.search(pattern, got).groups(), re.search(pattern, want).groups()):
        assert float(a) == pytest.approx(float(b), abs=1.0 / SMALL["n_test"] + 1e-4)
