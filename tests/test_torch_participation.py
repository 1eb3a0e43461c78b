"""Cohort sampling: the port's ``participation`` against the reference's.

Both are host numpy code on the same seed streams, so every comparison
here is exact: cohorts index for index (and mask for mask), traces bit
for bit, slot counts equal, and the same validation errors.
"""
import numpy as np
import pytest
import torch

from repro.federated import participation as ref
from repro_torch.federated import participation as part

M = 20


def _sizes():
    sizes = np.random.default_rng(3).integers(0, 50, size=M)
    sizes[[2, 11]] = 0  # zero-size clients are never drawn
    return sizes


def _policy(mod, sampler):
    """(config, n) of one sampler, built in module ``mod``."""
    if sampler == "weighted":
        return mod.ParticipationConfig(fraction=0.3, sampler="weighted", seed=5), _sizes()
    if sampler == "weighted_few":  # fewer positive-mass clients than slots: pads
        sizes = np.zeros(M, np.int64)
        sizes[[1, 7, 8]] = [4, 1, 9]
        return mod.ParticipationConfig(cohort_size=6, sampler="weighted"), sizes
    if sampler == "round_robin":
        return mod.ParticipationConfig(cohort_size=7, sampler="round_robin"), None
    if sampler == "availability":
        trace = ref.diurnal_trace(M, period=4, peak=0.5, trough=0.05, seed=2)
        return mod.ParticipationConfig(cohort_size=8, sampler="availability",
                                       availability=trace, seed=1), None
    return mod.ParticipationConfig(fraction=0.25, seed=9), None


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("sampler",
                         ["uniform", "weighted", "weighted_few", "round_robin", "availability"])
def test_sample_cohort_matches_reference(sampler, seed):
    rcfg, sizes = _policy(ref, sampler)
    pcfg, _ = _policy(part, sampler)
    rcfg = ref.ParticipationConfig(**{**rcfg.__dict__, "seed": rcfg.seed + seed})
    pcfg = part.ParticipationConfig(**{**pcfg.__dict__, "seed": pcfg.seed + seed})
    n_port = None if sizes is None else torch.as_tensor(sizes)  # a tensor, as data.n is
    slots = set()
    for rnd in range(1, 7):
        want = ref.sample_cohort(rcfg, rnd, M, sizes)
        got = part.sample_cohort(pcfg, rnd, M, n_port)
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_array_equal(got.mask, want.mask)
        assert got.indices.dtype == np.int32 and got.mask.dtype == bool
        assert len(got) == len(want) and got.num_slots == pcfg.resolve_size(M)
        np.testing.assert_array_equal(got.members, want.members)
        slots.add(got.num_slots)
    assert len(slots) == 1  # one fixed shape per policy
    sched = part.cohort_schedule(pcfg, 6, M, sizes)
    np.testing.assert_array_equal(sched[5].indices, got.indices)


def test_full_participation_is_none_and_weighted_needs_sizes():
    assert part.sample_cohort(None, 1, M) is None
    assert part.sample_cohort(part.ParticipationConfig(), 1, M) is None
    cfg = part.ParticipationConfig(cohort_size=M, sampler="availability",
                                   availability=np.ones((M, 1), bool))
    assert not cfg.is_full(M) and len(part.sample_cohort(cfg, 1, M)) == M
    with pytest.raises(ValueError, match="sizes"):
        part.sample_cohort(part.ParticipationConfig(fraction=0.5, sampler="weighted"), 1, M)
    with pytest.raises(ValueError, match="zero dataset size"):
        part.sample_cohort(part.ParticipationConfig(fraction=0.5, sampler="weighted"), 1, M,
                           np.zeros(M))


@pytest.mark.parametrize("kw", [dict(), dict(period=5, peak=0.7, trough=0.3, seed=4),
                                dict(spread=False, seed=1), dict(peak=0.0, trough=0.0)])
def test_diurnal_trace_bit_exact(kw):
    np.testing.assert_array_equal(part.diurnal_trace(37, **kw), ref.diurnal_trace(37, **kw))


@pytest.mark.parametrize("kw", [dict(), dict(period=7, duty=2, recharge=5, seed=3),
                                dict(duty=1, recharge=0)])
def test_battery_trace_bit_exact(kw):
    got = part.battery_trace(37, **kw)
    np.testing.assert_array_equal(got, ref.battery_trace(37, **kw))
    assert got.any(axis=1).all()  # every client is up in some phase


@pytest.mark.parametrize("make", [lambda mod: mod.diurnal_trace(4, peak=0.2, trough=0.5),
                                  lambda mod: mod.battery_trace(4, duty=0)])
def test_trace_argument_errors(make):
    for mod in (ref, part):
        with pytest.raises(ValueError):
            make(mod)


@pytest.mark.parametrize("fraction,m,cohort_size,want", [
    (0.25, 10, None, 3),   # ceil, where banker's rounding gives 2
    (0.1, 130, None, 13),  # float fuzz (13.000000000000002) adds no slot
    (0.5, 7, None, 4), (1e-6, 10, None, 1), (1.0, 9, None, 9),
    (0.5, 10, 4, 4), (0.5, 10, 40, 10), (0.5, 10, 0, 1),
])
def test_resolve_size_ceil_rule(fraction, m, cohort_size, want):
    kw = dict(fraction=fraction, cohort_size=cohort_size)
    assert part.ParticipationConfig(**kw).resolve_size(m) == want
    assert ref.ParticipationConfig(**kw).resolve_size(m) == want
    assert part.ParticipationConfig(**kw).is_full(m) == ref.ParticipationConfig(**kw).is_full(m)


@pytest.mark.parametrize("kw", [dict(fraction=0.0), dict(fraction=1.5), dict(sampler="nope"),
                                dict(sampler="availability")])
def test_config_errors(kw):
    for mod in (ref, part):
        with pytest.raises(ValueError):
            mod.ParticipationConfig(**kw)


def test_pareto_sampler_is_not_ported():
    """The pareto sampler is ported now (``tests/test_torch_selection.py``);
    as in the reference, it needs a ``SelectionConfig``."""
    for mod in (ref, part):
        with pytest.raises(ValueError, match="SelectionConfig"):
            mod.ParticipationConfig(fraction=0.5, sampler="pareto")
    cfg = part.ParticipationConfig(fraction=0.5, sampler="pareto",
                                   selection=part.SelectionConfig())
    assert cfg.sampler in part.SAMPLERS and len(part.sample_cohort(cfg, 1, 10)) == 5


@pytest.mark.parametrize("indices,mask", [
    ([1, 2], [True]),                      # lengths differ
    ([[1, 2]], [[True, True]]),            # not 1-D
    ([1, 2, 3], [True, False, True]),      # a real slot after a pad slot
    ([3, 1, 5], [True, True, False]),      # members not increasing
    ([2, 2], [True, True]),                # duplicate member
])
def test_cohort_validation(indices, mask):
    for mod in (ref, part):
        with pytest.raises(ValueError):
            mod.Cohort(indices=np.asarray(indices), mask=np.asarray(mask))


def test_as_cohort_and_pad_slots():
    assert part.as_cohort(None, M) is None
    c = part.as_cohort([2, 5, 9], M)
    np.testing.assert_array_equal(c.mask, True)
    assert c.indices.dtype == np.int32 and part.as_cohort(c, M) is c
    padded = part.pad_slots(c, 5, M)
    want = ref.pad_slots(ref.as_cohort([2, 5, 9], M), 5, M)
    np.testing.assert_array_equal(padded.indices, want.indices)
    np.testing.assert_array_equal(padded.mask, want.mask)
    assert len(padded) == 3 and padded.num_slots == 5
    assert part.pad_slots(c, 3, M) is c
    for mod, cohort in ((part, c), (ref, ref.as_cohort([2, 5, 9], M))):
        with pytest.raises(ValueError, match="pad"):
            mod.pad_slots(cohort, 2, M)
