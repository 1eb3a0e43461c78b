"""The client mesh over torch.distributed: sharded cohort rounds and the
row-sharded server state, in 2- and 4-rank gloo runs on the CPU.

Each shard count s spawns its ranks once (``repro_torch.federated.mesh.spawn``,
``file://`` init under a temporary directory, one torch thread a rank)
and plays every run in them: the ten strategies of the reference's
``tests/test_sharded_state.py``, replicated (``FedConfig(mesh="auto")``)
and row-sharded (``shard_state=True``), init and two padded cohort rounds
(3 and 4 members of m = 8, padded to 5 slots and then to a multiple of s);
buffered-async ucfl and fedavg (``flush_k=2``) over three rounds; ucfl
with the W refresh. The batch orders are the reference's from its round
keys, so the same runs go through the port without a mesh and through the
reference.

Tolerances: a mesh run against the port's ``mesh=None`` run within rtol
1e-5, atol 1e-6 (the local batch shape changes the products' algorithms;
ROADMAP C2 *Mesh*); against the reference within 1e-4 (C2's summation
order); row-sharded against replicated at the same s bit for bit (one
owner per row, the same arithmetic on every rank). Rows that no cohort
reaches are bit-identical to the initial state. The reference on 4 forced
host devices is in ``tests/test_torch_mesh.py``.
"""
import functools
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from repro import core as ref_core
from repro.core import FedConfig as RefFedConfig
from repro.data import synthetic as ref_synthetic
from repro.federated import participation as ref_part
from repro.federated import simulation as ref_simulation
from repro.models import lenet as ref_lenet
from repro_torch.core import flat
from repro_torch.federated import mesh
from torch_parity import MESH_NAMES as NAMES
from torch_parity import SMALL, key_schedule, mesh_cfg, mesh_kw, mesh_run, small_arrays

M = 8
SEED = 0
MEMBERS = ((0, 2, 5), (1, 3, 4, 6))
ASYNC_MEMBERS = ((1, 4, 6), (2,), (0, 5))
ABSENT = 7  # no cohort reaches client 7
# the slabs of each strategy whose rows only a cohort member's round moves
UNTOUCHED = {"local": ("params",), "oracle": ("params",), "cfl": ("params",),
             "fedfomo": ("params",), "ucfl": ("params",), "ditto": ("personal",),
             "pfedme": ("params", "personal"), "scaffold": ("c_i",)}


@functools.lru_cache(maxsize=None)
def _schedule(name, members=MEMBERS):
    return mesh_run(name, M, members)


# the runs whose final state every rank saves (checkpoint.save, gathered
# when row-sharded), restores and converts (interop.state_to_reference)
SAVED = ("ucfl", "ditto", "scaffold")


def _run(key, name, shard, *, members=MEMBERS, **extra):
    return dict(_schedule(name, members)[0], key=key, shard=shard, **extra)


def _runs():
    out = []
    for shard in (False, True):
        lay = "sharded" if shard else "replicated"
        out += [_run(f"{name}/{lay}", name, shard,
                     **({"ckpt": f"{name}_{lay}.msgpack"} if name in SAVED else {}))
                for name in NAMES]
        out += [_run(f"async_{name}/{lay}", name, shard, members=ASYNC_MEMBERS, flush_k=2)
                for name in ("ucfl", "fedavg")]
        out.append(_run(f"refresh_ucfl/{lay}", "ucfl", shard, refresh=True))
        out += [_run(f"int8_{name}/{lay}", name, shard, transport="int8")
                for name in ("ucfl", "scaffold")]
        out.append(_run(f"faults_ucfl/{lay}", "ucfl", shard, faults=True))
    out.append(_run("ucfl_parallel/replicated", "ucfl_parallel", False))  # refuses shard_state
    # the dense path shards the m clients (replicated only: shard_state refuses it)
    out += [dict(_run(f"dense_{name}/replicated", name, False), cohorts=[(None, None)] * 2)
            for name in ("fedavg", "scaffold", "pfedme", "ucfl")]
    return out


def _sims():
    """``simulation.run`` of ucfl at fraction 0.5 for 3 rounds, both layouts."""
    return [dict(key=f"sim_ucfl/{lay}", name="ucfl", cfg=mesh_cfg("ucfl"), kw=mesh_kw("ucfl"),
                 shard=lay == "sharded", rounds=3, fraction=0.5)
            for lay in ("replicated", "sharded")]


@functools.lru_cache(maxsize=None)
def spawned(s):
    """Every run over s gloo ranks: {key: [each rank's report]}, and under
    "files" the bytes of each saved checkpoint file."""
    small_arrays(SEED, M)  # warm the cache the ranks rebuild from the seed
    with tempfile.TemporaryDirectory() as tmp:
        reports = mesh.spawn(ranks.run_all, s, backend="gloo", store_path=f"{tmp}/store",
                             timeout=240, args=(SEED, M, _runs(), _sims(), tmp))
        files = {run["ckpt"]: open(f"{tmp}/{run['ckpt']}", "rb").read()
                 for run in _runs() if run.get("ckpt")}
    return {key: [r[key] for r in reports] for key in reports[0]} | {"files": files}


def assembled(s, key):
    """A run's slabs as one (m, ·) array each: the ranks' blocks stacked
    in rank order when row-sharded, rank 0's copy (checked equal on every
    rank) when replicated."""
    reps = spawned(s)[key]
    out = {}
    for k in reps[0]["slabs"]:
        parts = [r["slabs"][k] for r in reps]
        if reps[0]["row_sharded"] and k == "upd":  # each block ends in its spare row
            out[k] = np.concatenate([p[:-1] for p in parts])
        elif reps[0]["row_sharded"] and k in ranks.SLABS and parts[0].shape[0] == M // len(reps):
            out[k] = np.concatenate(parts)  # a client slab (not a (1, W) broadcast EF row)
        else:
            for p in parts[1:]:
                np.testing.assert_array_equal(p, parts[0], err_msg=f"{key} {k}: ranks differ")
            out[k] = parts[0]
    return out


@functools.lru_cache(maxsize=None)
def port_none(key):
    """The run ``key`` through the port without a mesh (and so replicated),
    in this process."""
    run = dict(next(r for r in _runs() if r["key"] == key), shard=False)
    data, params0 = ranks.task(SEED, M)
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return ranks.play(run, data, params0, None)
    finally:
        torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def ref_none(name):
    """The reference's state slabs after the two cohort rounds, no mesh."""
    arrays, params = small_arrays(SEED, M)
    data = ref_synthetic.FederatedData(*(jnp.asarray(a) for a in arrays))
    params0 = {k: jnp.asarray(v) for k, v in params.items()}
    strat = ref_core.REGISTRY[name](ref_lenet.apply, params0, RefFedConfig(**mesh_cfg(name)),
                                    **mesh_kw(name))
    ikey, _ = key_schedule([])  # the init key: the schedule's first split
    rounds = _schedule(name)[1]
    state = (strat.init(ikey, data) if name in ("oracle", "cfl")
             else jax.jit(strat.init)(ikey, data))
    for rkey, cohort in rounds:
        rc = ref_part.Cohort(indices=cohort.indices, mask=cohort.mask)
        state, _ = strat.round(ref_simulation.donation_safe_copy(state), data, rkey, rc)
    return {k: np.array(state[k]) for k in ranks.SLABS if k in state}


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("layout", ["replicated", "sharded"])
@pytest.mark.parametrize("name", NAMES)
def test_mesh_round_matches_unsharded(name, layout, s):
    got = assembled(s, f"{name}/{layout}")
    want = port_none(f"{name}/{layout}")
    assert sorted(got) == sorted(want["slabs"])
    for k in got:
        np.testing.assert_allclose(got[k], want["slabs"][k], rtol=1e-5, atol=1e-6,
                                   err_msg=f"{name} {layout} s={s} {k}")
    reps = spawned(s)[f"{name}/{layout}"]
    for r in reps:
        assert [mt["streams"] for mt in r["metrics"]] == \
            [mt["streams"] for mt in want["metrics"]]
        np.testing.assert_allclose(r["accs"], want["accs"], atol=1.0 / SMALL["n_test"] + 1e-6)


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("layout", ["replicated", "sharded"])
@pytest.mark.parametrize("name", NAMES)
def test_mesh_round_matches_reference(name, layout, s):
    got = assembled(s, f"{name}/{layout}")
    want = ref_none(name)
    for k in want:
        np.testing.assert_allclose(got[k][:, : want[k].shape[1]], want[k], atol=1e-4,
                                   err_msg=f"{name} {layout} s={s} {k}")


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("name", NAMES + ["async_ucfl", "async_fedavg", "refresh_ucfl",
                                  "int8_ucfl", "int8_scaffold", "faults_ucfl"])
def test_row_sharded_equals_replicated_bit_for_bit(name, s):
    rep, sh = assembled(s, f"{name}/replicated"), assembled(s, f"{name}/sharded")
    for k in rep:
        if k == "upd":  # the buffer pads B to a shard multiple: compare its own B slots
            b = rep[k].shape[0] - 1
            np.testing.assert_array_equal(sh[k][:b], rep[k][:b])
        elif k == "buf_idx":
            np.testing.assert_array_equal(sh[k][: rep[k].shape[0]], rep[k])
        else:
            np.testing.assert_array_equal(sh[k], rep[k], err_msg=f"{name} s={s} {k}")
    reps = spawned(s)
    for a, b in zip(reps[f"{name}/replicated"], reps[f"{name}/sharded"]):
        np.testing.assert_array_equal(a["accs"], b["accs"])
        assert a["metrics"] == b["metrics"]


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("name", SAVED)
def test_row_sharded_checkpoint_is_the_replicated_file(name, s):
    """checkpoint.save of a row-sharded state (every rank calls it, rank 0
    writes the gathered state) writes the replicated run's file byte for
    byte; restore into the row-sharded state gives each rank its block's
    bits back, marked; state_to_reference gathers the same whole slab on
    every rank."""
    files = spawned(s)["files"]
    assert files[f"{name}_sharded.msgpack"] == files[f"{name}_replicated.msgpack"]
    rep, sh = spawned(s)[f"{name}/replicated"], spawned(s)[f"{name}/sharded"]
    for r in rep + sh:
        assert r["saved"]["restored"]
        np.testing.assert_array_equal(r["saved"]["converted"], rep[0]["saved"]["converted"])


@pytest.mark.parametrize("s", [2, 4])
def test_row_sharded_blocks_and_absent_rows(s):
    params0 = ranks.task(SEED, M)[1]
    slab0 = flat.LayoutTable.build(params0).slab(params0, M)
    for name in NAMES:
        reps = spawned(s)[f"{name}/sharded"]
        assert all(r["row_sharded"] for r in reps)
        for r in reps:  # each rank holds its m/s rows of every client slab
            assert {v.shape[0] for k, v in r["slabs"].items()} == {M // s}, name
        got = assembled(s, f"{name}/sharded")
        for k in UNTOUCHED.get(name, ()):
            init = slab0.numpy() if k in ("params", "personal") else np.zeros_like(got[k])
            np.testing.assert_array_equal(got[k][ABSENT], init[ABSENT], err_msg=f"{name} {k}")
            assert np.abs(got[k][list(MEMBERS[1])] - init[list(MEMBERS[1])]).max() > 0, (name, k)


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("name", ["ucfl", "fedavg"])
def test_async_row_sharded_buffer(name, s):
    key = f"async_{name}"
    for r in spawned(s)[f"{key}/sharded"]:
        b = len(r["slabs"]["buf_idx"])
        assert b % s == 0 and r["slabs"]["upd"].shape[0] == b // s + 1
    want = port_none(f"{key}/replicated")
    got = assembled(s, f"{key}/sharded")
    np.testing.assert_allclose(got["params"], want["slabs"]["params"], rtol=1e-5, atol=1e-6)
    flushed = [mt["flushed"] for mt in spawned(s)[f"{key}/sharded"][0]["metrics"]]
    assert flushed == [mt["flushed"] for mt in want["metrics"]] and 0 in flushed and 1 in flushed


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("name", ["int8_ucfl", "int8_scaffold", "faults_ucfl"])
def test_wire_and_faults_under_the_mesh(name, s):
    """The quantized wire's EF slabs (ucfl's per-client ``ef_dl`` row-sharded,
    SCAFFOLD's broadcast one whole) and the fault draws, client-indexed and
    keyed on ``fault_round``, the same on every rank. Against the port
    without a mesh within rtol 1e-5, atol 1e-6, except that under int8 a
    last-bit difference in a quantized value (SCAFFOLD's c: the sum of the
    s row blocks' sums, ``StateOps.row_mean``) may move an element one
    quantization step of its column chunk, for at most 0.1 % of a slab's
    elements (ROADMAP C2 *Wire*; the step is twice the largest EF residual
    of the chunk, as ``tests/test_torch_wire_strategies.py`` takes it)."""
    for layout in ("replicated", "sharded"):
        got = assembled(s, f"{name}/{layout}")
        want = port_none(f"{name}/{layout}")["slabs"]
        assert sorted(got) == sorted(want)
        width = want["params"].shape[1]
        step = _wire_step(want, width)
        for k in got:
            off = ~np.isclose(got[k], want[k], rtol=1e-5, atol=1e-6)
            if not name.startswith("int8"):
                assert not off.any(), (name, layout, s, k, np.abs(got[k] - want[k]).max())
                continue
            assert off.mean() <= 1e-3, (name, layout, s, k, off.mean())
            bound = 1e-6 + 1e-5 * np.abs(want[k]) + np.tile(step, want[k].shape[1] // width)
            assert (np.abs(got[k] - want[k]) <= bound).all(), (name, layout, s, k)


def _wire_step(slabs, width):
    """The quantization step of each 128-column chunk, folded onto the
    slab's ``width`` columns: twice the largest residual of the uplink EF
    there, plus the same of the downlink EF."""
    step = np.zeros(width, np.float32)
    for key in ("ef", "ef_dl"):
        if key in slabs:
            chunks = np.abs(slabs[key]).max(axis=0).reshape(-1, 128).max(axis=1)
            step += 2 * np.repeat(chunks, 128).reshape(-1, width).max(axis=0)
    return step


@pytest.mark.parametrize("s", [2, 4])
def test_refresh_composes_with_shard_state(s):
    got = assembled(s, "refresh_ucfl/sharded")
    want = port_none("refresh_ucfl/replicated")
    np.testing.assert_allclose(got["params"], want["slabs"]["params"], rtol=1e-5, atol=1e-6)
    stale = [r["metrics"][-1]["staleness_max"] for r in spawned(s)["refresh_ucfl/sharded"]]
    assert stale == [want["metrics"][-1]["staleness_max"]] * s


@pytest.mark.parametrize("s", [2, 4])
def test_ucfl_parallel_takes_the_mesh(s):
    """Each group's (stream, client) units train on the ranks' blocks."""
    got = assembled(s, "ucfl_parallel/replicated")["params"]
    want = port_none("ucfl_parallel/replicated")["slabs"]["params"]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("s", [2, 4])
def test_simulation_run_over_the_mesh(s):
    """``run`` with ``eval_mesh``: a row-sharded state is evaluated and
    finite-checked on each rank's block, the (m,) results all-gathered;
    ``verbose`` prints on rank 0 alone."""
    reps = spawned(s)
    rep, sh = reps["sim_ucfl/replicated"], reps["sim_ucfl/sharded"]
    assert all(r["row_sharded"] for r in sh) and not any(r["row_sharded"] for r in rep)
    for a, b in zip(rep, sh):
        assert a["avg"] == b["avg"] and a["worst"] == b["worst"] and a["sizes"] == b["sizes"]
    for lay in (rep, sh):  # verbose prints on rank 0 only: a line an evaluated round
        assert len(lay[0]["printed"].splitlines()) == 3
        assert all(r["printed"] == "" for r in lay[1:])
    np.testing.assert_array_equal(np.concatenate([r["params"] for r in sh]), rep[0]["params"])
    data, params0 = ranks.task(SEED, M)
    sim = dict(_sims()[0], shard=False)
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = ranks.simulate(sim, data, params0, None)
    finally:
        torch.set_num_threads(before)
    assert rep[0]["sizes"] == want["sizes"]
    np.testing.assert_allclose(rep[0]["params"], want["params"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rep[0]["avg"], want["avg"], atol=1.0 / SMALL["n_test"] + 1e-6)


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("name", ["fedavg", "scaffold", "pfedme", "ucfl"])
def test_dense_rounds_over_the_mesh(name, s):
    """Two dense rounds with the m clients' local SGD sharded over the
    ranks, replicated state (SCAFFOLD's c the rank-ordered block sums)."""
    got = assembled(s, f"dense_{name}/replicated")
    want = port_none(f"dense_{name}/replicated")["slabs"]
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)

