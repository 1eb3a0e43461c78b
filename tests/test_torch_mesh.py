"""The port's client mesh (``repro_torch.federated.mesh``) on the CPU.

The helpers against the reference's on the same numpy inputs (slot
padding, the cohort's shard padding through ``participation.pad_slots``,
the row localization, the async buffer's shard padding); ``mesh=1`` in one
process bit for bit ``mesh=None`` for every strategy in both layouts; the
collectives and the row-sharded primitives in 2 gloo ranks; ``spawn``'s
failures; the knob's refusals with the reference's types and messages;
and the reference's ucfl on 4 forced host devices (a subprocess, since the
flag must come before jax's import) against the port's 4-rank run.
"""
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from repro.federated import async_buffer as ref_async
from repro.federated import mesh as ref_mesh
from repro.federated import participation as ref_part
from repro_torch import checkpoint, interop
from repro_torch.core import REGISTRY, FedConfig, ucfl
from repro_torch.core.baselines import common
from repro_torch.federated import async_buffer, mesh, participation, topology
from repro_torch.models import lenet
from torch_parity import MESH_NAMES as NAMES
from torch_parity import BATCH, VAR_BATCH, mesh_run, one_torch_thread  # noqa: F401

M = 8
SEED = 0


def _fake_mesh(s):
    """A stand-in for the reference's ``Mesh`` of s devices: its helpers
    read ``mesh.devices.size`` alone."""
    return types.SimpleNamespace(devices=np.empty(s))


def test_pad_to_shards_matches_reference():
    for slots in range(0, 40):
        for s in (1, 2, 3, 4, 8):
            assert mesh.pad_to_shards(slots, s) == ref_mesh.pad_to_shards(slots, s)


@pytest.mark.parametrize("s", [1, 2, 3, 4, 8])
def test_pad_cohort_matches_reference(s):
    rng = np.random.default_rng(s)
    m = 20
    for slots in (1, 5, 7, 8, 13):
        members = np.sort(rng.choice(m, size=rng.integers(1, slots + 1), replace=False))
        port = participation.pad_slots(participation.as_cohort(members, m), slots, m)
        ref = ref_part.pad_slots(ref_part.as_cohort(members, m), slots, m)
        got = mesh.pad_cohort(port, types.SimpleNamespace(shards=s), m)
        want = ref_mesh.pad_cohort(ref, _fake_mesh(s), m)
        np.testing.assert_array_equal(got.indices, np.asarray(want.indices))
        np.testing.assert_array_equal(got.mask, np.asarray(want.mask))
        assert got.num_slots % s == 0


@pytest.mark.parametrize("s", [2, 4])
def test_localize_matches_reference(s):
    m = 12
    mb = m // s
    idx = np.asarray([0, 3, 5, 6, 11, m, 2, m], np.int32)
    want = jax.vmap(lambda _: ref_mesh._localize(jnp.asarray(idx), mb, "clients"),
                    axis_name="clients")(jnp.arange(s))
    for k in range(s):
        loc, own = mesh._localize(torch.as_tensor(idx), mb, k)
        np.testing.assert_array_equal(loc.numpy(), np.asarray(want[0][k]))
        np.testing.assert_array_equal(own.numpy(), np.asarray(want[1][k]))


@pytest.mark.parametrize("shards", [1, 2, 3, 4])
def test_async_buffer_shard_padding_matches_reference(shards):
    cfg = async_buffer.AsyncConfig(flush_k=3)
    rcfg = ref_async.AsyncConfig(flush_k=3)
    for slots in (1, 4, 5, 9):
        got = async_buffer.init_buffer(cfg, 10, slots, 37, shards=shards)
        want = ref_async.init_buffer(rcfg, 10, slots, 37, shards=shards)
        np.testing.assert_array_equal(got["idx"].numpy(), np.asarray(want["idx"]))
        np.testing.assert_array_equal(got["ver"].numpy(), np.asarray(want["ver"]))
        # the port's upd carries one spare row past the reference's B rows
        assert tuple(got["upd"].shape) == (want["upd"].shape[0] + 1, want["upd"].shape[1])
        assert got["idx"].shape[0] % shards == 0


def _schedule(name):
    return mesh_run(name, M, ((0, 2, 5), (1, 3, 4, 6)))[0]


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("name", NAMES)
def test_mesh_one_is_bit_for_bit_no_mesh(name):
    """``mesh=1`` needs no process group and runs no collective: replicated
    and row-sharded (one block of m rows) it gives the ``mesh=None`` bits."""
    data, params0 = ranks.task(SEED, M)
    run = _schedule(name)
    none = ranks.play(run, data, params0, None)
    for shard in (False, True):
        one = ranks.play(dict(run, shard=shard), data, params0, 1)
        assert one["row_sharded"] == shard
        assert sorted(one["slabs"]) == sorted(none["slabs"])
        for k in none["slabs"]:
            np.testing.assert_array_equal(one["slabs"][k], none["slabs"][k], err_msg=k)
        assert one["metrics"] == none["metrics"]
        np.testing.assert_array_equal(one["accs"], none["accs"])


@pytest.mark.usefixtures("one_torch_thread")
def test_mesh_one_dense_round_is_no_mesh():
    data, params0 = ranks.task(SEED, M)
    outs = []
    for knob in (None, 1):
        s = REGISTRY["fedavg"](lenet.apply_stacked, params0,
                               FedConfig(batch_size=BATCH, mesh=knob), device="cpu")
        state, _ = s.round(s.init(None, data), data, torch.Generator().manual_seed(3))
        outs.append(state["params"])
    assert torch.equal(outs[0], outs[1])


def test_collectives_and_row_primitives_in_two_ranks(tmp_path):
    got = mesh.spawn(ranks.collectives, 2, store_path=str(tmp_path / "store"), timeout=120)
    s, m, width = 2, 8, 5
    full = np.arange(m * width, dtype=np.float32).reshape(m, width)
    for r, out in enumerate(got):
        np.testing.assert_array_equal(out["summed"], np.full((3, 4), 3.0))
        np.testing.assert_array_equal(out["gathered"][:, 0], [0, 0, 1, 1])
        np.testing.assert_array_equal(out["flags"], [True, False])
        # the gather's SUM of owned rows is the replicated gather, exactly
        np.testing.assert_array_equal(out["gather"], full[[m - 1, 0, 2, m - 1]])
        # each rank writes the members it owns, at their local rows
        want = full[out["lo"]:out["lo"] + m // s].copy()
        for i, client in enumerate([1, m - 2]):
            if out["lo"] <= client < out["lo"] + m // s:
                want[client - out["lo"]] = -1.0
        np.testing.assert_array_equal(out["scattered"], want)
        np.testing.assert_array_equal(out["mean"], out["block_mean"])
        np.testing.assert_allclose(out["mean"][0], full.mean(axis=0), rtol=1e-6)
        assert out["drift"] is not None and "SPMD drift" in out["drift"]
        timed = out["timed"]["all_reduce"]  # counted with TIMING on: 12 f32 values
        assert timed["calls"] == 1 and timed["bytes"] == 48 and timed["ms"] > 0


def test_spawn_fails_when_a_rank_raises_or_hangs(tmp_path):
    with pytest.raises(RuntimeError, match="mesh.spawn: rank"):
        mesh.spawn(ranks.fail_on, 2, store_path=str(tmp_path / "a"), timeout=120, args=(1,))
    with pytest.raises(TimeoutError, match="did not finish"):
        mesh.spawn(ranks.hang, 2, store_path=str(tmp_path / "b"), timeout=4, args=(120,))


def _params0():
    return ranks.task(SEED, M)[1]


@pytest.mark.parametrize("name", NAMES + ["ucfl_k4"])
def test_shard_state_requires_a_mesh(name):
    cfg = FedConfig(shard_state=True)
    with pytest.raises(ValueError, match="requires a mesh"):
        if name == "ucfl_k4":
            ucfl.make_ucfl(lenet.apply_stacked, _params0(), cfg, num_streams=4, device="cpu")
        else:
            REGISTRY[name](lenet.apply_stacked, _params0(), cfg, device="cpu")


def test_refusals_match_reference():
    data, params0 = ranks.task(SEED, M)
    # the dense path under shard_state
    s = REGISTRY["fedavg"](lenet.apply_stacked, params0,
                           FedConfig(mesh=1, shard_state=True), device="cpu")
    with pytest.raises(ValueError, match="cohort rounds"):
        s.round(s.init(None, data), data, torch.Generator().manual_seed(0), None)
    # ucfl_parallel takes the mesh but not shard_state
    REGISTRY["ucfl_parallel"](lenet.apply_stacked, params0, FedConfig(mesh=1), device="cpu")
    with pytest.raises(NotImplementedError, match="shard_state is not supported by ucfl_parallel"):
        REGISTRY["ucfl_parallel"](lenet.apply_stacked, params0,
                                  FedConfig(mesh=1, shard_state=True), device="cpu")
    # the topology with shard_state
    topo = topology.Topology.contiguous(M, 2)
    for name in ("fedavg", "fedprox"):
        with pytest.raises(NotImplementedError, match="does not compose with shard_state"):
            REGISTRY[name](lenet.apply_stacked, params0,
                           FedConfig(mesh=1, shard_state=True, topology=topo), device="cpu")
    with pytest.raises(NotImplementedError, match="does not compose with shard_state"):
        ucfl.make_ucfl(lenet.apply_stacked, params0,
                       FedConfig(mesh=1, shard_state=True, topology=topo), num_streams=2,
                       device="cpu")
    # the knob's forms without a process group
    assert mesh.resolve(None) is None
    one = mesh.resolve(1)
    assert (one.group, one.rank, one.shards) == (None, 0, 1)
    assert mesh.resolve(one) is one
    with pytest.raises(ValueError, match=r"need 1 <= num_shards <= 1 local devices, got 8"):
        mesh.resolve(8)
    with pytest.raises(ValueError, match="process group"):
        mesh.resolve("auto")
    with pytest.raises(ValueError, match="divisible by the 3-device mesh"):
        mesh.commit_rows(torch.zeros(8, 4), mesh.ClientMesh(None, 0, 3), 8)


def test_row_sharded_state_refuses_checkpoint_and_reference_state(tmp_path):
    """A row-sharded state no longer refuses a checkpoint or the state
    converter: on one shard (``mesh=1``) its file is the replicated run's
    byte for byte, restore into it gives its bits back with the mark, and
    ``state_to_reference`` drops the mark. (The gathered save over 2 and 4
    ranks: ``tests/test_torch_sharded_state.py``.)"""
    data, params0 = ranks.task(SEED, M)
    s = REGISTRY["local"](lenet.apply_stacked, params0,
                          FedConfig(batch_size=BATCH, mesh=1, shard_state=True), device="cpu")
    cohort = participation.pad_slots(participation.as_cohort(np.arange(3), M), 4, M)
    state, _ = s.round(s.init(None, data), data, torch.Generator().manual_seed(0), cohort)
    assert mesh.row_mesh(state) is not None and mesh.row_mesh(state).keys == ("params",)
    checkpoint.save(str(tmp_path / "s.ckpt"), state)
    back = checkpoint.restore(str(tmp_path / "s.ckpt"), state)
    assert torch.equal(back["params"], state["params"]) and mesh.row_mesh(back) is not None
    conv = interop.state_to_reference(state, 10)
    assert mesh.ROW_KEY not in conv and torch.equal(conv["params"], state["params"])
    # the replicated layout writes the same file
    rep = REGISTRY["local"](lenet.apply_stacked, params0,
                            FedConfig(batch_size=BATCH, mesh=1), device="cpu")
    rstate, _ = rep.round(rep.init(None, data), data, torch.Generator().manual_seed(0), cohort)
    assert mesh.row_mesh(rstate) is None
    checkpoint.save(str(tmp_path / "r.ckpt"), rstate)
    assert (tmp_path / "r.ckpt").read_bytes() == (tmp_path / "s.ckpt").read_bytes()


def test_state_ops_replicated_is_the_plain_helpers():
    sops = common.StateOps()
    assert sops.mesh is None and not sops.sharded and sops.buffer_shards == 1
    assert sops.buffer_scatter() is None
    full = torch.randn(6, 8)
    assert torch.equal(sops.row0(full), full[0:1])
    assert torch.equal(sops.row_mean(full, 6), torch.mean(full, dim=0, keepdim=True))
    state = {"params": full}
    assert sops.commit_state(state, ("params",), 6) is state


_REF_MESH = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
sys.path[:0] = [{src!r}, {tests!r}]
from parity_arrays import small_arrays
from repro.core import FedConfig, REGISTRY
from repro.data import synthetic
from repro.federated import participation, simulation
from repro.models import lenet
from torch_parity import key_schedule
assert jax.device_count() == 4, jax.devices()
arrays, params = small_arrays({seed}, {m})
data = synthetic.FederatedData(*(jnp.asarray(a) for a in arrays))
params0 = {{k: jnp.asarray(v) for k, v in params.items()}}
out = {{}}
for shard in (False, True):
    strat = REGISTRY["ucfl"](lenet.apply, params0,
                             FedConfig(batch_size={batch}, mesh="auto", shard_state=shard),
                             var_batch_size={var})
    cohorts = [participation.Cohort(indices=np.asarray(i, np.int32), mask=np.asarray(k, bool))
               for i, k in {cohorts!r}]
    ikey, rounds = key_schedule(cohorts)
    state = strat.init(ikey, data)
    for rkey, cohort in rounds:
        state, _ = strat.round(simulation.donation_safe_copy(state), data, rkey, cohort)
    out["sharded" if shard else "replicated"] = np.asarray(state["params"])
np.savez({path!r}, **out)
"""


def test_four_device_reference_matches_four_ranks(tmp_path):
    """The reference's ucfl on 4 forced host devices, replicated and
    row-sharded, init and two padded cohort rounds, against the port's
    4-rank gloo runs of the same rounds: within 1e-4."""
    root = Path(__file__).resolve().parents[1]
    run = _schedule("ucfl")
    script = _REF_MESH.format(src=str(root / "src"), tests=str(root / "tests"), seed=SEED, m=M,
                              batch=BATCH, var=VAR_BATCH,
                              cohorts=[(i.tolist(), k.tolist()) for i, k in run["cohorts"]],
                              path=str(tmp_path / "ref.npz"))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, "-c", script], env=env, cwd=tmp_path)
    try:
        runs = [dict(run, key=lay, shard=lay == "sharded") for lay in ("replicated", "sharded")]
        reports = mesh.spawn(ranks.run_all, 4, store_path=str(tmp_path / "store"), timeout=180,
                             args=(SEED, M, runs))
    finally:
        assert ref.wait(timeout=300) == 0
    want = np.load(tmp_path / "ref.npz")
    for lay in ("replicated", "sharded"):
        parts = [r[lay]["slabs"]["params"] for r in reports]
        got = np.concatenate(parts) if lay == "sharded" else parts[0]
        np.testing.assert_allclose(got[:, : want[lay].shape[1]], want[lay], atol=1e-4,
                                   err_msg=lay)
