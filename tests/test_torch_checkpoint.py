"""The port's checkpoints (``repro_torch.checkpoint``) against the reference's.

The seven cases of ``tests/test_checkpoint.py`` on the port's module; its
msgpack subset against the installed ``msgpack`` package, byte for byte in
both directions, over fixed cases and as a hypothesis property; files
written by either package and read by the other, bit for bit (the LeNet
slab, a bf16 transformer tree, a tree with ints, 0-d leaves, ``None`` and
empty containers); and strategy states carried across through
``repro_torch.interop``: a reference ``ucfl`` state with the streaming
refresh, and a buffered ``fedavg`` state, each saved by the reference after
one cohort round and restored by the port, after which one more round of
each package agrees within ROADMAP C2's 1e-4 (the trajectories' tolerance);
and a port state saved through ``state_to_reference`` read by the
reference, bit for bit.
"""
import functools
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch

from hypothesis_compat import given, load_ci_profile, st
from repro import checkpoint as ref_checkpoint
from repro.core import FedConfig as RefFedConfig
from repro.core import REGISTRY as REF_REGISTRY
from repro.core import similarity as ref_similarity
from repro.federated import async_buffer as ref_async
from repro.federated import simulation as ref_simulation
from repro.models import lenet as ref_lenet
from repro.models import transformer as ref_transformer
from repro import configs as ref_configs
from repro_torch import checkpoint, interop
from repro_torch.checkpoint import _msgpack
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.core import REGISTRY, FedConfig, flat, pytree
from repro_torch.core.similarity import RefreshConfig
from repro_torch.federated import async_buffer
from repro_torch.models import lenet
from torch_parity import (BATCH, SMALL, VAR_BATCH, key_schedule, n, np_tree, padded_cohorts,
                          ref_cohort, ref_permutations, small_task, t)

load_ci_profile(max_examples=60)


def _zeros_like(tree):
    return pytree.unflatten(tree, [torch.zeros_like(x) for x in pytree.leaves(tree)])


# ------------------------------------------- tests/test_checkpoint.py's seven
def test_roundtrip(tmp_path):
    params = lenet.init(torch.Generator().manual_seed(0), input_hw=(16, 16), channels=1,
                        num_classes=5, device="cpu")
    path = os.path.join(tmp_path, "ckpt.msgpack")
    checkpoint.save(path, params)
    restored = checkpoint.restore(path, _zeros_like(params))
    for a, b in zip(pytree.leaves(params), pytree.leaves(restored)):
        assert torch.equal(a, b) and a.dtype == b.dtype


def test_restore_rejects_shape_mismatch(tmp_path):
    path = os.path.join(tmp_path, "c.msgpack")
    checkpoint.save(path, {"w": torch.ones(3, 3)})
    with pytest.raises(ValueError, match="shape mismatch"):
        checkpoint.restore(path, {"w": torch.ones(4, 4)})


def test_restore_rejects_leaf_count_mismatch(tmp_path):
    path = os.path.join(tmp_path, "c.msgpack")
    checkpoint.save(path, {"w": torch.ones(3), "b": torch.ones(2)})
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.restore(path, {"w": torch.ones(3)})


def test_atomic_overwrite(tmp_path):
    path = os.path.join(tmp_path, "c.msgpack")
    checkpoint.save(path, {"w": torch.ones(2)})
    checkpoint.save(path, {"w": 2 * torch.ones(2)})
    out = checkpoint.restore(path, {"w": torch.zeros(2)})
    assert out["w"].tolist() == [2.0, 2.0]


def test_crash_mid_write_keeps_previous_checkpoint(tmp_path, monkeypatch):
    path = os.path.join(tmp_path, "c.msgpack")
    checkpoint.save(path, {"w": torch.ones(2)})

    def boom(src, dst):
        raise OSError("simulated crash before rename")

    monkeypatch.setattr(ckpt_io.os, "replace", boom)
    with pytest.raises(OSError, match="simulated crash"):
        checkpoint.save(path, {"w": 9 * torch.ones(2)})
    monkeypatch.undo()
    out = checkpoint.restore(path, {"w": torch.zeros(2)})
    assert out["w"].tolist() == [1.0, 1.0]
    assert [f for f in os.listdir(tmp_path) if ".tmp." in f] == []


def test_restore_ignores_orphaned_tmp_files(tmp_path):
    path = os.path.join(tmp_path, "c.msgpack")
    checkpoint.save(path, {"w": 3 * torch.ones(2)})
    with open(path + ".tmp.99999.deadbeef", "wb") as f:
        f.write(b"half-written garbage from a crashed saver")
    out = checkpoint.restore(path, {"w": torch.zeros(2)})
    assert out["w"].tolist() == [3.0, 3.0]


def test_concurrent_savers_never_clobber(tmp_path):
    path = os.path.join(tmp_path, "c.msgpack")
    real_replace = os.replace
    pending = []

    def defer(src, dst):  # hold the first saver's rename until the second's
        pending.append((src, dst))
        if len(pending) == 2:
            for s, d in reversed(pending):
                real_replace(s, d)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ckpt_io.os, "replace", defer)
        checkpoint.save(path, {"w": 1 * torch.ones(2)})
        checkpoint.save(path, {"w": 2 * torch.ones(2)})
    out = checkpoint.restore(path, {"w": torch.zeros(2)})
    assert out["w"].tolist() == [1.0, 1.0]


# ------------------------------------------------------- the msgpack subset
MSGPACK_CASES = [
    None, True, False, 0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
    -1, -32, -33, -128, -129, -2**15, -2**15 - 1, -2**31, -2**31 - 1, -2**63,
    0.0, -0.5, 1e300, float("inf"), "", "a" * 31, "a" * 32, "é" * 200, "x" * 70_000,
    b"", b"\x00" * 255, b"y" * 256, b"z" * 70_000, [], list(range(15)), list(range(16)),
    list(range(70_000)), {}, {str(i): i for i in range(15)}, {str(i): [i] for i in range(16)},
    {b"__nd__": True, b"dtype": "bfloat16", b"shape": [2, 3], b"data": b"\x01" * 12},
    {"treedef": "PyTreeDef(*)", "leaves": [{b"k": None}, [1.5, "s", b"b"]]},
]


@pytest.mark.parametrize("obj", MSGPACK_CASES, ids=lambda o: type(o).__name__)
def test_msgpack_subset_matches_the_package_both_ways(obj):
    ours = _msgpack.packb(obj)
    assert ours == msgpack.packb(obj)
    want = msgpack.unpackb(ours, strict_map_key=False)
    assert _msgpack.unpackb(ours) == want
    assert _msgpack.unpackb(msgpack.packb(obj)) == want


def test_msgpack_subset_refuses_what_it_does_not_write():
    with pytest.raises(TypeError):
        _msgpack.packb({1, 2})
    with pytest.raises(ValueError, match="subset"):
        _msgpack.unpackb(msgpack.packb(msgpack.ExtType(1, b"x")))
    with pytest.raises(ValueError, match="left after"):
        _msgpack.unpackb(msgpack.packb(1) + b"\x00")


_leaf = (st.none() | st.booleans() | st.integers(-2**63, 2**64 - 1)
         | st.floats(allow_nan=False) | st.text(max_size=40) | st.binary(max_size=300))
_obj = st.recursive(_leaf, lambda c: st.lists(c, max_size=20)
                    | st.dictionaries(st.text(max_size=10) | st.binary(max_size=10), c,
                                      max_size=20), max_leaves=60)


@given(_obj)
def test_msgpack_subset_property(obj):
    ours = _msgpack.packb(obj)
    assert ours == msgpack.packb(obj)
    assert _msgpack.unpackb(ours) == msgpack.unpackb(ours, strict_map_key=False)


# ------------------------------------------------ files across the packages
def _lenet_slab():
    _, _, _, tparams = small_task()
    layout = flat.LayoutTable.build(tparams)
    slab = layout.slab(tparams, SMALL["m"])
    slab[:, : layout.dim] += 0.01 * torch.randn(SMALL["m"], layout.dim,
                                                generator=torch.Generator().manual_seed(1))
    return {"params": slab}


@functools.lru_cache(maxsize=1)
def _bf16_tree():
    cfg = ref_configs.get("stablelm-1.6b").reduced()
    p = np_tree(jax.jit(functools.partial(ref_transformer.init, cfg=cfg))(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    bf = {k: v for k, v in p.items()}
    bf["blocks"] = jax.tree.map(lambda x: (x + 0.01 * rng.normal(size=x.shape)).astype(
        ml_dtypes.bfloat16), p["blocks"])
    bf["extra"] = {"count": np.asarray(7, np.int32), "none": None, "empty": (),
                   "ids": np.arange(5, dtype=np.int32), "flags": np.array([True, False])}
    return bf


def _as_port(tree):
    if isinstance(tree, dict):
        return {k: _as_port(v) for k, v in tree.items()}
    if tree is None or isinstance(tree, tuple):
        return tree
    return interop._tensor(tree, torch.device("cpu"))


def _assert_bits(got, want):
    """A port tree against a numpy tree, bit for bit (bf16 compared as bits)."""
    gl, wl = pytree.leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        if w.dtype == ml_dtypes.bfloat16:
            assert g.dtype == torch.bfloat16
            np.testing.assert_array_equal(g.view(torch.int16).numpy(), w.view(np.int16))
        else:
            np.testing.assert_array_equal(n(g), w)
            assert n(g).dtype == w.dtype


@pytest.mark.parametrize("which", ["lenet_slab", "bf16_tree"])
def test_reference_file_reads_into_the_port_bit_for_bit(tmp_path, which):
    tree = _bf16_tree() if which == "bf16_tree" else np_tree(
        {k: np.asarray(v) for k, v in _lenet_slab().items()})
    path = os.path.join(tmp_path, "ref.msgpack")
    ref_checkpoint.save(path, jax.tree.map(jnp.asarray, tree))
    got = checkpoint.restore(path, _zeros_like(_as_port(tree)))
    _assert_bits(got, tree)


@pytest.mark.parametrize("which", ["lenet_slab", "bf16_tree"])
def test_port_file_reads_into_the_reference_bit_for_bit(tmp_path, which):
    port = _as_port(_bf16_tree()) if which == "bf16_tree" else _lenet_slab()
    path = os.path.join(tmp_path, "port.msgpack")
    checkpoint.save(path, port)
    like = jax.tree.map(lambda x: jnp.zeros(np.shape(x), jnp.asarray(n(x)).dtype
                                            if x.dtype != torch.bfloat16 else jnp.bfloat16),
                        port)
    got = ref_checkpoint.restore(path, like)
    _assert_bits(port, got)
    # the port reads its own file back bit for bit, on the like's device
    back = checkpoint.restore(path, _zeros_like(port))
    for a, b in zip(pytree.leaves(back), pytree.leaves(port)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_restore_casts_to_the_like_and_keeps_python_numbers(tmp_path):
    path = os.path.join(tmp_path, "c.msgpack")
    checkpoint.save(path, {"i": torch.arange(4, dtype=torch.int32), "n": 5, "x": 1.5,
                           "z": torch.tensor(2.0)})
    out = checkpoint.restore(path, {"i": torch.zeros(4, dtype=torch.int64), "n": 0, "x": 0.0,
                                    "z": torch.zeros((), dtype=torch.bfloat16)})
    assert out["i"].dtype == torch.int64 and out["i"].tolist() == [0, 1, 2, 3]
    assert out["n"] == 5 and isinstance(out["n"], int) and out["x"] == 1.5
    assert out["z"].dtype == torch.bfloat16 and float(out["z"]) == 2.0
    raw = msgpack.unpackb(open(path, "rb").read(), strict_map_key=False)
    assert [(r[b"dtype"], r[b"shape"]) for r in raw["leaves"]] == [
        ("int32", [4]), ("int64", []), ("float64", []), ("float32", [])]


# ------------------------------------------------- strategy states, through interop
FLUSH = ref_async.AsyncConfig(flush_k=4, alpha=0.5)


def _strategies(name):
    data, tdata, rparams, tparams = small_task()
    if name == "ucfl":
        ref = REF_REGISTRY["ucfl"](ref_lenet.apply, rparams, RefFedConfig(
            batch_size=BATCH, w_refresh=ref_similarity.RefreshConfig()), var_batch_size=VAR_BATCH)
        port = REGISTRY["ucfl"](lenet.apply_stacked, tparams, FedConfig(
            batch_size=BATCH, w_refresh=RefreshConfig()), var_batch_size=VAR_BATCH, device="cpu")
    else:
        ref = REF_REGISTRY["fedavg"](ref_lenet.apply, rparams,
                                     RefFedConfig(batch_size=BATCH, async_buffer=FLUSH))
        port = REGISTRY["fedavg"](lenet.apply_stacked, tparams, FedConfig(
            batch_size=BATCH, async_buffer=async_buffer.AsyncConfig(FLUSH.flush_k, FLUSH.alpha)),
            device="cpu")
    return data, tdata, ref, port


def _port_round(port, state, tdata, rkey, cohort):
    perms = t(ref_permutations(rkey, SMALL["m"], 1, SMALL["n"], BATCH))
    return port.round(state, tdata, None, cohort, perms=perms)[0]


@pytest.mark.parametrize("name", ["ucfl", "fedavg"])
def test_reference_state_restored_through_interop_runs_the_same_round(tmp_path, name):
    data, tdata, ref, port = _strategies(name)
    ikey, rounds = key_schedule(padded_cohorts())
    (k1, c1), (k2, c2) = rounds
    rstate = jax.jit(ref.init)(ikey, data)
    if name == "ucfl":
        rstate = dict(rstate, streams=None)
    rstate, _ = ref.round(ref_simulation.donation_safe_copy(rstate), data, k1, ref_cohort(c1))
    path = os.path.join(tmp_path, f"{name}.msgpack")
    ref_checkpoint.save(path, rstate)

    # the port's own state after the same round gives the structure
    like = _port_round(port, port.init(None, tdata), tdata, k1, c1)
    dim = flat.LayoutTable.build(small_task()[3]).dim
    ref_shaped = checkpoint.restore(path, interop.state_to_reference(like, dim))
    state = interop.state_from_reference(ref_shaped, like)
    for a, b in zip(pytree.leaves(state), pytree.leaves(like)):
        assert a.shape == b.shape and a.dtype == b.dtype
    want_leaves = jax.tree.leaves(rstate)
    for a, w in zip(pytree.leaves(ref_shaped), want_leaves):  # the file, bit for bit
        np.testing.assert_array_equal(n(a), np.asarray(w))

    rnext, _ = ref.round(ref_simulation.donation_safe_copy(rstate), data, k2, ref_cohort(c2))
    got = _port_round(port, state, tdata, k2, c2)
    np.testing.assert_allclose(n(got["params"]), np.asarray(rnext["params"]), rtol=0, atol=1e-4)
    if name == "ucfl":
        dim_r = np.asarray(rnext["refresh"]["grads"]).shape[1]
        for k in ("grads", "sigma_sq", "delta"):
            g = n(got["refresh"][k])
            np.testing.assert_allclose(g[:, :dim_r] if k == "grads" else g,
                                       np.asarray(rnext["refresh"][k]), rtol=0, atol=1e-4)
        np.testing.assert_allclose(n(got["W"]), np.asarray(rnext["W"]), rtol=0, atol=1e-4)
    else:
        buf = got["abuf"]
        assert int(buf["version"]) == int(rnext["abuf"]["version"]) == 1  # round 2 flushed
        for k in ("idx", "ver", "count", "last_sync"):
            np.testing.assert_array_equal(n(buf[k]), np.asarray(rnext["abuf"][k]))


def test_port_state_saved_for_the_reference_reads_back_bit_for_bit(tmp_path):
    data, tdata, ref, port = _strategies("fedavg")
    _, rounds = key_schedule(padded_cohorts())
    state = _port_round(port, port.init(None, tdata), tdata, *rounds[0])
    path = os.path.join(tmp_path, "port_state.msgpack")
    dim = flat.LayoutTable.build(small_task()[3]).dim
    checkpoint.save(path, interop.state_to_reference(state, dim))
    rstate = jax.jit(ref.init)(jax.random.PRNGKey(0), data)
    rstate, _ = ref.round(rstate, data, rounds[0][0], ref_cohort(rounds[0][1]))
    got = ref_checkpoint.restore(path, rstate)
    for g, w in zip(jax.tree.leaves(got), pytree.leaves(interop.state_to_reference(state, dim))):
        np.testing.assert_array_equal(np.asarray(g), n(w))
    # and the port's own file of its state restores bit for bit
    checkpoint.save(path, state)
    back = checkpoint.restore(path, state)
    for a, b in zip(pytree.leaves(back), pytree.leaves(state)):
        assert torch.equal(a, b)


def test_state_converter_round_trips_the_ports_shapes():
    """to_reference cuts the slab-wide directions to dim, drops upd's spare
    row and labels_host (views, no copy); from_reference restores the
    port's shapes with zero tails and a zero spare row, labels_host from
    labels."""
    g = torch.Generator().manual_seed(0)
    grads = torch.randn(4, 256, generator=g)
    grads[:, 200:] = 0.0
    upd = torch.randn(8, 256, generator=g)
    upd[7] = 0.0
    state = {"params": torch.randn(4, 256, generator=g), "labels": torch.tensor([1, 0, 1, 0]),
             "labels_host": np.array([1, 0, 1, 0]), "streams": 2,
             "refresh": {"grads": grads, "staleness": torch.zeros(4, dtype=torch.int32)},
             "abuf": {"upd": upd, "count": torch.tensor(3, dtype=torch.int32)}}
    ref = interop.state_to_reference(state, 200)
    assert tuple(ref["refresh"]["grads"].shape) == (4, 200)
    assert tuple(ref["abuf"]["upd"].shape) == (7, 256)
    assert ref["refresh"]["grads"].data_ptr() == grads.data_ptr() and ref["labels_host"] is None
    assert len(pytree.leaves(ref)) == len(pytree.leaves(state)) - 1
    back = interop.state_from_reference(ref, state)
    for a, b in zip(pytree.leaves(back), pytree.leaves(state)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert np.array_equal(a, b)
