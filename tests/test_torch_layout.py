"""The port's slab layout against the reference's (bit-exact).

``repro_torch.core.flat.LayoutTable`` must order leaves as ``jax.tree``
flattens a dict (sorted keys, at every level of a nested tree), put them
at the reference's offsets, keep ``dim_aligned`` and a zero tail, so one
params tree ravels to the same slab in both packages, element for
element; ``core.pytree``'s nested helpers follow the same order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flat as ref_flat
from repro.core import pytree as ref_pytree
from repro_torch.core import flat, pytree
from repro_torch.interop import params_from_numpy
from torch_parity import lenet_params, n


def _lenet_params(hw=(28, 28), classes=47):
    p = lenet_params(np.random.default_rng(3), hw, classes, bias=0.5)
    return {k: jnp.asarray(v) for k, v in p.items()}, params_from_numpy(p, device="cpu")


@pytest.mark.parametrize("hw,classes", [((28, 28), 47), ((16, 16), 6)])
def test_layout_matches_reference(hw, classes):
    rp, tp = _lenet_params(hw, classes)
    rl = ref_flat.LayoutTable.build(rp)
    tl = flat.LayoutTable.build(tp)
    assert tl.keys == tuple(sorted(tp)) and tl.keys[:3] == ("c1_b", "c1_w", "c2_b")
    assert tl.shapes == rl.shapes and tl.sizes == rl.sizes and tl.offsets == rl.offsets
    assert (tl.dim, tl.dim_aligned) == (rl.dim, rl.dim_aligned)
    if hw == (28, 28):
        assert tl.dim == 47571 and tl.dim_aligned == 47616


@pytest.mark.parametrize("lead", [(), (3,), (2, 4)])
def test_ravel_unravel_bit_exact_vs_reference(lead):
    rp, tp = _lenet_params((16, 16), 6)
    rs = jax.tree.map(lambda x: jnp.broadcast_to(x, lead + x.shape) + 0.0, rp)
    ts = {k: v.expand(lead + tuple(v.shape)).clone() for k, v in tp.items()}
    rl, tl = ref_flat.LayoutTable.build(rp), flat.LayoutTable.build(tp)
    rmat, tmat = rl.ravel(rs), tl.ravel(ts)
    np.testing.assert_array_equal(n(tmat), n(rmat))
    np.testing.assert_array_equal(n(tmat)[..., tl.dim:], 0.0)
    back = tl.unravel(tmat)
    for k in tp:
        np.testing.assert_array_equal(n(back[k]), n(ts[k]))
    np.testing.assert_array_equal(n(tl.slab(tp, 5)), n(rl.slab(rp, 5)))


def test_unravel_leaves_are_views_and_narrow_matrix_raises():
    _, tp = _lenet_params((16, 16), 6)
    tl = flat.LayoutTable.build(tp)
    slab = tl.slab(tp, 2)
    leaves = tl.unravel(slab)
    assert leaves["f3_b"].data_ptr() == slab[:, tl.offsets[tl.keys.index("f3_b")]:].data_ptr()
    leaves["c1_b"][1, 0] = 123.0
    assert float(slab[1, tl.offsets[0]]) == 123.0
    with pytest.raises(ValueError, match="different template"):
        tl.unravel(torch.zeros(2, tl.dim - 1))


def test_stacked_ravel_and_count_match_reference():
    rp, tp = _lenet_params((16, 16), 6)
    rs = jax.tree.map(lambda x: jnp.stack([x, 2 * x]), rp)
    ts = {k: torch.stack([v, 2 * v]) for k, v in tp.items()}
    np.testing.assert_array_equal(n(pytree.stacked_ravel(ts)), n(ref_pytree.stacked_ravel(rs)))
    assert pytree.tree_count_params(tp) == ref_pytree.tree_count_params(rp)


def _nested(rng, lead=()):
    """A nested tree like a transformer's: dicts at several levels, keys
    out of sorted order, a 0-d leaf."""
    def leaf(*shape):
        return rng.normal(size=lead + shape).astype(np.float32)
    return {"z": {"b": leaf(3, 2), "a": leaf(4)}, "m": leaf(), "blocks": {
        "l1": {"w": leaf(2, 5)}, "l0": {"w": leaf(2, 5), "s": leaf(5)}}}


def test_nested_leaves_paths_and_unflatten_follow_jax():
    tree = _nested(np.random.default_rng(0))
    want = jax.tree.leaves(tree)
    got = pytree.leaves(tree)
    assert len(got) == len(want) and all(g is w for g, w in zip(got, want))
    assert pytree.paths(tree) == [("blocks", "l0", "s"), ("blocks", "l0", "w"),
                                  ("blocks", "l1", "w"), ("m",), ("z", "a"), ("z", "b")]
    back = pytree.unflatten(tree, range(6))
    assert back == {"blocks": {"l0": {"s": 0, "w": 1}, "l1": {"w": 2}}, "m": 3,
                    "z": {"a": 4, "b": 5}}
    with pytest.raises(ValueError, match="more values"):
        pytree.unflatten(tree, range(7))
    summed = pytree.tree_map(lambda a, b: a + b, tree, tree)
    np.testing.assert_array_equal(summed["z"]["b"], 2 * tree["z"]["b"])


def test_leaves_and_unflatten_follow_jax_through_sequences_and_none():
    """Lists, tuples and NamedTuples hold their items in order, None and
    empty containers no leaf, as jax.tree flattens them (a checkpoint's
    file order)."""
    import collections
    pair = collections.namedtuple("pair", "lo hi")
    rng = np.random.default_rng(1)
    tree = {"b": [rng.normal(size=2), (np.int32(3), None)], "a": pair(rng.normal(size=(2, 2)), ()),
            "c": None, "d": {"y": 1.5, "x": [[], rng.normal(size=1)]}}
    want = jax.tree.leaves(tree)
    got = pytree.leaves(tree)
    assert len(got) == len(want) == 5 and all(g is w for g, w in zip(got, want))
    assert pytree.paths(tree) == [("a", "0"), ("b", "0"), ("b", "1", "0"), ("d", "x", "1"),
                                  ("d", "y")]
    back = pytree.unflatten(tree, range(5))
    assert back == {"a": pair(0, ()), "b": [1, (2, None)], "c": None, "d": {"x": [[], 3], "y": 4}}
    assert type(back["a"]) is pair and type(back["b"][1]) is tuple
    assert pytree.leaves(None) == [] and pytree.unflatten((), []) == ()


def test_stacked_ravel_into_a_zero_tailed_buffer_matches_the_reference():
    tree = _nested(np.random.default_rng(1), lead=(3,))
    want = np.asarray(ref_pytree.stacked_ravel(jax.tree.map(jnp.asarray, tree)))
    tt = pytree.tree_map(torch.as_tensor, tree)
    np.testing.assert_array_equal(n(pytree.stacked_ravel(tt)), want)
    d = want.shape[1]
    buf = torch.zeros(3, 2, d + 7)  # one row of each (client, partition), strided
    out = pytree.stacked_ravel(tt, out=buf[:, 1])
    assert out.data_ptr() == buf[:, 1].data_ptr()
    np.testing.assert_array_equal(n(buf[:, 1, :d]), want)
    assert not buf[:, 1, d:].any() and not buf[:, 0].any()
    half = pytree.stacked_ravel(pytree.tree_map(lambda x: x.to(torch.bfloat16), tt),
                                out=torch.zeros(3, d, dtype=torch.bfloat16))
    assert torch.equal(half, torch.tensor(want).to(torch.bfloat16))
    with pytest.raises(ValueError, match="columns wide"):
        pytree.stacked_ravel(tt, out=torch.zeros(3, d - 1))
    with pytest.raises(ValueError, match="does not lead"):
        pytree.stacked_ravel(tt, out=torch.zeros(2, d))


def test_nested_layout_matches_reference_and_unravels_views():
    tree = _nested(np.random.default_rng(2))
    rl = ref_flat.LayoutTable.build(jax.tree.map(jnp.asarray, tree))
    tt = pytree.tree_map(torch.as_tensor, tree)
    tl = flat.LayoutTable.build(tt)
    assert tl.keys == ("blocks/l0/s", "blocks/l0/w", "blocks/l1/w", "m", "z/a", "z/b")
    assert (tl.shapes, tl.offsets, tl.dim, tl.dim_aligned) == (
        rl.shapes, rl.offsets, rl.dim, rl.dim_aligned)
    slab = tl.slab(tt, 2)
    np.testing.assert_array_equal(n(slab), np.asarray(rl.slab(jax.tree.map(jnp.asarray, tree), 2)))
    back = tl.unravel(slab)
    assert back["z"]["b"].data_ptr() == slab[:, tl.offsets[5]:].data_ptr()
    assert torch.equal(back["blocks"]["l1"]["w"][1], tt["blocks"]["l1"]["w"])
    assert tuple(back["m"].shape) == (2,)
