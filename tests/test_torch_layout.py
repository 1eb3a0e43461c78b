"""The port's slab layout against the reference's (bit-exact).

``repro_torch.core.flat.LayoutTable`` must order leaves as ``jax.tree``
flattens a dict (sorted keys), put them at the reference's offsets, keep
``dim_aligned`` and a zero tail, so one params tree ravels to the same slab
in both packages, element for element.
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
