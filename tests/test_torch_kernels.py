"""The port's kernel ops against the reference's Pallas kernels.

On the CPU the port's ops run their plain torch versions
(``repro_torch.kernels.ref``); the reference runs its Pallas kernels in
interpret mode, as ``tests/test_kernels.py`` does. Tolerances: f32 sums in
another order, so rtol 1e-5 (atol 1e-5 for values near 0); k-means labels
are exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro_torch.kernels import ops
from torch_parity import f32, n, t

SHAPES_MIX = [(1, 1, 128), (4, 8, 300), (16, 16, 1024), (5, 7, 97), (3, 20, 513)]


@pytest.mark.parametrize("k,m,d", SHAPES_MIX)
def test_mix_aggregate_matches_reference(k, m, d):
    rng = np.random.default_rng(k * 100 + m)
    w = rng.normal(size=(k, m)).astype(np.float32)
    th = rng.normal(size=(m, d)).astype(np.float32)
    want = ref_ops.mix_aggregate(f32(w), f32(th), impl="interpret")
    got = ops.mix_aggregate(t(w), t(th))
    assert got.dtype == torch.float32 and got.shape == (k, d)
    np.testing.assert_allclose(n(got), n(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k,m", [(1, 4), (2, 4), (4, 4), (2, 2), (16, 16)])
@pytest.mark.parametrize("d", [513, 4_099, 8_192])
def test_mix_aggregate_bf16_matches_reference(k, m, d):
    """A bf16 θ (the train step's leaves, mixed in their storage dtype)
    against the reference's ``mix_aggregate_pallas`` in interpret mode,
    which casts each θ block to f32 and writes θ's dtype: the port's output
    is bf16, equal to the reference's or one bf16 step from it where the
    two f32 sums, taken in other orders, round to neighbouring values."""
    from repro.kernels.mix_aggregate import mix_aggregate_pallas
    rng = np.random.default_rng(k * 1000 + m * 10 + d)
    w = rng.dirichlet(np.ones(m), size=k).astype(np.float32)
    th = torch.tensor(rng.normal(size=(m, d)).astype(np.float32)).to(torch.bfloat16)
    want = mix_aggregate_pallas(f32(w), jnp.asarray(th.float().numpy(), dtype=jnp.bfloat16),
                                interpret=True)
    got = ops.mix_aggregate(t(w), th)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16 and got.shape == (k, d)
    want = torch.tensor(np.asarray(want.astype(jnp.float32)))
    step = 2.0 ** -7 * want.abs()  # one bf16 step of each value (8 significant bits)
    assert bool(((got.float() - want).abs() <= step).all())
    assert float((got.float() == want).float().mean()) >= 0.99


@pytest.mark.parametrize("m,d", [(3, 64), (7, 300), (12, 1111),
                                 (2, 1001), (4, 4099)])  # the collaboration round's few rows
def test_gram_and_delta_match_reference(m, d):
    rng = np.random.default_rng(m + d)
    g = rng.normal(size=(m, d)).astype(np.float32)
    want = ref_ops.pairwise_delta(f32(g), impl="interpret")
    got = ops.pairwise_delta(t(g))
    scale = float(np.max(np.abs(n(want))))
    np.testing.assert_allclose(n(got), n(want), rtol=1e-5, atol=1e-5 * scale)
    np.testing.assert_allclose(n(ops.gram(t(g))), g @ g.T, rtol=1e-5, atol=1e-4)
    assert np.all(n(got) >= 0) and np.all(np.diag(n(got)) == 0)


@pytest.mark.parametrize("m,f,k", [(10, 5, 3), (100, 100, 4), (33, 17, 8)])
def test_kmeans_assign_matches_reference(m, f, k):
    rng = np.random.default_rng(m * f + k)
    p = rng.normal(size=(m, f)).astype(np.float32)
    c = rng.normal(size=(k, f)).astype(np.float32)
    wl, wd = ref_ops.kmeans_assign(f32(p), f32(c), impl="interpret")
    gl, gd = ops.kmeans_assign(t(p), t(c))
    assert gl.dtype == torch.int32 and gd.dtype == torch.float32
    np.testing.assert_array_equal(n(gl), n(wl))
    np.testing.assert_allclose(n(gd), n(wd), rtol=1e-5, atol=1e-5)


def test_kmeans_assign_tie_goes_to_lowest_index():
    p = np.eye(4, 6, dtype=np.float32)
    c = np.zeros((3, 6), np.float32)  # three identical centroids
    labels, dist = ops.kmeans_assign(t(p), t(c))
    np.testing.assert_array_equal(n(labels), 0)
    wl, _ = ref_ops.kmeans_assign(f32(p), f32(c), impl="interpret")
    np.testing.assert_array_equal(n(labels), n(wl))
    np.testing.assert_allclose(n(dist), 1.0)


def test_dispatch_rules():
    x = torch.ones(2, 3)
    w = torch.ones(1, 2)
    with pytest.raises(ValueError, match="CUDA"):
        ops.mix_aggregate(w, x, impl="cuda")
    with pytest.raises(ValueError, match="unknown kernel impl"):
        ops.mix_aggregate(w, x, impl="pallas")
    np.testing.assert_array_equal(n(ops.mix_aggregate(w, x, impl="ref")), 2.0)
    assert ops.ALIGN == 128
    assert [ops.aligned_dim(d) for d in (0, 1, 128, 129, 47571)] == [0, 128, 128, 256, 47616]


def test_mix_aggregate_zero_width():
    out = ops.mix_aggregate(torch.ones(3, 4), torch.ones(4, 0))
    assert out.shape == (3, 0)
