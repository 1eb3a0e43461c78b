"""The special round, clustering and the dense mix rules against the reference.

Tolerances (f32 on the CPU): ``compute_collaboration`` full gradients and
σ² atol 1e-5 relative to their scale (the gradient sums run in another
order), Δ atol 1e-5 relative to its largest diagonal Gram entry (it is a
difference of such entries), W atol 1e-4 (Δ's error scaled by 1/(2σσ));
k-means from the reference's seeds gives the same labels exactly;
``user_centric``/``clustered`` rtol 1e-5.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as ref_agg
from repro.core import clustering as ref_clustering
from repro.core import similarity as ref_sim
from repro.core import ucfl as ref_ucfl
from repro.models import lenet as ref_lenet
from repro_torch.core import aggregation, clustering, flat, similarity, ucfl
from repro_torch.models import lenet
from torch_parity import VAR_BATCH, f32, n, small_task, t


@functools.lru_cache(maxsize=None)
def reference_collaboration():
    data, _, params0, _ = small_task()
    return jax.jit(lambda p, d: ref_ucfl.compute_collaboration(
        ref_lenet.apply, p, d, var_batch_size=VAR_BATCH))(params0, data)


def test_compute_collaboration_matches_reference():
    data, tdata, params0, tparams = small_task()
    want = reference_collaboration()
    got = ucfl.compute_collaboration(lenet.apply_stacked, tparams, tdata,
                                     var_batch_size=VAR_BATCH)
    chunked = ucfl.compute_collaboration(lenet.apply_stacked, tparams, tdata,
                                         var_batch_size=VAR_BATCH, chunk_size=4)
    g_scale = float(np.max(np.abs(n(want["full_grads"]))))
    np.testing.assert_allclose(n(got["full_grads"]), n(want["full_grads"]), atol=1e-5 * g_scale)
    s_scale = float(np.max(n(want["sigma_sq"])))
    np.testing.assert_allclose(n(got["sigma_sq"]), n(want["sigma_sq"]), atol=1e-5 * s_scale)
    gram_diag = float(np.max(np.sum(n(want["full_grads"]) ** 2, axis=1)))
    np.testing.assert_allclose(n(got["delta"]), n(want["delta"]), atol=1e-5 * gram_diag)
    np.testing.assert_allclose(n(got["W"]), n(want["W"]), atol=1e-4)
    np.testing.assert_allclose(n(got["W"]).sum(axis=1), 1.0, atol=1e-6)
    for k in got:
        torch.testing.assert_close(chunked[k], got[k], atol=1e-6, rtol=1e-6)


def test_special_round_takes_delta_from_slab_wide_rows(monkeypatch):
    """Δ is taken from the (m, dim_aligned) mean gradient, whose columns
    past ``layout.dim`` are exact zeros (the slab's pad columns never
    reach the loss), so the Gram kernel reads aligned rows where they lie;
    ``full_grads`` keeps (m, dim), and Δ agrees with the reference's."""
    _, tdata, _, tparams = small_task()
    layout = flat.LayoutTable.build(tparams)
    assert layout.dim_aligned > layout.dim  # the small task has pad columns
    seen = []
    delta_of = similarity.pairwise_delta
    monkeypatch.setattr(similarity, "pairwise_delta", lambda g: seen.append(g) or delta_of(g))
    got = ucfl.compute_collaboration(lenet.apply_stacked, tparams, tdata,
                                     var_batch_size=VAR_BATCH)
    (rows,) = seen
    m = tdata.num_clients
    assert tuple(rows.shape) == (m, layout.dim_aligned) and rows.is_contiguous()
    assert torch.equal(rows[:, layout.dim:], torch.zeros(m, layout.dim_aligned - layout.dim))
    assert tuple(got["full_grads"].shape) == (m, layout.dim)
    assert torch.equal(got["full_grads"], rows[:, :layout.dim])
    want = reference_collaboration()
    gram_diag = float(np.max(np.sum(n(want["full_grads"]) ** 2, axis=1)))
    np.testing.assert_allclose(n(got["delta"]), n(want["delta"]), atol=1e-5 * gram_diag)


@pytest.mark.parametrize("m,seed", [(5, 0), (16, 3)])
def test_mixing_weights_match_reference(m, seed):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(m, 40)).astype(np.float32)
    delta = np.asarray(ref_sim.pairwise_delta(f32(g), impl="ref"))
    sig = rng.uniform(0.5, 3.0, size=m).astype(np.float32)
    sig[0] = 0.0  # σ→0 branch: that client trains locally
    nn = rng.integers(50, 200, size=m).astype(np.float32)
    want = ref_sim.mixing_weights(f32(delta), f32(sig), f32(nn))
    got = similarity.mixing_weights(t(delta), t(sig), t(nn))
    np.testing.assert_allclose(n(got), n(want), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(n(got)[0], np.eye(m)[0], atol=0)
    np.testing.assert_allclose(n(got).sum(axis=1), 1.0, atol=1e-6)


def test_mixing_weights_homogeneous_clients_give_fedavg():
    m = 6
    got = similarity.mixing_weights(torch.zeros(m, m), torch.ones(m), torch.full((m,), 100.0))
    np.testing.assert_allclose(n(got), 1.0 / m, atol=1e-7)


def test_sigma_sq_matches_reference():
    rng = np.random.default_rng(4)
    mb = rng.normal(size=(3, 5, 11)).astype(np.float32)
    full = mb.mean(axis=1)
    want = jax.vmap(ref_sim.sigma_sq)(f32(mb), f32(full))
    np.testing.assert_allclose(n(similarity.sigma_sq(t(mb), t(full))), n(want), rtol=1e-5)


def _blobs(seed=0, m=24, f=8, k=4):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=4.0, size=(k, f))
    return (centers[np.arange(m) % k] + rng.normal(size=(m, f))).astype(np.float32)


@pytest.mark.parametrize("k", [2, 4])
def test_kmeans_from_reference_seeds_matches(k):
    pts = _blobs()
    key = jax.random.PRNGKey(11)
    want = ref_clustering.kmeans(key, f32(pts), k)
    seeds = jax.jit(ref_clustering._plusplus_init, static_argnums=2)(key, f32(pts), k)
    got = clustering.kmeans(None, t(pts), k, init_centroids=t(seeds))
    np.testing.assert_array_equal(n(got.labels), n(want.labels))
    np.testing.assert_allclose(n(got.centroids), n(want.centroids), atol=1e-5)
    np.testing.assert_allclose(float(got.inertia), float(want.inertia), rtol=1e-5)


def test_kmeans_plusplus_and_silhouette_and_alg2():
    pts = t(_blobs(m=20, k=4))
    gen = torch.Generator().manual_seed(0)
    res = clustering.kmeans(gen, pts, 4)
    # the blobs are 4 well-separated groups i % 4
    labels = n(res.labels)
    assert len({tuple(np.nonzero(labels == c)[0] % 4) for c in range(4)}) == 4
    want = ref_clustering.silhouette_score(f32(n(pts)), jnp.asarray(labels))
    np.testing.assert_allclose(float(clustering.silhouette_score(pts, res.labels)),
                               float(want), atol=1e-5)
    best, results = clustering.choose_num_streams(gen, pts, k_max=6)
    assert best == 4 and sorted(results) == [2, 3, 4, 5, 6]


def test_kmeans_empty_cluster_keeps_its_centroid():
    pts = torch.tensor([[0.0, 0.0], [0.1, 0.0], [0.0, 0.1]])
    init = torch.tensor([[0.0, 0.0], [50.0, 50.0]])
    res = clustering.kmeans(None, pts, 2, iters=3, init_centroids=init)
    np.testing.assert_array_equal(n(res.centroids)[1], [50.0, 50.0])
    np.testing.assert_array_equal(n(res.labels), 0)


@pytest.mark.parametrize("rule", ["user_centric", "mix_centroids", "fedavg"])
def test_mix_tree_hands_bf16_leaves_to_the_kernel_unconverted(monkeypatch, rule):
    """Each leaf reaches ops.mix_aggregate as its (m, numel) view in its
    storage dtype where the kernel takes it (bf16, f32), and the result is
    bit for bit the former f32 copy's mix cast back; a dtype the kernel
    does not take (f16) is still mixed through an f32 copy."""
    from repro_torch.kernels import ops, ref
    rng = np.random.default_rng(11)
    m = 4
    tree = {"a": torch.tensor(rng.normal(size=(m, 6, 5)).astype(np.float32)).to(torch.bfloat16),
            "b": torch.tensor(rng.normal(size=(m, 9)).astype(np.float32)),
            "c": torch.tensor(rng.normal(size=(m, 7)).astype(np.float32)).to(torch.float16)}
    w = torch.tensor(rng.dirichlet(np.ones(m), size=m).astype(np.float32))
    labels = torch.tensor([0, 1, 1, 0], dtype=torch.int32)
    rules = torch.tensor(rng.dirichlet(np.ones(m), size=2).astype(np.float32))
    seen = []
    real = ops.mix_aggregate
    monkeypatch.setattr(ops, "mix_aggregate",
                        lambda w_, x, **kw: seen.append((x.dtype, x.dim())) or real(w_, x, **kw))
    if rule == "user_centric":
        got, mix = aggregation.user_centric(tree, w), w
    elif rule == "mix_centroids":
        got, mix = aggregation.mix_centroids(tree, rules, labels), rules
    else:
        got, mix = aggregation.fedavg(tree, torch.ones(m)), torch.full((1, m), 1.0 / m)
    assert seen == [(torch.bfloat16, 2), (torch.float32, 2), (torch.float32, 2)]
    for key, x in tree.items():
        before = ref.mix_aggregate(mix, x.reshape(m, -1).float()).to(x.dtype)
        if rule == "mix_centroids":
            before = before[labels.long()]
        elif rule == "fedavg":
            before = before.expand(m, -1)
        assert got[key].dtype == x.dtype and got[key].shape == x.shape
        assert torch.equal(got[key].reshape(m, -1), before), key


def test_dense_rules_match_reference():
    rng = np.random.default_rng(5)
    m, k = 7, 3
    tree = {"a": rng.normal(size=(m, 4, 3)).astype(np.float32),
            "b": rng.normal(size=(m, 5)).astype(np.float32)}
    w = rng.uniform(size=(m, m)).astype(np.float32)
    w /= w.sum(axis=1, keepdims=True)
    labels = np.array([0, 1, 2, 0, 1, 2, 0], np.int32)
    rtree = {kk: f32(v) for kk, v in tree.items()}
    ttree = {kk: t(v) for kk, v in tree.items()}
    nn = np.arange(1, m + 1).astype(np.float32)
    cases = [
        (ref_agg.user_centric(rtree, f32(w)), aggregation.user_centric(ttree, t(w))),
        (ref_agg.clustered(rtree, f32(w), jnp.asarray(labels), k),
         aggregation.clustered(ttree, t(w), t(labels), k)),
        (ref_agg.fedavg(rtree, f32(nn)), aggregation.fedavg(ttree, t(nn))),
    ]
    for want, got in cases:
        for kk in tree:
            np.testing.assert_allclose(n(got[kk]), n(want[kk]), rtol=1e-5, atol=1e-6)
    # a slab mixes in one launch to what the per-leaf mix gives
    slab = np.concatenate([tree["a"].reshape(m, -1), tree["b"]], axis=1)
    got_slab = aggregation.clustered(t(slab), t(w), t(labels), k)
    want = ref_agg.clustered(rtree, f32(w), jnp.asarray(labels), k)
    np.testing.assert_allclose(n(got_slab), np.concatenate(
        [n(want["a"]).reshape(m, -1), n(want["b"])], axis=1), rtol=1e-5, atol=1e-6)
    z = np.array([[1.0, 3.0], [0.0, 0.0]], np.float32)
    np.testing.assert_array_equal(n(aggregation.renormalize_rows(t(z))),
                                  n(ref_agg.renormalize_rows(f32(z))))
