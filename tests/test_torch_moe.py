"""The port's MoE layer (``repro_torch.models.moe``) against the reference's,
on the CPU.

The same numpy weights and tokens go through ``repro.models.moe`` (jit, f32)
and the port; the port runs m clients at once, so one model is m = 1 and
the client fold is held against m separate reference calls. The router is
drawn wider than its init (N(0, 1)/√D · 3) so the top-k choices are far
from ties and the experts' loads uneven.

Tolerances (f32, sums in another order): y atol 1e-5 on outputs of about
1; aux atol 1e-6 on values near 1; each client's count of dropped
assignments (``moe.dropped``) exactly, and at a capacity that drops, the
port's y within 1e-5 of the reference's while it is far (> 1e-2) from the
drop-free output.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as ref_moe
from repro_torch import interop
from repro_torch.models import moe
from torch_parity import CPU, jax_tree, n, np_tree, t

Y_TOL = dict(rtol=0, atol=1e-5)
AUX_TOL = dict(rtol=0, atol=1e-6)


def cfgs(**kw):
    base = dict(d_model=32, d_ff=48, num_experts=4, top_k=2)
    base.update(kw)
    return ref_moe.MoEConfig(**base), moe.MoEConfig(**base)


def moe_params(cfg, seed=0):
    rng = np.random.default_rng(seed)
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    return {"router": (rng.normal(size=(d, e)) * 3 / d ** 0.5).astype(np.float32),
            "w_gate": (rng.normal(size=(e, d, f)) / d ** 0.5).astype(np.float32),
            "w_up": (rng.normal(size=(e, d, f)) / d ** 0.5).astype(np.float32),
            "w_down": (rng.normal(size=(e, f, d)) / f ** 0.5).astype(np.float32)}


def tokens_x(shape, d, seed=1):
    return np.random.default_rng(seed).normal(size=shape + (d,)).astype(np.float32)


def port(p, m=None):
    """numpy params -> the port's (m, ...) leaves (m = 1 when p has no client axis)."""
    tp = interop.transformer_params_from_numpy(p, device=CPU)
    return tp if m else {k: v[None] for k, v in tp.items()}


def ref_apply(rcfg, p, x):
    return jax.jit(functools.partial(ref_moe.apply, cfg=rcfg))(jax_tree(p), jnp.asarray(x))


def ref_drops(rcfg, p, x):
    """The reference's dropped assignments, counted from its router's ids
    with its own sort and capacity (numpy)."""
    xt = x.reshape(-1, rcfg.d_model)
    logits = xt @ p["router"]
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    _, ids = jax.lax.top_k(jnp.asarray(probs), rcfg.top_k)
    flat = np.asarray(ids).reshape(-1)
    s_ids = flat[np.argsort(flat, kind="stable")]
    seg = np.searchsorted(s_ids, np.arange(rcfg.num_experts), side="left")
    slot = np.arange(flat.size) - seg[s_ids]
    return int((slot >= ref_moe.capacity(xt.shape[0], rcfg)).sum())


# ------------------------------------------------------------------ capacity
@pytest.mark.parametrize("tokens", [0, 1, 5, 8, 63, 64, 100, 1000, 2048])
@pytest.mark.parametrize("e,k,cf", [(4, 2, 1.25), (8, 2, 1.25), (384, 8, 1.25), (8, 2, 4.0),
                                    (6, 1, 0.3)])
def test_capacity_matches_reference(tokens, e, k, cf):
    rcfg, pcfg = cfgs(num_experts=e, top_k=k, capacity_factor=cf)
    got = moe.capacity(tokens, pcfg)
    assert got == ref_moe.capacity(tokens, rcfg)
    assert got % 8 == 0 and got >= 8


def test_capacity_at_mixtral_prefill():
    """mixtral-8x7b's prefill of 2 requests x 1,024 tokens a client: C = 640."""
    _, pcfg = cfgs(d_model=4096, d_ff=14336, num_experts=8, top_k=2)
    assert moe.capacity(2 * 1024, pcfg) == 640


# ------------------------------------------------------------------ apply
@pytest.mark.parametrize("cf,softcap", [(2.0, None), (1.25, None), (0.5, None), (0.5, 2.0)])
def test_apply_matches_reference(cf, softcap):
    """y, aux and the dropped count of one model (m = 1); cf 0.5 drops."""
    rcfg, pcfg = cfgs(capacity_factor=cf, router_softcap=softcap)
    p = moe_params(rcfg)
    x = tokens_x((2, 24), rcfg.d_model)
    want_y, want_aux = ref_apply(rcfg, p, x)
    got_y, got_aux = moe.apply(port(p), t(x)[None], pcfg)
    np.testing.assert_allclose(n(got_y[0]), n(want_y), **Y_TOL)
    np.testing.assert_allclose(float(got_aux[0]), float(want_aux), **AUX_TOL)
    got_drops = int(moe.dropped(port(p), t(x)[None], pcfg)[0])
    if softcap is None:
        assert got_drops == ref_drops(rcfg, p, x)
    if cf == 0.5:  # the drops matter: far from the output with every assignment kept
        assert got_drops > 0
        free, _ = ref_apply(cfgs(capacity_factor=4.0, router_softcap=softcap)[0], p, x)
        assert np.abs(n(got_y[0]) - n(free)).max() > 1e-2


def test_apply_reference_matches_reference():
    rcfg, pcfg = cfgs(num_experts=6, top_k=3)
    p = moe_params(rcfg, seed=3)
    x = tokens_x((3, 10), rcfg.d_model, seed=4)
    want = jax.jit(functools.partial(ref_moe.apply_reference, cfg=rcfg))(jax_tree(p),
                                                                         jnp.asarray(x))
    got = moe.apply_reference(port(p), t(x)[None], pcfg)
    np.testing.assert_allclose(n(got[0]), n(want), **Y_TOL)
    # with capacity to spare, the sort dispatch equals the oracle
    roomy = cfgs(num_experts=6, top_k=3, capacity_factor=6 / 3)[1]
    y, _ = moe.apply(port(p), t(x)[None], roomy)
    np.testing.assert_allclose(n(y[0]), n(want), **Y_TOL)


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_client_fold_matches_separate_reference_calls(cf):
    """m = 3 clients in one call (one sort, one (m·E, C + 1, D) buffer)
    against three reference calls: each client's segment keeps its own
    order, so the same assignments drop, and C is one client's."""
    rcfg, pcfg = cfgs(capacity_factor=cf)
    ps = [moe_params(rcfg, seed=10 + i) for i in range(3)]
    xs = [tokens_x((2, 16), rcfg.d_model, seed=20 + i) for i in range(3)]
    stacked = {k: np.stack([p[k] for p in ps]) for k in ps[0]}
    y, aux = moe.apply(port(stacked, m=3), t(np.stack(xs)), pcfg)
    drops = moe.dropped(port(stacked, m=3), t(np.stack(xs)), pcfg)
    for i in range(3):
        want_y, want_aux = ref_apply(rcfg, ps[i], xs[i])
        np.testing.assert_allclose(n(y[i]), n(want_y), err_msg=f"client {i}", **Y_TOL)
        np.testing.assert_allclose(float(aux[i]), float(want_aux), **AUX_TOL)
        assert int(drops[i]) == ref_drops(rcfg, ps[i], xs[i])
    if cf == 0.5:
        assert int(drops.sum()) > 0


def test_experts_of_a_stacked_group_view():
    """A group's view of stacked blocks (m, G, E, D, F)[:, g] does not fold
    client and expert into one batch stride: the per-client products give
    the bits of the folded ones."""
    _, pcfg = cfgs()
    p = moe_params(pcfg)
    stacked = {k: np.stack([np.stack([v, v * 0.5]), np.stack([v * 0.9, v])]) for k, v in
               p.items()}  # (m=2, G=2, ...)
    tp = interop.transformer_params_from_numpy(stacked, device=CPU)
    view = {k: v[:, 1] for k, v in tp.items()}
    contiguous = {k: v.contiguous() for k, v in view.items()}
    assert view["w_gate"].stride(0) != view["w_gate"].shape[1] * view["w_gate"].stride(1)
    x = t(tokens_x((2, 2, 8), pcfg.d_model))
    y0, a0 = moe.apply(view, x, pcfg)
    y1, a1 = moe.apply(contiguous, x, pcfg)
    assert torch.equal(y0, y1) and torch.equal(a0, a1)


def test_gradients_match_reference():
    """d(sum(y · r) + aux)/d(params, x) against ``jax.grad``, at a capacity
    that drops: 1e-4 of each leaf's largest gradient."""
    rcfg, pcfg = cfgs(capacity_factor=0.75)
    p = moe_params(rcfg, seed=5)
    x = tokens_x((2, 12), rcfg.d_model, seed=6)
    r = np.random.default_rng(7).normal(size=x.shape).astype(np.float32)

    def ref_obj(p, x):
        y, aux = ref_moe.apply(p, x, rcfg)
        return jnp.sum(y * r) + aux

    want = jax.jit(jax.grad(ref_obj, argnums=(0, 1)))(jax_tree(p), jnp.asarray(x))
    tp = {k: v.requires_grad_(True) for k, v in port(p).items()}
    tx = t(x)[None].requires_grad_(True)
    y, aux = moe.apply(tp, tx, pcfg)
    (torch.sum(y[0] * t(r)) + aux[0]).backward()
    for k in p:
        w = n(want[0][k])
        np.testing.assert_allclose(n(tp[k].grad[0]), w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=k)
    w = n(want[1])
    np.testing.assert_allclose(n(tx.grad[0]), w, rtol=0, atol=1e-4 * np.abs(w).max())


def test_bf16_keeps_the_router_f32():
    _, pcfg = cfgs()
    p = moe.init(torch.Generator().manual_seed(0), pcfg, torch.bfloat16, CPU)
    assert p["router"].dtype == torch.float32 and p["w_gate"].dtype == torch.bfloat16
    x = torch.randn(1, 2, 8, pcfg.d_model, generator=torch.Generator().manual_seed(1))
    y, aux = moe.apply({k: v[None] for k, v in p.items()}, x.to(torch.bfloat16), pcfg)
    assert y.dtype == torch.bfloat16 and aux.dtype == torch.float32
    assert bool(torch.isfinite(y.float()).all())


def test_init_matches_reference_shapes_and_dtypes():
    rcfg, pcfg = cfgs(num_experts=5, d_ff=24)
    want = np_tree(ref_moe.init(jax.random.PRNGKey(0), rcfg, jnp.bfloat16))
    got = moe.init(torch.Generator().manual_seed(0), pcfg, torch.bfloat16, CPU)
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in got.items()} == {
        k: (v.shape, "torch.float32" if v.dtype == np.float32 else "torch.bfloat16")
        for k, v in want.items()}


def test_expert_parallel_waits_for_the_mesh():
    """Expert parallelism no longer waits for a mesh: on a one-rank (1, 1)
    rank mesh (no process group) the port's ``apply_expert_parallel``
    equals the reference's on a (1, 1) jax mesh; ``apply_auto`` takes it exactly when a mesh is set and the config names
    an expert axis, and the sort dispatch otherwise. (Meshes of several
    ranks: ``tests/test_torch_ep.py``.)"""
    from jax.sharding import AxisType
    from repro_torch.launch import mesh as rank_mesh
    rcfg, pcfg = cfgs(ep_axis="data")
    p = moe_params(pcfg)
    x = tokens_x((2, 16), pcfg.d_model)
    jmesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    ref_moe.set_ep_mesh(jmesh)
    try:
        want_y, want_aux = jax.jit(lambda p, x: ref_moe.apply_expert_parallel(p, x, rcfg))(
            jax_tree(p), jnp.asarray(x))
    finally:
        ref_moe.set_ep_mesh(None)
    tp, tx = port(p), t(x)[None]
    moe.set_ep_mesh(rank_mesh.make_host_mesh())
    try:
        y, aux = moe.apply_auto(tp, tx, pcfg)
        plain_cfg = moe.MoEConfig(**{**pcfg.__dict__, "ep_axis": None})
        y_plain, _ = moe.apply_auto(tp, tx, plain_cfg)  # no expert axis: the sort dispatch
    finally:
        moe.set_ep_mesh(None)
    np.testing.assert_allclose(n(y[0]), np.asarray(want_y), **Y_TOL)
    np.testing.assert_allclose(float(aux[0]), float(want_aux), **AUX_TOL)
    want_plain, _ = moe.apply(tp, tx, pcfg)
    assert torch.equal(y_plain, want_plain)
    y, aux = moe.apply_auto(tp, tx, pcfg)  # no mesh: the sort dispatch
    want_y, want_aux = moe.apply(tp, tx, pcfg)
    assert torch.equal(y, want_y) and torch.equal(aux, want_aux)
