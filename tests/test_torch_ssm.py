"""The port's Mamba2 SSD block (``repro_torch.models.ssm``) against the
reference's, on the CPU.

Weights come from the reference's init (jit, f32), every leaf then
perturbed with numpy noise (A_log, D and dt_bias too, so the heads decay
at different rates), and go to both packages as numpy arrays; the port
runs m clients at once, so one model is m = 1.

Tolerances: ``forward``, ``decode`` and the caches within 1e-5 of the
largest magnitude of each (f32, sums in another order); chunked against
sequential in the port at the reference's own tolerances for this
identity (``tests/test_models.py``: y rtol 1e-3, atol 1e-5; h rtol 1e-4,
atol 1e-5); gradients within 1e-4 of each leaf's largest. In bf16 the
SSD's products keep f32 results: the final state within 1e-5 of its
largest against the reference's bf16 scan (a bf16-rounded product would
be off by about 2^-9 of it).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as ref_ssm
from repro_torch import interop
from repro_torch.models import ssm
from torch_parity import CPU, jax_tree, n, np_tree, perturbed, t


def cfgs(**kw):
    base = dict(d_model=16, state=8, headdim=4, expand=2, chunk=8)
    base.update(kw)
    return ref_ssm.SSMConfig(**base), ssm.SSMConfig(**base)


@functools.lru_cache(maxsize=None)
def ssm_params(d_model=16, state=8, headdim=4, seed=0):
    rcfg, _ = cfgs(d_model=d_model, state=state, headdim=headdim)
    p = np_tree(jax.jit(functools.partial(ref_ssm.init, cfg=rcfg))(jax.random.PRNGKey(seed)))
    return perturbed(p, np.random.default_rng(seed + 50), 0.3)


def port(p):
    return {k: (v[None] if not isinstance(v, dict) else {kk: vv[None] for kk, vv in v.items()})
            for k, v in interop.transformer_params_from_numpy(p, device=CPU).items()}


def x_of(shape, seed=1):
    return (0.5 * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def close(got, want, rel=1e-5, msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30), err_msg=msg)


def ref_forward(rcfg, p, x, **kw):
    return jax.jit(functools.partial(ref_ssm.forward, cfg=rcfg))(jax_tree(p), jnp.asarray(x),
                                                                 **kw)


@pytest.mark.parametrize("seq,chunk", [(12, 4), (16, 16), (32, 8), (64, 16), (8, 32)])
def test_forward_matches_reference(seq, chunk):
    rcfg, pcfg = cfgs(chunk=chunk)
    p = ssm_params()
    x = x_of((2, seq, 16))
    want_y, want_c = ref_forward(rcfg, p, x)
    got_y, got_c = ssm.forward(port(p), t(x)[None], pcfg)
    close(n(got_y[0]), want_y)
    close(n(got_c["h"][0]), want_c["h"])
    close(n(got_c["conv"][0]), want_c["conv"])


def test_forward_continues_from_a_cache():
    """``h0`` and ``conv_prev`` carry a forward on from an earlier one."""
    rcfg, pcfg = cfgs()
    p = ssm_params()
    x = x_of((2, 32, 16), seed=3)
    _, rc = ref_forward(rcfg, p, x[:, :16])
    want_y, want_c = ref_forward(rcfg, p, x[:, 16:], h0=rc["h"], conv_prev=rc["conv"])
    tp = port(p)
    _, pc = ssm.forward(tp, t(x[:, :16])[None], pcfg)
    got_y, got_c = ssm.forward(tp, t(x[:, 16:])[None], pcfg, h0=pc["h"], conv_prev=pc["conv"])
    close(n(got_y[0]), want_y)
    close(n(got_c["h"][0]), want_c["h"])


def test_decode_and_init_cache_match_reference():
    rcfg, pcfg = cfgs()
    p = ssm_params()
    x = x_of((2, 12, 16), seed=4)
    rdec = jax.jit(functools.partial(ref_ssm.decode, cfg=rcfg))
    rcache = ref_ssm.init_cache(2, rcfg)
    tcache = ssm.init_cache(1, 2, pcfg, torch.float32, CPU)
    assert {k: (tuple(v.shape[1:]), v.dtype) for k, v in tcache.items()} == {
        k: (v.shape, torch.float32) for k, v in rcache.items()}
    h_buf = tcache["h"]
    tp = port(p)
    for s in range(12):
        want, rcache = rdec(jax_tree(p), jnp.asarray(x[:, s:s + 1]), rcache)
        got, tcache = ssm.decode(tp, t(x[:, s:s + 1])[None], tcache, pcfg)
        close(n(got[0]), want, msg=f"step {s}")
    close(n(tcache["h"][0]), rcache["h"])
    close(n(tcache["conv"][0]), rcache["conv"])
    assert tcache["h"] is h_buf  # written in place
    bf = ssm.init_cache(3, 2, pcfg, torch.bfloat16, CPU)
    assert bf["h"].dtype == torch.float32 and bf["conv"].dtype == torch.bfloat16


@pytest.mark.parametrize("seq,chunk", [(12, 4), (16, 16), (32, 8)])
def test_chunked_equals_sequential_decode(seq, chunk):
    """The reference's own identity (``tests/test_models.py``), in the port."""
    _, pcfg = cfgs(chunk=chunk)
    tp = port(ssm_params())
    x = t(x_of((2, seq, 16), seed=5))[None]
    y, cache = ssm.forward(tp, x, pcfg)
    c = ssm.init_cache(1, 2, pcfg, torch.float32, CPU)
    ys = []
    for s in range(seq):
        yt, c = ssm.decode(tp, x[:, :, s:s + 1], c, pcfg)
        ys.append(yt)
    np.testing.assert_allclose(n(torch.cat(ys, dim=2)), n(y), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(n(c["h"]), n(cache["h"]), rtol=1e-4, atol=1e-5)


def test_chunk_must_divide_the_sequence():
    _, pcfg = cfgs(chunk=8)
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        ssm.forward(port(ssm_params()), t(x_of((1, 12, 16)))[None], pcfg)


@pytest.mark.parametrize("steep", [False, True])
def test_gradients_match_jax_grad(steep):
    """Gradients of sum(y · r) through the chunked SSD against
    ``jax.grad``; ``steep`` decays fast enough (A = −e³, dt ≈ 3) that the
    acausal exponents overflow: masking the exponent keeps them finite."""
    rcfg, pcfg = cfgs(chunk=8)
    p = dict(ssm_params())
    if steep:
        p["A_log"] = np.full_like(p["A_log"], 3.0)
        p["dt_bias"] = np.full_like(p["dt_bias"], 3.0)
    x = x_of((2, 16, 16), seed=6)
    r = np.random.default_rng(7).normal(size=(2, 16, 16)).astype(np.float32)

    def obj(p, x):
        return jnp.sum(ref_ssm.forward(p, x, rcfg)[0] * r)

    want = jax.jit(jax.grad(obj, argnums=(0, 1)))(jax_tree(p), jnp.asarray(x))
    tp = port(p)
    flat = [v for v in tp.values() if not isinstance(v, dict)] + list(tp["norm"].values())
    for v in flat:
        v.requires_grad_(True)
    tx = t(x)[None].requires_grad_(True)
    torch.sum(ssm.forward(tp, tx, pcfg)[0][0] * t(r)).backward()
    for k, v in tp.items():
        g, w = (v["scale"].grad, want[0][k]["scale"]) if isinstance(v, dict) else (v.grad,
                                                                                 want[0][k])
        assert bool(torch.isfinite(g).all()), k
        close(n(g[0]), np.asarray(w), rel=1e-4, msg=k)
    close(n(tx.grad[0]), np.asarray(want[1]), rel=1e-4)


def test_ssd_bf16_products_have_f32_results():
    """``_ssd_chunked`` on bf16 x, B and C: the port's final state (f32)
    within 1e-5 of the reference's, y within one bf16 step of the largest."""
    rcfg, pcfg = cfgs(chunk=16)
    rng = np.random.default_rng(8)
    r_, s, h, pdim, nn = 2, 48, 8, 4, 8
    xh = rng.normal(size=(r_, s, h, pdim)).astype(np.float32)
    b = rng.normal(size=(r_, s, nn)).astype(np.float32)
    c = rng.normal(size=(r_, s, nn)).astype(np.float32)
    dt = rng.uniform(0.05, 0.5, size=(r_, s, h)).astype(np.float32)
    a_log = rng.normal(size=(h,)).astype(np.float32) * 0.5
    bf = jnp.bfloat16
    want_y, want_h = jax.jit(functools.partial(ref_ssm._ssd_chunked, cfg=rcfg))(
        jnp.asarray(xh, bf), jnp.asarray(b, bf), jnp.asarray(c, bf), jnp.asarray(dt),
        jnp.asarray(a_log))

    def tb(a):
        return t(np.asarray(jnp.asarray(a, bf), np.float32)).to(torch.bfloat16)

    got_y, got_h = ssm._ssd_chunked(tb(xh), tb(b), tb(c), t(dt),
                                    t(np.broadcast_to(a_log, (r_, h)).copy()), pcfg)
    assert got_y.dtype == torch.bfloat16 and got_h.dtype == torch.float32
    close(n(got_h), want_h)
    want = np.asarray(want_y, np.float32)
    np.testing.assert_allclose(n(got_y.float()), want, rtol=0,
                               atol=2.0 ** -7 * np.abs(want).max())


def test_init_matches_reference_shapes_and_dtypes():
    rcfg, pcfg = cfgs(d_model=32, state=16, headdim=8)
    want = np_tree(ref_ssm.init(jax.random.PRNGKey(0), rcfg, jnp.bfloat16))
    got = ssm.init(torch.Generator().manual_seed(0), pcfg, torch.bfloat16, CPU)

    def sig(tree, fn):
        return {k: sig(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}

    assert sig(got, lambda v: (tuple(v.shape), str(v.dtype)[6:])) == sig(
        want, lambda v: (v.shape, "float32" if v.dtype == np.float32 else "bfloat16"))
