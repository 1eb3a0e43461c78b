"""The port's optimizers and schedules against the reference, on the CPU.

Tree SGD (``repro_torch.optim.sgd_init``/``sgd_update``) with and without
momentum and weight decay, in f32 and bf16; AdamW; the constant, cosine
and warmup-cosine schedules; all from the same numpy trees. Tolerances:
f32 results within 1e-6 (elementwise ops in the same order; XLA may fuse
them into one rounding); bf16 SGD within 2^-7 relative plus 2^-9 absolute (one bf16 step of the
operands, about 1 here, where p − ηv cancels), since XLA computes a fused
bf16 chain in f32 and rounds once, where torch rounds after each op as
the reference's code is written. Schedules within
1e-6 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as ref_optim
from repro_torch import interop, optim
from repro_torch.core import pytree
from torch_parity import assert_tree_close, jax_tree, n, np_tree


def _tree(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(3, 4)).astype(dtype),
            "blocks": {"a": rng.normal(size=(2, 5)).astype(dtype),
                       "b": {"scale": rng.normal(size=(5,)).astype(dtype)}}}


def _bf16(tree):
    import ml_dtypes
    return pytree.tree_map(lambda x: x.astype(ml_dtypes.bfloat16), tree)


def _port(tree):
    return interop.transformer_params_from_numpy(tree, device="cpu")


@pytest.mark.parametrize("momentum,weight_decay", [(0.9, 0.0), (0.9, 1e-2), (0.0, 0.0),
                                                    (0.0, 5e-2)])
def test_tree_sgd_matches_reference(momentum, weight_decay):
    params, grads = _tree(0), _tree(1)
    rstate = ref_optim.sgd_init(jax_tree(params), momentum=momentum)
    tstate = optim.sgd_init(_port(params), momentum=momentum)
    if momentum == 0.0:
        assert rstate == () and tstate == ()
    rp, tp = jax_tree(params), _port(params)
    upd = jax.jit(lambda g, s, p: ref_optim.sgd_update(g, s, p, lr=0.1, momentum=momentum,
                                                       weight_decay=weight_decay))
    for s in range(3):
        g = _tree(10 + s)
        rp, rstate = upd(jax_tree(g), rstate, rp)
        tp, tstate = optim.sgd_update(_port(g), tstate, tp, lr=0.1, momentum=momentum,
                                      weight_decay=weight_decay)
    assert_tree_close(tp, np_tree(rp), rtol=0, atol=1e-6)
    if momentum:
        assert_tree_close(tstate, np_tree(rstate), rtol=0, atol=1e-6)


def test_tree_sgd_bf16_and_momentum_dtype():
    params, grads = _bf16(_tree(2)), _bf16(_tree(3))
    tstate = optim.sgd_init(_port(params), momentum=0.9)
    assert all(x.dtype == torch.bfloat16 for x in pytree.leaves(tstate))
    f32_state = optim.sgd_init(_port(params), momentum=0.9, momentum_dtype=torch.float32)
    assert all(x.dtype == torch.float32 for x in pytree.leaves(f32_state))
    rp, rs = ref_optim.sgd_update(jax_tree(grads), ref_optim.sgd_init(jax_tree(params)),
                                  jax_tree(params), lr=0.1)
    tp, ts = optim.sgd_update(_port(grads), tstate, _port(params), lr=0.1)
    for got, want in zip(pytree.leaves(tp), jax.tree.leaves(rp)):
        assert got.dtype == torch.bfloat16
        w = np.asarray(want, np.float32)
        np.testing.assert_allclose(n(got.float()), w, rtol=2**-7, atol=2**-9)
    # a step of the tensor form is the tree form's on a one-leaf tree
    p = torch.randn(6)
    g = torch.randn(6)
    buf = optim.sgd_init(p, momentum=0.9)
    want, _ = optim.sgd_update(g, buf.clone(), p.clone(), lr=0.1)
    optim.sgd_update_(p, g, buf, lr=0.1)
    torch.testing.assert_close(p, want, rtol=0, atol=1e-7)


def test_tree_sgd_does_not_write_its_inputs():
    params = _port(_tree(4))
    before = pytree.tree_map(torch.clone, params)
    state = optim.sgd_init(params)
    optim.sgd_update(_port(_tree(5)), state, params, lr=0.1, weight_decay=0.1)
    for a, b in zip(pytree.leaves(params), pytree.leaves(before)):
        assert torch.equal(a, b)
    assert all(float(x.abs().max()) == 0 for x in pytree.leaves(state))


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_adamw_matches_reference(dtype):
    params = _tree(6) if dtype == np.float32 else _bf16(_tree(6))
    rstate = ref_optim.adamw_init(jax_tree(params))
    tstate = optim.adamw_init(_port(params))
    assert tstate["count"].dtype == torch.int32 and int(tstate["count"]) == 0
    rp, tp = jax_tree(params), _port(params)
    upd = jax.jit(lambda g, s, p: ref_optim.adamw_update(g, s, p, lr=1e-2))
    for s in range(4):
        g = _tree(20 + s)
        rp, rstate = upd(jax_tree(g), rstate, rp)
        tp, tstate = optim.adamw_update(_port(g), tstate, tp, lr=1e-2)
    assert int(tstate["count"]) == int(rstate["count"]) == 4
    assert_tree_close(tstate["mu"], np_tree(rstate["mu"]), rtol=0, atol=1e-6)
    assert_tree_close(tstate["nu"], np_tree(rstate["nu"]), rtol=1e-6, atol=1e-7)
    for got, want in zip(pytree.leaves(tp), jax.tree.leaves(rp)):
        tol = 1e-6 if dtype == np.float32 else 2**-7
        np.testing.assert_allclose(n(got.float()), np.asarray(want, np.float32), rtol=tol,
                                   atol=tol * 1e-2)


@pytest.mark.parametrize("name,args", [("constant", (0.3,)), ("cosine", (0.3, 100)),
                                       ("cosine", (1.0, 7, 0.2)),
                                       ("warmup_cosine", (0.3, 10, 100)),
                                       ("warmup_cosine", (0.5, 0, 40, 0.0))])
def test_schedules_match_reference(name, args):
    rfn, tfn = getattr(ref_optim, name)(*args), getattr(optim, name)(*args)
    steps = [0, 1, 5, 9, 10, 11, 37, 99, 100, 150]
    for s in steps:
        want = float(rfn(jnp.asarray(s, jnp.float32)))
        got = tfn(s)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-9)
    got = tfn(torch.tensor(steps))
    want = np.array([float(rfn(jnp.asarray(s, jnp.float32))) for s in steps])
    np.testing.assert_allclose(n(got) * np.ones(len(steps)), want, rtol=1e-6, atol=1e-9)
