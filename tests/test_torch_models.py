"""LeNet-5, heavy-ball SGD, batching and local SGD against the reference.

Tolerances (f32 on the CPU, TF32 off): LeNet logits and gradients atol
1e-5 (both sides sum the same products in another order); one client's
local SGD from the reference's permutations atol 1e-4 (a round of 4
momentum steps carries that rounding forward); evaluation accuracy within
one test sample.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import loader as ref_loader
from repro.federated import client as ref_client
from repro.models import lenet as ref_lenet
from repro.optim import sgd as ref_sgd
from repro_torch.core import flat
from repro_torch.data import loader
from repro_torch.federated import client
from repro_torch.interop import params_from_numpy
from repro_torch.models import lenet
from repro_torch.optim import sgd
from torch_parity import (BATCH, SMALL, lenet_params, n, ref_client_permutations,
                          small_task, t)


def _params(hw, classes, seed=0):
    # non-zero biases so the bias paths are checked too
    p = lenet_params(np.random.default_rng(seed), hw, classes, bias=0.05)
    return {k: jnp.asarray(v) for k, v in p.items()}, params_from_numpy(p, device="cpu")


@pytest.mark.parametrize("hw,classes,batch", [((16, 16), 6, 5), ((28, 28), 47, 3)])
def test_lenet_logits_and_grads_match_reference(hw, classes, batch):
    rp, tp = _params(hw, classes)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(batch,) + hw + (1,)).astype(np.float32)
    y = rng.integers(0, classes, size=batch)
    np.testing.assert_allclose(n(lenet.apply(tp, t(x))),
                               n(jax.jit(ref_lenet.apply)(rp, jnp.asarray(x))), atol=1e-5, rtol=0)
    rg = jax.jit(jax.grad(ref_client.make_loss(ref_lenet.apply)))(
        rp, jnp.asarray(x), jnp.asarray(y, jnp.int32))
    tpg = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    loss = client.make_loss(lenet.apply)(tpg, t(x), t(y, np.int64))
    grads = torch.autograd.grad(loss, [tpg[k] for k in sorted(tpg)])
    for k, g in zip(sorted(tpg), grads):
        np.testing.assert_allclose(n(g), n(rg[k]), atol=1e-5, rtol=0, err_msg=k)


def test_stacked_apply_is_per_unit_apply():
    _, tp = _params((16, 16), 6)
    _, tq = _params((16, 16), 6, seed=1)
    x = torch.randn(2, 4, 16, 16, 1, generator=torch.Generator().manual_seed(0))
    stacked = {k: torch.stack([tp[k], tq[k]]) for k in tp}
    out = lenet.apply_stacked(stacked, x)
    torch.testing.assert_close(out[0], lenet.apply(tp, x[0]), atol=1e-6, rtol=0)
    torch.testing.assert_close(out[1], lenet.apply(tq, x[1]), atol=1e-6, rtol=0)


def test_lenet_init_shapes_match_reference():
    rp, _ = _params((28, 28), 47)
    tp = lenet.init(torch.Generator().manual_seed(0), device="cpu")
    assert {k: tuple(v.shape) for k, v in tp.items()} == {k: v.shape for k, v in rp.items()}
    limit = (6.0 / (25 * 1 + 6)) ** 0.5
    assert float(tp["c1_w"].abs().max()) <= limit and float(tp["c1_b"].abs().max()) == 0.0


def test_sgd_update_matches_reference():
    rng = np.random.default_rng(2)
    p, g1, g2 = (rng.normal(size=(3, 7)).astype(np.float32) for _ in range(3))
    rs = ref_sgd.sgd_init({"a": jnp.asarray(p)}, momentum=0.9)
    rp = {"a": jnp.asarray(p)}
    tp = t(p).clone()
    buf = sgd.sgd_init(tp, momentum=0.9)
    for g in (g1, g2):
        rp, rs = ref_sgd.sgd_update({"a": jnp.asarray(g)}, rs, rp, lr=0.1, momentum=0.9)
        sgd.sgd_update_(tp, t(g), buf, lr=0.1, momentum=0.9)
    np.testing.assert_allclose(n(tp), n(rp["a"]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(n(buf), n(rs["a"]), atol=1e-6, rtol=0)
    plain = t(p).clone()
    sgd.sgd_update_(plain, t(g1), sgd.sgd_init(plain, momentum=0.0), lr=0.1, momentum=0.0)
    np.testing.assert_allclose(n(plain), p - 0.1 * g1, atol=1e-7)


def test_loader_matches_reference():
    x = np.arange(11 * 2, dtype=np.float32).reshape(11, 2)
    y = np.arange(11)
    key = jax.random.PRNGKey(5)
    rx, ry = ref_loader.epoch_batches(key, jnp.asarray(x), jnp.asarray(y), 4)
    perm = np.asarray(jax.random.permutation(key, 11))
    tx, ty = loader.epoch_batches(t(perm, np.int64), t(x), t(y), 4)
    np.testing.assert_array_equal(n(tx), n(rx))
    np.testing.assert_array_equal(n(ty), n(ry))
    fx, fy = loader.fixed_partition(t(x), t(y), 3)
    gx, gy = ref_loader.fixed_partition(jnp.asarray(x), jnp.asarray(y), 3)
    np.testing.assert_array_equal(n(fx), n(gx))
    np.testing.assert_array_equal(n(fy), n(gy))
    perms = loader.draw_permutations(torch.Generator().manual_seed(0), 3, 2, 11, device="cpu")
    assert perms.shape == (3, 2, 11)
    assert all(sorted(r.tolist()) == list(range(11)) for r in perms.reshape(-1, 11))


def test_one_client_local_sgd_matches_reference():
    data, tdata, params0, tparams = small_task()
    key = jax.random.PRNGKey(9)
    epochs = 2
    local = ref_client.make_local_sgd(ref_lenet.apply, batch_size=BATCH, epochs=epochs)
    want, _ = jax.jit(local)(params0, data.x[0], data.y[0], key)
    layout = flat.LayoutTable.build(tparams)
    perms = ref_client_permutations([key], epochs, SMALL["n"], BATCH)
    run = client.make_local_sgd(lenet.apply_stacked, layout, batch_size=BATCH, epochs=epochs)
    got = run(layout.slab(tparams, 1), tdata.x[:1], tdata.y[:1], t(perms))
    np.testing.assert_allclose(n(got[0]), n(flat.LayoutTable.build(tparams).ravel(
        params_from_numpy({k: np.asarray(v) for k, v in want.items()}, device="cpu"))),
        atol=1e-4, rtol=0)


def test_chunked_federated_sgd_equals_unchunked():
    _, tdata, _, tparams = small_task()
    layout = flat.LayoutTable.build(tparams)
    slab = layout.slab(tparams, SMALL["m"])
    perms = loader.draw_permutations(torch.Generator().manual_seed(1), SMALL["m"], 1,
                                     SMALL["n"], device="cpu")
    full = client.make_federated_local_sgd(lenet.apply_stacked, layout, batch_size=BATCH)
    chunked = client.make_federated_local_sgd(lenet.apply_stacked, layout, batch_size=BATCH,
                                              chunk_size=4)
    a = full(slab, tdata.x, tdata.y, perms=perms)
    b = chunked(slab, tdata.x, tdata.y, perms=perms)
    torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(n(a)[:, layout.dim:], 0.0)
    # a one-shard mesh needs no process group and is bit for bit no mesh
    one = client.make_federated_local_sgd(lenet.apply_stacked, layout, batch_size=BATCH, mesh=1)
    assert torch.equal(one(slab, tdata.x, tdata.y, perms=perms), a)


def test_evaluate_matches_reference():
    data, tdata, params0, tparams = small_task()
    rng = np.random.default_rng(0)
    m = SMALL["m"]
    stacked = {k: np.asarray(v)[None] + 0.3 * rng.normal(size=(m,) + v.shape).astype(np.float32)
               for k, v in params0.items()}
    want = jax.jit(lambda p, x, y: ref_client.evaluate(ref_lenet.apply, p, x, y))(
        {k: jnp.asarray(v) for k, v in stacked.items()}, data.x_test, data.y_test)
    ts = {k: t(v) for k, v in stacked.items()}
    got = client.evaluate(lenet.apply_stacked, ts, tdata.x_test, tdata.y_test)
    got_chunked = client.evaluate(lenet.apply_stacked, ts, tdata.x_test, tdata.y_test, batch=4)
    np.testing.assert_allclose(n(got), n(want), atol=1.0 / SMALL["n_test"] + 1e-6)
    np.testing.assert_array_equal(n(got), n(got_chunked))
