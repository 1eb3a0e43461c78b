"""The port's federated LM training path against the reference, on the CPU.

``transformer.loss_fn``, the per-client gradients, ``build_train_step``
with each of its four mixes and the ``fedsgd_sharded`` regime, against
``repro.models.transformer.loss_fn`` under ``vmap(value_and_grad)`` and
``repro.launch.steps.build_train_step``, from the same numpy params
(the reference's init, perturbed) and tokens. Reduced configurations are
f32 on both sides; the port's attention runs through its plain version,
the reference's through ``_attend``.

Tolerances (f32, sums in another order, two layers and a 512-wide
read-out): losses atol 1e-5 on values near ln(V) ≈ 6; gradients atol 1e-5,
C2's LeNet gradient tolerance; params and momentum after 3 SGD steps
(lr 0.1, β 0.9) and their mixes atol 1e-5, tighter than C2's 1e-4 for the
slab after two rounds. Remat changes no bit of the loss or the gradients.
The flash Function's backward equals plain autograd to 1e-6 (both are the
plain version's gradient, in f32).
"""
import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.launch import steps as ref_steps
from repro.models import transformer as ref_transformer
from repro.optim import sgd_init as ref_sgd_init
from repro_torch import configs, interop
from repro_torch.federated import mesh as mesh_lib
from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import ops, ref
from repro_torch.launch import steps, train
from repro_torch.models import registry, transformer
from repro_torch.optim import sgd_init
from torch_parity import (CPU, assert_tree_close, jax_tree, n, np_tree, perturbed,
                          stack_clients, t)

LOSS_TOL = dict(rtol=0, atol=1e-5)
GRAD_TOL = dict(rtol=0, atol=1e-5)
STEP_TOL = dict(rtol=0, atol=1e-5)
ARCHS = ("stablelm-1.6b", "qwen2-7b")
M = 3


def cfgs(arch, **over):
    return ref_configs.get(arch).reduced(**over), configs.get(arch).reduced(**over)


@functools.lru_cache(maxsize=None)
def client_params(arch, m=M, seed=0):
    """numpy params of m clients: the reference's reduced init, each client
    perturbed on its own."""
    rcfg, _ = cfgs(arch)
    p0 = np_tree(jax.jit(functools.partial(ref_transformer.init, cfg=rcfg))(
        jax.random.PRNGKey(seed)))
    return stack_clients([perturbed(p0, np.random.default_rng(seed + 100 + i))
                          for i in range(m)])


def lm_batch(rcfg, lead, seq=12, seed=5):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, rcfg.vocab_size, size=lead + (seq + 1,)).astype(np.int32)
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


def torch_batch(b):
    return {k: t(v).long() for k, v in b.items()}


def port_loss_and_grads(pcfg, params, batch):
    p = transformer.tree_map(lambda x: x.detach().requires_grad_(True), params)
    loss = transformer.loss_fn(p, batch, pcfg)
    grads = torch.autograd.grad(loss.sum(), transformer.leaves(p))
    return loss, dict(zip(transformer.leaves(p), grads)), p


def grads_tree(p, grads):
    return transformer.tree_map(lambda x: grads[x], p)


# ------------------------------------------------------------------ loss
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_per_client_grads_match_reference(arch):
    rcfg, pcfg = cfgs(arch)
    p = client_params(arch)
    b = lm_batch(rcfg, (M, 2))
    want_loss, want_grads = jax.jit(jax.vmap(jax.value_and_grad(
        functools.partial(ref_transformer.loss_fn, cfg=rcfg))))(jax_tree(p), jax_tree(b))
    tp = interop.transformer_params_from_numpy(p, device=CPU)
    loss, grads, tracked = port_loss_and_grads(pcfg, tp, torch_batch(b))
    assert tuple(loss.shape) == (M,)
    np.testing.assert_allclose(n(loss), n(want_loss), **LOSS_TOL)
    assert_tree_close(grads_tree(tracked, grads), np_tree(want_grads), **GRAD_TOL)
    # one model through the registry's bundle: the reference's Model.loss
    one = transformer.tree_map(lambda x: x[1], tp)
    got = registry.build(pcfg).loss(one, {k: v[1] for k, v in torch_batch(b).items()})
    np.testing.assert_allclose(float(got), float(want_loss[1]), **LOSS_TOL)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_changes_no_bit(policy):
    _, pcfg = cfgs("stablelm-1.6b")
    rcfg = ref_configs.get("stablelm-1.6b").reduced()
    tp = interop.transformer_params_from_numpy(client_params("stablelm-1.6b"), device=CPU)
    b = torch_batch(lm_batch(rcfg, (M, 2)))
    loss0, g0, p0 = port_loss_and_grads(pcfg, tp, b)
    on = dataclasses.replace(pcfg, remat=True, remat_policy=policy)
    calls = []
    real = torch.utils.checkpoint.checkpoint
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(transformer, "checkpoint", lambda *a, **k: calls.append(1) or real(*a, **k))
        loss1, g1, p1 = port_loss_and_grads(on, tp, b)
    assert len(calls) == pcfg.num_groups  # one checkpoint a layer group
    assert torch.equal(loss0, loss1)
    for a, c in zip(transformer.leaves(p0), transformer.leaves(p1)):
        assert torch.equal(g0[a], g1[c])


def test_remat_save_moe_raises_and_inference_skips_checkpoint():
    """remat_policy="save_moe" keeps the MoE layers' tensors; on the dense
    family, which has none, it no longer raises and gives the loss and
    gradients of "full" bit for bit, one checkpoint a group (the MoE
    family's case is ``tests/test_torch_families.py``). Params that need
    no gradient take no checkpoint and give the same logits."""
    _, pcfg = cfgs("stablelm-1.6b")
    tp = interop.transformer_params_from_numpy(client_params("stablelm-1.6b"), device=CPU)
    rcfg = ref_configs.get("stablelm-1.6b").reduced()
    b = torch_batch(lm_batch(rcfg, (M, 2)))
    full = port_loss_and_grads(dataclasses.replace(pcfg, remat=True), tp, b)
    on = dataclasses.replace(pcfg, remat=True, remat_policy="save_moe")
    calls = []
    real = torch.utils.checkpoint.checkpoint
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(transformer, "checkpoint", lambda *a, **k: calls.append(1) or real(*a, **k))
        saved = port_loss_and_grads(on, tp, b)
    assert len(calls) == pcfg.num_groups
    assert torch.equal(full[0], saved[0])
    for a, c in zip(transformer.leaves(full[2]), transformer.leaves(saved[2])):
        assert torch.equal(full[1][a], saved[1][c])
    np.testing.assert_array_equal(n(transformer.forward(tp, b, on)),
                                  n(transformer.forward(tp, b, pcfg)))


# ------------------------------------------------------------ train step
def _mix_inputs(agg, m=M, seed=3):
    rng = np.random.default_rng(seed)
    if agg == "user_centric":
        w = rng.uniform(0.1, 1.0, size=(m, m)).astype(np.float32)
        w /= w.sum(axis=1, keepdims=True)
        return (jnp.asarray(w),), (t(w),)
    if agg == "clustered":
        cw = rng.uniform(0.1, 1.0, size=(2, m)).astype(np.float32)
        cw /= cw.sum(axis=1, keepdims=True)
        labels = np.array([1, 0, 1][:m], np.int32)
        return ((jnp.asarray(cw), jnp.asarray(labels)),), ((t(cw), t(labels)),)
    return ((),), ((),)


@pytest.mark.parametrize("agg", ["user_centric", "clustered", "fedavg", "local"])
def test_train_step_matches_reference_over_3_steps(agg):
    arch = "stablelm-1.6b"
    rcfg, pcfg = cfgs(arch)
    p = client_params(arch)
    (rmix,), (tmix,) = _mix_inputs(agg)
    rstep = jax.jit(ref_steps.build_train_step(rcfg, n_clients=M, agg=agg, lr=0.1, momentum=0.9))
    step = steps.build_train_step(pcfg, n_clients=M, agg=agg, lr=0.1, momentum=0.9)
    rparams = jax_tree(p)
    ropt = ref_sgd_init(rparams, momentum=0.9)
    tparams = interop.transformer_params_from_numpy(p, device=CPU)
    topt = sgd_init(tparams, momentum=0.9)
    for s in range(3):
        b = lm_batch(rcfg, (M, 2), seed=20 + s)
        rparams, ropt, rm = rstep(rparams, ropt, rmix, jax_tree(b))
        tparams, topt, tm = step(tparams, topt, tmix, torch_batch(b))
        np.testing.assert_allclose(float(tm["loss"]), float(rm["loss"]), **LOSS_TOL)
    assert_tree_close(tparams, np_tree(rparams), **STEP_TOL)
    assert_tree_close(topt, np_tree(ropt), **STEP_TOL)
    if agg == "fedavg":  # every client holds the mean
        for x in transformer.leaves(tparams):
            assert torch.equal(x[0], x[1]) and torch.equal(x[1], x[2])


def test_fedsgd_sharded_step_matches_reference_over_3_steps():
    rcfg, pcfg = cfgs("qwen2-7b", regime="fedsgd_sharded")
    p = {k: v for k, v in client_params("qwen2-7b", m=1).items()}
    one = transformer.tree_map(lambda x: x[0], p)
    rstep = jax.jit(ref_steps.build_train_step(rcfg, n_clients=1, agg="fedavg", lr=0.1,
                                               momentum=0.9))
    step = steps.build_train_step(pcfg, n_clients=1, agg="fedavg", lr=0.1, momentum=0.9)
    rparams, tparams = jax_tree(one), interop.transformer_params_from_numpy(one, device=CPU)
    ropt, topt = ref_sgd_init(rparams, momentum=0.9), sgd_init(tparams, momentum=0.9)
    for s in range(3):
        b = lm_batch(rcfg, (4,), seed=30 + s)
        rparams, ropt, rm = rstep(rparams, ropt, jax_tree(b))
        tparams, topt, tm = step(tparams, topt, torch_batch(b))
        np.testing.assert_allclose(float(tm["loss"]), float(rm["loss"]), **LOSS_TOL)
    assert_tree_close(tparams, np_tree(rparams), **STEP_TOL)


def test_train_step_mixes_on_the_mix_op_one_launch_a_leaf(monkeypatch):
    """Each mixing agg calls ops.mix_aggregate once a leaf on the leaf's
    (m, numel) view in its storage dtype (f32 here; a bf16 model's leaves
    in bf16, with no f32 copy), W rounded to the leaf's dtype; local
    never."""
    _, pcfg = cfgs("stablelm-1.6b")
    rcfg = ref_configs.get("stablelm-1.6b").reduced()
    tp = interop.transformer_params_from_numpy(client_params("stablelm-1.6b"), device=CPU)
    nleaves = len(transformer.leaves(tp))
    calls = []
    real = ops.mix_aggregate
    monkeypatch.setattr(ops, "mix_aggregate",
                        lambda w, x, **k: calls.append((tuple(w.shape), x.dtype, x.dim()))
                        or real(w, x, **k))
    b = torch_batch(lm_batch(rcfg, (M, 1)))
    for agg, k in (("user_centric", M), ("clustered", 2), ("fedavg", 1), ("local", None)):
        calls.clear()
        (_,), (mix,) = _mix_inputs(agg)
        step = steps.build_train_step(pcfg, n_clients=M, agg=agg)
        step(tp, sgd_init(tp, momentum=0.9), mix, b)
        want = [] if k is None else [((k, M), torch.float32, 2)] * nleaves
        assert calls == want, agg
    # a bf16 model: W rounded to bf16, each leaf mixed in bf16 (f32 sums),
    # the bits of the former f32 copy's mix cast back
    bcfg = dataclasses.replace(pcfg, param_dtype="bfloat16", act_dtype="bfloat16")
    bf = transformer.tree_map(lambda x: x.to(torch.bfloat16), tp)
    w = torch.full((M, M), 1.0 / 3)
    calls.clear()
    mixed, _, _ = steps.build_train_step(bcfg, n_clients=M, agg="user_centric", lr=0.0,
                                         momentum=0.0)(bf, (), w, b)
    x = bf["lm_head"]["w"]
    want = (w.to(torch.bfloat16).float() @ x.reshape(M, -1).float()).to(torch.bfloat16)
    assert torch.equal(mixed["lm_head"]["w"].reshape(M, -1), want)
    assert calls == [((M, M), torch.bfloat16, 2)] * nleaves


def test_train_step_refusals():
    """An unknown agg raises ValueError and a mix placement that is no mesh
    TypeError; a one-rank client mesh as ``mix_gather_shardings`` places
    the mix on the rank itself and gives the unsharded step's bits for
    each agg (the placement over 2 ranks: ``tests/test_torch_ep.py``)."""
    _, pcfg = cfgs("stablelm-1.6b")
    with pytest.raises(TypeError, match="mesh that holds the clients"):
        steps.build_train_step(pcfg, n_clients=2, agg="fedavg", mix_gather_shardings=object())
    with pytest.raises(ValueError):
        steps.build_train_step(pcfg, n_clients=2, agg="mean")
    rcfg = ref_configs.get("stablelm-1.6b").reduced()
    tp = interop.transformer_params_from_numpy(client_params("stablelm-1.6b"), device=CPU)
    b = torch_batch(lm_batch(rcfg, (M, 1)))
    for agg in steps.AGGS:
        (_,), (mix,) = _mix_inputs(agg)
        plain = steps.build_train_step(pcfg, n_clients=M, agg=agg)(
            tp, sgd_init(tp, momentum=0.9), mix, b)
        placed = steps.build_train_step(pcfg, n_clients=M, agg=agg,
                                        mix_gather_shardings=mesh_lib.resolve(1))(
            tp, sgd_init(tp, momentum=0.9), mix, b)
        assert torch.equal(placed[2]["loss"], plain[2]["loss"]), agg
        assert all(torch.equal(x, y) for x, y in zip(transformer.leaves(placed[0]),
                                                      transformer.leaves(plain[0]))), agg


# --------------------------------------------------- the flash Function
def _qkv(dtype=torch.float32, seed=0, shape=(2, 4, 2, 24, 24, 16)):
    b, hq, hkv, sq, sk, dh = shape
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(b, hq, sq, dh, generator=g, dtype=dtype).requires_grad_(),
            torch.randn(b, hkv, sk, dh, generator=g, dtype=dtype).requires_grad_(),
            torch.randn(b, hkv, sk, dh, generator=g, dtype=dtype).requires_grad_())


@pytest.mark.parametrize("causal,window,softcap", [(True, None, None), (True, 5, 20.0),
                                                   (False, None, 30.0)])
def test_flash_function_backward_equals_plain_autograd(causal, window, softcap):
    q, k, v = _qkv()
    out = flash.FlashAttentionFn.apply(q, k, v, causal, window, softcap, ref.flash_attention)
    want = ref.flash_attention(q, k, v, causal=causal, window=window, softcap=softcap)
    assert torch.equal(out, want) and out.grad_fn is not None
    g = torch.randn_like(out)
    got = torch.autograd.grad(out, (q, k, v), g)
    exp = torch.autograd.grad(want, (q, k, v), g)
    for a, e in zip(got, exp):
        np.testing.assert_allclose(n(a), n(e), rtol=0, atol=1e-6)
    # only the inputs that need a gradient get one
    q2 = q.detach()
    out = flash.FlashAttentionFn.apply(q2, k, v, causal, window, softcap, ref.flash_attention)
    gk, gv = torch.autograd.grad(out, (k, v), g)
    np.testing.assert_allclose(n(gk), n(exp[1]), rtol=0, atol=1e-6)


def test_flash_function_keeps_bf16_grads_in_the_inputs_dtype():
    q, k, v = _qkv(torch.bfloat16, seed=1)
    out = flash.FlashAttentionFn.apply(q, k, v, True, None, None, ref.flash_attention)
    gq, gk, gv = torch.autograd.grad(out.float().sum(), (q, k, v))
    assert gq.dtype == gk.dtype == gv.dtype == torch.bfloat16
    eq, ek, ev = torch.autograd.grad(ref.flash_attention(q, k, v).float().sum(), (q, k, v))
    assert torch.equal(gq, eq) and torch.equal(gk, ek) and torch.equal(gv, ev)


def test_flash_cuda_refuses_a_detached_result_under_grad():
    q, k, v = _qkv()
    with pytest.raises(RuntimeError, match="needs a gradient"):
        flash.flash_attention_cuda(q, k, v)
    assert flash.needs_grad(q, k, v)
    with torch.no_grad():
        assert not flash.needs_grad(q, k, v)
        with pytest.raises(ValueError, match="CUDA"):  # past the guard: a CPU tensor
            flash.flash_attention_cuda(q, k, v)
    assert not flash.needs_grad(q.detach(), k.detach(), v.detach())


# ------------------------------------------------------------ the driver
def test_train_main_smoke_loss_falls(capsys):
    final = train.main(["--device", "cpu", "--smoke", "--rounds", "12", "--seq", "32"])
    out = capsys.readouterr().out
    first = float(re.search(r"round\s+1 loss=([0-9.]+)", out).group(1))
    assert "collaboration matrix W:" in out
    assert np.isfinite(final) and final < first, (first, final)


def test_collaboration_round_on_lm_grads_is_row_stochastic(monkeypatch):
    _, pcfg = cfgs("stablelm-1.6b", vocab_size=64)
    gen = torch.Generator().manual_seed(0)
    params = train.client_params(pcfg, 4, gen, CPU)
    chains = train.lm_synthetic.make_group_chains(gen, 2, pcfg.vocab_size)
    g = train.partition_grads(pcfg, params, gen, chains, batch=2, seq=8)
    d = sum(x[0].numel() for x in transformer.leaves(params))
    assert tuple(g.shape) == (4, train.PARTS, ops.aligned_dim(d))
    assert bool((g[..., d:] == 0).all()) and bool((g[..., :d] != 0).any())
    whole = train.similarity.collaboration_round(g, torch.full((4,), 16.0))  # one chunk
    monkeypatch.setattr(train.similarity, "SIGMA_CHUNK", 1000)
    collab = train.similarity.collaboration_round(g, torch.full((4,), 16.0))
    np.testing.assert_allclose(n(collab["sigma_sq"]), n(whole["sigma_sq"]), rtol=1e-5)
    assert torch.equal(collab["full_grads"], whole["full_grads"])
    w = collab["W"]
    np.testing.assert_allclose(n(w.sum(dim=1)), 1.0, rtol=0, atol=1e-6)
