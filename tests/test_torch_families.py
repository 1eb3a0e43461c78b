"""The MoE, SSM, hybrid and VLM model families of the port's transformer
against the reference, on the CPU: reduced mixtral-8x7b (MoE, window),
kimi-k2 (MoE top-2 of 4 experts behind a dense ``first_block``,
fedsgd_sharded), mamba2-1.3b (SSM), zamba2-2.7b at 12 layers (two hybrid
groups, so the shared attention runs twice with two caches) and
internvl2-1b (VLM: 8 projected patch embeddings of width 64 before the
tokens, GQA 2 over 2 at the reduced width, qkv bias).

Weights are the reference's reduced init (jit, f32), every leaf perturbed
with numpy noise, for 2 clients (the second perturbed again), carried
across by ``interop``; tokens and the VLM's patch embeddings N(0, 1)
from numpy. The port's attention runs
through its plain ``flash_attention``.

Tolerances (f32, sums in another order through the layers and a 512-wide
read-out): logits atol 1e-4 (values up to about 5); caches 5e-5 of each
leaf's largest plus 2e-5 (zamba2's SSM states reach about 19 after seven
mamba layers, where f32 reordering leaves 1.6e-5 of an element); losses
atol 1e-5; gradients and a train step's params within 1e-4 of each
leaf's largest.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as ref_configs
from repro.launch import steps as ref_steps
from repro.models import transformer as ref_transformer
from repro.optim import sgd_init as ref_sgd_init
from repro_torch import configs, interop
from repro_torch.launch import steps
from repro_torch.models import registry, transformer
from repro_torch.optim import sgd_init
from torch_parity import (CPU, jax_tree, n, np_tree, perturbed, stack_clients, t)

LOGIT_TOL = dict(rtol=0, atol=1e-4)
LOSS_TOL = dict(rtol=0, atol=1e-5)
CACHE_REL = 5e-5
ARCHS = {"mixtral": ("mixtral-8x7b", {}), "kimi": ("kimi-k2-1t-a32b", {}),
         "mamba2": ("mamba2-1.3b", {}), "zamba2": ("zamba2-2.7b", {"num_layers": 12}),
         "internvl2": ("internvl2-1b", {})}
M = 2
SEQ = 64  # a multiple of the reduced SSD chunk (32)


def cfgs(arch, **extra):
    name, over = ARCHS[arch]
    over = dict(over, **extra)
    return ref_configs.get(name).reduced(**over), configs.get(name).reduced(**over)


@functools.lru_cache(maxsize=None)
def client_params(arch):
    rcfg, _ = cfgs(arch)
    p0 = perturbed(np_tree(jax.jit(functools.partial(ref_transformer.init, cfg=rcfg))(
        jax.random.PRNGKey(0))), np.random.default_rng(100))
    return stack_clients([p0, perturbed(p0, np.random.default_rng(101), 0.02)])


def tokens(rcfg, shape, seed):
    return np.random.default_rng(seed).integers(0, rcfg.vocab_size, size=shape).astype(np.int32)


def inputs(rcfg, tok, seed=9):
    """The forward's numpy inputs: tokens, and the VLM's patch embeddings
    (lead, P, P_in) N(0, 1)."""
    out = {"tokens": tok}
    if rcfg.family == "vlm":
        out["patch_embeds"] = np.random.default_rng(seed).normal(
            size=tok.shape[:-1] + (rcfg.num_patches, rcfg.patch_embed_dim)).astype(np.float32)
    return out


def torch_inputs(b):
    return {k: t(v) if v.dtype == np.float32 else t(v).long() for k, v in b.items()}


def shapes(tree):
    return {k: shapes(v) if isinstance(v, dict) else (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in tree.items()}


def assert_close_rel(got, want, rel, floor=0.0, path=""):
    """Every leaf within ``rel`` of its largest magnitude plus ``floor``."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got), set(want))
        for k in want:
            assert_close_rel(got[k], want[k], rel, floor, f"{path}/{k}")
        return
    w = np.asarray(want, np.float32)
    g = n(got).astype(np.float32)
    assert g.shape == w.shape, (path, g.shape, w.shape)
    np.testing.assert_allclose(g, w, rtol=0, atol=rel * np.abs(w).max() + floor, err_msg=path)


# ------------------------------------------------------------------ init
@pytest.mark.parametrize("arch", list(ARCHS))
def test_init_matches_reference_shapes(arch):
    """Leaf for leaf the reference's layout and dtypes (bf16 at full
    precision settings: the router and A_log, D, dt_bias stay f32)."""
    rcfg, pcfg = cfgs(arch, param_dtype="bfloat16", act_dtype="bfloat16")
    want = jax.eval_shape(functools.partial(ref_transformer.init, cfg=rcfg),
                          jax.random.PRNGKey(0))
    got = transformer.init(torch.Generator().manual_seed(0), pcfg, CPU)

    def ref_sig(tree):
        return {k: ref_sig(v) if isinstance(v, dict) else (tuple(v.shape), str(v.dtype))
                for k, v in tree.items()}
    assert shapes(got) == ref_sig(want)


# ------------------------------------------------------------------ serve
@pytest.mark.parametrize("arch", list(ARCHS))
def test_federated_prefill_matches_reference(arch):
    """The federated prefill step of 2 clients (every position's logits
    through ``forward``, the last through the step) and its caches: k, v of
    every attention slot, h and conv of every mamba slot, first_block's."""
    rcfg, pcfg = cfgs(arch)
    p = client_params(arch)
    b = inputs(rcfg, tokens(rcfg, (M, 2, SEQ), seed=7))
    rfwd = jax.jit(jax.vmap(functools.partial(ref_transformer.forward, cfg=rcfg,
                                              return_cache=True)))
    want, _, wcache = rfwd(jax_tree(p), jax_tree(b))
    tp = interop.transformer_params_from_numpy(p, device=CPU)
    got = transformer.forward(tp, torch_inputs(b), pcfg)
    assert got.shape[2] == SEQ + (rcfg.num_patches if rcfg.family == "vlm" else 0)
    np.testing.assert_allclose(n(got), n(want), **LOGIT_TOL)
    last, gcache = steps.build_prefill_step(pcfg, federated=True)(tp, torch_inputs(b))
    np.testing.assert_allclose(n(last), n(want)[:, :, -1:], **LOGIT_TOL)
    assert_close_rel(gcache, np_tree(wcache), CACHE_REL, 2e-5)
    assert np.abs(n(last[0]) - n(last[1])).max() > 1e-3  # the clients' models differ


@pytest.mark.parametrize("arch", list(ARCHS))
def test_federated_decode_matches_reference_teacher_forced(arch):
    """8 decode steps of 2 clients from empty caches (every slot's cache
    written in place), then one model through the registry's bundle."""
    rcfg, pcfg = cfgs(arch)
    p = client_params(arch)
    tok = tokens(rcfg, (M, 2, 8), seed=8)
    rstep = jax.jit(ref_steps.build_serve_step(rcfg, federated=True))
    rcache = jax.vmap(lambda _: ref_transformer.init_cache(rcfg, 2, 16))(jnp.arange(M))
    tp = interop.transformer_params_from_numpy(p, device=CPU)
    step = steps.build_serve_step(pcfg, federated=True)
    tcache = transformer.init_cache(pcfg, M, 2, 16, CPU)
    assert shapes(tcache) == shapes(interop.cache_from_numpy(np_tree(rcache), device=CPU))
    for s in range(8):
        want, rcache = rstep(jax_tree(p), rcache, jnp.asarray(tok[:, :, s:s + 1]),
                             jnp.asarray(s, jnp.int32))
        got, tcache = step(tp, tcache, t(tok[:, :, s:s + 1]).long(), s)
        np.testing.assert_allclose(n(got), n(want), err_msg=f"step {s}", **LOGIT_TOL)
    assert_close_rel(tcache, np_tree(rcache), CACHE_REL, 2e-5)
    # one model: client 1's reference cache carried across, the bundle's
    # decode step against the reference's next federated step
    cache1 = interop.cache_from_numpy(np_tree(jax.tree.map(lambda x: x[1], rcache)), device=CPU)
    want, _ = rstep(jax_tree(p), rcache, jnp.asarray(tok[:, :, :1]), jnp.asarray(8, jnp.int32))
    got1, _ = registry.build(pcfg).decode_step(transformer.tree_map(lambda x: x[1], tp), cache1,
                                               t(tok[1, :, :1]).long(), 8)
    np.testing.assert_allclose(n(got1), n(want[1]), **LOGIT_TOL)


# ------------------------------------------------------------------ train
def lm_batch(rcfg, lead, seed=5):
    toks = tokens(rcfg, lead + (SEQ + 1,), seed)
    return dict(inputs(rcfg, toks[..., :-1]), labels=toks[..., 1:])


@pytest.mark.parametrize("arch", list(ARCHS))
def test_loss_with_aux_and_grads_match_reference(arch):
    """Each client's mean NLL + 0.01 · aux against the reference's
    ``vmap(value_and_grad(loss_fn))``; the MoE families' aux is nonzero."""
    rcfg, pcfg = cfgs(arch)
    p = client_params(arch)
    b = lm_batch(rcfg, (M, 2))
    want_loss, want_grads = jax.jit(jax.vmap(jax.value_and_grad(
        functools.partial(ref_transformer.loss_fn, cfg=rcfg))))(jax_tree(p), jax_tree(b))
    tp = transformer.tree_map(lambda x: x.requires_grad_(True),
                              interop.transformer_params_from_numpy(p, device=CPU))
    tb = torch_inputs(b)
    loss = transformer.loss_fn(tp, tb, pcfg)
    assert tuple(loss.shape) == (M,)
    np.testing.assert_allclose(n(loss), n(want_loss), **LOSS_TOL)
    loss.sum().backward()
    grads = transformer.tree_map(lambda x: torch.zeros_like(x) if x.grad is None else x.grad, tp)
    assert_close_rel(grads, np_tree(want_grads), 1e-4)
    nll = transformer.loss_fn(tp, tb, pcfg, aux_weight=0.0)
    if pcfg.family == "moe":
        assert float((loss - nll).detach().min()) > 0
    else:
        assert torch.equal(loss, nll)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_train_step_matches_reference(arch):
    """One ``build_train_step`` step: user_centric for the federated
    configs, kimi's fedsgd_sharded regime on one model."""
    rcfg, pcfg = cfgs(arch)
    p = client_params(arch)
    if rcfg.regime == "fedsgd_sharded":
        p = jax.tree.map(lambda x: x[0], p)
        b = lm_batch(rcfg, (2,))
        rstep = jax.jit(ref_steps.build_train_step(rcfg, n_clients=1, agg="fedavg", lr=0.1,
                                                   momentum=0.0))
        step = steps.build_train_step(pcfg, n_clients=1, agg="fedavg", lr=0.1, momentum=0.0)
        rmix = tmix = None
    else:
        b = lm_batch(rcfg, (M, 2))
        w = np.array([[0.7, 0.3], [0.4, 0.6]], np.float32)
        rstep = jax.jit(ref_steps.build_train_step(rcfg, n_clients=M, agg="user_centric",
                                                   lr=0.1, momentum=0.9))
        step = steps.build_train_step(pcfg, n_clients=M, agg="user_centric", lr=0.1,
                                      momentum=0.9)
        rmix, tmix = jnp.asarray(w), t(w)
    mom = 0.0 if rcfg.regime == "fedsgd_sharded" else 0.9
    rparams, ropt = jax_tree(p), ref_sgd_init(jax_tree(p), momentum=mom)
    tparams = interop.transformer_params_from_numpy(p, device=CPU)
    topt = sgd_init(tparams, momentum=mom)
    if rmix is None:
        rparams, ropt, rm = rstep(rparams, ropt, jax_tree(b))
        tparams, topt, tm = step(tparams, topt, torch_inputs(b))
    else:
        rparams, ropt, rm = rstep(rparams, ropt, rmix, jax_tree(b))
        tparams, topt, tm = step(tparams, topt, tmix, torch_inputs(b))
    np.testing.assert_allclose(float(tm["loss"]), float(rm["loss"]), **LOSS_TOL)
    assert_close_rel(tparams, np_tree(rparams), 1e-4)


class SortCount(TorchDispatchMode):
    """Counts the sorts torch runs (the MoE dispatch's argsort is one) and
    its batched products (the expert products among them)."""

    def __init__(self):
        super().__init__()
        self.sorts = self.bmms = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in (torch.ops.aten.sort, torch.ops.aten.argsort):
            self.sorts += 1
        if func.overloadpacket is torch.ops.aten.bmm:
            self.bmms += 1
        return func(*args, **(kwargs or {}))


def test_remat_save_moe_keeps_the_dispatch():
    """remat_policy="save_moe" gives the gradients of "full" bit for bit
    and keeps each MoE layer's routing, dispatch and output for the
    backward: its dispatch sorts once a layer over the forward and the
    backward, where "full" sorts again in the backward's recomputation,
    while the expert products are recomputed under both: "full" runs one
    batched product more a layer, the router's, which save_moe keeps."""
    rcfg, pcfg = cfgs("mixtral")
    p = interop.transformer_params_from_numpy(client_params("mixtral"), device=CPU)
    b = torch_inputs(lm_batch(rcfg, (M, 2)))
    layers = pcfg.num_layers
    out = {}
    for policy in ("full", "save_moe"):
        cfg = dataclasses.replace(pcfg, remat=True, remat_policy=policy)
        tp = transformer.tree_map(lambda x: x.detach().requires_grad_(True), p)
        with SortCount() as count:
            loss = transformer.loss_fn(tp, b, cfg)
            grads = torch.autograd.grad(loss.sum(), transformer.leaves(tp))
        out[policy] = (loss, grads, count.sorts, count.bmms)
    assert out["full"][2] == 2 * layers and out["save_moe"][2] == layers
    # the router's product is kept with the routing; the expert products recompute
    assert out["full"][3] == out["save_moe"][3] + layers
    assert torch.equal(out["full"][0], out["save_moe"][0])
    for a, c in zip(out["full"][1], out["save_moe"][1]):
        assert torch.equal(a, c)


class Outputs(TorchDispatchMode):
    """Records the shape and dtype of every tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for x in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(x, torch.Tensor):
                self.seen.append((tuple(x.shape), x.dtype))
        return out


@pytest.mark.parametrize("arch", list(ARCHS))
def test_aux_sum_only_from_moe_layers(arch):
    """The forward's aux sum is an (M,) f32 tensor where MoE layers give
    one and None elsewhere: a forward and a decode step of a family
    without MoE layers make no (M,) f32 tensor at all."""
    rcfg, pcfg = cfgs(arch)
    p = interop.transformer_params_from_numpy(client_params(arch), device=CPU)
    b = torch_inputs(inputs(rcfg, tokens(rcfg, (M, 2, SEQ), 7)))
    tok = b["tokens"]
    with torch.no_grad(), Outputs() as rec:
        _, aux, _ = transformer._forward(p, b, pcfg, return_cache=False, last_only=True)
        cache = transformer.init_cache(pcfg, M, 2, 8, CPU)
        transformer.decode_step(p, cache, tok[:, :, :1], 0, pcfg)
    if pcfg.family == "moe":
        assert aux is not None and tuple(aux.shape) == (M,) and aux.dtype == torch.float32
    else:
        assert aux is None
        assert ((M,), torch.float32) not in rec.seen


def test_vlm_decode_continues_its_prefill():
    """internvl2: the prefill over P patches and S tokens fills positions
    0..P+S-1 of each layer's cache; 6 teacher-forced decode steps from
    position P+S (tokens alone) against the reference's from the same
    cache, and the loss reads the last S logits (the labels' positions)."""
    rcfg, pcfg = cfgs("internvl2")
    p = client_params("internvl2")
    b = inputs(rcfg, tokens(rcfg, (M, 2, SEQ), seed=11))
    total, max_len = rcfg.num_patches + SEQ, rcfg.num_patches + SEQ + 6
    _, _, wcache = jax.jit(jax.vmap(functools.partial(ref_transformer.forward, cfg=rcfg,
                                                      return_cache=True)))(jax_tree(p), jax_tree(b))
    cache = np_tree(jax.vmap(lambda _: ref_transformer.init_cache(rcfg, 2, max_len))(
        jnp.arange(M)))
    for key, slot in cache["blocks"].items():
        for kv in ("k", "v"):
            slot[kv] = np.array(slot[kv])
            slot[kv][:, :, :, :total] = np.asarray(wcache["blocks"][key][kv])
        slot["pos"] = np.array(slot["pos"])
        slot["pos"][..., :total] = np.arange(total)
    rcache, tcache = jax_tree(cache), interop.cache_from_numpy(cache, device=CPU)
    tp = interop.transformer_params_from_numpy(p, device=CPU)
    rstep = jax.jit(ref_steps.build_serve_step(rcfg, federated=True))
    step = steps.build_serve_step(pcfg, federated=True)
    tok = tokens(rcfg, (M, 2, 6), seed=12)
    for s in range(6):
        want, rcache = rstep(jax_tree(p), rcache, jnp.asarray(tok[:, :, s:s + 1]),
                             jnp.asarray(total + s, jnp.int32))
        got, tcache = step(tp, tcache, t(tok[:, :, s:s + 1]).long(), total + s)
        np.testing.assert_allclose(n(got), n(want), err_msg=f"step {s}", **LOGIT_TOL)
    assert_close_rel(tcache, np_tree(rcache), CACHE_REL, 2e-5)
    lb = lm_batch(rcfg, (M, 2))
    assert lb["labels"].shape[-1] == SEQ
    want = jax.jit(jax.vmap(functools.partial(ref_transformer.loss_fn, cfg=rcfg)))(
        jax_tree(p), jax_tree(lb))
    np.testing.assert_allclose(n(transformer.loss_fn(tp, torch_inputs(lb), pcfg)), n(want),
                               **LOSS_TOL)
