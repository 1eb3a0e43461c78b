"""Federated training of the SSM, hybrid, MoE, audio and VLM families in the
port against the reference, on the CPU, with remat on: reduced mamba2-1.3b
(SSM, 64-token sequences: two SSD chunks of 32, so the inter-chunk
recurrence and its backward run), zamba2-2.7b at 12 layers (two hybrid
groups: the shared attention's gradient summed over its two invocations),
mixtral-8x7b under ``remat_policy="save_moe"`` (MoE, window),
whisper-large-v3 (encoder-decoder over 32 stub frames) and internvl2-1b
(8 patch embeddings before the tokens).

Weights are one reduced init (the port's, whose layout and dtypes are the
reference's: ``test_torch_families.py``, ``test_torch_whisper.py``) as
numpy, every leaf perturbed with numpy noise, for 2 clients (the second
perturbed again), fed to both sides; tokens, frames and patches from
numpy. The port's attention runs through its plain ``flash_attention``,
the mix through its plain version.

Tolerances (f32 on both sides, sums in another order):
  * three ``build_train_step`` steps (momentum 0.9): losses atol 1e-5,
    params and momentum after the third step ``STEP_TOL``, atol 1e-5, as
    ``tests/test_torch_train.py`` states it. The learning rate is 0.1 as
    there, but zamba2's is 0.01: at 0.1 its third step amplifies rounding,
    a relative perturbation of 1e-7 of every param (f32 rounding's size)
    moving the port's own third loss by 4.0e-4 and its embedding by 4.2e-3,
    so no tolerance that catches a fault could hold there. At 0.01 the
    same perturbation moves them by 1.9e-6 and 5.8e-6, and its momentum
    buffers (sums of 3 gradients up to 2.8 in size) by up to 2.6e-4 of a
    leaf's largest magnitude (the other families' by at most 4.1e-6), so
    zamba2's momentum is held within ``ZAMBA2_MOMENTUM_REL``, 1e-3 of each
    leaf's largest (a lost gradient or a wrong mix is off by about 1);
  * the collaboration round (``train.partition_grads`` + ``collaboration``
    against ``vmap(grad(model.loss))`` + ``collaboration_round`` on the same
    four injected batches): full gradients atol 1e-4 of their largest
    magnitude (the families' gradient tolerance, ``test_torch_families.py``),
    σ² rtol 1e-4; the port's Δ within 1e-4 of itself of Δ from an f64 Gram
    of the reference's full gradients (it reads 1.6e-6 to 1.5e-5); W atol
    5e-4: the reference's f32 Δ is up to 6.6e-4 of itself off the f64 Δ
    (mixtral), which moves W by 5.3e-5 (1.3e-4 on zamba2); the port's zero
    tail past d is zero;
  * remat on against remat off: the loss and every gradient bit for bit;
  * ``train.main`` on mamba2-1.3b (the reference's own usage line): its last
    loss below its first.
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
from repro.core import similarity as ref_similarity
from repro.core.pytree import stacked_ravel as ref_stacked_ravel
from repro.launch import steps as ref_steps
from repro.models import registry as ref_registry
from repro.optim import sgd_init as ref_sgd_init
from repro_torch import configs, interop
from repro_torch.core.pytree import leaves
from repro_torch.launch import steps, train
from repro_torch.models import registry, transformer
from repro_torch.optim import sgd_init
from torch_parity import one_torch_thread  # noqa: F401
from torch_parity import (CPU, assert_tree_close, jax_tree, n, np_tree, perturbed, stack_clients,
                          t)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

LOSS_TOL = dict(rtol=0, atol=1e-5)
STEP_TOL = dict(rtol=0, atol=1e-5)
GRAD_REL = 1e-4
LR = {"zamba2": 0.01}  # else 0.1
ZAMBA2_MOMENTUM_REL = 1e-3
SIGMA_TOL = dict(rtol=1e-4, atol=0)
DELTA_REL = 1e-4
W_TOL = dict(rtol=0, atol=5e-4)
ARCHS = {"mamba2": ("mamba2-1.3b", {}), "zamba2": ("zamba2-2.7b", {"num_layers": 12}),
         "mixtral": ("mixtral-8x7b", {"remat_policy": "save_moe"}),
         "whisper": ("whisper-large-v3", {}), "internvl2": ("internvl2-1b", {})}
M, B = 2, 2
SEQ = 64  # two chunks of the reduced SSD (32)


def cfgs(arch, **extra):
    name, over = ARCHS[arch]
    over = dict(over, remat=True, **extra)
    return ref_configs.get(name).reduced(**over), configs.get(name).reduced(**over)


@functools.lru_cache(maxsize=None)
def client_params(arch):
    _, pcfg = cfgs(arch)
    init = registry.module(pcfg).init(torch.Generator().manual_seed(0), pcfg, CPU)
    p0 = perturbed(transformer.tree_map(n, init), np.random.default_rng(300))
    return stack_clients([p0, perturbed(p0, np.random.default_rng(301), 0.02)])



def lm_batch(rcfg, seed, lead=(M, B), seq=SEQ):
    """Tokens and next-token labels, with whisper's frames or the VLM's
    patch embeddings N(0, 1) beside them."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, rcfg.vocab_size, size=lead + (seq + 1,)).astype(np.int32)
    out = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    if rcfg.family == "audio":
        out["frames"] = rng.normal(size=lead + (rcfg.encoder_seq, rcfg.d_model)).astype(np.float32)
    elif rcfg.family == "vlm":
        out["patch_embeds"] = rng.normal(
            size=lead + (rcfg.num_patches, rcfg.patch_embed_dim)).astype(np.float32)
    return out


def torch_batch(b):
    return {k: t(v) if v.dtype == np.float32 else t(v).long() for k, v in b.items()}


def mixes(agg):
    """(reference mix, port mix): a row-stochastic W, or 2 centroid rules
    and each client's label."""
    if agg == "user_centric":
        w = np.array([[0.7, 0.3], [0.4, 0.6]], np.float32)
        return jnp.asarray(w), t(w)
    cw = np.array([[0.2, 0.8], [0.9, 0.1]], np.float32)
    labels = np.array([1, 0], np.int32)
    return (jnp.asarray(cw), jnp.asarray(labels)), (t(cw), t(labels))


# ------------------------------------------------------------ train steps
@pytest.mark.parametrize("agg", ["user_centric", "clustered"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_train_steps_match_reference_with_remat(arch, agg):
    """Three ``build_train_step`` steps from the same params and batches,
    remat on both sides: every loss, then params and momentum."""
    rcfg, pcfg = cfgs(arch)
    p = client_params(arch)
    rmix, tmix = mixes(agg)
    lr = LR.get(arch, 0.1)
    rstep = jax.jit(ref_steps.build_train_step(rcfg, n_clients=M, agg=agg, lr=lr, momentum=0.9))
    step = steps.build_train_step(pcfg, n_clients=M, agg=agg, lr=lr, momentum=0.9)
    rparams = jax_tree(p)
    ropt = ref_sgd_init(rparams, momentum=0.9)
    tparams = interop.transformer_params_from_numpy(p, device=CPU)
    topt = sgd_init(tparams, momentum=0.9)
    for s in range(3):
        b = lm_batch(rcfg, seed=40 + s)
        rparams, ropt, rm = rstep(rparams, ropt, rmix, jax_tree(b))
        tparams, topt, tm = step(tparams, topt, tmix, torch_batch(b))
        np.testing.assert_allclose(float(tm["loss"]), float(rm["loss"]), **LOSS_TOL)
    assert_tree_close(tparams, np_tree(rparams), **STEP_TOL)
    if arch == "zamba2":
        for got, want in zip(leaves(topt), leaves(np_tree(ropt))):
            np.testing.assert_allclose(n(got), want, rtol=0,
                                       atol=ZAMBA2_MOMENTUM_REL * np.abs(want).max())
    else:
        assert_tree_close(topt, np_tree(ropt), **STEP_TOL)


# ------------------------------------------------- the collaboration round
@pytest.mark.parametrize("arch", ["mamba2", "zamba2", "mixtral"])
def test_collaboration_round_matches_reference(arch, monkeypatch):
    """``train.collaboration`` (K = 4 partitions raveled into the zero-tailed
    (m, K, d_aligned) buffer) on four injected batches against the
    reference's ``launch/train.py``: ``vmap(grad(model.loss))`` a partition,
    ``stacked_ravel``, ``collaboration_round`` with n = B·S."""
    rcfg, pcfg = cfgs(arch)
    p = client_params(arch)
    batches = [lm_batch(rcfg, seed=60 + k) for k in range(train.PARTS)]
    grad = jax.jit(jax.vmap(jax.grad(ref_registry.build(rcfg).loss)))
    gmat = jnp.stack([ref_stacked_ravel(grad(jax_tree(p), jax_tree(b))) for b in batches], axis=1)
    want = ref_similarity.collaboration_round(gmat, jnp.full((M,), B * SEQ, jnp.float32))

    fed = iter(torch_batch(b) for b in batches)
    monkeypatch.setattr(train.lm_synthetic, "federated_lm_batch", lambda *a, **k: next(fed))
    tp = interop.transformer_params_from_numpy(p, device=CPU)
    got = train.collaboration(pcfg, tp, torch.Generator(), None, batch=B, seq=SEQ)
    d = gmat.shape[-1]
    full = n(got["full_grads"])
    assert full.shape[1] >= d and not full[:, d:].any()
    wfull = np.asarray(want["full_grads"])
    np.testing.assert_allclose(full[:, :d], wfull, rtol=0,
                               atol=GRAD_REL * np.abs(wfull).max())
    np.testing.assert_allclose(n(got["sigma_sq"]), np.asarray(want["sigma_sq"]), **SIGMA_TOL)
    g64 = wfull.astype(np.float64)
    gram = g64 @ g64.T
    exact = np.diag(gram)[:, None] + np.diag(gram)[None, :] - 2.0 * gram
    np.testing.assert_allclose(n(got["delta"]), exact, rtol=0, atol=DELTA_REL * np.abs(exact).max())
    np.testing.assert_allclose(n(got["W"]), np.asarray(want["W"]), **W_TOL)
    np.testing.assert_allclose(n(got["W"]).sum(axis=1), 1.0, rtol=0, atol=1e-6)


# ------------------------------------------------------------------ remat
@pytest.mark.parametrize("arch", ["mamba2", "zamba2", "whisper", "internvl2"])
def test_remat_changes_no_bit(arch):
    """The family's loss_fn with remat on and off from the same params and
    batch: the losses and every gradient bit for bit."""
    _, pcfg = cfgs(arch)
    rcfg, _ = cfgs(arch)
    tp = interop.transformer_params_from_numpy(client_params(arch), device=CPU)
    b = torch_batch(lm_batch(rcfg, seed=80))
    loss_fn = registry.module(pcfg).loss_fn
    out = []
    for remat in (False, True):
        p = transformer.tree_map(lambda x: x.detach().requires_grad_(True), tp)
        loss = loss_fn(p, b, dataclasses.replace(pcfg, remat=remat))
        out.append((loss, torch.autograd.grad(loss.sum(), leaves(p), materialize_grads=True)))
    assert torch.equal(out[0][0], out[1][0])
    for a, c in zip(out[0][1], out[1][1]):
        assert torch.equal(a, c)


# ------------------------------------------------------- the entry point
def test_train_main_mamba2_loss_falls(capsys):
    """The reference's usage line, ``--arch mamba2-1.3b --smoke --clients 4
    --groups 2``, on the CPU: the collaboration round and W, then the loss
    falls."""
    final = train.main(["--device", "cpu", "--arch", "mamba2-1.3b", "--smoke", "--clients", "4",
                        "--groups", "2", "--rounds", "8", "--seq", "32"])
    out = capsys.readouterr().out
    first = float(re.search(r"round\s+1 loss=([0-9.]+)", out).group(1))
    assert "collaboration matrix W:" in out
    assert np.isfinite(final) and final < first, (first, final)
