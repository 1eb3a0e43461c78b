"""The port's whisper (``repro_torch.models.whisper``, the audio family)
against the reference, on the CPU.

Reduced whisper-large-v3: 2 encoder and 2 decoder layers, d_model 128,
4 query heads over 2 KV heads (GQA, the reduced config's own) and, as a
second case, 4 over 4 (MHA, the full model's layout); 32 encoder frames,
a 512-row position table, vocab 512. Weights are the reference's reduced
init (jit, f32), every leaf perturbed with numpy noise (so biases and
norms carry values), for 2 clients (the second perturbed again), carried
across by ``interop``; frames N(0, 1) and tokens from numpy. The port's
attention runs through its plain ``flash_attention``.

Tolerances (f32 on both sides, sums in another order): single layers and
the sinusoids 1e-5; the encoder's output, logits and losses atol 1e-4
(logits up to about 4); caches 5e-5 of each leaf's largest plus 2e-5;
gradients and a train step's params within 1e-4 of each leaf's largest
plus 1e-7: the key biases' gradients are 0 in exact arithmetic (a bias
on every key shifts a row of logits by one constant), so both sides hold
rounding noise of about 1e-9 there.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.launch import steps as ref_steps
from repro.models import attention as ref_attention
from repro.models import layers as ref_layers
from repro.models import whisper as ref_whisper
from repro.optim import sgd_init as ref_sgd_init
from repro_torch import configs, interop
from repro_torch.launch import serve, steps
from repro_torch.models import attention, layers, registry, transformer, whisper
from repro_torch.optim import sgd_init
from torch_parity import CPU, f32, jax_tree, n, np_tree, perturbed, stack_clients, t

LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=0, atol=1e-4)
CACHE_REL = 5e-5
GRAD_FLOOR = 1e-7
M, B, S = 2, 2, 12
HEADS = {"gqa": {}, "mha": {"num_kv_heads": 4}}


def cfgs(heads="gqa", **extra):
    over = dict(HEADS[heads], **extra)
    return (ref_configs.get("whisper-large-v3").reduced(**over),
            configs.get("whisper-large-v3").reduced(**over))


@functools.lru_cache(maxsize=None)
def client_params(heads="gqa"):
    rcfg, _ = cfgs(heads)
    p0 = perturbed(np_tree(jax.jit(functools.partial(ref_whisper.init, cfg=rcfg))(
        jax.random.PRNGKey(0))), np.random.default_rng(200))
    return stack_clients([p0, perturbed(p0, np.random.default_rng(201), 0.02)])


def tparams(heads="gqa"):
    return interop.transformer_params_from_numpy(client_params(heads), device=CPU)


def frames(rcfg, lead=(M, B), seed=3):
    return np.random.default_rng(seed).normal(
        size=lead + (rcfg.encoder_seq, rcfg.d_model)).astype(np.float32)


def tokens(rcfg, shape, seed):
    return np.random.default_rng(seed).integers(0, rcfg.vocab_size, size=shape).astype(np.int32)


def batch(rcfg, seq=S, seed=4):
    toks = tokens(rcfg, (M, B, seq + 1), seed)
    return {"frames": frames(rcfg), "tokens": toks[..., :-1], "labels": toks[..., 1:]}


def torch_batch(b):
    return {k: t(v) if v.dtype == np.float32 else t(v).long() for k, v in b.items()}


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


def one_client(tree, i):
    return jax.tree.map(lambda x: x[i], tree)


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("length,d_model", [(32, 128), (7, 10), (1500, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sinusoidal_positions_match_reference(length, d_model, dtype):
    """Computed in f32 in the reference's order, then cast: bf16 bit for
    bit, f32 within 1e-5 (sin and cos of angles up to 1,500 rad)."""
    want = np.asarray(ref_layers.sinusoidal_positions(length, d_model, getattr(jnp, dtype))
                      .astype(jnp.float32))
    got = layers.sinusoidal_positions(length, d_model, getattr(torch, dtype), CPU)
    assert tuple(got.shape) == (length, d_model) and got.dtype == getattr(torch, dtype)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(n(got.float()), want)
    else:
        np.testing.assert_allclose(n(got), want, **LAYER_TOL)


def test_gelu_mlp_matches_reference_per_client():
    """The tanh-form gelu MLP with its biases, per client: (m, D, F)
    weights and (m, F) biases against (m, B, S, D) activations."""
    rng = np.random.default_rng(5)
    p = {"w_up": rng.normal(size=(2, 16, 40)) * 0.3, "b_up": rng.normal(size=(2, 40)),
         "w_down": rng.normal(size=(2, 40, 16)) * 0.3, "b_down": rng.normal(size=(2, 16))}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(size=(2, 3, 5, 16)).astype(np.float32)
    got = layers.mlp_apply({k: t(v) for k, v in p.items()}, t(x), "gelu")
    for i in range(2):
        want = ref_layers.mlp_apply({k: f32(v[i]) for k, v in p.items()}, f32(x[i]), "gelu")
        np.testing.assert_allclose(n(got[i]), n(want), **LAYER_TOL)
    init = layers.mlp_init(torch.Generator().manual_seed(0), 16, 40, "gelu")
    assert {k: tuple(v.shape) for k, v in init.items()} == {
        "w_up": (16, 40), "b_up": (40,), "w_down": (40, 16), "b_down": (16,)}
    assert not init["b_up"].any() and not init["b_down"].any()


@pytest.mark.parametrize("heads", list(HEADS))
def test_bidirectional_cross_and_encode_kv_match_reference(heads):
    """One layer's attention weights (the first decoder layer's cross
    attention, biases perturbed) for 2 clients: ``bidirectional`` over the
    frames, ``encode_kv`` of them, and ``cross`` of a shorter decoder
    sequence over that K/V, each against the reference client by client."""
    rcfg, pcfg = cfgs(heads)
    acfg_r, acfg_p = ref_whisper.attn_config(rcfg), whisper.attn_config(pcfg)
    p = client_params(heads)["dec_blocks"]["cross_attn"]
    p = {k: v[:, 0] for k, v in p.items()}  # (m, ...) of layer 0
    rng = np.random.default_rng(6)
    enc = rng.normal(size=(M, B, rcfg.encoder_seq, rcfg.d_model)).astype(np.float32)
    x = rng.normal(size=(M, B, S, rcfg.d_model)).astype(np.float32)
    tp = {k: t(v) for k, v in p.items()}
    pos = torch.arange(rcfg.encoder_seq)[None]
    got_bi = attention.bidirectional(tp, t(enc), pos, acfg_p)
    got_k, got_v = attention.encode_kv(tp, t(enc), acfg_p)
    got_x = attention.cross(tp, t(x), (got_k, got_v), acfg_p)
    for i in range(M):
        pi = {k: f32(v[i]) for k, v in p.items()}
        rpos = jnp.broadcast_to(jnp.arange(rcfg.encoder_seq)[None], (B, rcfg.encoder_seq))
        np.testing.assert_allclose(n(got_bi[i]), n(ref_attention.bidirectional(
            pi, f32(enc[i]), rpos, acfg_r)), **LAYER_TOL)
        rk, rv = ref_attention.encode_kv(pi, f32(enc[i]), acfg_r)
        np.testing.assert_allclose(n(got_k[i]), n(rk), **LAYER_TOL)
        np.testing.assert_allclose(n(got_v[i]), n(rv), **LAYER_TOL)
        np.testing.assert_allclose(n(got_x[i]), n(ref_attention.cross(
            pi, f32(x[i]), (rk, rv), acfg_r)), **LAYER_TOL)
    assert tuple(got_k.shape) == (M, B, rcfg.encoder_seq, acfg_p.hkv_eff, acfg_p.head_dim)


# ------------------------------------------------------------------ model
def test_init_matches_reference_shapes():
    """Leaf for leaf the reference's layout and dtypes at bf16."""
    rcfg, pcfg = cfgs(param_dtype="bfloat16", act_dtype="bfloat16")
    want = jax.eval_shape(functools.partial(ref_whisper.init, cfg=rcfg), jax.random.PRNGKey(0))
    got = whisper.init(torch.Generator().manual_seed(0), pcfg, CPU)

    def sig(tree):
        return {k: sig(v) if isinstance(v, dict) else (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in tree.items()}
    assert sig(got) == sig(want)
    with pytest.raises(ValueError, match="generator"):
        whisper.init(torch.Generator(), pcfg, "meta")


@pytest.mark.parametrize("heads", list(HEADS))
def test_encode_matches_reference(heads):
    rcfg, pcfg = cfgs(heads)
    fr = frames(rcfg)
    want = jax.jit(jax.vmap(functools.partial(ref_whisper.encode, cfg=rcfg)))(
        jax_tree(client_params(heads)), jnp.asarray(fr))
    got = whisper.encode(tparams(heads), t(fr), pcfg)
    np.testing.assert_allclose(n(got), n(want), **LOGIT_TOL)


@pytest.mark.parametrize("heads", list(HEADS))
def test_forward_and_prefill_caches_match_reference(heads):
    """Every position's logits, the prefill caches (each decoder layer's
    self k and v, its cross K/V) and ``last_only``'s last position."""
    rcfg, pcfg = cfgs(heads)
    b = batch(rcfg)
    rfwd = jax.jit(jax.vmap(functools.partial(ref_whisper.forward, cfg=rcfg,
                                              return_cache=True)))
    want, _, wcache = rfwd(jax_tree(client_params(heads)),
                           {"frames": jnp.asarray(b["frames"]), "tokens": jnp.asarray(b["tokens"])})
    tp, tb = tparams(heads), torch_batch(b)
    got = whisper.forward(tp, tb, pcfg)
    np.testing.assert_allclose(n(got), n(want), **LOGIT_TOL)
    last, gcache = whisper.forward(tp, tb, pcfg, return_cache=True, last_only=True)
    assert tuple(last.shape) == (M, B, 1, pcfg.padded_vocab)
    np.testing.assert_allclose(n(last), n(want)[:, :, -1:], **LOGIT_TOL)
    assert_close_rel(gcache, np_tree(wcache), CACHE_REL, 2e-5)
    assert np.abs(n(last[0]) - n(last[1])).max() > 1e-3  # the clients' models differ


@pytest.mark.parametrize("heads", list(HEADS))
def test_loss_and_grads_match_reference(heads):
    """Each client's mean NLL against the reference's
    ``vmap(value_and_grad(loss_fn))``, and every leaf's gradient."""
    rcfg, pcfg = cfgs(heads)
    b = batch(rcfg)
    want_loss, want_grads = jax.jit(jax.vmap(jax.value_and_grad(
        functools.partial(ref_whisper.loss_fn, cfg=rcfg))))(jax_tree(client_params(heads)),
                                                           jax_tree(b))
    tp = transformer.tree_map(lambda x: x.requires_grad_(True), tparams(heads))
    loss = whisper.loss_fn(tp, torch_batch(b), pcfg)
    assert tuple(loss.shape) == (M,)
    np.testing.assert_allclose(n(loss), n(want_loss), **LOGIT_TOL)
    loss.sum().backward()
    grads = transformer.tree_map(lambda x: torch.zeros_like(x) if x.grad is None else x.grad, tp)
    assert_close_rel(grads, np_tree(want_grads), 1e-4, GRAD_FLOOR)


def test_remat_gives_the_same_loss_and_grads():
    """``cfg.remat`` checkpoints each encoder and decoder layer where
    autograd records it: the loss and every gradient bit for bit."""
    _, pcfg = cfgs()
    tb = torch_batch(batch(cfgs()[0]))
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(pcfg, remat=remat)
        tp = transformer.tree_map(lambda x: x.requires_grad_(True), tparams())
        loss = whisper.loss_fn(tp, tb, cfg)
        out.append((loss, torch.autograd.grad(loss.sum(), transformer.leaves(tp))))
    assert torch.equal(out[0][0], out[1][0])
    for a, c in zip(out[0][1], out[1][1]):
        assert torch.equal(a, c)


def ref_enc_caches(rcfg, heads, fr, max_len):
    """The reference's caches of 2 clients with cross K/V from their own
    encoder outputs (``init_cache(enc_out=, params=)``)."""
    p = jax_tree(client_params(heads))
    enc = jax.jit(jax.vmap(functools.partial(ref_whisper.encode, cfg=rcfg)))(p, jnp.asarray(fr))
    return jax.jit(jax.vmap(lambda pp, e: ref_whisper.init_cache(
        rcfg, B, max_len, enc_out=e, params=pp)))(p, enc)


@pytest.mark.parametrize("heads", list(HEADS))
def test_init_cache_matches_reference(heads):
    """With the encoder's output: every layer's cross K/V; without it, the
    reference's zeros; the self caches empty (pos −1) either way."""
    rcfg, pcfg = cfgs(heads)
    fr = frames(rcfg)
    want = ref_enc_caches(rcfg, heads, fr, 16)
    tp = tparams(heads)
    got = whisper.init_cache(pcfg, M, B, 16, CPU, enc_out=whisper.encode(tp, t(fr), pcfg),
                             params=tp)
    assert_close_rel(got, np_tree(want), CACHE_REL, 2e-5)
    zero = whisper.init_cache(pcfg, M, B, 16, CPU)
    rzero = jax.vmap(lambda _: ref_whisper.init_cache(rcfg, B, 16))(jnp.arange(M))
    assert_close_rel(zero, np_tree(rzero), 0.0)
    assert zero["self"]["pos"].dtype == torch.int32


@pytest.mark.parametrize("heads", list(HEADS))
def test_decode_step_teacher_forced_matches_reference(heads):
    """10 decode steps of 2 clients from caches with the encoder's cross
    K/V, the self caches written in place; then one model through the
    registry's bundle from client 1's reference caches."""
    rcfg, pcfg = cfgs(heads)
    fr = frames(rcfg)
    tok = tokens(rcfg, (M, B, 10), seed=8)
    rcache = ref_enc_caches(rcfg, heads, fr, 16)
    rstep = jax.jit(jax.vmap(functools.partial(ref_whisper.decode_step, cfg=rcfg),
                             in_axes=(0, 0, 0, None)))
    tp = tparams(heads)
    tcache = whisper.init_cache(pcfg, M, B, 16, CPU, enc_out=whisper.encode(tp, t(fr), pcfg),
                                params=tp)
    p = jax_tree(client_params(heads))
    for s in range(10):
        want, rcache = rstep(p, rcache, jnp.asarray(tok[:, :, s:s + 1]),
                             jnp.asarray(s, jnp.int32))
        got, tcache = whisper.decode_step(tp, tcache, t(tok[:, :, s:s + 1]).long(), s, pcfg)
        np.testing.assert_allclose(n(got), n(want), err_msg=f"step {s}", **LOGIT_TOL)
    assert_close_rel(tcache, np_tree(rcache), CACHE_REL, 2e-5)
    cache1 = interop.cache_from_numpy(np_tree(one_client(rcache, 1)), device=CPU)
    want, _ = rstep(p, rcache, jnp.asarray(tok[:, :, :1]), jnp.asarray(10, jnp.int32))
    got1, _ = registry.build(pcfg).decode_step(transformer.tree_map(lambda x: x[1], tp), cache1,
                                               t(tok[1, :, :1]).long(), 10)
    np.testing.assert_allclose(n(got1), n(want[1]), **LOGIT_TOL)


def test_decode_step_past_the_position_table_raises():
    """The reference clamps its position lookup at max_pos − 1; the port
    raises there (its self cache would be too short as well)."""
    _, pcfg = cfgs(max_pos=4)
    tp = whisper.init(torch.Generator().manual_seed(0), pcfg, CPU)
    cache = registry.build(pcfg).init_cache(B, 8, CPU)
    tok = torch.zeros((B, 1), dtype=torch.long)
    registry.build(pcfg).decode_step(tp, cache, tok, 3)
    with pytest.raises(ValueError, match="position table"):
        registry.build(pcfg).decode_step(tp, cache, tok, 4)


def test_cache_from_numpy_carries_a_whisper_cache():
    """interop's tree converter takes whisper's ``{"self": {"k", "v",
    "pos"}, "cross_kv"}`` as it is: the reference's cache of one model is
    the registry's empty cache, leaf for leaf, pos int32."""
    rcfg, pcfg = cfgs()
    got = interop.cache_from_numpy(np_tree(ref_whisper.init_cache(rcfg, B, 16)), device=CPU)
    mine = registry.build(pcfg).init_cache(B, 16, CPU)
    assert_close_rel(got, np_tree(transformer.tree_map(n, mine)), 0.0)
    assert got["self"]["pos"].dtype == torch.int32


# ------------------------------------------------------------------ steps
@pytest.mark.parametrize("heads", list(HEADS))
def test_federated_prefill_step_matches_reference(heads):
    rcfg, pcfg = cfgs(heads)
    b = batch(rcfg)
    inputs = {"frames": b["frames"], "tokens": b["tokens"]}
    want, wcache = jax.jit(ref_steps.build_prefill_step(rcfg, federated=True))(
        jax_tree(client_params(heads)), jax_tree(inputs))
    tp = tparams(heads)
    got, gcache = steps.build_prefill_step(pcfg, federated=True)(tp, torch_batch(inputs))
    np.testing.assert_allclose(n(got), n(want), **LOGIT_TOL)
    assert_close_rel(gcache, np_tree(wcache), CACHE_REL, 2e-5)
    one, _ = steps.build_prefill_step(pcfg, federated=False)(
        transformer.tree_map(lambda x: x[1], tp), torch_batch(one_client(inputs, 1)))
    np.testing.assert_allclose(n(one), n(want[1]), **LOGIT_TOL)


def test_federated_serve_step_matches_reference():
    """The serve step from the reference serve's caches (zero cross K/V),
    8 steps of 2 clients."""
    rcfg, pcfg = cfgs()
    tok = tokens(rcfg, (M, B, 8), seed=10)
    rstep = jax.jit(ref_steps.build_serve_step(rcfg, federated=True))
    rcache = jax.vmap(lambda _: ref_whisper.init_cache(rcfg, B, 16))(jnp.arange(M))
    step = steps.build_serve_step(pcfg, federated=True)
    tcache = registry.module(pcfg).init_cache(pcfg, M, B, 16, CPU)
    p, tp = jax_tree(client_params()), tparams()
    for s in range(8):
        want, rcache = rstep(p, rcache, jnp.asarray(tok[:, :, s:s + 1]), jnp.asarray(s, jnp.int32))
        got, tcache = step(tp, tcache, t(tok[:, :, s:s + 1]).long(), s)
        np.testing.assert_allclose(n(got), n(want), err_msg=f"step {s}", **LOGIT_TOL)
    assert_close_rel(tcache, np_tree(rcache), CACHE_REL, 2e-5)


@pytest.mark.parametrize("agg", ["user_centric", "fedavg"])
def test_federated_train_step_matches_reference(agg):
    """One ``build_train_step`` step of 2 clients: the family's loss_fn,
    then SGD with momentum and the mix."""
    rcfg, pcfg = cfgs()
    b = batch(rcfg)
    w = np.array([[0.7, 0.3], [0.4, 0.6]], np.float32)
    rstep = jax.jit(ref_steps.build_train_step(rcfg, n_clients=M, agg=agg, lr=0.1,
                                               momentum=0.9))
    step = steps.build_train_step(pcfg, n_clients=M, agg=agg, lr=0.1, momentum=0.9)
    p = jax_tree(client_params())
    rparams, _, rm = rstep(p, ref_sgd_init(p, momentum=0.9), jnp.asarray(w), jax_tree(b))
    tp = tparams()
    gparams, _, gm = step(tp, sgd_init(tp, momentum=0.9), t(w), torch_batch(b))
    np.testing.assert_allclose(float(gm["loss"]), float(rm["loss"]), **LOGIT_TOL)
    assert_close_rel(gparams, np_tree(rparams), 1e-4, GRAD_FLOOR)


# ------------------------------------------------------------------ dispatch
def test_registry_builds_the_audio_family():
    """``registry.build`` dispatches audio to whisper, adding and dropping
    the client axis: the bundle's init, forward, loss, init_cache and
    decode_step against whisper's own at m = 1."""
    rcfg, pcfg = cfgs()
    assert registry.module(pcfg) is whisper
    assert registry.module(configs.get("internvl2-1b").reduced()) is transformer
    model = registry.build(pcfg)
    one = model.init(torch.Generator().manual_seed(0), CPU)
    assert set(one) == {"embed", "pos_embed", "enc_blocks", "enc_final_norm", "dec_blocks",
                        "final_norm"}
    b = torch_batch(batch(rcfg))
    b1 = {k: v[0] for k, v in b.items()}
    tp = tparams()
    p1 = transformer.tree_map(lambda x: x[0], tp)
    full = whisper.forward(tp, b, pcfg)
    np.testing.assert_allclose(n(model.forward(p1, b1)), n(full[0]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(model.loss(p1, b1)), float(whisper.loss_fn(tp, b, pcfg)[0]),
                               rtol=0, atol=1e-6)
    cache = model.init_cache(B, 8, CPU)
    assert tuple(cache["cross_kv"].shape) == (pcfg.num_layers, 2, B, pcfg.encoder_seq,
                                              pcfg.num_kv_heads, pcfg.resolved_head_dim)
    logits, cache = model.decode_step(p1, cache, b1["tokens"][:, :1], 0)
    assert tuple(logits.shape) == (B, 1, pcfg.padded_vocab)
    assert int(cache["self"]["pos"][0, 0]) == 0


def test_audio_is_whisper_s_and_serve_steps_registry_dispatch_it():
    """``transformer`` still rejects the audio family, naming
    models/whisper.py; ``serve``, ``steps`` and ``registry`` send it there
    (the decode step of ``serve()``'s caches runs whisper's)."""
    _, pcfg = cfgs()
    with pytest.raises(NotImplementedError, match="models/whisper.py"):
        transformer.init(torch.Generator(), pcfg, CPU)
    with pytest.raises(NotImplementedError, match="models/whisper.py"):
        transformer.init_cache(pcfg, 1, 1, 8, CPU)
    params = serve.personalized_params(pcfg, M, 0, CPU)
    assert "enc_blocks" in params and params["embed"]["table"].shape[0] == M
    res = serve.serve(pcfg, clients=M, batch=B, prompt_len=4, decode_tokens=3, seed=0,
                      device=CPU)
    assert tuple(res.tokens.shape) == (M, B, 3)
    assert torch.isfinite(res.logits).all()


@pytest.mark.parametrize("arch", ["whisper-large-v3", "internvl2-1b"])
def test_serve_main_on_the_cpu(arch, capsys):
    """``python -m repro_torch.launch.serve --arch <arch> --device cpu``
    serves the reduced model: (clients, batch, decode_tokens) tokens in
    the vocabulary."""
    out = serve.main(["--arch", arch, "--device", "cpu", "--prompt-len", "6",
                      "--decode-tokens", "4"])
    assert tuple(out.shape) == (2, 2, 4)
    assert int(out.min()) >= 0 and int(out.max()) < 128
    assert "decoded 16 tokens" in capsys.readouterr().out
