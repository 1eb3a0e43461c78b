"""The port's dense transformer serve path against the reference, on the CPU.

Inputs come from numpy seeds: the reference's init (jax, reduced configs,
f32), every leaf then perturbed with numpy noise so norms and biases are
not trivially zero, handed to both packages as numpy arrays. The port's
attention runs through its plain ``flash_attention``; the reference's
through ``_attend`` (einsum logits, ``finfo.min`` mask, probabilities cast
to v's dtype, here f32).

Configurations: reduced qwen2-7b (GQA group 2, qkv bias, a padded vocab),
the same with 14 q over 2 kv heads (group 7), gemma2-9b (window 64,
softcaps, post-norms, geglu, tied and scaled embeddings) and stablelm-1.6b
(layernorm, rope over 25 % of the head); phi3-medium-14b, the fourth
dense configuration, in the whole-model tests.

Tolerances: f32 on both sides, sums in another order (XLA's dots against
torch's, the online softmax against the whole-row one), through two
layers and a 512-wide read-out: logits atol 5e-5 on values up to 5 (the
largest error seen is 5e-6); single layers 1e-5.
"""
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
from repro.models import transformer as ref_transformer
from repro_torch import configs, interop
from repro_torch.launch import steps
from repro_torch.models import attention, layers, registry, transformer
from repro_torch.models.registry import one
from torch_parity import (CPU, assert_tree_close, f32, jax_tree, n, np_tree, perturbed,
                          stack_clients, t)

LOGIT_TOL = dict(rtol=0, atol=5e-5)
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)

VARIANTS = {
    "qwen2": ("qwen2-7b", dict(vocab_size=500, vocab_pad=16)),
    "qwen2-g7": ("qwen2-7b", dict(num_heads=14, num_kv_heads=2)),
    "gemma2": ("gemma2-9b", {}),
    "stablelm": ("stablelm-1.6b", {}),
    "phi3": ("phi3-medium-14b", {}),
}


def cfgs(variant):
    arch, over = VARIANTS[variant]
    return ref_configs.get(arch).reduced(**over), configs.get(arch).reduced(**over)


@functools.lru_cache(maxsize=None)
def ref_params(variant, seed=0):
    """numpy params of the reference's reduced model, perturbed."""
    rcfg, _ = cfgs(variant)
    p = np_tree(jax.jit(functools.partial(ref_transformer.init, cfg=rcfg))(
        jax.random.PRNGKey(seed)))
    return perturbed(p, np.random.default_rng(seed + 100))


def tokens(rcfg, shape, seed):
    return np.random.default_rng(seed).integers(0, rcfg.vocab_size, size=shape).astype(np.int32)


# ------------------------------------------------------------------ layers
def test_configs_match_reference():
    for name, rc in ref_configs.ARCHITECTURES.items():
        pc = configs.get(name)
        for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff", "vocab_size",
                  "head_dim", "norm", "mlp", "window", "attn_pattern", "family", "source",
                  "param_dtype", "act_dtype", "rope_base", "rope_pct"):
            assert getattr(pc, f) == getattr(rc, f), (name, f)
        for over in ({}, {"vocab_size": 128}):
            assert configs.get(name).reduced(**over).__dict__.keys() == rc.__dict__.keys()
            assert str(configs.get(name).reduced(**over)) == str(rc.reduced(**over))
        assert pc.padded_vocab == rc.padded_vocab
        assert pc.for_mesh(16).padded_vocab == rc.for_mesh(16).padded_vocab
    assert configs.get("qwen2-7b").param_tdtype == torch.bfloat16
    with pytest.raises(KeyError):
        configs.get("nope")


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms_match_reference(kind):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 48)).astype(np.float32) * 3 + 1
    p = {"scale": rng.normal(size=(48,)).astype(np.float32)}
    if kind == "layernorm":
        p["bias"] = rng.normal(size=(48,)).astype(np.float32)
    _, ref_fn = ref_layers.make_norm(kind)
    _, fn = layers.make_norm(kind)
    want = ref_fn({k: f32(v) for k, v in p.items()}, f32(x))
    np.testing.assert_allclose(n(fn({k: t(v) for k, v in p.items()}, t(x))), n(want),
                               **LAYER_TOL)
    # per client: a (m, D) scale against (m, B, S, D) activations
    pc = {k: np.stack([v, 2 * v]) for k, v in p.items()}
    got = fn({k: t(v) for k, v in pc.items()}, t(np.stack([x, x])))
    want2 = ref_fn({k: f32(v[1]) for k, v in pc.items()}, f32(x))
    np.testing.assert_allclose(n(got[1]), n(want2), **LAYER_TOL)


@pytest.mark.parametrize("rope_dim,base", [(None, 1e4), (8, 1e4), (32, 1e6)])
def test_rope_matches_reference(rope_dim, base):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 7, 3, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(3, 10)[None], (2, 7)).astype(np.int32)
    want = ref_layers.rope(f32(x), jnp.asarray(pos), base=base, rope_dim=rope_dim)
    got = layers.rope(t(x), t(pos), base=base, rope_dim=rope_dim)
    np.testing.assert_allclose(n(got), n(want), **LAYER_TOL)
    if rope_dim == 8:  # the partial rotary leaves the rest untouched
        np.testing.assert_array_equal(n(got)[..., 8:], x[..., 8:])


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlp_matches_reference(kind):
    rng = np.random.default_rng(3)
    shapes = ((("w_gate", (16, 40)), ("w_up", (16, 40)), ("w_down", (40, 16)))
              if kind != "gelu" else
              (("w_up", (16, 40)), ("b_up", (40,)), ("w_down", (40, 16)), ("b_down", (16,))))
    p = {k: rng.normal(size=s).astype(np.float32) * 0.2 for k, s in shapes}
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    want = ref_layers.mlp_apply({k: f32(v) for k, v in p.items()}, f32(x), kind)
    got = layers.mlp_apply({k: t(v) for k, v in p.items()}, t(x), kind)
    np.testing.assert_allclose(n(got), n(want), **LAYER_TOL)
    with pytest.raises(ValueError):
        layers.mlp_init(torch.Generator(), 4, 8, "relu")


def test_softcap_and_embeddings_match_reference():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 9)).astype(np.float32) * 80
    np.testing.assert_allclose(n(layers.softcap(t(x), 30.0)),
                               n(ref_layers.softcap(f32(x), 30.0)), **LAYER_TOL)
    assert layers.softcap(t(x), None) is not None
    table = rng.normal(size=(50, 16)).astype(np.float32)
    tok = rng.integers(0, 50, size=(2, 6)).astype(np.int32)
    for scale in (None, 128 ** 0.5):
        want = ref_layers.embed_lookup({"table": f32(table)}, jnp.asarray(tok), scale=scale)
        got = layers.embed_lookup({"table": t(table)}, t(tok).long(), scale=scale)
        np.testing.assert_allclose(n(got), n(want), **LAYER_TOL)
    h = rng.normal(size=(2, 6, 16)).astype(np.float32)
    np.testing.assert_allclose(n(layers.embed_logits({"table": t(table)}, t(h))),
                               n(ref_layers.embed_logits({"table": f32(table)}, f32(h))),
                               **LAYER_TOL)
    # the per-client table: client 1's rows and read-out
    tables = np.stack([table, table[::-1].copy()])
    got = layers.embed_lookup({"table": t(tables)}, t(np.stack([tok, tok])).long())
    np.testing.assert_array_equal(n(got[1]), table[::-1][tok])
    got = layers.embed_logits({"table": t(tables)}, t(np.stack([h, h])))
    np.testing.assert_allclose(n(got[1]), h @ table[::-1].T, rtol=1e-5, atol=1e-5)


def test_embedding_scale_rounds_to_the_table_dtype():
    """gemma's sqrt(d) is rounded to the table's dtype before it scales, as
    the reference does: in bfloat16 sqrt(3584) = 59.87 becomes 59.75."""
    table = np.ones((4, 3), np.float32)
    want = ref_layers.embed_lookup({"table": jnp.asarray(table, jnp.bfloat16)},
                                   jnp.asarray([1]), scale=3584 ** 0.5)
    y = layers.embed_lookup({"table": t(table).to(torch.bfloat16)}, torch.tensor([1]),
                            scale=3584 ** 0.5)
    assert float(y[0, 0]) == float(want[0, 0]) == 59.75


# --------------------------------------------------------------- attention
def _attn_case(variant):
    rcfg, pcfg = cfgs(variant)
    racfg, pacfg = ref_transformer.attn_config(rcfg), transformer.attn_config(pcfg)
    p = ref_params(variant)["blocks"]["l0"]["attn"]
    p = {k: v[0] for k, v in p.items()}  # group 0
    window = rcfg.window
    return racfg, pacfg, p, window


@pytest.mark.parametrize("variant", ["qwen2", "qwen2-g7", "gemma2", "stablelm"])
def test_attention_forward_matches_reference(variant):
    racfg, pacfg, p, window = _attn_case(variant)
    x = np.random.default_rng(5).normal(size=(2, 70, racfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(70)[None], (2, 70)).astype(np.int32)
    want, (wk, wv) = jax.jit(functools.partial(ref_attention.forward, cfg=racfg,
                                               window=window))(
        jax_tree(p), f32(x), jnp.asarray(pos))
    got, (gk, gv) = attention.forward(one(interop.transformer_params_from_numpy(p, device=CPU)),
                                      t(x)[None], t(np.arange(70))[None], pacfg, window=window)
    np.testing.assert_allclose(n(got[0]), n(want), rtol=0, atol=1e-4)
    np.testing.assert_allclose(n(gk[0]), n(wk), **LAYER_TOL)
    np.testing.assert_allclose(n(gv[0]), n(wv), **LAYER_TOL)


@pytest.mark.parametrize("variant", ["qwen2-g7", "gemma2"])
def test_attention_decode_matches_reference(variant):
    """Step by step from an empty cache; gemma2's window-64 cache wraps."""
    racfg, pacfg, p, window = _attn_case(variant)
    steps_, length = 72, (window or 80)
    x = np.random.default_rng(6).normal(size=(2, steps_, racfg.d_model)).astype(np.float32)
    rdec = jax.jit(functools.partial(ref_attention.decode, cfg=racfg, window=window))
    rcache = ref_attention.init_cache(2, length, racfg, jnp.float32)
    tp = one(interop.transformer_params_from_numpy(p, device=CPU))
    tcache = attention.init_cache(1, 2, length, pacfg, torch.float32, CPU)
    for s in range(steps_):
        want, rcache = rdec(jax_tree(p), f32(x[:, s:s + 1]), rcache, jnp.asarray(s, jnp.int32))
        got, tcache = attention.decode(tp, t(x[:, s:s + 1])[None], tcache, s, pacfg,
                                       window=window)
        np.testing.assert_allclose(n(got[0]), n(want), rtol=0, atol=1e-4, err_msg=f"step {s}")
    assert_tree_close({k: v[0] for k, v in tcache.items()}, np_tree(rcache), **LAYER_TOL)


@pytest.mark.parametrize("heads,kv,pad", [(28, 4, 16), (16, 8, 16), (4, 2, 1), (40, 10, 16)])
def test_head_padding_plan_and_init_match_reference(heads, kv, pad):
    """``for_mesh`` deployments pad heads exactly (repeat-KV or zero slots):
    the plan and the padded parameter shapes are the reference's, and a
    zero q slot's ``wo`` rows are zero."""
    assert attention.plan_heads(heads, kv, pad) == ref_attention.plan_heads(heads, kv, pad)
    rc = ref_attention.AttnConfig(d_model=64, num_heads=heads, num_kv_heads=kv, head_dim=8,
                                  qkv_bias=True, pad_to=pad)
    pc = attention.AttnConfig(d_model=64, num_heads=heads, num_kv_heads=kv, head_dim=8,
                              qkv_bias=True, pad_to=pad)
    want = ref_attention.init(jax.random.PRNGKey(0), rc)
    got = attention.init(torch.Generator().manual_seed(0), pc, device=CPU)
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    q_of = pc.plan[2]
    wo = got["wo"].reshape(pc.hq_eff, 8, 64)
    for slot, head in enumerate(q_of):
        assert bool((wo[slot] == 0).all()) == (head < 0)


def test_attention_decode_past_a_global_cache_raises():
    _, pacfg, p, _ = _attn_case("qwen2")
    cache = attention.init_cache(1, 1, 4, pacfg, torch.float32, CPU)
    x = torch.zeros(1, 1, 1, pacfg.d_model)
    with pytest.raises(ValueError, match="does not fit"):
        attention.decode(one(interop.transformer_params_from_numpy(p, device=CPU)), x, cache,
                         4, pacfg)


# -------------------------------------------------------------- transformer
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_and_prefill_caches_match_reference(variant):
    rcfg, pcfg = cfgs(variant)
    p = ref_params(variant)
    tok = tokens(rcfg, (2, 70), seed=7)
    want, _, wcache = jax.jit(functools.partial(ref_transformer.forward, cfg=rcfg,
                                                return_cache=True))(
        jax_tree(p), {"tokens": jnp.asarray(tok)})
    tp = interop.transformer_params_from_numpy(p, device=CPU)
    got, gcache = transformer.forward(one(tp), {"tokens": t(tok).long()[None]}, pcfg,
                                      return_cache=True)
    np.testing.assert_allclose(n(got[0]), n(want), **LOGIT_TOL)
    assert_tree_close(transformer.tree_map(lambda x: x[0], gcache), np_tree(wcache),
                      rtol=1e-5, atol=2e-5)
    # the bundle's single-model forward and the last-position read-out
    np.testing.assert_allclose(n(registry.build(pcfg).forward(tp, {"tokens": t(tok).long()})),
                               n(want), **LOGIT_TOL)
    last = transformer.forward(one(tp), {"tokens": t(tok).long()[None]}, pcfg, last_only=True)
    np.testing.assert_allclose(n(last[0]), n(want)[:, -1:], **LOGIT_TOL)
    if pcfg.padded_vocab != pcfg.vocab_size:
        assert np.all(n(got)[..., pcfg.vocab_size:] == -1e30)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_decode_step_matches_reference_teacher_forced(variant):
    """decode_step from empty caches, step by step with the prompt's
    tokens; gemma2 runs past its window-64 cache's wrap."""
    rcfg, pcfg = cfgs(variant)
    p = ref_params(variant)
    steps_ = 70 if variant == "gemma2" else 12
    max_len = 80
    tok = tokens(rcfg, (2, steps_), seed=8)
    model = registry.build(pcfg)
    rstep = jax.jit(functools.partial(ref_transformer.decode_step, cfg=rcfg))
    rcache = ref_transformer.init_cache(rcfg, 2, max_len)
    tp = interop.transformer_params_from_numpy(p, device=CPU)
    tcache = model.init_cache(2, max_len, CPU)
    for s in range(steps_):
        want, rcache = rstep(jax_tree(p), rcache, jnp.asarray(tok[:, s:s + 1]),
                             jnp.asarray(s, jnp.int32))
        got, tcache = model.decode_step(tp, tcache, t(tok[:, s:s + 1]).long(), s)
        np.testing.assert_allclose(n(got), n(want), err_msg=f"step {s}", **LOGIT_TOL)
    assert_tree_close(tcache, np_tree(rcache), rtol=1e-5, atol=2e-5)
    if variant == "gemma2":
        assert n(tcache["blocks"]["l0"]["pos"]).max() == steps_ - 1  # the window cache wrapped
        assert tcache["blocks"]["l0"]["k"].shape[2] == 64


def test_cache_from_numpy_carries_a_reference_cache():
    rcfg, pcfg = cfgs("gemma2")
    rcache = np_tree(ref_transformer.init_cache(rcfg, 2, 80))
    got = interop.cache_from_numpy(rcache, device=CPU)
    mine = registry.build(pcfg).init_cache(2, 80, CPU)
    assert_tree_close(got, np_tree(transformer.tree_map(n, mine)), rtol=0, atol=0)
    assert got["blocks"]["l0"]["pos"].dtype == torch.int32


def test_params_from_numpy_keeps_bfloat16():
    """bf16 leaves arrive from jax as ml_dtypes arrays; their bits carry over."""
    x = jnp.asarray(np.random.default_rng(12).normal(size=(3, 5)), jnp.bfloat16)
    got = interop.transformer_params_from_numpy({"a": {"w": np.asarray(x)}}, device=CPU)
    assert got["a"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(n(got["a"]["w"].float()), np.asarray(x, np.float32))


def test_init_matches_reference_shapes():
    for variant in VARIANTS:
        rcfg, pcfg = cfgs(variant)
        want = ref_params(variant)
        got = transformer.init(torch.Generator().manual_seed(0), pcfg, CPU)
        shapes = transformer.tree_map(lambda x: tuple(x.shape), got)
        assert shapes == transformer.tree_map(lambda x: tuple(x.shape), want)


# --------------------------------------------------------- federated steps
def _client_params(variant):
    """Two clients: the perturbed init, and a second perturbation of it."""
    p0 = ref_params(variant)
    return stack_clients([p0, perturbed(p0, np.random.default_rng(42), 0.02)])


@pytest.mark.parametrize("variant", ["qwen2-g7", "gemma2"])
def test_federated_prefill_step_matches_reference(variant):
    rcfg, pcfg = cfgs(variant)
    p = _client_params(variant)
    tok = tokens(rcfg, (2, 2, 40), seed=9)
    want, wcache = jax.jit(ref_steps.build_prefill_step(rcfg, federated=True))(
        jax_tree(p), {"tokens": jnp.asarray(tok)})
    tp = interop.transformer_params_from_numpy(p, device=CPU)
    got, gcache = steps.build_prefill_step(pcfg, federated=True)(tp, {"tokens": t(tok).long()})
    assert tuple(got.shape) == (2, 2, 1, pcfg.padded_vocab)
    np.testing.assert_allclose(n(got), n(want), **LOGIT_TOL)
    assert_tree_close(gcache, np_tree(wcache), rtol=1e-5, atol=2e-5)
    assert np.abs(n(got[0]) - n(got[1])).max() > 1e-3  # the clients' models differ
    one_logits, _ = steps.build_prefill_step(pcfg, federated=False)(
        transformer.tree_map(lambda x: x[1], tp), {"tokens": t(tok[1]).long()})
    np.testing.assert_allclose(n(one_logits), n(want[1]), **LOGIT_TOL)


@pytest.mark.parametrize("variant", ["qwen2", "stablelm"])
def test_federated_serve_step_matches_reference(variant):
    rcfg, pcfg = cfgs(variant)
    p = _client_params(variant)
    tok = tokens(rcfg, (2, 2, 10), seed=10)
    rstep = jax.jit(ref_steps.build_serve_step(rcfg, federated=True))
    rcache = jax.vmap(lambda _: ref_transformer.init_cache(rcfg, 2, 16))(jnp.arange(2))
    tp = interop.transformer_params_from_numpy(p, device=CPU)
    step = steps.build_serve_step(pcfg, federated=True)
    tcache = transformer.init_cache(pcfg, 2, 2, 16, CPU)
    for s in range(10):
        want, rcache = rstep(jax_tree(p), rcache, jnp.asarray(tok[:, :, s:s + 1]),
                             jnp.asarray(s, jnp.int32))
        got, tcache = step(tp, tcache, t(tok[:, :, s:s + 1]).long(), s)
        np.testing.assert_allclose(n(got), n(want), err_msg=f"step {s}", **LOGIT_TOL)
    assert_tree_close(tcache, np_tree(rcache), rtol=1e-5, atol=2e-5)
