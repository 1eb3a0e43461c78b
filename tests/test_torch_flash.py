"""The port's plain ``flash_attention`` against the reference's Pallas
kernel in interpret mode, on the CPU.

Tolerance rtol 2e-3, atol 2e-4, as ``tests/test_flash_attention.py``
holds the kernel against its plain einsum: both sides compute in f32, the
kernel with an online softmax over 128-wide blocks, the plain version over
the whole row, so sums and exponentials run in another order.
"""
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as ref_flash
from repro_torch import configs
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import (DECODE_MAX_SPLITS, DECODE_MIN_KEYS, FLASH_DEC,
                                                 FLASH_FMA, FLASH_TC, decode_blocks,
                                                 decode_splits, flash_route)
from repro_torch.models import attention
from test_flash_attention import CASES
from torch_parity import f32, n, t

TOL = dict(rtol=2e-3, atol=2e-4)

# (hq, hkv, sq, sk, dh, causal, window, cap): beyond the reference's four
EXTRA = [
    (4, 2, 1, 37, 64, False, None, None),     # decode: one query over a 37-slot prefix
    (14, 2, 1, 160, 128, False, None, 50.0),  # decode, GQA group 7, softcap
    (4, 2, 100, 200, 64, True, None, None),   # Sq < Sk causal: top-left alignment
    (4, 4, 70, 150, 32, True, 48, 30.0),      # Sq < Sk, window and softcap
    (4, 2, 130, 130, 256, True, None, 50.0),  # Dh = 256 (gemma2), ragged
    (14, 2, 96, 96, 32, True, 64, None),      # GQA group 7, window
]


def _inputs(seed, b, hq, hkv, sq, sk, dh):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hq, sq, dh)).astype(np.float32)
    k = rng.normal(size=(b, hkv, sk, dh)).astype(np.float32)
    v = rng.normal(size=(b, hkv, sk, dh)).astype(np.float32)
    return q, k, v


def _check(hq, hkv, sq, sk, dh, causal, window, cap, seed):
    q, k, v = _inputs(seed, 2, hq, hkv, sq, sk, dh)
    want = ref_flash(f32(q), f32(k), f32(v), causal=causal, window=window, softcap=cap,
                     interpret=True)
    got = ops.flash_attention(t(q), t(k), t(v), causal=causal, window=window, softcap=cap)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, hq, sq, dh)
    np.testing.assert_allclose(n(got), n(want), **TOL)


@pytest.mark.parametrize("hq,hkv,sq,dh,causal,window,cap", CASES)
def test_plain_flash_matches_reference_cases(hq, hkv, sq, dh, causal, window, cap):
    _check(hq, hkv, sq, sq, dh, causal, window, cap, seed=hq * 1000 + sq)


@pytest.mark.parametrize("hq,hkv,sq,sk,dh,causal,window,cap", EXTRA)
def test_plain_flash_matches_reference_extra(hq, hkv, sq, sk, dh, causal, window, cap):
    _check(hq, hkv, sq, sk, dh, causal, window, cap, seed=sq * 7 + sk)


def test_causal_is_top_left_aligned():
    """With Sq < Sk, query row r sees keys 0..r (rows and cols both from 0),
    not the bottom-right alignment that would let it see r + Sk − Sq."""
    q, k, v = _inputs(3, 1, 2, 2, 4, 9, 16)
    got = ops.flash_attention(t(q), t(k), t(v), causal=True)
    first = ops.flash_attention(t(q[:, :, :1]), t(k[:, :, :1]), t(v[:, :, :1]), causal=False)
    np.testing.assert_allclose(n(got[:, :, :1]), n(first), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(n(first[:, :, 0]), v[:, :, 0], rtol=1e-6, atol=1e-7)


def test_plain_flash_takes_strided_views():
    """(B, S, H, Dh) projections passed as ``.transpose(1, 2)`` views give
    what contiguous (B, H, S, Dh) inputs give."""
    q, k, v = _inputs(5, 2, 4, 2, 33, 33, 32)
    tq, tk, tv = (t(a).transpose(1, 2).contiguous().transpose(1, 2) for a in (q, k, v))
    assert tq.stride(3) == 1 and not tq.is_contiguous()
    got = ops.flash_attention(tq, tk, tv, window=8, softcap=20.0)
    want = ops.flash_attention(t(q), t(k), t(v), window=8, softcap=20.0)
    np.testing.assert_array_equal(n(got), n(want))


def test_fully_masked_rows_take_the_uniform_softmax():
    """Rows past Sk + window − 1 reach no key: the plain version, as the
    reference's plain path, gives them the mean of v."""
    q, k, v = _inputs(9, 1, 2, 1, 12, 4, 8)
    got = ops.flash_attention(t(q), t(k), t(v), causal=True, window=3)
    mean = v.mean(axis=2)  # (1, 1, Dh)
    for r in range(4 + 3 - 1, 12):
        np.testing.assert_allclose(n(got[:, :, r]), np.repeat(mean, 2, axis=1), rtol=1e-5,
                                   atol=1e-6)


def test_plain_flash_keeps_bfloat16():
    q, k, v = _inputs(11, 1, 2, 1, 20, 20, 64)
    got = ops.flash_attention(*(t(a).to(torch.bfloat16) for a in (q, k, v)))
    want = ref.flash_attention(t(q), t(k), t(v))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(n(got.float()), n(want), rtol=3e-2, atol=3e-2)


def test_bf16_probs_control_rounds_only_the_probabilities():
    """``probs_dtype`` (the control of the tile's precision checks on the
    card) rounds each probability to bf16 before P·V: the output moves, by
    at most a bf16 rounding (2^-8) of each p, so by 2^-8 of sum p·|v|."""
    q, k, v = _inputs(13, 2, 4, 2, 40, 40, 32)
    kw = dict(causal=True, window=24, softcap=20.0)
    want = ref.flash_attention(t(q), t(k), t(v), **kw)
    control = ref.flash_attention(t(q), t(k), t(v), probs_dtype=torch.bfloat16, **kw)
    weight = ref.flash_attention(t(q), t(k), t(np.abs(v)), **kw)  # sum p·|v|
    assert bool(((control - want).abs() <= 2.0 ** -8 * weight + 1e-6).all())
    assert float((control - want).abs().max()) > 0
    same = ref.flash_attention(t(q), t(k), t(v), probs_dtype=torch.float32, **kw)
    assert torch.equal(same, want)


@pytest.mark.parametrize("shapes,kw,msg", [
    (((1, 3, 4, 8), (1, 2, 4, 8), (1, 2, 4, 8)), {}, "multiple of Hkv"),
    (((1, 2, 4, 8), (1, 2, 4, 8), (1, 2, 5, 8)), {}, "must be"),
    (((1, 2, 4, 8), (1, 2, 0, 8), (1, 2, 0, 8)), {}, "Sk"),
    (((1, 2, 4, 8), (1, 2, 4, 8), (1, 2, 4, 8)), {"window": 0}, "window"),
    (((1, 2, 4, 8), (1, 2, 4, 8), (1, 2, 4, 8)), {"softcap": 0.0}, "softcap"),
    (((2, 4, 8), (2, 4, 8), (2, 4, 8)), {}, "4-D"),
])
def test_flash_rejects_bad_arguments(shapes, kw, msg):
    with pytest.raises(ValueError, match=msg):
        ops.flash_attention(*(torch.zeros(s) for s in shapes), **kw)


def test_impl_cuda_needs_cuda_tensors():
    x = torch.zeros(1, 2, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(x, x, x, impl="cuda")


# ------------------------------------------------------------- routing
def _model_qkv(arch, sq, sk, dtype=torch.bfloat16, m=2, b=1):
    """q over sq positions and k, v over a sk-slot cache prefix, as
    ``attention.forward`` (sq == sk) and ``attention.decode`` pass them:
    ``_fold`` views of (m, B, S, H, Dh) tensors, the cache one slot longer
    than the prefix."""
    cfg = configs.get(arch)
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = torch.zeros(m, b, sq, hq, dh, dtype=dtype)
    cache = torch.zeros(m, b, sk + 1, hkv, dh, dtype=dtype)
    return attention._fold(q), attention._fold(cache[:, :, :sk]), attention._fold(cache[:, :, :sk])


@pytest.mark.parametrize("arch", ["qwen2-7b", "gemma2-9b", "stablelm-1.6b"])
@pytest.mark.parametrize("phase,sq,sk,route", [("prefill", 64, 64, "tc"),
                                               ("prefill", 1024, 1024, "tc"),
                                               ("decode", 1, 160, "decode"),
                                               ("decode", 1, 1, "decode")])
def test_flash_route_at_model_shapes(arch, phase, sq, sk, route):
    """bf16 prefill takes the tensor-core tile and decode (Sq = 1) the
    decode kernel; in f32 decode takes the decode kernel too and prefill
    the FMA kernel."""
    q, k, v = _model_qkv(arch, sq, sk)
    assert flash_route(q, k, v) == route
    assert flash_route(*(x.float() for x in (q, k, v))) == ("decode" if sq == 1 else "fma")


@pytest.mark.parametrize("sq,dh,route", [(15, 64, "fma"), (16, 64, "tc"), (17, 64, "tc"),
                                         (64, 36, "fma"), (64, 40, "tc"), (64, 32, "tc"),
                                         (64, 80, "tc"), (64, 256, "tc"),
                                         (1, 64, "decode"), (1, 36, "fma"), (1, 40, "decode"),
                                         (1, 8, "decode"), (1, 256, "decode"), (2, 64, "fma")])
def test_flash_route_threshold_and_head_dims(sq, dh, route):
    q = torch.zeros(2, 4, sq, dh, dtype=torch.bfloat16)
    k = torch.zeros(2, 2, 50, dh, dtype=torch.bfloat16)
    assert flash_route(q, k, k) == route


@pytest.mark.parametrize("which", ["q", "k", "v"])
@pytest.mark.parametrize("fault", ["offset", "stride"])
def test_flash_route_unaligned_view_takes_fma(which, fault):
    """A view that starts one element into its buffer (2 bytes past a
    16-byte boundary), or whose sequence stride is 65 elements (a head dim
    plus one), leaves the tile's 16-byte copies unaligned: the FMA kernel."""
    ts = {name: torch.zeros(2, 4, 64, 64, dtype=torch.bfloat16) for name in "qkv"}
    assert flash_route(ts["q"], ts["k"], ts["v"]) == "tc"
    if fault == "offset":
        ts[which] = torch.zeros(2 * 4 * 64 * 64 + 1, dtype=torch.bfloat16)[1:].view(2, 4, 64, 64)
        assert ts[which].data_ptr() % 16 == 2
    else:
        ts[which] = torch.zeros(2, 4, 64, 65, dtype=torch.bfloat16)[..., :64]
        assert ts[which].stride(2) == 65
    assert flash_route(ts["q"], ts["k"], ts["v"]) == "fma"


@pytest.mark.parametrize("which", ["q", "k", "v"])
@pytest.mark.parametrize("fault", ["offset", "stride"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_flash_route_unaligned_decode_takes_fma(which, fault, dtype):
    """A decode whose q, k or v view starts one element into its buffer,
    or has a sequence stride of a head dim plus one, leaves the decode
    kernel's 16-byte loads unaligned: the FMA kernel."""
    shapes = {"q": (2, 4, 1, 64), "k": (2, 2, 30, 64), "v": (2, 2, 30, 64)}
    ts = {name: torch.zeros(shape, dtype=dtype) for name, shape in shapes.items()}
    assert flash_route(ts["q"], ts["k"], ts["v"]) == "decode"
    b, h, s_, dh = shapes[which]
    if fault == "offset":
        ts[which] = torch.zeros(b * h * s_ * dh + 1, dtype=dtype)[1:].view(b, h, s_, dh)
    else:
        ts[which] = torch.zeros(b, h, s_, dh + 1, dtype=dtype)[..., :dh]
    assert flash_route(ts["q"], ts["k"], ts["v"]) == "fma"


def test_flash_route_mixed_dtypes_take_fma():
    q = torch.zeros(2, 4, 1, 64, dtype=torch.bfloat16)
    k = torch.zeros(2, 2, 30, 64)
    assert flash_route(q, k, k) == "fma"
    assert flash_route(q.half(), k.half(), k.half()) == "fma"


def test_cpu_calls_launch_no_kernel():
    """On the CPU the wrapper takes the plain version: no kernel's launch
    counter moves, at prefill or at decode."""
    before = (FLASH_TC.launches, FLASH_DEC.launches, FLASH_FMA.launches)
    q, k, v = _inputs(13, 1, 4, 2, 32, 32, 64)
    ops.flash_attention(*(t(a).to(torch.bfloat16) for a in (q, k, v)))
    ops.flash_attention(*(t(a).to(torch.bfloat16) for a in (q[:, :, :1], k, v)), causal=False)
    assert (FLASH_TC.launches, FLASH_DEC.launches, FLASH_FMA.launches) == before


# ------------------------------------------------ the decode kernel's splits
# (hq, hkv, sk, dh, causal, window, cap): one query over a prefix; no Sk is
# a multiple of 2, 3 or 7
DECODE = [
    (2, 2, 37, 64, False, None, None),      # group 1 (MHA)
    (4, 2, 55, 32, False, 16, 30.0),        # group 2, a window (row 0 keeps every column), softcap
    (14, 2, 163, 128, False, None, 50.0),   # group 7 (qwen2's), softcap
    (48, 2, 101, 80, False, 7, 30.0),       # group 24 (three of the kernel's row tiles), window
    (12, 4, 43, 40, False, None, None),     # group 3, Dh 40 (below its padded width)
]


@pytest.mark.parametrize("splits", [1, 2, 3, 7, "sk"])
@pytest.mark.parametrize("hq,hkv,sk,dh,causal,window,cap", DECODE)
def test_decode_split_matches_plain_and_reference(hq, hkv, sk, dh, causal, window, cap, splits):
    """``ref.flash_decode_split``, the decode kernel's arithmetic (per-split
    max, sum and accumulator in f32, merged in split order), equals the
    plain version to f32 rounding (atol 1e-6: unit-scale outputs, sums in
    another order) and the reference's interpret-mode kernel within TOL."""
    splits = sk if splits == "sk" else splits
    q, k, v = _inputs(sk + dh, 2, hq, hkv, 1, sk, dh)
    kw = dict(causal=causal, window=window, softcap=cap)
    got = ref.flash_decode_split(t(q), t(k), t(v), splits, **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, hq, 1, dh)
    np.testing.assert_allclose(n(got), n(ref.flash_attention(t(q), t(k), t(v), **kw)),
                               rtol=0, atol=1e-6)
    want = ref_flash(f32(q), f32(k), f32(v), interpret=True, **kw)
    np.testing.assert_allclose(n(got), n(want), **TOL)


@pytest.mark.parametrize("splits", [2, 5])
def test_decode_split_causal_weighs_masked_splits_zero(splits):
    """Causal with Sq = 1 keeps column 0 only: every other split's columns
    are all masked (its max is -1e30) and merges with a weight of exactly
    0, so the output is v at key 0 of each head's kv head."""
    q, k, v = _inputs(21, 2, 14, 2, 1, 40, 32)
    got = ref.flash_decode_split(t(q), t(k), t(v), splits, causal=True)
    np.testing.assert_array_equal(n(got)[:, :, 0], np.repeat(v[:, :, 0], 7, axis=1))


def test_decode_split_keeps_bfloat16_and_rejects_empty_splits():
    q, k, v = (t(a).to(torch.bfloat16) for a in _inputs(23, 1, 4, 2, 1, 9, 16))
    got = ref.flash_decode_split(q, k, v, 3, causal=False)
    assert got.dtype == torch.bfloat16
    plain = ref.flash_attention(q, k, v, causal=False)
    np.testing.assert_allclose(n(got.float()), n(plain.float()), rtol=0, atol=2.0 ** -7)
    for bad in (0, 10):
        with pytest.raises(ValueError, match="splits"):
            ref.flash_decode_split(q, k, v, bad, causal=False)


@pytest.mark.parametrize("blocks,sk", [(16, 160), (16, 4096), (16, 1), (16, 63), (16, 64),
                                       (1, 100_000), (4, 20), (8, 97), (32, 4096),
                                       (64, 300), (200, 4096), (1, 65)])
def test_decode_splits_planner(blocks, sk):
    """Never an empty split; every split at least DECODE_MIN_KEYS keys when
    there are several (balanced splits hold floor or ceil of Sk / S); one
    split when two would fall under that; at most DECODE_MAX_SPLITS; and
    several splits only as far as one wave of the resident slots (two
    blocks an SM) holds them, reaching the SMs when the keys allow."""
    sms = 132
    s = decode_splits(blocks, sk, sms)
    bounds = [i * sk // s for i in range(s + 1)]
    assert 1 <= s <= DECODE_MAX_SPLITS
    assert all(hi > lo for lo, hi in zip(bounds, bounds[1:]))
    if s > 1:
        assert min(hi - lo for lo, hi in zip(bounds, bounds[1:])) >= DECODE_MIN_KEYS
        assert blocks * s <= 2 * sms
    if blocks <= sms and min(sk // DECODE_MIN_KEYS, DECODE_MAX_SPLITS) >= 2 * sms // blocks:
        assert blocks * s >= sms
    if sk < 2 * DECODE_MIN_KEYS:
        assert s == 1


def test_decode_splits_reach_the_sms_at_qwen2_long_decode():
    """qwen2-7b's decode over 4,096 keys (2 clients x 2 requests, 4 kv
    heads, one row tile of 7 query heads): 16 blocks a split, and the
    splits make the grid reach the H100's 132 SMs in one wave of its 264
    resident slots; over its 160-key serve prefix the 32-key minimum holds
    it to 5 splits."""
    blocks = decode_blocks(4, 28, 4)
    assert blocks == 16 and decode_blocks(4, 16, 8) == 32 and decode_blocks(2, 48, 2) == 12
    assert 132 <= blocks * decode_splits(blocks, 4096, 132) <= 264
    assert decode_splits(blocks, 4096, 132) == 16
    assert decode_splits(blocks, 160, 132) == 5


@pytest.fixture
def own_plans(monkeypatch):
    """The decode launch plans and workspace of one test, on the CPU (the
    logic of the cache does not touch a kernel), with 132 SMs."""
    from repro_torch.kernels import flash_attention as flash

    monkeypatch.setattr(flash, "_DECODE_PLANS", {})
    monkeypatch.setattr(flash, "_DECODE_WORKSPACE", {})
    monkeypatch.setattr(flash, "_sm_count", lambda index: 132)
    return flash


def test_decode_plan_is_kept_and_follows_the_workspace(own_plans, monkeypatch):
    """A shape's plan is the planner's split count and the current
    workspace's pointers, kept for the next call at that shape; one split
    needs no workspace; a workspace that grows drops every kept plan, whose
    pointers it freed."""
    flash, cpu = own_plans, torch.device("cpu")
    plan = flash._decode_plan(cpu, 0, 4, 28, 4, 160)
    counters, partials = flash._DECODE_WORKSPACE[None, 0][4:]
    assert plan == (5, counters.data_ptr(), counters.numel(), partials.data_ptr(),
                    partials.numel())
    assert counters.numel() >= 16 and partials.numel() >= 16 * 5 * flash.DECODE_RECORD_FLOATS
    assert flash._DECODE_PLANS[None, 0, 4, 28, 4, 160] is plan
    assert flash._decode_plan(cpu, 0, 4, 28, 4, 20) == (1, None, 0, None, 0)
    assert len(flash._DECODE_PLANS) == 2
    monkeypatch.setattr(flash, "_sm_count", lambda index: 1000)
    grown = flash._decode_plan(cpu, 0, 4, 28, 4, 100_000)  # 64 splits of 16 blocks
    assert grown[0] == DECODE_MAX_SPLITS and grown[3] != plan[3]
    assert grown[4] >= 16 * DECODE_MAX_SPLITS * flash.DECODE_RECORD_FLOATS
    assert list(flash._DECODE_PLANS) == [(None, 0, 4, 28, 4, 100_000)]


def test_decode_plans_are_bounded(own_plans, monkeypatch):
    """Sk rises by one a decode step, so the kept plans are emptied when
    they reach DECODE_PLANS."""
    flash, cpu = own_plans, torch.device("cpu")
    monkeypatch.setattr(flash, "DECODE_PLANS", 3)
    for sk in range(100, 107):
        flash._decode_plan(cpu, 0, 4, 28, 4, sk)
        assert 1 <= len(flash._DECODE_PLANS) <= 3
    assert (None, 0, 4, 28, 4, 106) in flash._DECODE_PLANS
