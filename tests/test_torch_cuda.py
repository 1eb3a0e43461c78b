"""Each hand-written CUDA kernel against its plain torch version, on the card.

These tests need an NVIDIA GPU with nvcc (sm_90a) and skip without one;
they import neither jax nor the reference package, so they also run where
only torch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: f32 sums in another order, so 1e-5 of the largest output; the
k-means labels (ties included) are exact. gram (the few-row route's f32
CUDA-core sums at m <= M_ROWS, else 3xTF32 on the tensor cores) is also
exactly symmetric, two calls give the same bits, each call with d > 0 is
one launch with no synchronizing call, it copies only rows it cannot read
where they lie (a 16-byte base and row stride), and on clustered rows its
Δ is within 2x the error of ``g @ g.T`` in full f32 against an f64 Gram;
a plan it cannot take is refused. The mix and the masked
mix-scatter run one register-tiled core (``csrc/mix_tile.cuh``) whose sums
run in order, so their bits are exact where the order is the same: two
calls, W with zero pad columns against the unpadded W, and the identity
scatter against mix_aggregate. The mix's few-row route (k, m <= 16,
``csrc/mix_aggregate.cu``'s mix_rows_kernel) sums in the tile route's
order: its f32 output is bit for bit the tile route's (``route="tiles"``),
its bf16 output bit for bit the tile route's f32 output cast to bf16, on
both its paths (16-byte packs and the scalar path of odd widths and
offset views) and past 2^31 elements of θ. flash_attention: in f32 atol
2e-5 (outputs are averages of unit-scale v; the kernel's online softmax
sums in another order than the plain version's whole row); in bfloat16
both compute in f32 from the same inputs and round once, so they differ
by at most two bf16 steps of the largest output (2^-6 of it), and each
element by at most one bf16 step of itself plus 2^-7 of the median output
(``assert_each_within_a_step``). bf16 prefill shapes take the tensor-core
tile (``flash_route``), whose probabilities keep 16 bits through a hi/lo
bf16 split: at qwen2-7b's prefill shape it stays within one bf16 step
(2^-7 of the largest output), and its mean error is at most half that of
the plain version with P rounded to bf16 (what a tile without the lo half
would give). Decode (Sq = 1) takes the split-KV decode kernel in f32 and
bf16, whose splits merge in a fixed order: strided views give the bits of
contiguous inputs, and a reduced bf16 model's decode steps match the
plain attention's within 2^-5 of the largest logit, as its prefill does.
Under autograd each kernel runs inside ``FlashAttentionFn``: the gradients
of q, k and v within 2^-7 of the largest of each against autograd through
the plain version, and a reduced f32 model's per-client loss gradients on
the card within 1e-4 of the CPU's.
"""
import ctypes
import functools

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels.flash_attention import FLASH_DEC, FLASH_FMA, FLASH_TC, flash_route
from repro_torch.kernels.kmeans_assign import ASSIGN, kmeans_plan
from repro_torch.kernels.masked_mix_scatter import MIX_SCATTER
from repro_torch.kernels.mix_aggregate import (MIX, ROUTE_ROWS, ROUTE_TILES, mix_aggregate_cuda,
                                               mix_plan)
from repro_torch.kernels import pairwise_delta
from repro_torch.kernels.cohort_gather import GATHER
from repro_torch.kernels.pairwise_delta import GRAM, M_ROWS


def cuda_device():
    """The CUDA device, or skip the calling test (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


GRAM_CASES = [  # (m, d, row stride or None for contiguous, padded copy)
    (100, 47571, None, True),    # the special round's width, contiguous: unaligned rows
    (100, 47616, None, False),   # the slab-wide rows the special round hands the kernel
    (512, 47616, None, False),   # 512 clients: ten tiles, two slices a stage
    (50, 47616, None, False),    # FedFomo's 50-slot cohort: one tile of one job
    (1, 33, None, True),
    (7, 300, None, False),
    (130, 1000, None, False),    # a second row tile of 2 rows
    (100, 1000, 1040, False),    # a row-strided view: read where it lies
    (100, 1000, 1001, True),     # a row stride TMA cannot take
    # the few-row route (m <= M_ROWS)
    (2, 47616, None, False),     # the collaboration round's widest rows have 2 clients
    (3, 47616, None, False),
    (4, 47616, None, False),     # gram_m4
    (4, 47571, 47616, False),    # d % 4 = 3 on aligned rows: the kernel masks the tail
    (2, 1003, 1004, False),
    (3, 1001, None, True),       # d % 4 = 1, contiguous: rows 4 bytes apart, the padded copy
    (4, 1000, 1001, True),       # a row stride float4 loads cannot take
    (4, 0, None, False),         # no columns: zeros, no launch
    (1, 5, None, True),
    (M_ROWS, 47616, None, False),
    (M_ROWS + 1, 47616, None, False),  # the tensor-core route's fewest rows
]


def gram_input(m, d, stride, dev, seed=0):
    gen = torch.Generator().manual_seed(seed + m)
    g = torch.randn(m, d, generator=gen, dtype=torch.float32)
    if stride is None:
        return g.to(dev)
    buf = torch.zeros(m, stride, dtype=torch.float32, device=dev)
    buf[:, :d] = g.to(dev)
    return buf[:, :d]


@pytest.mark.cuda
@pytest.mark.parametrize("m,d,stride,padded", GRAM_CASES)
def test_cuda_gram_matches_plain(m, d, stride, padded):
    """Exactly symmetric, within 1e-5 of the largest entry of the plain
    version, one launch a call with columns (none without), a padded copy
    only where the kernel cannot read the rows, and two calls bit-equal."""
    dev = cuda_device()
    g = gram_input(m, d, stride, dev)
    launches, copies = GRAM.launches, GRAM.padded
    got = ops.gram(g, impl="cuda")
    assert GRAM.launches - launches == int(d > 0) and GRAM.padded - copies == int(padded)
    want = ref.gram(g)
    torch.cuda.synchronize()
    assert torch.equal(got, got.T)
    tol = 1e-5 * float(want.abs().max())
    assert float((got - want).abs().max()) <= tol
    assert torch.equal(got, ops.gram(g, impl="cuda"))


def clustered_rows(m, d, groups, noise, dev, seed=0):
    """m rows in ``groups`` clusters: each the group's common gradient plus
    noise at ``noise`` of its norm."""
    gen = torch.Generator().manual_seed(seed)
    common = torch.randn(groups, d, generator=gen, dtype=torch.float64)
    jitter = torch.randn(m, d, generator=gen, dtype=torch.float64)
    rows = common[torch.arange(m) % groups]
    rows = rows + noise * rows.norm(dim=1, keepdim=True) * jitter / jitter.norm(dim=1, keepdim=True)
    return rows.to(dev)


@pytest.mark.cuda
def test_cuda_gram_delta_on_clustered_rows():
    """Δ where clients nearly agree (4 groups, noise 1e-3 of the norm) at
    the special round's shape: against Δ from an f64 Gram, the kernel's
    largest error is within 2x that of Δ from g @ g.T in full f32 (TF32
    off) and within 1e-5 of the largest diagonal."""
    dev = cuda_device()
    g64 = clustered_rows(100, 47571, 4, 1e-3, dev)
    g = g64.float()
    exact = ref.delta_from_gram(g.double() @ g.double().T)
    kernel = ref.delta_from_gram(ops.gram(g, impl="cuda").double())
    plain = ref.delta_from_gram((g @ g.T).double())
    err, err_plain = float((kernel - exact).abs().max()), float((plain - exact).abs().max())
    diag = float(torch.diagonal(g.double() @ g.double().T).max())
    assert err <= 2 * err_plain and err <= 1e-5 * diag, (err, err_plain, diag)


@pytest.mark.cuda
def test_cuda_gram_delta_on_near_equal_rows():
    """Δ between near-equal rows (one base plus noise at 1e-3 of its norm,
    as FedFomo's trained models lie) on the slab-wide (100, 47,616) rows:
    against Δ from an f64 Gram, the kernel's largest error is at most that
    of Δ from g @ g.T in full f32 (TF32 off)."""
    dev = cuda_device()
    g = torch.zeros(100, 47616, device=dev)
    g[:, :47571] = clustered_rows(100, 47571, 1, 1e-3, dev).float()
    exact = ref.delta_from_gram(g.double() @ g.double().T)
    kernel = ref.delta_from_gram(ops.gram(g, impl="cuda").double())
    plain = ref.delta_from_gram((g @ g.T).double())
    err, err_plain = float((kernel - exact).abs().max()), float((plain - exact).abs().max())
    assert err <= err_plain, (err, err_plain)


@pytest.mark.cuda
def test_cuda_gram_makes_no_synchronizing_call():
    dev = cuda_device()
    g = gram_input(100, 47616, None, dev)
    ops.gram(g, impl="cuda")  # the stream's workspace exists from here on
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ops.gram(g, impl="cuda")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def assert_plans_refused(m, bads, partial_floats):
    """Each plan in ``bads`` is refused before any launch; the counters
    stay at zero, so the next call runs."""
    dev = cuda_device()
    g = gram_input(m, 1000, None, dev)
    for bad in bads:
        vals = (ctypes.c_longlong * len(bad))(*bad)
        counters = torch.zeros(2, dtype=torch.int32, device=dev)
        partial = torch.empty(partial_floats, device=dev)
        out = torch.empty(m, m, device=dev)
        with pytest.raises(RuntimeError, match="invalid argument"):
            GRAM(dev, g.data_ptr(), 1000, m, 1000, ctypes.cast(vals, ctypes.c_void_p),
                 len(bad), partial.data_ptr(), partial.numel(), counters.data_ptr(),
                 out.data_ptr())
    assert torch.equal(ops.gram(g, impl="cuda"), ops.gram(g, impl="cuda"))


@pytest.mark.cuda
def test_cuda_gram_refuses_a_plan_it_cannot_take():
    """A plan whose chunk is not a whole number of ring stages, whose tile
    list is short, or whose route is unknown, is refused before any
    launch; the counters stay at zero, so the next call runs."""
    plan = pairwise_delta.gram_plan(100, 1000, 132)
    v = plan.values()
    assert_plans_refused(100, (v[:-1], v[:12] + [v[12] + 1] + v[13:], [7] + v[1:]),
                         plan.partial_floats)


@pytest.mark.cuda
def test_cuda_gram_few_rows_refuse_a_plan_they_cannot_take():
    """A few-row plan whose run is not a multiple of 4 columns, whose
    blocks leave columns out, whose partials are miscounted or past the
    workspace, or whose values are short or long, is refused before any
    launch."""
    plan = pairwise_delta.gram_plan(4, 1000, 132)
    route, m, d, blocks, run, floats = v = plan.values()
    assert route == pairwise_delta.ROUTE_ROWS
    assert_plans_refused(4, ([route, m, d, blocks, run + 2, floats],
                             [route, m, d, blocks, 4, floats],
                             [route, m, d, blocks, run, floats - 1],
                             [route, m, d, blocks, run, 2**21], v[:-1], v + [0]), 2**20)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [2, 4])
def test_cuda_gram_few_rows_against_f64(m):
    """The few-row route on clustered rows (2 groups, noise 1e-3 of the
    norm) at 4,194,307 columns: within 1e-6 of the largest entry of an f64
    Gram (its f32 sums run over ~124 columns a thread), Δ no worse than
    from ``g @ g.T`` in full f32, one launch and no synchronizing call."""
    dev = cuda_device()
    g = clustered_rows(m, 4_194_307, 2, 1e-3, dev).float()
    launches = GRAM.launches
    got = ops.gram(g, impl="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ops.gram(g, impl="cuda")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert GRAM.launches - launches == 2
    exact = g.double() @ g.double().T
    assert float((got.double() - exact).abs().max()) <= 1e-6 * float(exact.abs().max())
    kernel = ref.delta_from_gram(got.double())
    plain = ref.delta_from_gram((g @ g.T).double())
    want = ref.delta_from_gram(exact)
    assert float((kernel - want).abs().max()) <= float((plain - want).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("k,m,d", [(100, 100, 47616), (4, 100, 47616), (5, 7, 97), (3, 600, 513),
                                   (1, 100, 47616),   # the FedAvg family's mean over the slab
                                   (50, 50, 47616),   # FedFomo's mix over a 50-slot cohort
                                   (1, 50, 47616),    # the FedAvg mean of 50 uploads
                                   (150, 512, 1000),  # a second row tile, a 32-chunk ring
                                   (1, 3, 5),         # the scalar path, one tail chunk
                                   (16, 100, 4096)])  # the 64-row tile, 6 warps past k
def test_cuda_mix_aggregate_matches_plain(k, m, d):
    dev = cuda_device()
    gen = torch.Generator().manual_seed(k + m)
    w = torch.softmax(torch.randn(k, m, generator=gen), dim=1).to(dev)
    th = torch.randn(m, d, generator=gen).to(dev)
    got = ops.mix_aggregate(w, th, impl="cuda")
    want = ref.mix_aggregate(w, th)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("m,f,k", [(100, 100, 4), (100, 100, 100), (37, 5, 3),
                                   (100, 100, 99),    # Algorithm 2's largest k at m = 100
                                   (300, 512, 40),    # wide rows, lanes take centroids
                                   (512, 512, 511),   # centroids staged in 14 chunks
                                   (5, 0, 3)])        # width 0: every distance 0, label 0
def test_cuda_kmeans_assign_matches_plain(m, f, k):
    dev = cuda_device()
    gen = torch.Generator().manual_seed(m + k)
    p = torch.randn(m, f, generator=gen).to(dev)
    c = torch.randn(k, f, generator=gen).to(dev)
    c[-1] = c[0]  # an exact tie: the lower index wins
    gl, gd = ops.kmeans_assign(p, c, impl="cuda")
    wl, wd = ref.kmeans_assign(p, c)
    torch.cuda.synchronize()
    assert torch.equal(gl, wl)
    assert float((gd - wd).abs().max()) <= 1e-5 * float(wd.abs().max())


@pytest.mark.cuda
def test_cuda_mix_aggregate_offset_view_takes_the_scalar_path():
    """θ one float into its buffer (d % 4 == 0, base not 16-byte aligned):
    the plan takes the scalar path, and the result is the bits of the
    aligned copy's."""
    dev = cuda_device()
    k, m, d = 100, 100, 1000
    gen = torch.Generator().manual_seed(3)
    w = torch.softmax(torch.randn(k, m, generator=gen), dim=1).to(dev)
    view = torch.empty(m * d + 1, device=dev)[1:].view(m, d)
    view.copy_(torch.randn(m, d, generator=gen))
    assert not mix_plan(k, m, d, view.data_ptr(), 0).vec
    got = ops.mix_aggregate(w, view, impl="cuda")
    want = ref.mix_aggregate(w, view)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert torch.equal(got, ops.mix_aggregate(w, view.clone(), impl="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("k,m,d", [(100, 100, 47616), (4, 100, 47616), (150, 512, 1000),
                                   (5, 7, 97)])
def test_cuda_mix_aggregate_is_deterministic_and_ignores_zero_columns(k, m, d):
    """Every output sums j = 0..m-1 in order with FMAs from 0: two calls
    give the same bits, and W with 28 zero columns appended (θ with 28
    matching rows) gives the bits of the unpadded product."""
    dev = cuda_device()
    gen = torch.Generator().manual_seed(k * m)
    w = torch.softmax(torch.randn(k, m, generator=gen), dim=1).to(dev)
    th = torch.randn(m, d, generator=gen).to(dev)
    first = ops.mix_aggregate(w, th, impl="cuda")
    assert torch.equal(first, ops.mix_aggregate(w, th, impl="cuda"))
    w_pad = torch.cat([w, torch.zeros(k, 28, device=dev)], dim=1)
    th_pad = torch.cat([th, torch.randn(28, d, generator=gen).to(dev)], dim=0)
    assert torch.equal(first, ops.mix_aggregate(w_pad, th_pad, impl="cuda"))


MIX_ROWS_CASES = [  # (k, m, d): the few-row route at the train step's and the engine's shapes
    (4, 4, 1_048_576),  # user_centric over a leaf, 16-byte packs
    (2, 4, 65_536),     # the centroid rules
    (1, 4, 47_616),     # fedavg's mean; the engine's (1, 4) combine
    (2, 2, 131_072),    # families-agree's two clients
    (16, 16, 4_096),    # the route's most rows
    (3, 7, 1_000),      # f32 packs, bf16 scalar (1,000 % 8 != 0)
    (4, 4, 4_099),      # an odd width: the scalar path
    (1, 1, 5),          # narrower than a pack
    (5, 13, 2_056),
]


def mix_inputs(k, m, d, dtype, dev, seed=0):
    gen = torch.Generator().manual_seed(seed + k * 100 + m)
    w = torch.softmax(torch.randn(k, m, generator=gen), dim=1).to(dev)
    th = torch.randn(m, d, generator=gen).to(dtype).to(dev)
    return w, th


@pytest.mark.cuda
@pytest.mark.parametrize("k,m,d", MIX_ROWS_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_mix_rows_matches_plain_and_the_tile_route(k, m, d, dtype):
    """The few-row route against the plain version (f32 within 1e-5 of the
    largest output; bf16 within one bf16 step of each output plus that f32
    allowance: the two f32 sums, in other orders, may round to neighbouring
    bf16 values, and where the terms cancel the sums differ by more than a
    step of the small result), and bit for
    bit against the tile route: f32 its output, bf16 its f32 output on the
    widened θ cast to bf16. One launch a call, θ's dtype out."""
    dev = cuda_device()
    w, th = mix_inputs(k, m, d, dtype, dev)
    assert mix_plan(k, m, d, th.data_ptr(), 0, elem=th.element_size()).route == "rows"
    before = MIX.launches
    got = ops.mix_aggregate(w, th, impl="cuda")
    assert MIX.launches - before == 1 and got.dtype == dtype and got.shape == (k, d)
    want = ref.mix_aggregate(w, th)
    tiles = mix_aggregate_cuda(w, th.float(), route="tiles")
    torch.cuda.synchronize()
    if dtype == torch.float32:
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
        assert torch.equal(got, tiles)
    else:
        err = (got.float() - want.float()).abs()
        allowed = 2.0 ** -7 * want.float().abs() + 1e-5 * float(want.float().abs().max())
        assert bool((err <= allowed).all())
        assert torch.equal(got, tiles.to(torch.bfloat16))
        assert torch.equal(got, mix_aggregate_cuda(w, th, route="tiles"))
    assert torch.equal(got, ops.mix_aggregate(w, th, impl="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,offset", [(torch.float32, 1), (torch.bfloat16, 1),
                                          (torch.bfloat16, 4), (torch.float32, 4)])
def test_cuda_mix_rows_offset_view_takes_the_scalar_path(dtype, offset):
    """θ ``offset`` elements into its buffer (d a multiple of every pack):
    the plan takes the scalar path unless the view lies on a 16-byte
    boundary, and the bits are the aligned copy's and the tile route's."""
    dev = cuda_device()
    k, m, d = 2, 4, 8_192
    w, th = mix_inputs(k, m, d, dtype, dev, seed=7)
    buf = torch.empty(m * d + offset, dtype=dtype, device=dev)
    view = buf[offset:].view(m, d)
    view.copy_(th)
    vec = (offset * th.element_size()) % 16 == 0
    assert mix_plan(k, m, d, view.data_ptr(), 0, elem=th.element_size()).vec == vec
    got = ops.mix_aggregate(w, view, impl="cuda")
    torch.cuda.synchronize()
    assert torch.equal(got, ops.mix_aggregate(w, th, impl="cuda"))
    assert torch.equal(got, mix_aggregate_cuda(w, view.float(), route="tiles").to(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_mix_rows_past_2_31_elements(dtype):
    """A (2, 2)·(2, 2^30 + 2,056) θ, 2^31 + 4,112 elements (mamba2's widest
    leaf passes 2^31 at 4 rows): the route addresses rows, runs and packs
    with 64-bit offsets. Columns near the end, past 2^31 elements of θ's
    buffer, against the plain version on a slice."""
    dev = cuda_device()
    k, m, d = 2, 2, 2**30 + 2_056
    th = torch.empty(m, d, dtype=dtype, device=dev)
    th.normal_(generator=torch.Generator(device=dev).manual_seed(5))
    w = torch.tensor([[0.25, 0.75], [0.5, 0.5]], device=dev)
    got = ops.mix_aggregate(w, th, impl="cuda")
    for c0 in (0, d // 2, d - 4_096):
        part = th[:, c0: c0 + 4_096]
        want = mix_aggregate_cuda(w, part.float().contiguous(), route="tiles").to(dtype)
        assert torch.equal(got[:, c0: c0 + 4_096], want), c0
    del th, got
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_cuda_mix_and_kmeans_refuse_a_plan_they_do_not_take():
    """A plan that disagrees with the kernel's own layout is refused by the
    launch (cudaErrorInvalidConfiguration) and raises; no launch counts."""
    dev = cuda_device()
    w = torch.rand(4, 8, device=dev)
    th = torch.rand(8, 256, device=dev)
    out = torch.empty(4, 256, device=dev)
    plan = mix_plan(4, 20, 256, th.data_ptr(), out.data_ptr())
    before = MIX.launches
    w20, th20 = torch.rand(4, 20, device=dev), torch.rand(20, 256, device=dev)
    with pytest.raises(RuntimeError, match="launch failed"):
        MIX(dev, _build.ptr(w20), _build.ptr(th20), _build.ptr(out), 4, 20, 256, ROUTE_TILES, 0,
            plan.tile, int(plan.vec), plan.blocks, plan.smem_bytes + 4, 0)
    rows = mix_plan(4, 8, 256, th.data_ptr(), out.data_ptr())
    for m, d, bf16, blocks, run in ((8, 256, 0, rows.blocks + 1, rows.run),  # an empty block
                                    (8, 256, 0, rows.blocks, rows.run + 4),  # half a bf16 pack
                                    (17, 256, 0, rows.blocks, rows.run),     # too many rows
                                    (8, 252, 1, rows.blocks, rows.run)):     # 252 % 8 != 0
        with pytest.raises(RuntimeError, match="launch failed"):
            MIX(dev, _build.ptr(w), _build.ptr(th), _build.ptr(out), 4, m, d, ROUTE_ROWS, bf16,
                0, 1, blocks, 0, run)
    with pytest.raises(RuntimeError, match="launch failed"):  # θ one float in: no 16-byte path
        MIX(dev, _build.ptr(w), ctypes.c_void_p(th.data_ptr() + 4), _build.ptr(out), 4, 8, 252,
            ROUTE_ROWS, 0, 0, 1, 1, 0, rows.run)
    assert MIX.launches == before
    p = torch.rand(10, 8, device=dev)
    labels = torch.empty(10, dtype=torch.int32, device=dev)
    dist = torch.empty(10, device=dev)
    kp = kmeans_plan(10, 3, 8, p.data_ptr(), p.data_ptr())
    before_assign = ASSIGN.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        ASSIGN(dev, _build.ptr(p), _build.ptr(p), _build.ptr(labels), _build.ptr(dist), 10, 3, 8,
               int(kp.vec), kp.stride, kp.groups, kp.chunk, kp.per_lane, kp.warps, kp.blocks + 1,
               kp.smem_bytes)
    assert ASSIGN.launches == before_assign


@pytest.mark.cuda
@pytest.mark.parametrize("k", [41, 64, 99])
def test_cuda_kmeans_tie_across_lanes_goes_to_the_lower_index(k):
    """Identical centroids at indices 3 and 40 lie in different lanes (every
    lane its own centroids at k >= 32): points nearest to them take 3."""
    dev = cuda_device()
    gen = torch.Generator().manual_seed(k)
    c = torch.randn(k, 100, generator=gen)
    c[40] = c[3]
    p = torch.randn(100, 100, generator=gen)
    p[:20] = c[3] + 1e-3 * torch.randn(20, 100, generator=gen)
    labels, _ = ops.kmeans_assign(p.to(dev), c.to(dev), impl="cuda")
    want, _ = ref.kmeans_assign(p, c)
    torch.cuda.synchronize()
    assert torch.equal(labels.cpu(), want)
    assert bool((labels[:20] == 3).all()) and not bool((labels == 40).any())


def _cohort(m, c, real, gen, dev):
    """idx (c,) int32 with ``real`` sorted members then the sentinel m, and
    the matching mask, on ``dev``."""
    members = torch.sort(torch.randperm(m, generator=gen)[:real]).values
    idx = torch.full((c,), m, dtype=torch.int32)
    idx[:real] = members.to(torch.int32)
    mask = torch.zeros(c, dtype=torch.bool)
    mask[:real] = True
    return idx.to(dev), mask.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("m,d,c,real,misalign", [
    (100, 47616, 50, 42, False),  # the main path's slab and a padded cohort
    (13, 97, 6, 4, False),        # odd width: the scalar path
    (7, 300, 7, 7, True),         # d % 4 == 0 but a misaligned base: the scalar path
    (100, 47616, 50, 0, False),   # all pads: every slot reads row m-1
    (100, 95232, 50, 42, False),  # SCAFFOLD's two-stream EF slab under a quantized wire
    (100, 95232, 50, 0, False),
])
def test_cuda_cohort_gather_matches_plain(m, d, c, real, misalign):
    dev = cuda_device()
    gen = torch.Generator().manual_seed(m + c)
    base = torch.randn(m * d + 1, generator=gen).to(dev)
    full = (base[1:] if misalign else base[:-1]).view(m, d)  # [1:] is 4 bytes off
    idx, _ = _cohort(m, c, real, gen, dev)
    for index in (idx, idx.long()):
        got = ops.cohort_gather(full, index, impl="cuda")
        torch.cuda.synchronize()
        assert torch.equal(got, ref.cohort_gather(full, index))


@pytest.mark.cuda
@pytest.mark.parametrize("m,c,d,real", [(100, 50, 47616, 42), (13, 5, 97, 3), (100, 50, 47616, 0),
                                        (600, 40, 513, 40)])
def test_cuda_masked_mix_scatter_matches_plain(m, c, d, real):
    dev = cuda_device()
    gen = torch.Generator().manual_seed(m + c + d)
    idx, mask = _cohort(m, c, real, gen, dev)
    w = torch.zeros(c, c)
    w[:, :real] = torch.softmax(torch.randn(c, real, generator=gen), dim=1) if real else 0.0
    w = w.to(dev)
    theta = torch.randn(c, d, generator=gen).to(dev)
    full = torch.randn(m, d, generator=gen).to(dev)
    before = full.clone()
    want = ref.masked_mix_scatter(w, theta, idx, mask, full)
    got = ops.masked_mix_scatter(w, theta, idx, mask, full, impl="cuda")
    torch.cuda.synchronize()
    assert got.data_ptr() == full.data_ptr()  # written in place
    assert float((got - want).abs().max()) <= 1e-5 * max(float(want.abs().max()), 1.0)
    outside = torch.ones(m, dtype=torch.bool, device=dev)
    outside[idx[mask].long()] = False
    assert torch.equal(got[outside], before[outside])
    if real:  # the unpadded cohort writes exactly the same bits
        unpadded = before.clone()
        ops.masked_mix_scatter(w[:real, :real].contiguous(), theta[:real].contiguous(),
                               idx[:real], mask[:real], unpadded, impl="cuda")
        torch.cuda.synchronize()
        assert torch.equal(unpadded, got)


@pytest.mark.cuda
def test_cuda_masked_mix_scatter_masked_in_bounds_slot_keeps_its_row():
    dev = cuda_device()
    full = torch.randn(8, 256, generator=torch.Generator().manual_seed(0)).to(dev)
    before = full.clone()
    idx = torch.tensor([0, 2, 5, 7], dtype=torch.int32, device=dev)
    mask = torch.tensor([True, True, False, True], device=dev)
    w = torch.eye(4, device=dev)
    theta = torch.ones(4, 256, device=dev)
    ops.masked_mix_scatter(w, theta, idx, mask, full, impl="cuda")
    torch.cuda.synchronize()
    assert torch.equal(full[5], before[5]) and torch.equal(full[[0, 2, 7]], theta[:3])


@pytest.mark.cuda
def test_cuda_masked_mix_scatter_rejects_overlap():
    dev = cuda_device()
    full = torch.randn(10, 128, device=dev)
    idx = torch.arange(3, dtype=torch.int32, device=dev)
    mask = torch.ones(3, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="overlaps"):
        ops.masked_mix_scatter(torch.eye(3, device=dev), full[4:7], idx, mask, full, impl="cuda")
    with pytest.raises(ValueError, match="overlaps"):
        ops.masked_mix_scatter(full[0, :9].view(3, 3), torch.ones(3, 128, device=dev), idx, mask,
                               full, impl="cuda")


def _scatter_inputs(m, c, real, d, seed, dev, full_offset=False):
    """A padded cohort's (w, theta, idx, mask, full) on ``dev``: ``real``
    members and c - real pad slots, W's pad columns 0. With
    ``full_offset`` full is a view 4 bytes into its buffer (the scalar
    path at d % 4 == 0)."""
    gen = torch.Generator().manual_seed(seed)
    idx, mask = _cohort(m, c, real, gen, dev)
    w = torch.zeros(c, c)
    w[:, :real] = torch.softmax(torch.randn(c, real, generator=gen), dim=1)
    theta = torch.randn(c, d, generator=gen).to(dev)
    base = torch.randn(m * d + 1, generator=gen).to(dev)
    full = (base[1:] if full_offset else base[:-1]).view(m, d)
    return w.to(dev), theta, idx, mask, full


@pytest.mark.cuda
@pytest.mark.parametrize("path,d,full_offset,vec", [("vec", 1000, False, True),
                                                    ("odd", 97, False, False),
                                                    ("offset", 1000, True, False)])
@pytest.mark.parametrize("c", [1, 4, 5, 50, 64, 65, 100, 130])
def test_cuda_masked_mix_scatter_tiles_match_plain(c, path, d, full_offset, vec):
    """Every tile of mix_plan (4 rows for c <= 4, 64 for c <= 64, else 128
    over row tiles) on the 16-byte and the scalar path, with pad slots:
    the live rows within 1e-5 of the largest output, every other row of
    full unchanged, and the unpadded cohort's bits."""
    dev = cuda_device()
    m, real = 200, c - c // 8
    w, theta, idx, mask, full = _scatter_inputs(m, c, real, d, c + d, dev, full_offset)
    assert mix_plan(c, c, d, theta.data_ptr(), full.data_ptr()).vec == vec
    before = full.clone()
    want = ref.masked_mix_scatter(w, theta, idx, mask, full)
    got = ops.masked_mix_scatter(w, theta, idx, mask, full, impl="cuda")
    torch.cuda.synchronize()
    assert got.data_ptr() == full.data_ptr()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    outside = torch.ones(m, dtype=torch.bool, device=dev)
    outside[idx[mask].long()] = False
    assert torch.equal(got[outside], before[outside])
    unpadded = before.clone()
    ops.masked_mix_scatter(w[:real, :real].contiguous(), theta[:real].contiguous(), idx[:real],
                           mask[:real], unpadded, impl="cuda")
    torch.cuda.synchronize()
    assert torch.equal(unpadded, got)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [4, 50, 100])
def test_cuda_masked_mix_scatter_repeats_its_bits(c):
    """Two calls on the same inputs write the same bits (ordered sums)."""
    dev = cuda_device()
    w, theta, idx, mask, full = _scatter_inputs(100, c, c - c // 8, 47616, c, dev)
    first = ops.masked_mix_scatter(w, theta, idx, mask, full.clone(), impl="cuda")
    second = ops.masked_mix_scatter(w, theta, idx, mask, full.clone(), impl="cuda")
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [5, 50, 130])
def test_cuda_masked_mix_scatter_all_pad_cohort_is_a_no_op(c):
    """A cohort of pad slots only (sentinel m, mask off) writes nothing."""
    dev = cuda_device()
    m = 200
    w, theta, _, _, full = _scatter_inputs(m, c, 1, 1000, c, dev)
    before = full.clone()
    idx = torch.full((c,), m, dtype=torch.int32, device=dev)
    ops.masked_mix_scatter(w, theta, idx, torch.zeros(c, dtype=torch.bool, device=dev), full,
                           impl="cuda")
    torch.cuda.synchronize()
    assert torch.equal(full, before)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [4, 50, 100])
def test_cuda_identity_scatter_equals_mix_aggregate(c):
    """idx = 0..c-1, every slot live, into a zero (c, d) full: the scatter
    epilogue writes the bits of mix_aggregate's dense store, since both run
    one core on the same plan."""
    dev = cuda_device()
    d = 47616
    gen = torch.Generator().manual_seed(c)
    w = torch.softmax(torch.randn(c, c, generator=gen), dim=1).to(dev)
    theta = torch.randn(c, d, generator=gen).to(dev)
    full = torch.zeros(c, d, device=dev)
    idx = torch.arange(c, dtype=torch.int32, device=dev)
    mask = torch.ones(c, dtype=torch.bool, device=dev)
    got = ops.masked_mix_scatter(w, theta, idx, mask, full, impl="cuda")
    torch.cuda.synchronize()
    assert torch.equal(got, ops.mix_aggregate(w, theta, impl="cuda"))


@pytest.mark.cuda
def test_cuda_masked_mix_scatter_refuses_a_plan_it_does_not_take():
    """A plan whose blocks or shared memory disagree with the tile is
    refused by the launch and raises; no launch counts."""
    dev = cuda_device()
    w, theta, idx, mask, full = _scatter_inputs(100, 50, 42, 47616, 0, dev)
    plan = mix_plan(50, 50, 47616, theta.data_ptr(), full.data_ptr())
    before = MIX_SCATTER.launches
    for blocks, smem in ((plan.blocks + 1, plan.smem_bytes), (plan.blocks, plan.smem_bytes + 4)):
        with pytest.raises(RuntimeError, match="launch failed"):
            MIX_SCATTER(dev, _build.ptr(w), _build.ptr(theta), _build.ptr(idx),
                        _build.ptr(mask), _build.ptr(full), 50, 100, 47616, plan.tile,
                        int(plan.vec), blocks, smem)
    assert MIX_SCATTER.launches == before


@pytest.mark.cuda
def test_cuda_masked_mix_scatter_makes_no_sync():
    """The wrapper reads nothing back from the card: 20 calls at the
    cohort phase's shape make no synchronizing call."""
    import warnings

    dev = cuda_device()
    w, theta, idx, mask, full = _scatter_inputs(100, 50, 42, 47616, 1, dev)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(20):
                ops.masked_mix_scatter(w, theta, idx, mask, full, impl="cuda")
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert not [x for x in caught if "called a synchronizing" in str(x.message)]


@pytest.mark.cuda
@pytest.mark.parametrize("num_streams", [None, 2])
def test_cuda_cohort_round_matches_cpu(num_streams):
    from repro_torch.core import FedConfig, clustering, ucfl
    from repro_torch.data import loader, synthetic
    from repro_torch.federated import participation
    from repro_torch.models import lenet

    dev = cuda_device()
    torch.backends.cudnn.allow_tf32 = False
    kw = dict(m=8, n=80, n_test=20, num_classes=6, hw=(16, 16))
    cpu_data = synthetic.covariate_label_shift(0, device="cpu", **kw)
    gpu_data = synthetic.FederatedData(*(a.to(dev) for a in cpu_data))
    p0 = lenet.init(torch.Generator().manual_seed(0), input_hw=(16, 16), num_classes=6,
                    device="cpu")
    cfg = FedConfig(batch_size=20)
    host = ucfl.make_ucfl(lenet.apply_stacked, p0, cfg, num_streams=num_streams,
                          var_batch_size=20, device="cpu")
    card = ucfl.make_ucfl(lenet.apply_stacked, p0, cfg, num_streams=num_streams,
                          var_batch_size=20, device=dev)
    seeds = None  # both sides start K-means from the same seeds
    if num_streams is not None:
        w_host = ucfl.compute_collaboration(lenet.apply_stacked, p0, cpu_data,
                                            var_batch_size=20)["W"]
        seeds = clustering._plusplus_init(torch.Generator().manual_seed(2), w_host, num_streams)
    hs = host.init(None, cpu_data, kmeans_init=seeds)
    cs = card.init(None, gpu_data, kmeans_init=None if seeds is None else seeds.to(dev))
    cohort = participation.pad_slots(participation.as_cohort([1, 3, 6], 8), 5, 8)
    perms = loader.draw_permutations(torch.Generator().manual_seed(2), 8, 1, 80, device="cpu")
    hs, hm = host.round(hs, cpu_data, None, cohort, perms=perms)
    cs, cm = card.round(cs, gpu_data, None, cohort, perms=perms.to(dev))
    torch.cuda.synchronize()
    assert hm == cm
    assert float((cs["params"].cpu() - hs["params"]).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fedavg", "fedfomo"])
def test_cuda_baseline_rounds_match_cpu(name):
    """A dense round, then a cohort round with two pad slots, of FedAvg
    (mix_aggregate at k = 1) and FedFomo (gram on the trained rows, then
    mix_aggregate at k = c) on the card against the CPU's plain path, from
    the same data, weights and batch orders: slabs within 1e-4, metrics
    equal, and the kernels launched."""
    from repro_torch.core import REGISTRY, FedConfig
    from repro_torch.data import loader, synthetic
    from repro_torch.federated import participation
    from repro_torch.models import lenet

    dev = cuda_device()
    torch.backends.cudnn.allow_tf32 = False
    kw = dict(m=8, n=80, n_test=20, num_classes=6, hw=(16, 16))
    cpu_data = synthetic.covariate_label_shift(0, device="cpu", **kw)
    gpu_data = synthetic.FederatedData(*(a.to(dev) for a in cpu_data))
    p0 = lenet.init(torch.Generator().manual_seed(0), input_hw=(16, 16), num_classes=6,
                    device="cpu")
    cfg = FedConfig(batch_size=16)
    host = REGISTRY[name](lenet.apply_stacked, p0, cfg, device="cpu")
    card = REGISTRY[name](lenet.apply_stacked, p0, cfg, device=dev)
    hs, cs = host.init(None, cpu_data), card.init(None, gpu_data)
    n_train = 64 if name == "fedfomo" else 80  # FedFomo trains on all but its 16 validation rows
    cohort = participation.pad_slots(participation.as_cohort([1, 3, 6], 8), 5, 8)
    grams, mixes = GRAM.launches, MIX.launches
    for r, c in enumerate([None, cohort]):
        perms = loader.draw_permutations(torch.Generator().manual_seed(r), 8, 1, n_train,
                                         device="cpu")
        hs, hm = host.round(hs, cpu_data, None, c, perms=perms)
        cs, cm = card.round(cs, gpu_data, None, c, perms=perms.to(dev))
        torch.cuda.synchronize()
        assert hm == cm
        assert float((cs["params"].cpu() - hs["params"]).abs().max()) <= 1e-4, r
    assert MIX.launches - mixes == 2
    assert GRAM.launches - grams == (2 if name == "fedfomo" else 0)


def _wire_schema(width, streams):
    from repro_torch.federated import transport

    names = [("delta", "model"), ("control_delta", "control")][:streams]
    return transport.WireSchema(
        "scaffold" if streams == 2 else "fedavg",
        uplink=tuple(transport.Stream(up, width) for up, _ in names),
        downlink=tuple(transport.Stream(down, width) for _, down in names))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("streams", [1, 2])
@pytest.mark.parametrize("direction", ["uplink", "downlink"])
def test_cuda_wire_stage_equals_cpu_bits(kind, streams, direction):
    """The quantize→dequantize→EF stage on the card gives the CPU's bits
    (round-half-even, e4m3 cast, division by a tensor) on a 50-slot
    cohort's (50, 47,616) single-stream and (50, 95,232) SCAFFOLD wire,
    its zero tail included; two calls, the second carrying the EF."""
    from repro_torch.federated import transport

    dev = cuda_device()
    schema = _wire_schema(47571, streams)
    stage = transport.make_wire_stage(schema, transport.TransportConfig(kind), direction)
    rows, width = (50 if direction == "uplink" else 1), schema.width_aligned(direction)
    gen = torch.Generator().manual_seed(streams)
    pre = torch.randn(rows, width, generator=gen)
    post = pre + 0.01 * torch.randn(rows, width, generator=gen) * torch.logspace(
        -2, 2, rows * width // 128).repeat_interleave(128).view(rows, width)
    tails = [slice(lo + 47571, hi) for lo, hi in schema.slices(direction)]
    for tail in tails:
        pre[:, tail], post[:, tail] = 0.0, 0.0
    ef = torch.zeros(rows, width)
    ef_card = ef.to(dev)
    for _ in range(2):
        want, ef = stage(pre, post, ef)
        got, ef_card = stage(pre.to(dev), post.to(dev), ef_card)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want) and torch.equal(ef_card.cpu(), ef)
        assert all(bool((ef[:, tail] == 0).all()) for tail in tails)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ucfl", "fedavg", "scaffold"])
def test_cuda_wire_rounds_match_cpu(name):
    """Two int8 cohort rounds (two pad slots) on the card against the
    CPU's plain path from the same data, weights and batch orders: every
    slab, EF included, within 1e-4 or, where the card's sums flip a
    rounding of the wire, one step of its chunk (twice the CPU's largest
    residual there), for at most 0.1 % of the elements."""
    from repro_torch.core import REGISTRY, FedConfig
    from repro_torch.data import loader, synthetic
    from repro_torch.federated import participation
    from repro_torch.federated.transport import TransportConfig
    from repro_torch.models import lenet

    dev = cuda_device()
    torch.backends.cudnn.allow_tf32 = False
    kw = dict(m=8, n=80, n_test=20, num_classes=6, hw=(16, 16))
    cpu_data = synthetic.covariate_label_shift(0, device="cpu", **kw)
    gpu_data = synthetic.FederatedData(*(a.to(dev) for a in cpu_data))
    p0 = lenet.init(torch.Generator().manual_seed(0), input_hw=(16, 16), num_classes=6,
                    device="cpu")
    base = dict(lr=0.01, momentum=0.0, epochs=5) if name == "scaffold" else {}
    cfg = FedConfig(batch_size=16, transport=TransportConfig("int8"), **base)
    extra = dict(var_batch_size=20) if name == "ucfl" else {}
    host = REGISTRY[name](lenet.apply_stacked, p0, cfg, device="cpu", **extra)
    card = REGISTRY[name](lenet.apply_stacked, p0, cfg, device=dev, **extra)
    hs, cs = host.init(None, cpu_data), card.init(None, gpu_data)
    cohort = participation.pad_slots(participation.as_cohort([1, 3, 6], 8), 5, 8)
    gathers = GATHER.launches
    for r in range(2):
        perms = loader.draw_permutations(torch.Generator().manual_seed(r), 8, cfg.epochs, 80,
                                         device="cpu")
        hs, hm = host.round(hs, cpu_data, None, cohort, perms=perms)
        cs, cm = card.round(cs, gpu_data, None, cohort, perms=perms.to(dev))
        torch.cuda.synchronize()
        assert hm == cm
        width = hs["params"].shape[1]
        step = torch.zeros(width)
        for k in ("ef", "ef_dl"):
            if k in hs:
                peak = hs[k].abs().amax(dim=0).view(-1, 128).amax(dim=1).repeat_interleave(128)
                step += 2 * peak.view(-1, width).amax(dim=0)
        for k, want in hs.items():
            if not isinstance(want, torch.Tensor) or want.dtype != torch.float32 or k in (
                    "W", "collab"):
                continue
            err = (cs[k].cpu() - want).abs()
            assert bool((err <= 1e-4 + step.repeat(want.shape[1] // width)).all()), (r, k)
            assert float((err > 1e-4).float().mean()) <= 1e-3, (r, k)
    per_round = {"ucfl": 3, "fedavg": 2, "scaffold": 4}[name]  # one a gathered slab
    assert GATHER.launches - gathers == 2 * per_round


def _small_task(dev):
    from repro_torch.data import synthetic
    from repro_torch.models import lenet

    torch.backends.cudnn.allow_tf32 = False
    kw = dict(m=8, n=80, n_test=20, num_classes=6, hw=(16, 16))
    cpu_data = synthetic.covariate_label_shift(0, device="cpu", **kw)
    gpu_data = synthetic.FederatedData(*(a.to(dev) for a in cpu_data))
    p0 = lenet.init(torch.Generator().manual_seed(0), input_hw=(16, 16), num_classes=6,
                    device="cpu")
    return cpu_data, gpu_data, p0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ucfl", "ucfl_k2", "ucfl_parallel"])
def test_cuda_refresh_rounds_match_cpu(name):
    """Init and two cohort rounds (two pad slots, then one) with
    ``RefreshConfig()`` on the card against the CPU's plain path: slab, W and
    the refresh buffers within 1e-4, staleness exact; the special round and
    the unit rows' Δ̂ are one gram launch each, with no padded copy."""
    from repro_torch.core import REGISTRY, FedConfig, clustering, ucfl
    from repro_torch.core.similarity import RefreshConfig
    from repro_torch.data import loader
    from repro_torch.federated import participation
    from repro_torch.models import lenet

    dev = cuda_device()
    cpu_data, gpu_data, p0 = _small_task(dev)
    cfg = FedConfig(batch_size=20, w_refresh=RefreshConfig())
    ns = 2 if name == "ucfl_k2" else None
    if name == "ucfl_parallel":
        host, card = (REGISTRY[name](lenet.apply_stacked, p0, cfg, var_batch_size=20, device=d)
                      for d in ("cpu", dev))
        init_kw = ({}, {})
    else:
        host, card = (ucfl.make_ucfl(lenet.apply_stacked, p0, cfg, num_streams=ns,
                                     var_batch_size=20, device=d) for d in ("cpu", dev))
        seeds = None if ns is None else clustering._plusplus_init(
            torch.Generator().manual_seed(2), ucfl.compute_collaboration(
                lenet.apply_stacked, p0, cpu_data, var_batch_size=20)["W"], ns)
        init_kw = ({"kmeans_init": seeds}, {"kmeans_init": None if seeds is None
                                            else seeds.to(dev)})
    grams, padded = GRAM.launches, GRAM.padded
    hs, cs = host.init(None, cpu_data, **init_kw[0]), card.init(None, gpu_data, **init_kw[1])
    assert GRAM.launches - grams == 2 and GRAM.padded == padded
    cohorts = [participation.pad_slots(participation.as_cohort([1, 3, 6], 8), 5, 8),
               participation.pad_slots(participation.as_cohort([0, 2, 3, 5], 8), 5, 8)]
    for r, cohort in enumerate(cohorts):
        shape = (8, 8, 1, 80) if name == "ucfl_parallel" else (8, 1, 80)
        perms = loader.draw_permutations(torch.Generator().manual_seed(r), int(np.prod(
            shape[:-2])), 1, 80, device="cpu").view(shape)
        hs, hm = host.round(hs, cpu_data, None, cohort, perms=perms)
        cs, cm = card.round(cs, gpu_data, None, cohort, perms=perms.to(dev))
        torch.cuda.synchronize()
        assert int(hm["streams"]) == int(cm["streams"])
        for k, got, want in [("params", cs["params"], hs["params"]), ("W", cs["W"], hs["W"])] + [
                (k, cs["refresh"][k], hs["refresh"][k]) for k in ("grads", "sigma_sq", "delta")]:
            assert float((got.cpu() - want).abs().max()) <= 1e-4, (r, k)
        assert torch.equal(cs["refresh"]["staleness"].cpu(), hs["refresh"]["staleness"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ucfl", "fedavg", "scaffold", "cfl"])
def test_cuda_faulted_rounds_match_cpu(name):
    """Two cohort rounds under sign-flip attackers and drops with trimmed
    mean on the card against the CPU's plain path, from the same data,
    weights, batch orders and fault draws (the attacker set and the drop
    uniforms come from numpy): every slab within 1e-4, the same final
    streams; the mix-scatter takes the holed final mask as it is."""
    from repro_torch.core import REGISTRY, FedConfig
    from repro_torch.core.aggregation import RobustConfig
    from repro_torch.data import loader
    from repro_torch.federated import faults, participation
    from repro_torch.models import lenet

    dev = cuda_device()
    cpu_data, gpu_data, p0 = _small_task(dev)
    base = dict(lr=0.01, momentum=0.0, epochs=5) if name == "scaffold" else {}
    cfg = FedConfig(batch_size=16, faults=faults.FaultConfig(
        byzantine_frac=0.25, attack="sign_flip", drop_rate=0.2), robust=RobustConfig(), **base)
    extra = dict(var_batch_size=20) if name == "ucfl" else {}
    host = REGISTRY[name](lenet.apply_stacked, p0, cfg, device="cpu", **extra)
    card = REGISTRY[name](lenet.apply_stacked, p0, cfg, device=dev, **extra)
    hs, cs = host.init(None, cpu_data), card.init(None, gpu_data)
    cohort = participation.pad_slots(participation.as_cohort([0, 1, 3, 4, 6, 7], 8), 7, 8)
    for r in range(2):
        perms = loader.draw_permutations(torch.Generator().manual_seed(r), 8, cfg.epochs, 80,
                                         device="cpu")
        hs, hm = host.round(hs, cpu_data, None, cohort, perms=perms)
        cs, cm = card.round(cs, gpu_data, None, cohort, perms=perms.to(dev))
        torch.cuda.synchronize()
        assert int(hm["streams"]) == int(cm["streams"])
        for k, want in hs.items():
            if isinstance(want, torch.Tensor) and want.dtype == torch.float32 and k != "W":
                assert bool(torch.isfinite(cs[k]).all()), (r, k)
                assert float((cs[k].cpu() - want).abs().max()) <= 1e-4, (r, k)
        if name == "cfl":
            assert np.array_equal(cs["assignment"], hs["assignment"])


@pytest.mark.cuda
def test_cuda_masked_mix_scatter_with_holes_matches_compacted_cohort():
    """A final mask with holes mid-cohort (demoted slots with the sentinel
    or with their own in-range id, zero columns in W): the live rows bit for
    bit those of the compacted cohort, within 1e-5 of the plain version, and
    no demoted row moves."""
    dev = cuda_device()
    m, c, d = 100, 50, 47616
    gen = torch.Generator().manual_seed(3)
    full = torch.randn(m, d, generator=gen).to(dev)
    idx = torch.full((c,), m, dtype=torch.int32)
    idx[:42] = torch.sort(torch.randperm(m, generator=gen)[:42]).values.to(torch.int32)
    mask = torch.arange(c) < 42
    mask[[0, 3, 16, 30, 41]] = False
    w = torch.softmax(torch.randn(c, c, generator=gen), dim=1) * mask.float()[None, :]
    w = w / w.sum(dim=1, keepdim=True)
    theta = 0.05 * torch.randn(c, d, generator=gen)
    w, theta, idx, mask = w.to(dev), theta.to(dev), idx.to(dev), mask.to(dev)
    live = torch.nonzero(mask).squeeze(1)
    for index in (torch.where(mask, idx, torch.full_like(idx, m)), idx):
        got = ops.masked_mix_scatter(w, theta, index, mask, full.clone(), impl="cuda")
        want = ref.masked_mix_scatter(w, theta, index, mask, full)
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
        compact = ops.masked_mix_scatter(w[live][:, live].contiguous(), theta[live].contiguous(),
                                         idx[live], mask[live], full.clone(), impl="cuda")
        assert torch.equal(got, compact)
        still = torch.ones(m, dtype=torch.bool, device=dev)
        still[idx[live].long()] = False
        assert torch.equal(got[still], full[still])


@pytest.mark.cuda
def test_cuda_gram_on_unit_rows_reads_them_where_they_lie():
    """The refresh's slab-wide unit directions (zero tail): one launch, no
    padded copy, within 1e-5 of the largest entry, Δ̂ symmetric."""
    from repro_torch.core import similarity

    dev = cuda_device()
    gen = torch.Generator().manual_seed(4)
    full = torch.randn(100, 47571, generator=gen).to(dev)
    launches, padded = GRAM.launches, GRAM.padded
    buf = similarity.init_refresh_state({"full_grads": full, "sigma_sq": torch.ones(100, device=dev)},
                                        100, width=47616)
    torch.cuda.synchronize()
    assert GRAM.launches - launches == 1 and GRAM.padded == padded
    g = buf["grads"]
    assert tuple(g.shape) == (100, 47616) and not bool(g[:, 47571:].any())
    got, want = ops.gram(g, impl="cuda"), ref.gram(g)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert torch.equal(buf["delta"], buf["delta"].T)


# (B, Hq, Hkv, Sq, Sk, Dh, causal, window, softcap)
FLASH_CASES = [
    (4, 28, 4, 1024, 1024, 128, True, None, None),  # qwen2-7b's prefill (2 clients x 2)
    (4, 28, 4, 1, 160, 128, False, None, None),     # qwen2-7b's decode over a 160 prefix
    (2, 32, 32, 200, 200, 64, True, None, None),    # stablelm's heads, ragged
    (2, 4, 2, 100, 100, 80, False, None, None),     # Dh 80, bidirectional, ragged
    (2, 16, 8, 300, 300, 256, True, 128, 50.0),     # gemma2's heads, window, softcap
    (4, 14, 2, 1, 97, 256, False, None, 50.0),      # decode, group 7, Dh 256
    (1, 4, 2, 100, 260, 64, True, None, None),      # Sq < Sk: top-left causal
    (1, 2, 1, 40, 10, 32, True, 4, None),           # rows past Sk + window - 1: uniform
    (3, 4, 2, 65, 129, 32, True, 64, 30.0),         # reduced gemma2, one past the tiles
    # around the tensor-core tile (bf16, Sq >= 16, Dh % 8 == 0, aligned)
    (2, 8, 2, 15, 15, 64, True, None, None),        # Sq 15: the FMA kernel
    (2, 8, 2, 16, 16, 64, True, None, None),        # Sq 16: the tile's smallest q
    (2, 8, 4, 64, 200, 256, False, 48, 20.0),       # Dh 256, window + softcap, not causal
    (2, 4, 2, 70, 70, 36, True, None, None),        # Dh 36: the FMA kernel
    (1, 4, 2, 16, 300, 128, True, None, None),      # Sq < Sk at the tile's smallest q
    (1, 2, 1, 80, 20, 64, True, 8, 10.0),           # rows past Sk + window - 1, two q tiles
    # around the decode kernel (Sq = 1, f32 or bf16, Dh % 8 == 0, aligned)
    (4, 28, 4, 1, 4096, 128, False, None, None),    # qwen2-7b's decode over 4,096 keys
    (4, 16, 8, 1, 4096, 256, False, None, 50.0),    # gemma2-9b's decode over 4,096 keys
    (4, 32, 32, 1, 300, 64, False, None, None),     # stablelm's MHA (group 1)
    (4, 28, 4, 1, 600, 128, True, None, None),      # causal, several splits: out = v[:, :, 0]
    (2, 8, 2, 1, 20, 64, False, None, None),        # under one split's minimum keys: one split
    (2, 48, 2, 1, 333, 80, False, 7, 30.0),         # group 24: three row tiles a kv head, window
    (2, 12, 4, 1, 77, 40, False, None, None),       # Dh 40 below its padded width
    (2, 8, 2, 1, 50, 36, False, None, None),        # Dh 36: the FMA kernel
    # the families' shapes: mixtral-8x7b's GQA-4 with window 4096, zamba2-2.7b's
    # MHA at Dh 80 (the tile's 128-wide template; the decode kernel at group 1)
    (4, 32, 8, 1024, 1024, 128, True, 4096, None),  # mixtral-8x7b's prefill
    (4, 32, 8, 1, 1040, 128, False, None, None),    # mixtral-8x7b's decode
    (4, 32, 32, 1024, 1024, 80, True, None, None),  # zamba2-2.7b's prefill, Dh 80
    (4, 32, 32, 1, 1040, 80, False, None, None),    # zamba2-2.7b's decode, Dh 80
]
DECODE_CASES = [c for c in FLASH_CASES if c[3] == 1 and c[5] % 8 == 0]


def flash_inputs(b, hq, hkv, sq, sk, dh, dtype, dev, seed=0):
    """q, k, v as the model passes them: ``.transpose(1, 2)`` views of
    (B, S, H, Dh) tensors (k and v a prefix of a longer cache)."""
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn(b, sq, hq, dh, generator=gen).to(dev, dtype).transpose(1, 2)
    k = torch.randn(b, sk + 7, hkv, dh, generator=gen).to(dev, dtype)[:, :sk].transpose(1, 2)
    v = torch.randn(b, sk + 7, hkv, dh, generator=gen).to(dev, dtype)[:, :sk].transpose(1, 2)
    return q, k, v


def flash_tol(want, dtype):
    if dtype == torch.float32:
        return 2e-5
    return float(want.float().abs().max()) * 2.0 ** -6


def assert_each_within_a_step(got, want):
    """bf16: both sides round an f32 value once, so each element may land
    one bf16 step away (2^-7 of its magnitude); the floor, 2^-7 of the
    median |want|, covers outputs near 0."""
    g, w = got.float(), want.float()
    allowed = 2.0 ** -7 * (w.abs() + float(w.abs().median()))
    assert bool(((g - w).abs() <= allowed).all()), float(((g - w).abs() / allowed).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,hq,hkv,sq,sk,dh,causal,window,cap", FLASH_CASES)
def test_cuda_flash_attention_matches_plain(b, hq, hkv, sq, sk, dh, causal, window, cap, dtype):
    dev = cuda_device()
    q, k, v = flash_inputs(b, hq, hkv, sq, sk, dh, dtype, dev, seed=sq + sk + dh)
    got = ops.flash_attention(q, k, v, causal=causal, window=window, softcap=cap, impl="cuda")
    want = ref.flash_attention(q, k, v, causal=causal, window=window, softcap=cap)
    torch.cuda.synchronize()
    assert got.dtype == dtype and tuple(got.shape) == (b, hq, sq, dh)
    assert float((got.float() - want.float()).abs().max()) <= flash_tol(want, dtype)
    if dtype == torch.bfloat16:
        assert_each_within_a_step(got, want)
    # contiguous inputs give the same bits as the strided views
    again = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
                                window=window, softcap=cap, impl="cuda")
    assert torch.equal(again, got)


def flash_launches():
    return {"tc": FLASH_TC.launches, "decode": FLASH_DEC.launches, "fma": FLASH_FMA.launches}


def flash_route_taken(fn):
    """(result of fn(), the route whose counter rose by one)."""
    before = flash_launches()
    out = fn()
    rose = [r for r, n in flash_launches().items() if n != before[r]]
    assert len(rose) == 1 and flash_launches()[rose[0]] == before[rose[0]] + 1, rose
    return out, rose[0]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,sq,dh,offset,route", [
    (torch.bfloat16, 64, 128, 0, "tc"), (torch.bfloat16, 16, 64, 0, "tc"),
    (torch.bfloat16, 15, 64, 0, "fma"), (torch.bfloat16, 1, 128, 0, "decode"),
    (torch.bfloat16, 64, 36, 0, "fma"), (torch.bfloat16, 64, 128, 1, "fma"),
    (torch.float32, 64, 128, 0, "fma"), (torch.float32, 1, 128, 0, "decode"),
    (torch.bfloat16, 1, 36, 0, "fma"), (torch.bfloat16, 1, 128, 1, "fma")])
def test_cuda_flash_counters_show_the_route(dtype, sq, dh, offset, route):
    """Each call launches the kernel ``flash_route`` names, once, and
    agrees with the plain version; ``offset`` 1 slices q one element into
    its buffer (not 16-byte aligned)."""
    dev = cuda_device()
    gen = torch.Generator().manual_seed(sq + dh)
    buf = torch.randn(2 * sq * 4 * dh + offset, generator=gen).to(dev, dtype)
    q = buf[offset:].view(2, sq, 4, dh).transpose(1, 2)
    _, k, v = flash_inputs(2, 4, 2, sq, 90, dh, dtype, dev, seed=dh)
    assert flash_route(q, k, v) == route
    got, took = flash_route_taken(lambda: ops.flash_attention(q, k, v, impl="cuda"))
    assert took == route
    want = ref.flash_attention(q, k, v)
    assert float((got.float() - want.float()).abs().max()) <= flash_tol(want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [c for c in FLASH_CASES if c[3] >= 16 and c[5] % 8 == 0],
                         ids=str)
def test_cuda_flash_tile_strided_equals_contiguous(case):
    """On the tensor-core tile, strided views and contiguous copies of the
    same bf16 inputs give the same bits."""
    b, hq, hkv, sq, sk, dh, causal, window, cap = case
    dev = cuda_device()
    q, k, v = flash_inputs(b, hq, hkv, sq, sk, dh, torch.bfloat16, dev, seed=sq + sk + dh)
    kw = dict(causal=causal, window=window, softcap=cap, impl="cuda")
    got, took = flash_route_taken(lambda: ops.flash_attention(q, k, v, **kw))
    flat, took_flat = flash_route_taken(lambda: ops.flash_attention(
        q.contiguous(), k.contiguous(), v.contiguous(), **kw))
    assert took == took_flat == "tc"
    assert torch.equal(flat, got)


@pytest.mark.cuda
def test_cuda_flash_tile_keeps_one_bf16_step_at_prefill():
    """qwen2-7b's prefill shape in bf16: the tile's error against the
    plain version is at most 2^-7 of the largest output, one bf16 step of
    each element, and at most half the mean error of the plain version with
    P rounded to bf16 before P·V."""
    dev = cuda_device()
    q, k, v = flash_inputs(*FLASH_CASES[0][:6], torch.bfloat16, dev, seed=2)
    got, took = flash_route_taken(lambda: ops.flash_attention(q, k, v, impl="cuda"))
    want = ref.flash_attention(q, k, v)
    assert took == "tc"
    assert float((got.float() - want.float()).abs().max()) <= (
        float(want.float().abs().max()) * 2.0 ** -7)
    assert_each_within_a_step(got, want)
    control = ref.flash_attention(q, k, v, probs_dtype=torch.bfloat16)
    mean = float((got.float() - want.float()).abs().mean())
    assert mean <= 0.5 * float((control.float() - want.float()).abs().mean())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,case", [
    (torch.bfloat16, (4, 32, 32, 256, 256, 64, True, None, None)),  # the tile (train shape)
    (torch.float32, (2, 4, 2, 40, 40, 32, True, None, None)),       # the FMA kernel
    (torch.bfloat16, (2, 16, 8, 100, 100, 128, True, 32, 50.0))])   # window, softcap
def test_cuda_flash_gradients_flow_through_the_function(dtype, case):
    """Under autograd the kernel runs inside FlashAttentionFn: the output
    has a grad_fn and the gradients of q, k and v equal autograd through
    the plain version (the Function's backward recomputes it). A direct
    kernel call on inputs that need a gradient raises."""
    b, hq, hkv, sq, sk, dh, causal, window, cap = case
    dev = cuda_device()
    q, k, v = flash_inputs(b, hq, hkv, sq, sk, dh, dtype, dev, seed=sq + dh)
    ins = [x.detach().requires_grad_(True) for x in (q, k, v)]
    kw = dict(causal=causal, window=window, softcap=cap)
    out, took = flash_route_taken(lambda: ops.flash_attention(*ins, **kw))
    assert out.grad_fn is not None and took == flash_route(q, k, v)
    plain = [x.detach().requires_grad_(True) for x in (q, k, v)]
    want = ref.flash_attention(*plain, **kw)
    assert float((out.detach().float() - want.detach().float()).abs().max()) <= flash_tol(
        want.detach(), dtype)
    g = torch.randn(out.shape, generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev).to(dtype)
    for a, e in zip(torch.autograd.grad(out, ins, g), torch.autograd.grad(want, plain, g)):
        assert a.dtype == dtype
        assert float((a.float() - e.float()).abs().max()) <= 2.0 ** -7 * float(
            e.float().abs().max())
    with pytest.raises(RuntimeError, match="needs a gradient"):
        flash.flash_attention_cuda(*ins, **kw)


@pytest.mark.cuda
def test_cuda_transformer_loss_gradients_match_the_cpu():
    """A reduced model's per-client loss gradients on the card (attention on
    the FMA kernel inside FlashAttentionFn) against the plain path on the
    CPU, f32: every leaf within 1e-4 of the CPU's gradient, so no
    gradient is lost through attention's q, k and v."""
    from repro_torch import configs
    from repro_torch.models import transformer
    dev = cuda_device()
    cfg = configs.get("stablelm-1.6b").reduced()
    host = transformer.tree_map(lambda x: x[None].repeat(2, *([1] * x.dim())),
                                transformer.init(torch.Generator().manual_seed(0), cfg, "cpu"))
    toks = torch.randint(0, cfg.vocab_size, (2, 2, 33), generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}

    def grads(params, b):
        p = transformer.tree_map(lambda x: x.detach().requires_grad_(True), params)
        loss = transformer.loss_fn(p, b, cfg)
        return loss, torch.autograd.grad(loss.sum(), transformer.leaves(p))

    hl, hg = grads(host, batch)
    before = FLASH_FMA.launches
    cl, cg = grads(transformer.tree_map(lambda x: x.to(dev), host),
                   {k: v.to(dev) for k, v in batch.items()})
    assert FLASH_FMA.launches - before == cfg.num_layers
    assert float((cl.detach().cpu() - hl.detach()).abs().max()) <= 1e-5
    for a, e in zip(cg, hg):
        assert float((a.cpu() - e).abs().max()) <= 1e-4
    wq = next(i for i, x in enumerate(transformer.leaves(host))
              if x is host["blocks"]["l0"]["attn"]["wq"])
    assert float(cg[wq].abs().max()) > 0  # attention's projections get a gradient


@pytest.mark.cuda
def test_cuda_flash_attention_rejects_what_it_cannot_take():
    dev = cuda_device()
    x = torch.zeros(1, 2, 4, 8, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        big = torch.zeros(1, 2, 4, 264, device=dev)
        ops.flash_attention(big, big, big, impl="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(x.transpose(2, 3), x.transpose(2, 3), x.transpose(2, 3), impl="cuda")
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        ops.flash_attention(x.half(), x.half(), x.half(), impl="cuda")
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        ops.flash_attention(x, x.bfloat16(), x, impl="cuda")
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.flash_attention(x, x.cpu(), x, impl="cuda")
    with pytest.raises(ValueError, match="multiple of Hkv"):
        ops.flash_attention(torch.zeros(1, 3, 4, 8, device=dev), x, x, impl="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-7b", "gemma2-9b"])
def test_cuda_serve_matches_cpu(arch):
    """A reduced f32 model for 2 clients: the federated prefill step and
    teacher-forced decode steps (gemma2 past its window-64 wrap) on the
    card, through the kernel, against the plain path on the CPU. Logits
    atol 1e-4 (values up to ~5; f32 sums in another order)."""
    from repro_torch import configs
    from repro_torch.launch import serve, steps
    from repro_torch.models import transformer

    dev = cuda_device()
    cfg = configs.get(arch).reduced()
    host = serve.personalized_params(cfg, 2, 0, "cpu")
    card = transformer.tree_map(lambda x: x.to(dev), host)
    tok = torch.randint(0, cfg.vocab_size, (2, 2, 72), generator=torch.Generator().manual_seed(1))
    prefill = steps.build_prefill_step(cfg, federated=True)
    hl, hc = prefill(host, {"tokens": tok[:, :, :40]})
    before = flash_launches()
    cl, cc = prefill(card, {"tokens": tok[:, :, :40].to(dev)})
    assert flash_launches() == dict(before, fma=before["fma"] + cfg.num_layers)
    assert float((cl.cpu() - hl).abs().max()) <= 1e-4
    step = steps.build_serve_step(cfg, federated=True)
    hcache = transformer.init_cache(cfg, 2, 2, 80, "cpu")
    ccache = transformer.init_cache(cfg, 2, 2, 80, dev)
    before = flash_launches()
    for s in range(72):
        hl, hcache = step(host, hcache, tok[:, :, s:s + 1], s)
        cl, ccache = step(card, ccache, tok[:, :, s:s + 1].to(dev), s)
        assert float((cl.cpu() - hl).abs().max()) <= 1e-4, s
    assert flash_launches() == dict(before, decode=before["decode"] + 72 * cfg.num_layers)


def _leaves(tree):
    return [x for v in tree.values() for x in _leaves(v)] if isinstance(tree, dict) else [tree]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-7b", "gemma2-9b"])
def test_cuda_bf16_prefill_tile_matches_plain_attention(arch, monkeypatch):
    """A reduced bf16 model's prefill step over 96 tokens (past gemma2's
    window 64) launches the tensor-core tile once a layer, and matches the
    same step with the plain attention on the card: both share every other
    kernel, so they differ only where an attention output rounds one bf16
    step away, carried through later layers; logits and cache leaves within
    4 bf16 steps of their largest magnitude (2^-5 of it)."""
    from repro_torch import configs
    from repro_torch.launch import serve, steps

    dev = cuda_device()
    cfg = configs.get(arch).reduced(param_dtype="bfloat16", act_dtype="bfloat16")
    params = serve.personalized_params(cfg, 2, 0, dev)
    tok = torch.randint(0, cfg.vocab_size, (2, 2, 96),
                        generator=torch.Generator().manual_seed(2)).to(dev)
    prefill = steps.build_prefill_step(cfg, federated=True)
    before = flash_launches()
    got, got_cache = prefill(params, {"tokens": tok})
    assert flash_launches() == dict(before, tc=before["tc"] + cfg.num_layers)
    monkeypatch.setattr(ops, "flash_attention", functools.partial(ops.flash_attention,
                                                                  impl="ref"))
    after = flash_launches()
    want, want_cache = prefill(params, {"tokens": tok})
    assert flash_launches() == after
    for g, w in zip([got] + _leaves(got_cache), [want] + _leaves(want_cache)):
        assert float((g.float() - w.float()).abs().max()) <= 2.0 ** -5 * float(
            w.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", DECODE_CASES, ids=str)
def test_cuda_flash_decode_strided_equals_contiguous(case, dtype):
    """On the decode kernel, strided views and contiguous copies of the
    same inputs give the same bits: the splits merge in split order
    whichever block arrives last."""
    b, hq, hkv, sq, sk, dh, causal, window, cap = case
    dev = cuda_device()
    q, k, v = flash_inputs(b, hq, hkv, sq, sk, dh, dtype, dev, seed=sq + sk + dh)
    kw = dict(causal=causal, window=window, softcap=cap, impl="cuda")
    got, took = flash_route_taken(lambda: ops.flash_attention(q, k, v, **kw))
    flat, took_flat = flash_route_taken(lambda: ops.flash_attention(
        q.contiguous(), k.contiguous(), v.contiguous(), **kw))
    assert took == took_flat == "decode"
    assert torch.equal(flat, got)
    again = ops.flash_attention(q, k, v, **kw)
    assert torch.equal(again, got)


@pytest.mark.cuda
def test_cuda_flash_decode_causal_takes_the_first_key():
    """Causal with Sq = 1 over several splits: only key 0 survives, and
    every other split merges with a weight of exactly 0."""
    dev = cuda_device()
    q, k, v = flash_inputs(4, 28, 4, 1, 600, 128, torch.bfloat16, dev, seed=7)
    assert flash.decode_splits(flash.decode_blocks(4, 28, 4), 600, flash._sm_count(dev.index)) > 1
    got = ops.flash_attention(q, k, v, causal=True, impl="cuda")
    assert torch.equal(got, torch.repeat_interleave(v[:, :, :1], 7, dim=1))


@pytest.mark.cuda
def test_cuda_flash_decode_has_no_fallback(monkeypatch):
    """A decode on the card raises when the decode kernel's symbol is
    missing or its launch is refused; it takes neither the FMA kernel nor
    the plain version. Its launch plans and workspace are its own: a plan
    made before would skip the patched planner."""
    dev = cuda_device()
    q, k, v = flash_inputs(4, 28, 4, 1, 160, 128, torch.bfloat16, dev)
    before = flash_launches()
    monkeypatch.setattr(flash, "_DECODE_PLANS", {})
    monkeypatch.setattr(flash, "_DECODE_WORKSPACE", {})
    missing = _build.Kernel("flash_attention.cu", "flash_attention_decode_missing",
                            FLASH_DEC.argtypes)
    monkeypatch.setattr(flash, "FLASH_DEC", missing)
    with pytest.raises(AttributeError, match="flash_attention_decode_missing"):
        ops.flash_attention(q, k, v, causal=False, impl="cuda")
    monkeypatch.setattr(flash, "FLASH_DEC", FLASH_DEC)
    monkeypatch.setattr(flash, "_DECODE_PLANS", {})
    monkeypatch.setattr(flash, "decode_splits", lambda *a: flash.DECODE_MAX_SPLITS + 1)
    with pytest.raises(RuntimeError, match="flash_attention_decode: launch failed"):
        ops.flash_attention(q, k, v, causal=False, impl="cuda")
    assert flash_launches() == before


@pytest.mark.cuda
def test_cuda_flash_decode_step_makes_no_sync():
    """28 decode calls (one step's layers at qwen2-7b's shape) make no
    synchronizing CUDA call and launch 28 decode kernels."""
    import warnings

    dev = cuda_device()
    q, k, v = flash_inputs(4, 28, 4, 1, 160, 128, torch.bfloat16, dev)
    ops.flash_attention(q, k, v, causal=False, impl="cuda")  # the workspace exists
    torch.cuda.synchronize()
    before = flash_launches()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(28):
                ops.flash_attention(q, k, v, causal=False, impl="cuda")
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert not [w for w in caught if "called a synchronizing" in str(w.message)]
    assert flash_launches() == dict(before, decode=before["decode"] + 28)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-7b", "gemma2-9b"])
def test_cuda_bf16_decode_kernel_matches_plain_attention(arch, monkeypatch):
    """A reduced bf16 model's 72 teacher-forced decode steps (past gemma2's
    window 64) launch the decode kernel once a layer, and match the same
    steps with the plain attention on the card: every step's logits within
    4 bf16 steps of its largest (2^-5 of it), as at prefill."""
    from repro_torch import configs
    from repro_torch.launch import serve, steps
    from repro_torch.models import transformer

    dev = cuda_device()
    cfg = configs.get(arch).reduced(param_dtype="bfloat16", act_dtype="bfloat16")
    params = serve.personalized_params(cfg, 2, 0, dev)
    tok = torch.randint(0, cfg.vocab_size, (2, 2, 72),
                        generator=torch.Generator().manual_seed(4)).to(dev)
    step = steps.build_serve_step(cfg, federated=True)

    def run():
        cache = transformer.init_cache(cfg, 2, 2, 80, dev)
        out = []
        for pos in range(72):
            logits, cache = step(params, cache, tok[:, :, pos:pos + 1], pos)
            out.append(logits)
        return out

    before = flash_launches()
    got = run()
    assert flash_launches() == dict(before, decode=before["decode"] + 72 * cfg.num_layers)
    monkeypatch.setattr(ops, "flash_attention", functools.partial(ops.flash_attention,
                                                                  impl="ref"))
    want = run()
    for pos, (g, w) in enumerate(zip(got, want)):
        assert float((g.float() - w.float()).abs().max()) <= 2.0 ** -5 * float(
            w.float().abs().max()), pos


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ucfl", "ucfl_k2", "fedavg"])
def test_cuda_async_flush1_rounds_equal_the_barrier_rounds(name):
    """``AsyncConfig(flush_k=1, alpha=0.0)`` on the card: two cohort rounds
    from the same state and batch orders as the barrier rounds, bit for bit
    for ucfl and its clustered variant (the flush mixes and scatters the
    buffer's rows in the same launch shape), within float association for
    the FedAvg family's delta form; and the barrier run within 1e-4 of the
    CPU's."""
    from repro_torch.core import REGISTRY, FedConfig, ucfl
    from repro_torch.data import loader
    from repro_torch.federated import participation, simulation
    from repro_torch.federated.async_buffer import AsyncConfig
    from repro_torch.models import lenet

    dev = cuda_device()
    cpu_data, gpu_data, p0 = _small_task(dev)

    def build(device, **kw):
        cfg = FedConfig(batch_size=20, **kw)
        if name == "fedavg":
            return REGISTRY[name](lenet.apply_stacked, p0, cfg, device=device)
        return ucfl.make_ucfl(lenet.apply_stacked, p0, cfg, var_batch_size=20, device=device,
                              num_streams=2 if name == "ucfl_k2" else None)

    barrier, asy = build(dev), build(dev, async_buffer=AsyncConfig(flush_k=1, alpha=0.0))
    host = build("cpu")
    state = barrier.init(torch.Generator(device=dev).manual_seed(0), gpu_data)
    hs = host.init(torch.Generator().manual_seed(0), cpu_data)
    if name == "ucfl_k2":  # the card's K-means labels on both sides
        hs = dict(hs, labels=state["labels"].cpu(), labels_host=state["labels_host"])
    sb, sa = simulation.clone_state(state), simulation.clone_state(state)
    cohorts = [participation.pad_slots(participation.as_cohort([1, 3, 6], 8), 5, 8),
               participation.pad_slots(participation.as_cohort([0, 2, 3, 5], 8), 5, 8)]
    for r, cohort in enumerate(cohorts):
        perms = loader.draw_permutations(torch.Generator().manual_seed(r), 8, 1, 80,
                                         device="cpu")
        sb, mb = barrier.round(sb, gpu_data, None, cohort, perms=perms.to(dev))
        sa, ma = asy.round(sa, gpu_data, None, cohort, perms=perms.to(dev))
        hs, _ = host.round(hs, cpu_data, None, cohort, perms=perms)
        torch.cuda.synchronize()
        assert int(ma["flushed"]) == 1 and int(ma["streams"]) == int(mb["streams"])
        if name == "fedavg":
            assert float((sa["params"] - sb["params"]).abs().max()) <= 1e-5
        else:
            assert torch.equal(sa["params"], sb["params"]), r
        assert float((sb["params"].cpu() - hs["params"]).abs().max()) <= 1e-4, r


@pytest.mark.cuda
def test_cuda_masked_mix_scatter_over_the_async_buffer():
    """The mix-scatter over a buffer of 109 rows whose live ids are in
    arrival order (a second deposit overwrote some clients in place and
    appended the rest), with a sentinel tail: within 1e-5 of the plain
    version on flush rules, bit for bit on exact inputs (rules in eighths,
    integer rows), and nothing written when the flush predicate is False;
    the deposits equal the CPU's."""
    from repro_torch.core import aggregation
    from repro_torch.federated import async_buffer

    dev = cuda_device()
    m, d = 100, 47616
    acfg = async_buffer.AsyncConfig(flush_k=60)
    gen = torch.Generator().manual_seed(5)
    bufs = [async_buffer.init_buffer(acfg, m, 50, d, device=x) for x in ("cpu", dev)]
    for rnd, real in ((0, 44), (1, 42)):
        idx = torch.full((50,), m, dtype=torch.int32)
        idx[:real] = torch.sort(torch.randperm(m, generator=gen)[:real]).values.to(torch.int32)
        args = (torch.randn(50, d, generator=gen), idx, torch.arange(50) < real,
                torch.full((50,), rnd, dtype=torch.int32))
        bufs = [async_buffer.deposit(b, *(a.to(b["upd"].device) for a in args), m)
                for b in bufs]
    host, buf = bufs
    for k in ("idx", "ver", "count"):
        assert torch.equal(buf[k].cpu(), host[k]), k
    assert torch.equal(async_buffer.rows(buf).cpu(), async_buffer.rows(host))
    bidx, valid = buf["idx"], async_buffer.valid_mask(buf, m)
    live = bidx[valid].cpu()
    assert not bool((live[1:] > live[:-1]).all()) and int(buf["count"]) < 86
    buf = dict(buf, version=torch.ones_like(buf["version"]))
    w = aggregation.masked_cohort_matrix(
        torch.softmax(torch.randn(m, m, generator=gen), dim=1).to(dev), bidx, valid,
        async_buffer.staleness_weights(buf, m, 0.5))
    theta = async_buffer.rows(buf)
    full = torch.randn(m, d, generator=gen).to(dev)
    want = ref.masked_mix_scatter(w, theta, bidx, valid, full)
    got = ops.masked_mix_scatter(w, theta, bidx, valid, full.clone(), impl="cuda")
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    exact_w = (torch.randint(0, 9, (109, 109), generator=gen).float() / 8.0).to(dev)
    exact_w = exact_w * valid.float()[None, :]
    exact_t = torch.randint(-8, 9, (109, d), generator=gen).float().to(dev)
    assert torch.equal(ops.masked_mix_scatter(exact_w, exact_t, bidx, valid, full.clone(),
                                              impl="cuda"),
                       ref.masked_mix_scatter(exact_w, exact_t, bidx, valid, full))
    idle = ops.masked_mix_scatter(w, theta, bidx, valid & False, full.clone(), impl="cuda")
    assert torch.equal(idle, full)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fedavg", "ucfl_k2"])
def test_cuda_tiered_rounds_match_cpu(name):
    """Two cohort rounds over ``Topology.contiguous(8, 3)`` on the card
    against the CPU's plain path (slab within 1e-4, the same streams), and
    within 1e-4 of the card's flat rounds; the tiered mixes run on the
    mix kernel (two launches a FedAvg round, one for ucfl_k2's partials)."""
    from repro_torch.core import REGISTRY, FedConfig, ucfl
    from repro_torch.data import loader
    from repro_torch.federated import participation
    from repro_torch.federated.topology import Topology
    from repro_torch.models import lenet

    dev = cuda_device()
    cpu_data, gpu_data, p0 = _small_task(dev)

    def build(device, **kw):
        cfg = FedConfig(batch_size=20, **kw)
        if name == "fedavg":
            return REGISTRY[name](lenet.apply_stacked, p0, cfg, device=device)
        return ucfl.make_ucfl(lenet.apply_stacked, p0, cfg, var_batch_size=20, device=device,
                              num_streams=2)

    topo = Topology.contiguous(8, 3)
    card, host, flat = build(dev, topology=topo), build("cpu", topology=topo), build(dev)
    cs = card.init(torch.Generator(device=dev).manual_seed(0), gpu_data)
    hs = host.init(torch.Generator().manual_seed(0), cpu_data)
    if name == "ucfl_k2":
        hs = dict(hs, labels=cs["labels"].cpu(), labels_host=cs["labels_host"])
    fs = {k: (v.clone() if isinstance(v, torch.Tensor) else v) for k, v in cs.items()}
    cohorts = [participation.pad_slots(participation.as_cohort([1, 3, 6], 8), 5, 8),
               participation.pad_slots(participation.as_cohort([0, 2, 3, 5, 7], 8), 6, 8)]
    for r, cohort in enumerate(cohorts):
        perms = loader.draw_permutations(torch.Generator().manual_seed(r), 8, 1, 80,
                                         device="cpu")
        before = MIX.launches
        cs, cm = card.round(cs, gpu_data, None, cohort, perms=perms.to(dev))
        assert MIX.launches - before == (2 if name == "fedavg" else 1)
        hs, hm = host.round(hs, cpu_data, None, cohort, perms=perms)
        fs, _ = flat.round(fs, gpu_data, None, cohort, perms=perms.to(dev))
        torch.cuda.synchronize()
        assert int(cm["streams"]) == int(hm["streams"])
        assert float((cs["params"].cpu() - hs["params"]).abs().max()) <= 1e-4, r
        assert float((cs["params"] - fs["params"]).abs().max()) <= 1e-4, r


@pytest.mark.cuda
@pytest.mark.parametrize("attack", ["scaled_noise", "inf"])
def test_cuda_attacks_match_cpu(attack, monkeypatch):
    """ucfl under ``scaled_noise`` and ``inf`` attackers with trimmed mean,
    two cohort rounds on the card against the CPU's plain path from the same
    draws (the noise drawn once on the host): the slab within 1e-4 and
    finite, the same streams."""
    from repro_torch.core import FedConfig, ucfl
    from repro_torch.core.aggregation import RobustConfig
    from repro_torch.data import loader
    from repro_torch.federated import faults, participation
    from repro_torch.models import lenet

    dev = cuda_device()
    cpu_data, gpu_data, p0 = _small_task(dev)
    draw = faults.draw

    def host_draw(cfg, m, width, rnd, device):
        d = draw(cfg, m, width, rnd, "cpu")
        return faults.FaultDraws(d.attacker.to(device), d.uniforms.to(device),
                                 None if d.noise is None else d.noise.to(device))

    monkeypatch.setattr(faults, "draw", host_draw)
    cfg = FedConfig(batch_size=16, faults=faults.FaultConfig(byzantine_frac=0.25, attack=attack),
                    robust=RobustConfig("trimmed_mean", trim_k=1))
    host, card = (ucfl.make_ucfl(lenet.apply_stacked, p0, cfg, var_batch_size=20, device=d)
                  for d in ("cpu", dev))
    hs, cs = host.init(None, cpu_data), card.init(None, gpu_data)
    cohort = participation.pad_slots(participation.as_cohort([0, 1, 3, 4, 6, 7], 8), 7, 8)
    for r in range(2):
        perms = loader.draw_permutations(torch.Generator().manual_seed(r), 8, 1, 80,
                                         device="cpu")
        hs, hm = host.round(hs, cpu_data, None, cohort, perms=perms)
        cs, cm = card.round(cs, gpu_data, None, cohort, perms=perms.to(dev))
        torch.cuda.synchronize()
        assert int(hm["streams"]) == int(cm["streams"])
        assert bool(torch.isfinite(cs["params"]).all())
        assert float((cs["params"].cpu() - hs["params"]).abs().max()) <= 1e-4, r


@pytest.mark.cuda
def test_cuda_bf16_products_reduce_in_f32():
    """A bf16 product through ``layers.matmul`` on the card turns cuBLAS's
    reduced-precision bf16 reduction off for the process (the backward's
    products included), whatever the caller had set."""
    from repro_torch.models import layers

    dev = cuda_device()
    saved = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    try:
        x = torch.randn(2, 8, 64, device=dev).to(torch.bfloat16)
        layers.matmul(x.float(), torch.randn(64, 32, device=dev))
        assert torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
        layers.matmul(x, torch.randn(2, 64, 32, device=dev).to(torch.bfloat16))
        assert not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = saved


# ------------------------------------------------------- the model families
@pytest.mark.cuda
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_cuda_moe_layer_matches_cpu(cf):
    """The MoE layer of 2 clients (one sort and one buffer for both) on the
    card against the CPU, f32: y within 1e-5 of the largest |y|, the aux
    loss within 1e-6 and the same count of dropped assignments."""
    from repro_torch.models import moe

    dev = cuda_device()
    cfg = moe.MoEConfig(d_model=256, d_ff=512, num_experts=8, top_k=2, capacity_factor=cf)
    gen = torch.Generator().manual_seed(0)
    host = {k: torch.stack([v, v.flip(0)]) for k, v in
            moe.init(gen, cfg, torch.float32, "cpu").items()}
    host["router"] = host["router"] * 50  # uneven loads
    x = torch.randn(2, 2, 64, 256, generator=gen)
    card = {k: v.to(dev) for k, v in host.items()}
    hy, ha = moe.apply(host, x, cfg)
    cy, ca = moe.apply(card, x.to(dev), cfg)
    assert float((cy.cpu() - hy).abs().max()) <= 1e-5 * float(hy.abs().max())
    assert float((ca.cpu() - ha).abs().max()) <= 1e-6
    drops = moe.dropped(host, x, cfg)
    assert torch.equal(moe.dropped(card, x.to(dev), cfg).cpu(), drops)
    if cf == 0.5:
        assert int(drops.sum()) > 0


@pytest.mark.cuda
def test_cuda_ssd_layer_matches_cpu():
    """One SSD block of 2 clients on the card against the CPU, f32: the
    chunked forward and 8 decode steps, y and the caches within 1e-5 of the
    largest of each."""
    from repro_torch.models import ssm, transformer

    dev = cuda_device()
    cfg = ssm.SSMConfig(d_model=128, state=32, headdim=16, chunk=32)
    gen = torch.Generator().manual_seed(1)
    host = transformer.tree_map(lambda v: torch.stack([v, v * 0.9]),
                                ssm.init(gen, cfg, torch.float32, "cpu"))
    host["A_log"] = torch.randn(2, cfg.num_heads, generator=gen) * 0.5
    card = transformer.tree_map(lambda v: v.to(dev), host)
    x = 0.5 * torch.randn(2, 2, 96, 128, generator=gen)

    def close(got, want):
        assert float((got.cpu() - want).abs().max()) <= 1e-5 * float(want.abs().max())

    hy, hc = ssm.forward(host, x, cfg)
    cy, cc = ssm.forward(card, x.to(dev), cfg)
    close(cy, hy)
    close(cc["h"], hc["h"])
    close(cc["conv"], hc["conv"])
    for s in range(8):
        hy, hc = ssm.decode(host, x[:, :, s:s + 1], hc, cfg)
        cy, cc = ssm.decode(card, x[:, :, s:s + 1].to(dev), cc, cfg)
        close(cy, hy)
    close(cc["h"], hc["h"])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "kimi-k2-1t-a32b", "mamba2-1.3b",
                                  "zamba2-2.7b"])
def test_cuda_family_serve_matches_cpu(arch):
    """A reduced f32 model of each ported family for 2 clients (zamba2 at 12
    layers: two shared-attention caches): the federated prefill step over
    64 tokens (the FMA kernel once an attention layer) and 24 teacher-forced
    decode steps (the decode kernel) on the card against the CPU, logits
    atol 1e-4."""
    from repro_torch import configs
    from repro_torch.launch import serve, steps
    from repro_torch.models import transformer

    dev = cuda_device()
    cfg = configs.get(arch).reduced(**({"num_layers": 12} if arch == "zamba2-2.7b" else {}))
    layers = {"ssm": 0, "hybrid": cfg.num_groups}.get(cfg.family, cfg.num_layers)
    host = serve.personalized_params(cfg, 2, 0, "cpu")
    card = transformer.tree_map(lambda x: x.to(dev), host)
    tok = torch.randint(0, cfg.vocab_size, (2, 2, 64), generator=torch.Generator().manual_seed(1))
    prefill = steps.build_prefill_step(cfg, federated=True)
    hl, _ = prefill(host, {"tokens": tok})
    before = flash_launches()
    cl, _ = prefill(card, {"tokens": tok.to(dev)})
    assert flash_launches() == dict(before, fma=before["fma"] + layers)
    assert float((cl.cpu() - hl).abs().max()) <= 1e-4
    step = steps.build_serve_step(cfg, federated=True)
    hcache = transformer.init_cache(cfg, 2, 2, 32, "cpu")
    ccache = transformer.init_cache(cfg, 2, 2, 32, dev)
    before = flash_launches()
    for s in range(24):
        hl, hcache = step(host, hcache, tok[:, :, s:s + 1], s)
        cl, ccache = step(card, ccache, tok[:, :, s:s + 1].to(dev), s)
        assert float((cl.cpu() - hl).abs().max()) <= 1e-4, s
    assert flash_launches() == dict(before, decode=before["decode"] + 24 * layers)
