"""The launch plans of the Gram, mix, mix-scatter and k-means kernels, on the CPU.

``mix_plan`` and ``kmeans_plan`` are functions of host ints that decide a
launch: the register tile or lane groups, the 16-byte or scalar path, the
grid and the dynamic shared memory. ``mix_plan``'s tile route
(``tile_plan``) serves both kernels of ``csrc/mix_tile.cuh``:
mix_aggregate, and the masked mix-scatter with ``tile_plan(c, c, d,
theta, full)``. The kernels refuse a plan that
disagrees with their own layout (checked on the card by
``tests/test_torch_cuda.py``); here the plans are held to what the kernels
need: every row, column and point covered once, rows 16-byte aligned on
the 16-byte path only, shared memory within a block's 227 KB, and, on the
main path, θ read once (one row tile at k <= 128), a 50-slot cohort in one
wave of blocks, and the centroids staged in one round trip. ``gram_plan``
picks its route from m alone: at m <= M_ROWS the few-row route, whose
m(m+1)/2 sums cover the triangle once, whose blocks' runs cover d once,
each 16-byte aligned, in one wave of one block an SM (up to 2^33 columns,
the values exact), with a triangle a block in the workspace; above it the
tensor-core route, whose tiles' 64 x 64 jobs cover every element with
row <= col < m once and no job lies wholly below the diagonal, each
tile's splits cover d in chunks of whole ring stages, and the grid is one
wave of one block an SM; ``gram_aligned`` picks the path that both routes
can read (16-byte base and row stride) or the padded copy. ``mix_plan``
also picks a route, from k and m: at k, m <= MIX_ROWS the few-row route,
whose runs cover d once, each whole 16-byte packs of either dtype, a
block each (at LLM width a sweep of a block's loads, else up to two
blocks an SM; up to 2^33 columns), on 16-byte packs where d is
a multiple of the pack (4 f32, 8 bf16) and both pointers are aligned;
above it the tile route, which the masked mix-scatter takes at every c
through ``tile_plan``.
"""
import ctypes
import itertools

import pytest

from repro_torch.kernels.kmeans_assign import (MAX_SMEM_BYTES, SMEM_BYTES, WARPS, kmeans_plan,
                                               row_stride)
from repro_torch.kernels import masked_mix_scatter
from repro_torch.kernels.mix_aggregate import (BK, MIX_ROWS, MIX_TILES, ROW_BLOCKS_PER_SM,
                                               ROW_LOADS, RUN_ALIGN, mix_plan, sweep_columns)
from repro_torch.kernels.mix_aggregate import ROW_THREADS as MIX_THREADS
from repro_torch.kernels.mix_aggregate import RUN_MIN as MIX_RUN_MIN
from repro_torch.kernels.mix_aggregate import rows_plan as mix_rows_plan
from repro_torch.kernels.mix_aggregate import tile_plan as mix_tile_plan
from repro_torch.kernels.pairwise_delta import (DEPTH, HALF, M_ROWS, MAX_WIDTH, ROW_THREADS,
                                                RUN_MIN, TILE, WINDOW, gram_aligned, gram_plan,
                                                rows_plan, tile_jobs, tile_plan)

ALIGNED = (0x7F0000000000, 0x7F0000100000)  # two 256-byte aligned base pointers
BLOCK_SMEM = 232_448  # a block's most dynamic shared memory on an H100
SM_SMEM = 233_472     # an SM's shared memory for blocks (228 KB), 1 KB of it reserved a block
SMS = 132             # an H100 SXM's SMs


def tile_rule(k):
    """The tile mix_plan must pick: T0 for k <= 4, T2 for k <= 64, else T1."""
    return 0 if k <= 4 else 2 if k <= 64 else 1


def route_rule(k, m):
    """The route mix_plan must pick: the few rows at k, m <= 16, else tiles."""
    return "rows" if k <= 16 and m <= 16 else "tiles"


@pytest.mark.parametrize("k,m,d", list(itertools.product((1, 4, 100, 150, 511), (3, 100, 512),
                                                         (5, 97, 47_616))))
def test_mix_plan_covers_the_output(k, m, d):
    plan = mix_plan(k, m, d, *ALIGNED)
    assert plan.route == route_rule(k, m)
    if plan.route == "rows":  # m = 3 rows at k = 1 and 4: the runs cover d once
        assert plan.blocks * plan.run >= d > (plan.blocks - 1) * plan.run
        assert plan.run % RUN_ALIGN == 0 and plan.run >= MIX_RUN_MIN
        assert plan.threads == MIX_THREADS and plan.blocks <= ROW_BLOCKS_PER_SM * SMS
        assert plan.vec == (d % 4 == 0)
        return
    tile = MIX_TILES[plan.tile]
    assert plan.tile == tile_rule(k)
    assert plan.row_tiles * tile.rows >= k > (plan.row_tiles - 1) * tile.rows
    assert plan.col_tiles * tile.cols >= d > (plan.col_tiles - 1) * tile.cols
    assert plan.blocks == plan.row_tiles * plan.col_tiles
    assert plan.threads == tile.threads <= 256 and 32 % tile.tc == 0
    assert plan.smem_bytes == tile.smem_bytes <= BLOCK_SMEM
    assert plan.vec == (d % 4 == 0)
    if k <= max(t.rows for t in MIX_TILES):  # θ crosses HBM once
        assert plan.row_tiles == 1


def test_mix_plan_at_the_main_path():
    """ucfl (k = 100) and ucfl_k4 (k = 4) over the (100, 47,616) slab: one
    row tile, 372 column tiles of 128, the 16-byte path."""
    for k, tile, threads in ((100, 1, 256), (4, 0, 32)):
        plan = mix_plan(k, 100, 47_616, *ALIGNED)
        assert (plan.tile, plan.vec, plan.row_tiles, plan.col_tiles, plan.blocks,
                plan.threads) == (tile, True, 1, 372, 372, threads)


@pytest.mark.parametrize("k,tile,row_tiles", [(1, 0, 1), (4, 0, 1), (5, 2, 1), (16, 2, 1),
                                              (50, 2, 1), (64, 2, 1), (65, 1, 1), (128, 1, 1),
                                              (129, 1, 2), (150, 1, 2), (511, 1, 4)])
def test_mix_plan_tile_choice(k, tile, row_tiles):
    plan = mix_plan(k, 100, 1000, *ALIGNED)
    assert (plan.tile, plan.row_tiles) == (tile, row_tiles) and tile == tile_rule(k)
    assert plan == mix_tile_plan(k, 100, 1000, *ALIGNED)


@pytest.mark.parametrize("k,m", [(1, 2), (1, 4), (2, 4), (4, 4), (2, 2), (16, 16), (1, 16),
                                 (16, 1), (17, 4), (4, 17), (1, 50), (16, 50), (100, 100),
                                 (50, 50), (4, 100)])
@pytest.mark.parametrize("elem", [4, 2])
def test_mix_plan_route_rule(k, m, elem):
    """The few-row route at k, m <= MIX_ROWS = 16 in either dtype, else the
    tile route (whose plan is tile_plan's, of the f32 θ)."""
    assert MIX_ROWS == 16
    plan = mix_plan(k, m, 47_616, *ALIGNED, elem=elem)
    assert plan.route == route_rule(k, m)
    if plan.route == "rows":
        assert plan == mix_rows_plan(k, m, 47_616, *ALIGNED, elem, SMS) and plan.elem == elem
    else:
        assert plan == mix_tile_plan(k, m, 47_616, *ALIGNED)


@pytest.mark.parametrize("d", [1, 5, 8, 97, 1_024, 4_099, 47_616, 65_536, 427_136,
                               205_520_896, 557_842_432, 2**31 + 8, 3 * 2**30 + 1_004, 2**33])
@pytest.mark.parametrize("elem", [4, 2])
@pytest.mark.parametrize("m", [4, 2])
def test_mix_rows_plan_covers_d_once(d, elem, m):
    """The few-row runs: a positive multiple of RUN_ALIGN columns (whole
    16-byte packs of f32 or bf16), at least RUN_MIN, a block each, covering
    d once with none empty, up to 2^33 columns (the kernel's offsets are
    64-bit) within the grid's limit; values exact Python ints. Where d
    fills ROW_BLOCKS_PER_SM blocks an SM with a sweep each (256 threads x
    ROW_LOADS // m packs of every row), a run is one sweep; a narrower d
    takes at most that many blocks. The 16-byte path at d a multiple of
    the pack, 4 columns of f32 or 8 of bf16; the scalar path otherwise."""
    plan = mix_rows_plan(4, m, d, *ALIGNED, elem, SMS)
    sweep = MIX_THREADS * (ROW_LOADS // m) * (16 // elem)
    assert sweep_columns(m, elem) == sweep and sweep % RUN_ALIGN == 0
    assert plan.run % RUN_ALIGN == 0 and plan.run >= MIX_RUN_MIN and (16 // elem) <= RUN_ALIGN
    assert plan.blocks * plan.run >= d > (plan.blocks - 1) * plan.run
    assert 1 <= plan.blocks <= 2**31 - 1
    if d >= ROW_BLOCKS_PER_SM * SMS * sweep:  # wide: a sweep a block, the blocks in order
        assert plan.run == sweep and plan.blocks >= ROW_BLOCKS_PER_SM * SMS
    else:
        assert plan.blocks <= ROW_BLOCKS_PER_SM * SMS
    assert plan.vec == (d % (16 // elem) == 0)
    assert all(isinstance(v, int) for v in (plan.blocks, plan.run))


@pytest.mark.parametrize("theta_off,out_off,elem,vec", [
    (0, 0, 4, True), (0, 0, 2, True), (4, 0, 4, False), (2, 0, 2, False), (0, 8, 2, False),
    (16, 16, 2, True), (0, 12, 4, False)])
def test_mix_rows_plan_needs_both_pointers_aligned(theta_off, out_off, elem, vec):
    """An offset view of θ (or an output not on a 16-byte boundary) takes
    the scalar path in either dtype."""
    plan = mix_rows_plan(2, 4, 8_192, ALIGNED[0] + theta_off, ALIGNED[1] + out_off, elem, SMS)
    assert plan.vec == vec


def test_mix_rows_plan_refuses_what_the_route_does_not_take():
    for k, m in ((17, 4), (4, 17), (0, 4), (4, 0)):
        with pytest.raises(ValueError, match="rows_plan"):
            mix_rows_plan(k, m, 1_000, *ALIGNED, 4, SMS)
    with pytest.raises(ValueError, match="bytes"):
        mix_plan(4, 4, 1_000, *ALIGNED, elem=8)


@pytest.mark.parametrize("c,want", [
    (4, (0, True, 1, 372, 372, 32, 33_792)),    # row 5b's c = 4: the 4-row tile, not the few rows
    (50, (2, True, 1, 372, 372, 256, 37_632)),  # a 50-slot cohort: the 64-row tile
    (109, (1, True, 1, 372, 372, 256, 49_920)),  # the 109-row buffer: the 128-row tile
])
def test_mix_scatter_plan_is_the_tile_plan_at_every_c(c, want):
    """The masked mix-scatter launches on tile_plan(c, c, d, θ, full) at
    every c, the few-row sizes included: its plan and its bits stay the
    register tiles'."""
    assert masked_mix_scatter.tile_plan is mix_tile_plan
    plan = mix_tile_plan(c, c, 47_616, *ALIGNED)
    assert plan.route == "tiles" and tuple(plan) == want


def test_mix_tiles_shared_memory():
    """The ring's bytes, as the source's Tile computes them: per stage a
    (BK, BM) W^T tile (rows BM floats apart, or BM + 4 where BM / 4 is
    even) and a (BK, BN) θ tile; only the 128-row tile passes 48 KB (and
    so sets the attribute). The launch bound (``minb`` blocks an SM)
    leaves each thread at least 80 of the SM's 64 K registers, and the
    128- and 64-row tiles' bounds fit the SM's shared memory too (the
    4-row tile's 16 is a cap on registers; shared memory holds 6 of it).
    The 64-row tile has 3,136 floats a stage."""
    assert BK == 16
    assert [t.smem_bytes for t in MIX_TILES] == [33_792, 49_920, 37_632]
    assert [(t.rows, t.cols, t.threads) for t in MIX_TILES] == [
        (4, 128, 32), (128, 128, 256), (64, 128, 256)]
    assert MIX_TILES[2].smem_bytes == 4 * 3 * (BK * (64 + 4) + BK * 128)

    def resident(t):  # blocks an SM's shared memory holds: the ring, the
        # scatter's target rows (4 bytes a row) and 1 KB reserved a block
        return SM_SMEM // (t.smem_bytes + 4 * t.rows + 1024)

    assert [resident(t) for t in MIX_TILES] == [6, 4, 6]
    for t in MIX_TILES:
        assert t.smem_bytes <= BLOCK_SMEM
        assert 65_536 // (t.minb * t.threads) >= 80
    assert all(resident(t) >= t.minb for t in MIX_TILES[1:])
    assert [t.smem_bytes > 48 * 1024 for t in MIX_TILES] == [False, True, False]


def test_mix_scatter_plan_at_the_main_path():
    """The cohort phase's mix-scatter, tile_plan(c, c, d) at c = 50 slots of
    the 47,616-wide slab: the 64-row tile, one row tile (θ crosses HBM
    once), 372 blocks of 256 threads, the 16-byte path, and all 372 blocks
    resident at once on 132 SMs at three blocks an SM (one wave)."""
    plan = mix_tile_plan(50, 50, 47_616, *ALIGNED)
    assert (plan.tile, plan.vec, plan.row_tiles, plan.col_tiles, plan.blocks,
            plan.threads) == (2, True, 1, 372, 372, 256)
    assert plan.smem_bytes == MIX_TILES[2].smem_bytes == 37_632
    assert plan.blocks <= SMS * MIX_TILES[plan.tile].minb
    # the 128-row tile would leave 78 of its 128 rows idle here
    assert MIX_TILES[1].rows - 50 > MIX_TILES[2].rows - 50 >= 0


@pytest.mark.parametrize("full_off,vec", [(0, True), (4, False), (8, False), (12, False),
                                          (16, True)])
def test_mix_scatter_plan_needs_full_aligned(full_off, vec):
    """The scatter stores whole float4s into full's rows, so the 16-byte
    path needs full (not only θ) on a 16-byte boundary."""
    plan = mix_tile_plan(50, 50, 47_616, ALIGNED[0], ALIGNED[1] + full_off)
    assert plan.vec == vec
    assert mix_tile_plan(50, 50, 97, *ALIGNED).vec is False  # d % 4 != 0


@pytest.mark.parametrize("d,theta_off,out_off,vec", [
    (47_616, 0, 0, True),
    (47_616, 4, 0, False),   # θ one float into its buffer (an offset view)
    (47_616, 0, 8, False),   # out not 16-byte aligned
    (47_616, 16, 0, True),   # 16 bytes in is still aligned
    (97, 0, 0, False),       # d % 4 != 0: rows after the first are misaligned
    (6, 0, 0, False),
    (150, 0, 0, False),
    (5, 0, 0, False),
    (4, 0, 0, True),
])
def test_mix_plan_path(d, theta_off, out_off, vec):
    """(3, 5) is the few-row route's: the 16-byte path under the tile
    route's f32 rule (d % 4 == 0, both pointers aligned)."""
    plan = mix_plan(3, 5, d, ALIGNED[0] + theta_off, ALIGNED[1] + out_off)
    assert plan.route == "rows" and plan.vec == vec
    assert mix_tile_plan(3, 5, d, ALIGNED[0] + theta_off, ALIGNED[1] + out_off).vec == vec


def test_mix_plan_rejects_empty_shapes():
    for k, m, d in ((0, 3, 5), (3, 0, 5), (3, 5, 0), (0, 30, 5), (30, 30, 0)):
        with pytest.raises(ValueError, match="positive"):
            mix_plan(k, m, d, *ALIGNED)
        with pytest.raises(ValueError, match="positive"):
            mix_tile_plan(k, m, d, *ALIGNED)


@pytest.mark.parametrize("f", [1, 3, 4, 5, 8, 32, 97, 100, 128, 512])
def test_row_stride_hits_every_bank(f):
    s = row_stride(f)
    assert s >= f and s % 4 == 0 and s - f < 8 and (s // 4) % 2 == 1
    # 8 lanes reading float4 q of rows 0..7 start on 8 distinct 4-bank groups
    assert len({(r * s // 4) % 8 for r in range(8)}) == 8


@pytest.mark.parametrize("m,k,f", list(itertools.product((3, 100, 512), (1, 2, 4, 40, 99, 511),
                                                         (5, 100, 512))))
def test_kmeans_plan_covers_points_and_centroids(m, k, f):
    plan = kmeans_plan(m, k, f, *ALIGNED)
    s = row_stride(f)
    assert plan.stride == s
    assert plan.warps == WARPS
    assert plan.blocks * plan.warps >= m > (plan.blocks - 1) * plan.warps
    assert 1 <= plan.chunk <= k
    assert plan.smem_bytes == 4 * ((plan.warps + plan.chunk) * s + plan.chunk) <= SMEM_BYTES
    # all k centroids in one round trip whenever they fit beside the points
    if 4 * ((plan.warps + k) * s + k) <= SMEM_BYTES:
        assert plan.chunk == k
    else:
        assert 4 * ((plan.warps + plan.chunk + 1) * s + plan.chunk + 1) > SMEM_BYTES
    g = plan.groups
    assert g & (g - 1) == 0 and min(k, 32) <= g < 2 * min(k, 32) and 32 % g == 0
    assert plan.per_lane == (1 if plan.chunk <= g else 4)
    assert plan.vec == (f % 4 == 0)


def test_kmeans_plan_at_the_main_path():
    """ucfl_k4's K-means (100 rows of W, 4 centroids): 13 blocks, groups of
    8 lanes splitting the features, one centroid a group, one round trip;
    Algorithm 2's k = 99: every lane its own 4 centroids, still one round
    trip; m = 512, k = 511: 39 centroids a round trip."""
    p4 = kmeans_plan(100, 4, 100, *ALIGNED)
    assert (p4.blocks, p4.groups, p4.chunk, p4.per_lane, p4.vec) == (13, 4, 4, 1, True)
    p99 = kmeans_plan(100, 99, 100, *ALIGNED)
    assert (p99.groups, p99.chunk, p99.per_lane, p99.smem_bytes) == (32, 99, 4, 43_196)
    big = kmeans_plan(512, 511, 512, *ALIGNED)
    assert (big.stride, big.chunk, big.blocks) == (516, 39, 64)
    assert -(-511 // big.chunk) == 14


@pytest.mark.parametrize("p_off,c_off,f,vec", [(0, 0, 100, True), (4, 0, 100, False),
                                               (0, 8, 100, False), (0, 0, 5, False),
                                               (0, 0, 97, False), (32, 16, 512, True)])
def test_kmeans_plan_path(p_off, c_off, f, vec):
    plan = kmeans_plan(10, 3, f, ALIGNED[0] + p_off, ALIGNED[1] + c_off)
    assert plan.vec == vec


def test_kmeans_plan_wide_rows():
    """A width that leaves no room at WARPS points a block takes fewer
    points, then up to a block's most shared memory; past that it raises."""
    wide = kmeans_plan(100, 4, 5000, *ALIGNED)
    assert wide.warps < WARPS and wide.chunk >= 1 and wide.smem_bytes <= SMEM_BYTES
    wider = kmeans_plan(100, 4, 20_000, *ALIGNED)
    assert wider.warps == 1 and SMEM_BYTES < wider.smem_bytes <= MAX_SMEM_BYTES
    with pytest.raises(ValueError, match="does not fit"):
        kmeans_plan(100, 4, 40_000, *ALIGNED)
    for m, k, f in ((0, 4, 5), (4, 0, 5), (4, 4, -1)):
        with pytest.raises(ValueError, match="positive"):
            kmeans_plan(m, k, f, *ALIGNED)
    empty = kmeans_plan(10, 3, 0, *ALIGNED)  # width 0: rows of 4 zeros, every distance 0
    assert (empty.stride, empty.chunk, empty.vec) == (4, 3, True)


GRAM_SHAPES = list(itertools.product((1, 2, 3, 4, 7, 16, 17, 64, 65, 100, 128, 129, 130, 300,
                                       512), (1, 33, 1000, 47_616)))


def runs(plan):
    """The few-row plan's blocks' columns [c0, c1), as the kernel reads them."""
    return [(b * plan.run, min((b + 1) * plan.run, plan.d)) for b in range(plan.blocks)]


def check_rows_plan(plan, m, d):
    """The few-row plan covers [0, d) once in 16-byte aligned runs, one
    block an SM, with a triangle a block in the workspace."""
    assert plan.route == "rows" and (plan.m, plan.d) == (m, d)
    runs_ = runs(plan)
    assert len(runs_) == plan.blocks <= SMS
    assert runs_[0][0] == 0 and runs_[-1][1] == d
    assert all(c1 == n0 for (_, c1), (n0, _) in zip(runs_, runs_[1:]))
    assert all(c0 % 4 == 0 and c1 > c0 for c0, c1 in runs_)
    assert plan.run % 4 == 0 and plan.run >= RUN_MIN
    assert plan.partial_floats == plan.blocks * m * (m + 1) // 2
    assert plan.values() == [1, m, d, plan.blocks, plan.run, plan.partial_floats]


@pytest.mark.parametrize("m,d", GRAM_SHAPES)
def test_gram_plan_tiles_cover_the_upper_triangle_once(m, d):
    """Every (row, col) with row <= col < m is summed exactly once: by the
    few-row route's m(m+1)/2 sums at m <= M_ROWS, else by exactly one 64 x
    64 job of one tile, and every job holds at least one such element (a
    diagonal tile has no job below its diagonal)."""
    plan = gram_plan(m, d, SMS)
    if m <= M_ROWS:
        # the kernel's sums, row-major: p = i m - i (i - 1) / 2 + (j - i)
        pairs = {i * m - i * (i - 1) // 2 + (j - i): (i, j) for i in range(m) for j in range(i, m)}
        assert plan.route == "rows" and sorted(pairs) == list(range(m * (m + 1) // 2))
        pairs = list(pairs.values())
        assert set(pairs) == {(r, c) for r in range(m) for c in range(r, m)}
        return
    row_tiles = -(-m // TILE)
    assert [(t.bi, t.bj) for t in plan.tiles] == [
        (bi, bj) for bi in range(row_tiles) for bj in range(bi, row_tiles)]
    seen = {}
    for t in plan.tiles:
        jobs = tile_jobs(m, t.bi, t.bj)
        assert t.jobs == len(jobs) and 1 <= len(jobs) <= 4
        for h, c in jobs:
            r0, c0 = t.bi * TILE + HALF * h, t.bj * TILE + HALF * c
            upper = [(r, cc) for r in range(r0, min(r0 + HALF, m))
                     for cc in range(c0, min(c0 + HALF, m)) if r <= cc]
            assert upper, f"job {(h, c)} of tile {(t.bi, t.bj)} holds no upper element"
            for rc in upper:
                seen[rc] = seen.get(rc, 0) + 1
    assert len(seen) == m * (m + 1) // 2 and set(seen.values()) == {1}


@pytest.mark.parametrize("m,d", GRAM_SHAPES)
def test_gram_plan_splits_cover_d(m, d):
    plan = gram_plan(m, d, SMS)
    if m <= M_ROWS:
        check_rows_plan(plan, m, d)
        return
    for t in plan.tiles:
        assert t.chunk % DEPTH == 0 and t.chunk >= DEPTH
        assert t.splits * t.chunk >= d > (t.splits - 1) * t.chunk


@pytest.mark.parametrize("m,d", GRAM_SHAPES)
def test_gram_plan_is_one_wave(m, d):
    """One block an SM at most, the offsets consecutive, and the ring plus
    the split copies within a block's most shared memory (the few-row
    route's blocks hold their sums in registers)."""
    plan = gram_plan(m, d, SMS)
    if m <= M_ROWS:
        assert plan.blocks <= SMS and plan.blocks == -(-d // plan.run)
        assert len(plan.values()) == 6
        return
    first = part = 0
    for t in plan.tiles:
        assert (t.first_block, t.part_offset) == (first, part)
        first += t.splits
        part += t.splits * TILE * TILE
    assert plan.blocks == first <= SMS and plan.partial_floats == part
    assert plan.slices == (2 if len(plan.tiles) > 1 else 1)
    assert plan.smem_bytes == 1024 + (plan.stages * plan.slices + 4) * TILE * DEPTH * 4
    assert plan.smem_bytes <= BLOCK_SMEM
    assert len(plan.values()) == 8 + 7 * len(plan.tiles) and plan.values()[0] == 0


@pytest.mark.parametrize("d", [1, 33, 1000, 47_616, 616_599_552, 2**31 + 4, MAX_WIDTH])
def test_gram_route_is_chosen_by_m_alone(d):
    """The few-row route up to M_ROWS rows, the tensor-core route from
    M_ROWS + 1, at 50 (FedFomo's cohort) and at 512 clients, whatever d."""
    assert 4 <= M_ROWS <= 49
    for m in (1, 2, 3, 4, M_ROWS):
        assert gram_plan(m, d, SMS).route == "rows"
    for m in (M_ROWS + 1, 50, 100, 512):
        if m > TILE and d > 2**32:
            continue  # 10 tiles' splits would pass 2^30 columns: the plan refuses it
        assert gram_plan(m, d, SMS).route == "tiles"


@pytest.mark.parametrize("m,d", [(4, 47_616), (4, 616_599_552), (2, 1_713_418_240),
                                 (4, 930_152_448), (4, 984_560_384), (2, 3 * 2**30 + 1_004),
                                 (M_ROWS, 2**31 + 1), (1, MAX_WIDTH), (3, 5), (4, 47_571)])
def test_gram_rows_plan_covers_d_once(m, d):
    """The few-row plan at the collaboration rounds' shapes, past 2^31
    columns and up to MAX_WIDTH: runs cover [0, d) once, each starting on
    a multiple of 4 columns (16 bytes), their offsets exact as 64-bit
    values (a run start past 2^31 is no wrapped 32-bit int), one block an
    SM, and the workspace holds the blocks' triangles (the wrapper's
    workspace is at least 2^20 floats)."""
    plan = rows_plan(m, d, SMS)
    check_rows_plan(plan, m, d)
    if d > 2**31:
        assert runs(plan)[-1][1] > 2**31  # the last run reaches past a 32-bit offset
    vals = plan.values()
    assert list((ctypes.c_longlong * len(vals))(*vals)) == vals  # exact as the kernel's int64s
    assert plan.partial_floats <= SMS * M_ROWS * (M_ROWS + 1) // 2 <= 2**20
    assert ROW_THREADS * 4 == RUN_MIN


def test_gram_plan_at_the_main_path():
    """The special round (m = 100 over the 47,616-wide slab): one diagonal
    tile of 3 jobs (rows 0-63 x columns 0-63 and 64-127, rows 64-127 x
    columns 64-127), 124 splits of 384 columns (12 ring stages each), a
    4-stage ring of one slice."""
    plan = gram_plan(100, 47_616, SMS)
    (t,) = plan.tiles
    assert (t.bi, t.bj, t.jobs, t.splits, t.chunk) == (0, 0, 3, 124, 384)
    assert tile_jobs(100, 0, 0) == [(0, 0), (0, 1), (1, 1)]
    assert (plan.blocks, plan.stages, plan.slices, plan.smem_bytes) == (124, 4, 1, 132_096)
    assert plan.partial_floats == 124 * TILE * TILE


def test_gram_plan_at_512_clients():
    """512 clients: 4 diagonal tiles of 3 jobs with 11 splits of 4,352
    columns, 6 off-diagonal tiles of 4 jobs with 14 splits of 3,424, so a
    block's jobs x stages are even (408 and 428); 128 blocks, two slices
    a stage."""
    plan = gram_plan(512, 47_616, SMS)
    diag = [t for t in plan.tiles if t.bi == t.bj]
    off = [t for t in plan.tiles if t.bi != t.bj]
    assert len(diag) == 4 and len(off) == 6
    assert {(t.jobs, t.splits, t.chunk) for t in diag} == {(3, 11, 4352)}
    assert {(t.jobs, t.splits, t.chunk) for t in off} == {(4, 14, 3424)}
    assert (plan.blocks, plan.slices, plan.smem_bytes) == (128, 2, 197_632)


def test_gram_plan_at_the_widest_collaboration_rows():
    """mixtral-8x7b's collaboration rows at its published widths, 1 of 32
    layers, 2 clients: 1,713,418,240 columns, the few-row route: 132 runs
    of 12,980,444 columns, a block each. Past 2^31 columns the kernel
    addresses a run with 64-bit offsets, up to MAX_WIDTH = 2^33 columns.
    The tensor-core route (at m > M_ROWS) reads a split through the TMA
    map of the 2^30-column window that holds its first column, so each
    stage's coordinate, counted from that window's base, stays a signed
    32-bit int."""
    d = 1_713_418_240
    plan = gram_plan(2, d, SMS)
    assert (plan.route, plan.blocks, plan.run) == ("rows", 132, 12_980_444)
    for d in (d, 2**31, 3 * 2**30 + 1_004, MAX_WIDTH):
        check_rows_plan(gram_plan(2, d, SMS), 2, d)
        for t in tile_plan(M_ROWS + 1, d, SMS).tiles:
            assert t.chunk <= WINDOW and t.splits * t.chunk >= d
            for k0 in range(0, d, t.chunk):
                j = k0 // WINDOW
                last = min(k0 + t.chunk, d) - 1  # the split's last column
                assert j < MAX_WIDTH // WINDOW and last // DEPTH * DEPTH - j * WINDOW < 2**31 - DEPTH
    with pytest.raises(ValueError, match="2\\^33"):
        gram_plan(2, MAX_WIDTH + 1, SMS)
    with pytest.raises(ValueError, match="2\\^30"):
        gram_plan(TILE + 1, 2**31, 3)  # 3 tiles on 3 SMs: a split of 2^31 columns


def test_gram_plan_rejects():
    for m, d, sms in ((0, 5, SMS), (5, 0, SMS), (5, 5, 0)):
        with pytest.raises(ValueError, match="positive"):
            gram_plan(m, d, sms)
    with pytest.raises(ValueError, match="tiles"):
        gram_plan(11 * TILE, 100, SMS)  # 66 tiles
    with pytest.raises(ValueError, match="tiles"):
        gram_plan(512, 100, 8)  # 10 tiles on 8 SMs
    with pytest.raises(ValueError, match="m <= 16"):
        rows_plan(M_ROWS + 1, 100, SMS)  # more rows than the route's registers hold


@pytest.mark.parametrize("off,stride,d,col,aligned", [
    (0, 47_616, 47_616, 1, True),    # the special round's slab-wide rows
    (0, 47_571, 47_571, 1, False),   # the unaligned width, contiguous: the padded copy
    (0, 47_616, 47_571, 1, True),    # a view of the slab's first 47,571 columns
    (4, 47_616, 47_616, 1, False),   # one float into the buffer
    (16, 1000, 1000, 1, True),
    (0, 300, 300, 1, True),
    (0, 33, 33, 1, False),
    (0, 4, 8, 1, False),             # overlapping rows
    (0, 1000, 1000, 2, False),       # a column stride
    (8, 1024, 1000, 1, False),
])
def test_gram_path(off, stride, d, col, aligned):
    assert gram_aligned(ALIGNED[0] + off, stride, d, col) == aligned

