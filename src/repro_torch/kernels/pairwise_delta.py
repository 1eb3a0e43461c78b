"""Wrapper of the Hopper Gram kernel (``csrc/gram.cu``).

Replaces ``repro.kernels.pairwise_delta.gram_pallas``. One C entry, one
launch a call, two routes, which the plan picks from m alone:

* m <= M_ROWS, the few-row route (the collaboration round's 2-4 rows at
  LLM width): a streaming kernel on the CUDA cores, bound by the bytes of
  G. Each block sums a run of d into its triangle in f32 registers, and the
  last block to finish sums the blocks' triangles in block order;
* m > M_ROWS, the tensor-core route: the upper triangle of ``G Gᵀ`` in
  3xTF32 on the tensor cores (wgmma), split over d in one wave of blocks
  that then merge their partial triangles in the same launch.

Both mirror the triangle, so the result is exactly symmetric; Δ is formed
from it in plain torch by :func:`repro_torch.kernels.ops.pairwise_delta`,
as the reference does.

:func:`gram_plan` is the launch plan, a function of shapes alone: for the
few-row route the blocks and their runs of columns, for the tensor-core
route the tiles of the triangle, each tile's splits of d and their chunk,
the ring's stages, the grid and the workspace. :func:`gram_aligned` says
whether the kernel can read a tensor where it lies (a 16-byte aligned base
and row stride: TMA's rule, and the few-row route's float4 loads); any
other input is first copied into a zero-padded scratch of width
``round_up(d, 4)``, counted by ``GRAM.padded``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

TILE = 128        # rows (and columns) of a block tile in csrc/gram.cu
HALF = 64         # rows and columns of a job (one wgmma m64n64 accumulator)
DEPTH = 32        # columns of G a ring stage (128 bytes a row)
MAX_TILES = 64    # tiles a plan: m <= 10 x 128
WINDOW = 2**30    # columns between two TMA maps' bases in csrc/gram.cu; a split's most
MAX_WIDTH = 2**33  # most columns: 8 maps (a TMA coordinate is a signed 32-bit int)
STAGES = 4        # slices in flight a block
SLICE_BYTES = TILE * DEPTH * 4
SPLIT_SLICES = 4  # two buffers of the column operand's split, a big and a small slice each
# the plan takes the few-row route for m <= M_ROWS: csrc/gram.cu's
# gram_rows_kernel holds up to 16 rows (its triangle's sums in registers),
# and it is faster than the tensor-core route at every m it holds
# (PERF.md, the gram findings)
M_ROWS = 16
ROW_THREADS = 256  # threads a block of gram_rows_kernel
RUN_MIN = 4 * ROW_THREADS  # a block's fewest columns: a quad (float4) a thread
ROUTE_TILES, ROUTE_ROWS = 0, 1  # a plan's first value


class GramKernel(_build.Kernel):
    """The Gram launch. Besides ``launches``, ``padded`` counts the calls
    whose input had to be copied into an aligned scratch first (the main
    path hands the kernel aligned rows and shows none)."""

    def __init__(self, *args):
        super().__init__(*args)
        self.padded = 0


GRAM = GramKernel("gram.cu", "gram_f32", [
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p])


class GramTile(NamedTuple):
    bi: int            # row tile
    bj: int            # column tile, bj >= bi
    jobs: int          # 64 x 64 jobs covering the tile's part of the triangle
    splits: int        # blocks cutting d
    chunk: int         # columns of d a split, a multiple of DEPTH
    first_block: int
    part_offset: int   # float offset of the tile's (splits, 128, 128) partials


class GramPlan(NamedTuple):
    m: int
    d: int
    tiles: tuple       # GramTile, row tile major, bi <= bj
    blocks: int        # the grid: the sum of the splits, at most one block an SM
    stages: int
    slices: int        # 128 x 32 slices a stage: 2 once any tile is off the diagonal
    smem_bytes: int
    partial_floats: int

    route = "tiles"

    def values(self) -> list:
        """The plan as the kernel reads it: the route, m, d, tiles, blocks,
        stages, slices, shared memory, then 7 values a tile."""
        head = [ROUTE_TILES, self.m, self.d, len(self.tiles), self.blocks, self.stages,
                self.slices, self.smem_bytes]
        return head + [v for t in self.tiles for v in t]


class GramRowsPlan(NamedTuple):
    m: int
    d: int
    blocks: int          # the grid, at most one block an SM
    run: int             # columns a block, a multiple of 4; the last block's run ends at d
    partial_floats: int  # a block's m(m+1)/2 triangle sums each

    route = "rows"

    def values(self) -> list:
        """The plan as the kernel reads it: the route, m, d, blocks, run,
        partial floats."""
        return [ROUTE_ROWS, self.m, self.d, self.blocks, self.run, self.partial_floats]


def halves(m: int, b: int) -> int:
    """64-row halves of tile b that start below m (1 or 2)."""
    return 2 if m - b * TILE > HALF else 1


def tile_jobs(m: int, bi: int, bj: int) -> list:
    """The (h, c) jobs of tile (bi, bj): row half h, column half c, each
    starting below m, and on a diagonal tile only c >= h (the job below
    the diagonal holds no element of the upper triangle)."""
    return [(h, c) for h in range(halves(m, bi)) for c in range(halves(m, bj))
            if bi != bj or c >= h]


def gram_plan(m: int, d: int, sm_count: int):
    """The launch of ``G Gᵀ`` for G (m, d), m, d > 0, on ``sm_count`` SMs:
    :func:`rows_plan` for m <= M_ROWS, else :func:`tile_plan`. Raises
    ValueError past MAX_WIDTH columns."""
    if m <= 0 or d <= 0 or sm_count <= 0:
        raise ValueError(f"gram_plan: m, d and sm_count must be positive, got {(m, d, sm_count)}")
    if d > MAX_WIDTH:
        raise ValueError(f"gram_plan: d = {d} columns, past the kernel's {MAX_WIDTH} (2^33)")
    return rows_plan(m, d, sm_count) if m <= M_ROWS else tile_plan(m, d, sm_count)


def rows_plan(m: int, d: int, sm_count: int) -> GramRowsPlan:
    """The few-row route's launch (m <= M_ROWS): runs of
    ``max(RUN_MIN, round_up(ceil(d / sm_count), 4))`` columns, a block each,
    so at most one block an SM and every run 16-byte aligned on aligned
    rows; the workspace holds a triangle a block."""
    if not 0 < m <= M_ROWS or d <= 0 or sm_count <= 0:
        raise ValueError(f"rows_plan: needs 0 < m <= {M_ROWS} and positive d and sm_count, "
                         f"got {(m, d, sm_count)}")
    run = max(RUN_MIN, -(-(-(-d // sm_count)) // 4) * 4)
    blocks = -(-d // run)
    return GramRowsPlan(m, d, blocks, run, blocks * m * (m + 1) // 2)


def tile_plan(m: int, d: int, sm_count: int) -> GramPlan:
    """The tensor-core route's launch.

    The tiles (bi, bj), bi <= bj, of 128 rows cover the upper triangle.
    Each gets splits of d in proportion to its jobs, at least one, so that
    the blocks' work is even and all of them fit one block an SM; each
    split's chunk is a multiple of DEPTH. Raises ValueError past MAX_TILES
    tiles, when the tiles outnumber the SMs, past MAX_WIDTH columns or
    where a split would pass WINDOW columns (the kernel reads a split
    through one TMA map of 2 x WINDOW columns, whose coordinates are
    signed 32-bit ints)."""
    if m <= 0 or d <= 0 or sm_count <= 0:
        raise ValueError(f"gram_plan: m, d and sm_count must be positive, got {(m, d, sm_count)}")
    if d > MAX_WIDTH:
        raise ValueError(f"gram_plan: d = {d} columns, past the kernel's {MAX_WIDTH} (2^33)")
    row_tiles = -(-m // TILE)
    pairs = [(bi, bj) for bi in range(row_tiles) for bj in range(bi, row_tiles)]
    if len(pairs) > min(MAX_TILES, sm_count):
        raise ValueError(f"gram_plan: m={m} needs {len(pairs)} tiles, more than the kernel's "
                         f"{MAX_TILES} or the {sm_count} SMs")
    jobs = [len(tile_jobs(m, bi, bj)) for bi, bj in pairs]
    tiles, first, part = [], 0, 0
    for (bi, bj), n in zip(pairs, jobs):
        want = max(1, sm_count * n // sum(jobs))
        chunk = -(-(-(-d // want)) // DEPTH) * DEPTH
        splits = -(-d // chunk)
        if chunk > WINDOW:
            raise ValueError(f"gram_plan: tile ({bi}, {bj}) would sum {chunk} columns a split, "
                             f"past the kernel's {WINDOW} (2^30)")
        tiles.append(GramTile(bi, bj, n, splits, chunk, first, part))
        first += splits
        part += splits * TILE * TILE
    slices = 2 if len(tiles) > 1 else 1
    return GramPlan(m, d, tuple(tiles), first, STAGES, slices,
                    1024 + (STAGES * slices + SPLIT_SLICES) * SLICE_BYTES, part)


def gram_aligned(ptr: int, row_stride: int, d: int, col_stride: int = 1) -> bool:
    """Whether the kernel reads G (rows ``row_stride`` floats apart, from
    ``ptr``) where it lies: unit column stride, a 16-byte aligned base and
    row stride (TMA's rule, and the few-row route's float4 loads), and
    rows that do not overlap."""
    return col_stride == 1 and ptr % 16 == 0 and row_stride % 4 == 0 and row_stride >= d


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=256)
def _plan_values(m: int, d: int, sms: int):
    """(plan, its values as a ctypes array) for the launch, kept per shape."""
    plan = gram_plan(m, d, sms)
    vals = plan.values()
    return plan, (ctypes.c_longlong * len(vals))(*vals)


# (device index, stream) -> the grid barrier's two counters (the few-row
# route's ticket is the first; zeroed once, left at zero by every launch)
# and the partials, as (tensor, tensor).
# Launches on one stream run in order, so they share the buffers; the
# partials grow when a launch needs more.
_WORKSPACE: dict[tuple[int, int], tuple] = {}


def _workspace(device, stream_handle: int, floats: int):
    key = (device.index, stream_handle)
    ws = _WORKSPACE.get(key)
    if ws is None or ws[1].numel() < floats:
        counters = ws[0] if ws is not None else torch.zeros(2, dtype=torch.int32, device=device)
        partial = torch.empty(max(floats, 2**20), dtype=torch.float32, device=device)
        ws = _WORKSPACE[key] = (counters, partial)
    return ws


def gram_cuda(g: torch.Tensor) -> torch.Tensor:
    """(m, d) f32 CUDA tensor -> (m, m) f32 Gram matrix, exactly symmetric.

    One launch a call, with no synchronizing call and, once the stream's
    workspace exists, no allocation beyond the output (and the scratch of
    an input the kernel cannot read where it lies)."""
    if not g.is_cuda:
        raise ValueError("gram_cuda: expects a CUDA tensor")
    if g.dtype != torch.float32 or g.dim() != 2:
        raise TypeError(f"gram_cuda: expects a 2-D float32 tensor, got "
                        f"{g.dim()}-D {g.dtype}")
    m, d = g.shape
    out = torch.empty((m, m), dtype=torch.float32, device=g.device)
    if m == 0:
        return out
    if d == 0:
        return out.zero_()
    if not gram_aligned(g.data_ptr(), g.stride(0), d, g.stride(1)):
        scratch = torch.zeros((m, -(-d // 4) * 4), dtype=torch.float32, device=g.device)
        scratch[:, :d] = g
        g = scratch
        GRAM.padded += 1
    plan, values = _plan_values(m, d, _sm_count(g.device.index))
    stream = torch.cuda.current_stream(g.device).cuda_stream
    counters, partial = _workspace(g.device, stream, plan.partial_floats)
    GRAM.launch(g.device, stream, _build.ptr(g), g.stride(0), m, d,
                ctypes.cast(values, ctypes.c_void_p), len(values), _build.ptr(partial),
                partial.numel(), _build.ptr(counters), _build.ptr(out))
    return out
