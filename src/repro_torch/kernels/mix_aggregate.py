"""Wrapper of the Hopper mix kernel (``csrc/mix_aggregate.cu``).

Replaces ``repro.kernels.mix_aggregate.mix_aggregate_pallas``:
``out(k, d) = W(k, m) · θ(m, d)``, f32 accumulate.

:func:`mix_plan` is the launch plan, a function of host ints: which of the
three register tiles (``MIX_TILES``, ``T0``, ``T1`` and ``T2`` of
``csrc/mix_tile.cuh``) takes the call, the 16-byte or the scalar path, the
grid and the dynamic shared memory. The masked mix-scatter
(``masked_mix_scatter.py``) runs the same tiles and takes the same plan.
Each kernel refuses a plan that disagrees with its own tile.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

MIX = _build.Kernel("mix_aggregate.cu", "mix_aggregate_f32", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int])

BK = 16  # rows of θ a chunk of the kernel's shared-memory ring


class MixTile(NamedTuple):
    """A register tile of the kernel: each of tr x tc threads sums an
    rm x rn block of the output; ``stages`` chunks in the ring; ``minb``
    blocks an SM, the launch bound that caps the registers."""

    rm: int
    rn: int
    tr: int
    tc: int
    stages: int
    minb: int

    @property
    def rows(self) -> int:  # BM: rules a block covers
        return self.rm * self.tr

    @property
    def cols(self) -> int:  # BN: columns a block covers
        return self.rn * self.tc

    @property
    def threads(self) -> int:
        return self.tr * self.tc

    @property
    def smem_bytes(self) -> int:
        """The ring: per stage a transposed (BK, BM) W tile, its rows BM
        floats apart, or BM + 4 where BM / 4 is even (so the stride / 4 is
        odd), and a (BK, BN) θ tile, f32."""
        ws = self.rows if (self.rows // 4) % 2 else self.rows + 4
        return 4 * self.stages * BK * (ws + self.cols)


# the source's T0, T1 and T2, by index: the plan takes T0 when its 4 rows
# cover k, T2 when its 64 rows do, else T1 over ceil(k / 128) row tiles.
MIX_TILES = (
    MixTile(rm=4, rn=4, tr=1, tc=32, stages=4, minb=16),  # k <= 4 (ucfl_k4's centroid rules)
    MixTile(rm=8, rn=8, tr=16, tc=16, stages=3, minb=2),  # k > 64 (full ucfl), 128 rows a tile
    MixTile(rm=8, rn=4, tr=8, tc=32, stages=3, minb=3),   # 5 <= k <= 64 (a 50-slot cohort)
)


class MixPlan(NamedTuple):
    tile: int          # index into MIX_TILES
    vec: bool          # the 16-byte path
    row_tiles: int
    col_tiles: int
    blocks: int        # row_tiles * col_tiles, the row tile fastest
    threads: int
    smem_bytes: int


def mix_plan(k: int, m: int, d: int, theta_ptr: int, out_ptr: int) -> MixPlan:
    """The launch of ``out(k, d) = W(k, m) · θ(m, d)`` (k, m, d > 0): the
    4-row tile for k <= 4, the 64-row tile for k <= 64, else the 128-row
    tile over ceil(k / 128) row tiles (a warp whose rows all lie past k
    skips its FMAs); the 16-byte path when d % 4 == 0 and θ and out start
    on 16-byte boundaries (every row then does), else the scalar path; one
    block per row tile and 128 columns. m only has to be positive: the
    ring takes any m. The masked mix-scatter plans with ``mix_plan(c, c,
    d, theta_ptr, full_ptr)``."""
    if min(k, m, d) <= 0:
        raise ValueError(f"mix_plan: k, m, d must be positive, got {(k, m, d)}")
    index = 0 if k <= MIX_TILES[0].rows else 2 if k <= MIX_TILES[2].rows else 1
    t = MIX_TILES[index]
    row_tiles = -(-k // t.rows)
    col_tiles = -(-d // t.cols)
    blocks = row_tiles * col_tiles
    if blocks > 2**31 - 1:
        raise ValueError(f"mix_plan: {blocks} blocks for k={k}, d={d} pass the grid's limit")
    vec = d % 4 == 0 and (theta_ptr | out_ptr) % 16 == 0
    return MixPlan(index, vec, row_tiles, col_tiles, blocks, t.threads, t.smem_bytes)


def mix_aggregate_cuda(w: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """w (k, m), theta (m, d) float32 CUDA tensors -> (k, d) float32.

    W is cast to float32 like the reference does; θ must already be
    float32 (the slab always is). d == 0 returns early without a launch.
    """
    if not (w.is_cuda and theta.is_cuda) or w.device != theta.device:
        raise ValueError("mix_aggregate_cuda: expects both tensors on one CUDA device")
    if w.dim() != 2 or theta.dim() != 2 or w.shape[1] != theta.shape[0]:
        raise ValueError(f"mix_aggregate_cuda: shapes {tuple(w.shape)} x "
                         f"{tuple(theta.shape)} do not chain")
    if theta.dtype != torch.float32:
        raise TypeError(f"mix_aggregate_cuda: theta must be float32, got {theta.dtype}")
    k, m = w.shape
    d = theta.shape[1]
    out = torch.empty((k, d), dtype=torch.float32, device=theta.device)
    if d == 0 or k == 0:
        return out
    if m == 0:
        return out.zero_()
    w = w.to(torch.float32).contiguous()
    theta = theta.contiguous()
    plan = mix_plan(k, m, d, theta.data_ptr(), out.data_ptr())
    MIX(theta.device, _build.ptr(w), _build.ptr(theta), _build.ptr(out), k, m, d, plan.tile,
        int(plan.vec), plan.blocks, plan.smem_bytes)
    return out
