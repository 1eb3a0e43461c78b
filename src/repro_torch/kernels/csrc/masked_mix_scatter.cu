// Masked cohort mix + scatter, in place:
//   full[idx[i]] = (W(c, c) · θ(c, d))[i]   for every slot i with
//   mask[i] != 0 and 0 <= idx[i] < m; every other row of full is untouched.
//
// Replaces both TPU variants of the round-end cohort mix:
// src/repro/kernels/masked_mix_scatter.py::masked_mix_scatter_pallas (the
// VMEM slab, which copies all m rows of full through VMEM) and
// src/repro/kernels/masked_gather_mix_scatter.py::
// masked_gather_mix_scatter_pallas (full left in HBM, one DMA per cohort
// row). On Hopper one kernel that reads θ and W and writes only the live
// cohort rows covers both: traffic is O(c·d) at any m.
//
// What bounds it on an H100: at the main path's cohort (c = 50 slots, 42
// live, on the 47,616-wide slab) it reads θ once (9.5 MB) and writes the
// 42 live rows (8.0 MB), about 5.2 us at 3.35 TB/s, against 2·c²·d =
// 0.24 GFLOP on the f32 CUDA cores (3.6 us): bound by bytes.
//
// Design: mix_aggregate's register-tiled ring (mix_tile.cuh) with a
// scatter epilogue, on the tile that `tile_plan(c, c, d, θ, full)` picks:
// the 64-row tile T2 for 5 <= c <= 64, so a 50-slot cohort reads each
// (50, 128) column tile of θ from HBM once and its 372 blocks are all
// resident at once (three 256-thread blocks an SM on 132 SMs: one wave).
//   * A block first loads the target row of each of its BM slots into
//     shared memory: idx[i] if the slot is live, else -1. A block without
//     a live slot returns before it reads θ (an all-pad cohort reads and
//     writes nothing); a warp none of whose slots is live (rows past c,
//     or a cohort's trailing pads) skips its FMAs.
//   * Sum row i goes to full + target[i]·d + col, for live slots only.
//     Every sum is one FMA chain from +0 over j = 0..c-1 in order, as in
//     mix_aggregate, so a pad column of W (0) leaves a padded cohort's
//     live rows bit for bit those of the unpadded cohort, and the identity
//     scatter (idx = 0..c-1, all live) gives mix_aggregate's bits.
//
// Contract: the live indices are distinct (a Cohort's members strictly
// increase; duplicates would race), and θ and W do not overlap full (the
// wrapper checks this); neither is checked on the device.
#include "mix_tile.cuh"

namespace {

using namespace mix_tile;

template <class T, bool VEC>
__global__ void __launch_bounds__(T::kThreads, T::MINB)
masked_mix_scatter_kernel(const float* __restrict__ w, const float* __restrict__ theta,
                          const int* __restrict__ idx, const unsigned char* __restrict__ mask,
                          float* __restrict__ full, int c, int m, int64_t d, int row_tiles) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int target[T::BM];  // target row of each slot of the tile, -1 if dead
  const int r0 = (blockIdx.x % row_tiles) * T::BM;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x / row_tiles) * T::BN;
  bool mine = false;
  for (int i = threadIdx.x; i < T::BM; i += T::kThreads) {
    const int s = r0 + i;
    int r = -1;
    if (s < c) {
      const int t = idx[s];
      if (mask[s] != 0 && t >= 0 && t < m) r = t;
    }
    target[i] = r;
    mine |= r >= 0;
  }
  // the barrier also publishes target[]; the result is block-uniform
  if (!__syncthreads_or(mine)) return;

  const int tr = threadIdx.x / T::TC;
  bool has = false;
#pragma unroll
  for (int i = 0; i < T::RM; ++i) has |= target[tr * T::RM + i] >= 0;
  const bool live = __any_sync(0xffffffffu, has);

  float acc[T::RM][T::RN];
  tile_sums<T, VEC>(w, theta, smem, r0, c, c, d, c0, live, acc);
  if (!live) return;
#pragma unroll
  for (int i = 0; i < T::RM; ++i) {
    const int t = target[tr * T::RM + i];
    if (t >= 0) store_row<T, VEC>(full + static_cast<int64_t>(t) * d, acc[i], c0, d);
  }
}

template <class T, bool VEC>
cudaError_t launch(const float* w, const float* theta, const int* idx, const unsigned char* mask,
                   float* full, int c, int m, long long d, long long blocks, int smem_bytes,
                   cudaStream_t st) {
  static std::atomic<unsigned long long> done{0};
  // the planner (tile_plan) and the kernel must agree on the tile
  if (!plan_agrees<T>(c, d, blocks, smem_bytes)) return cudaErrorInvalidConfiguration;
  const cudaError_t err = allow_smem<T>(masked_mix_scatter_kernel<T, VEC>, done);
  if (err != cudaSuccess) return err;
  masked_mix_scatter_kernel<T, VEC>
      <<<static_cast<unsigned>(blocks), T::kThreads, T::kSmemBytes, st>>>(
          w, theta, idx, mask, full, c, m, d, (c + T::BM - 1) / T::BM);
  return cudaGetLastError();
}

template <class T>
cudaError_t launch_path(bool vec, const float* w, const float* theta, const int* idx,
                        const unsigned char* mask, float* full, int c, int m, long long d,
                        long long blocks, int smem_bytes, cudaStream_t st) {
  return vec ? launch<T, true>(w, theta, idx, mask, full, c, m, d, blocks, smem_bytes, st)
             : launch<T, false>(w, theta, idx, mask, full, c, m, d, blocks, smem_bytes, st);
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// w (c, c), theta (c, d), full (m, d): f32, row-major, contiguous;
// idx (c,) int32, mask (c,) bytes; c > 0, d > 0. Writes full in place.
// `tile`, `vec`, `blocks` and `smem_bytes` are tile_plan(c, c, d, theta,
// full)'s; a plan that disagrees with the kernel's own tile is refused
// (cudaErrorInvalidConfiguration).
extern "C" int masked_mix_scatter_f32(const float* w, const float* theta, const int* idx,
                                      const unsigned char* mask, float* full, int c, int m,
                                      long long d, int tile, int vec, long long blocks,
                                      int smem_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 0:
      return launch_path<T0>(vec, w, theta, idx, mask, full, c, m, d, blocks, smem_bytes, st);
    case 1:
      return launch_path<T1>(vec, w, theta, idx, mask, full, c, m, d, blocks, smem_bytes, st);
    case 2:
      return launch_path<T2>(vec, w, theta, idx, mask, full, c, m, d, blocks, smem_bytes, st);
    default: return cudaErrorInvalidValue;
  }
}
