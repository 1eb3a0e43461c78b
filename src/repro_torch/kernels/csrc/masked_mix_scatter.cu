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
// What bounds it on an H100: at the main path's cohort (c = 50 slots on the
// 47,616-wide slab) it reads θ once (9.5 MB) and writes at most 9.5 MB,
// about 5.7 us at 3.35 TB/s, against 2·c²·d = 0.24 GFLOP on the f32 CUDA
// cores (3.6 us): bound by bytes.
//
// Design: the column-per-thread sum of mix_rows.cuh (θ read coalesced with
// 16 loads in flight per thread, W's rows transposed in shared memory,
// sums over j = 0..c-1 in order with FMAs). A pad column of W is 0, so a
// padded cohort's live rows are bit-for-bit those of the unpadded cohort.
// A block owns 256 columns and KC = 16 consecutive slots (the slot chunk
// is the fastest grid index, so the chunks that re-read one θ tile run
// together and find it in L2). It first loads its slots' idx and mask;
// a block without a live slot returns before it reads θ. Stores go to
// full + idx[i]·d + col for live slots only.
//
// Contract: the live indices are distinct (a Cohort's members strictly
// increase; duplicates would race), and θ and W do not overlap full (the
// wrapper checks this); neither is checked on the device.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mix_rows.cuh"

namespace {

using mix_rows::kThreads;
constexpr int KC = 16;

__global__ void __launch_bounds__(kThreads)
masked_mix_scatter_kernel(const float* __restrict__ w,
                          const float* __restrict__ theta,
                          const int* __restrict__ idx,
                          const unsigned char* __restrict__ mask,
                          float* __restrict__ full, int c, int m, int64_t d,
                          int slot_chunks) {
  __shared__ int rows[KC];  // target row of each slot of the chunk, -1 if dead
  const int chunk = blockIdx.x % slot_chunks;
  const int64_t col_tile = blockIdx.x / slot_chunks;
  const int s0 = chunk * KC;
  bool mine = false;
  if (threadIdx.x < KC) {
    const int s = s0 + threadIdx.x;
    int r = -1;
    if (s < c) {
      const int t = idx[s];
      if (mask[s] != 0 && t >= 0 && t < m) r = t;
    }
    rows[threadIdx.x] = r;
    mine = r >= 0;
  }
  // the barrier also publishes rows[]; the result is block-uniform
  if (!__syncthreads_or(mine)) return;

  const int64_t col = col_tile * kThreads + threadIdx.x;
  const bool live = col < d;
  float acc[KC];
  mix_rows::accumulate<KC>(w, theta, s0, c, c, d, col, live, acc);
  if (!live) return;
#pragma unroll
  for (int i = 0; i < KC; ++i) {
    const int r = rows[i];
    if (r >= 0) full[static_cast<int64_t>(r) * d + col] = acc[i];
  }
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// w (c, c), theta (c, d), full (m, d): f32, row-major, contiguous;
// idx (c,) int32, mask (c,) bytes; c > 0, d > 0. Writes full in place.
extern "C" int masked_mix_scatter_f32(const float* w, const float* theta,
                                      const int* idx, const unsigned char* mask,
                                      float* full, int c, int m, long long d,
                                      void* stream) {
  const int slot_chunks = (c + KC - 1) / KC;
  const long long col_tiles = (d + kThreads - 1) / kThreads;
  const long long blocks = col_tiles * slot_chunks;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  masked_mix_scatter_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      w, theta, idx, mask, full, c, m, d, slot_chunks);
  return cudaGetLastError();
}
