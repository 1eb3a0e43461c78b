// User-centric mix out(k, d) = W(k, m) · θ(m, d), f32 in and out.
//
// Replaces src/repro/kernels/mix_aggregate.py::mix_aggregate_pallas
// (_mix_kernel), which keeps the small W resident in VMEM and streams θ
// through once, one d-block per grid step.
//
// What bounds it on an H100: θ is tall and skinny, and every column of the
// output needs only that column of θ. For k = 4 (the clustered variant) it
// reads 19 MB and writes 0.8 MB, about 6 us at 3.35 TB/s; for full
// personalisation (k = m = 100 on the 47,616-wide slab) it reads and writes
// 19 MB each, about 11 us, with 0.95 GFLOP on the f32 CUDA cores (about
// 14 us), so it sits near the ridge.
//
// Design: the column-per-thread sum of mix_rows.cuh (θ read coalesced with
// 16 loads in flight per thread, W's rows transposed in shared memory,
// sums in order 0..m-1 with FMAs), KC output rows per block in registers
// (KC = 4 for k <= 4, else 16); a block is 256 consecutive columns and one
// chunk of KC rows. The grid is 1-D with the row chunk fastest, so the
// blocks that re-read a column tile of θ run next to each other and find
// it in L2.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mix_rows.cuh"

namespace {

using mix_rows::kThreads;

template <int KC>
__global__ void __launch_bounds__(kThreads)
mix_kernel(const float* __restrict__ w, const float* __restrict__ theta,
           float* __restrict__ out, int k, int m, int64_t d, int row_chunks) {
  const int chunk = blockIdx.x % row_chunks;
  const int64_t col_tile = blockIdx.x / row_chunks;
  const int r0 = chunk * KC;
  const int64_t c = col_tile * kThreads + threadIdx.x;
  const bool live = c < d;

  float acc[KC];
  mix_rows::accumulate<KC>(w, theta, r0, k, m, d, c, live, acc);
  if (!live) return;
#pragma unroll
  for (int i = 0; i < KC; ++i)
    if (r0 + i < k) out[static_cast<int64_t>(r0 + i) * d + c] = acc[i];
}

template <int KC>
cudaError_t launch(const float* w, const float* theta, float* out, int k,
                   int m, long long d, cudaStream_t st) {
  const int row_chunks = (k + KC - 1) / KC;
  const long long col_tiles = (d + kThreads - 1) / kThreads;
  const long long blocks = col_tiles * row_chunks;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  mix_kernel<KC><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      w, theta, out, k, m, d, row_chunks);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// w (k, m), theta (m, d), out (k, d): f32, row-major, contiguous; d > 0.
extern "C" int mix_aggregate_f32(const float* w, const float* theta,
                                 float* out, int k, int m, long long d,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // two instances: k <= 4 (the clustered variant's few centroid rules)
  // and 16 rows per block for anything wider (full personalisation)
  if (k <= 4) return launch<4>(w, theta, out, k, m, d, st);
  return launch<16>(w, theta, out, k, m, d, st);
}
