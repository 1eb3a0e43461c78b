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
// Design:
//   * one thread per output column and KC output rows in registers (KC = 4
//     for k <= 4, else 16); a block is 256 consecutive columns and one
//     chunk of KC rows. The grid
//     is 1-D with the row chunk fastest, so the blocks that re-read a column
//     tile of θ run next to each other and find it in L2;
//   * θ is read coalesced: a warp reads 32 neighbouring floats of one row,
//     and each thread starts 16 such loads (16 clients) before it uses
//     them, so enough bytes are in flight to approach HBM rate with only
//     one thread per column;
//   * W's KC rows are staged in shared memory, transposed so that the KC
//     weights of one client are contiguous and read as broadcasts. Clients
//     are staged 512 at a time, so any m fits in 32 KB;
//   * each output is summed over clients in order 0..m-1 with FMAs.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kClientsPerStage = 512;
constexpr int kBatch = 16;  // θ loads in flight together (memory-level parallelism)

template <int KC>
__global__ void __launch_bounds__(kThreads)
mix_kernel(const float* __restrict__ w, const float* __restrict__ theta,
           float* __restrict__ out, int k, int m, int64_t d, int row_chunks) {
  __shared__ __align__(16) float ws[kClientsPerStage][KC];
  const int chunk = blockIdx.x % row_chunks;
  const int64_t col_tile = blockIdx.x / row_chunks;
  const int r0 = chunk * KC;
  const int64_t c = col_tile * kThreads + threadIdx.x;
  const bool live = c < d;

  float acc[KC];
#pragma unroll
  for (int i = 0; i < KC; ++i) acc[i] = 0.f;

  for (int j0 = 0; j0 < m; j0 += kClientsPerStage) {
    const int jn = m - j0 < kClientsPerStage ? m - j0 : kClientsPerStage;
    __syncthreads();  // the previous stage's readers are done
    for (int t = threadIdx.x; t < jn * KC; t += kThreads) {
      const int j = t / KC;
      const int i = t % KC;
      ws[j][i] = r0 + i < k ? w[static_cast<int64_t>(r0 + i) * m + j0 + j] : 0.f;
    }
    __syncthreads();
    if (live) {
      const float* col = theta + static_cast<int64_t>(j0) * d + c;
      int j = 0;
      // kBatch independent loads in flight per thread before their FMAs
      for (; j + kBatch <= jn; j += kBatch) {
        float t[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) t[u] = col[static_cast<int64_t>(j + u) * d];
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
#pragma unroll
          for (int i = 0; i < KC; ++i) acc[i] = fmaf(ws[j + u][i], t[u], acc[i]);
      }
      for (; j < jn; ++j) {
        const float t = col[static_cast<int64_t>(j) * d];
#pragma unroll
        for (int i = 0; i < KC; ++i) acc[i] = fmaf(ws[j][i], t, acc[i]);
      }
    }
  }
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
