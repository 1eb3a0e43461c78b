// Column-per-thread weighted row sum of masked_mix_scatter.cu:
// out_i(c) = sum_j W[r0 + i, j] * θ[j, c] for the KC rules r0 .. r0 + KC - 1
// of a (k, m) W over the (m, d) θ. (mix_aggregate.cu has its own
// register-tiled kernel and does not include this header.)
//
// Design (see masked_mix_scatter.cu for what bounds it):
//   * each thread owns one column c of θ and keeps its KC sums in
//     registers; a warp reads 32 neighbouring floats of one θ row, so θ is
//     read coalesced, and each thread starts kBatch loads (kBatch rows)
//     before it uses them, so enough bytes are in flight to approach HBM
//     rate with one thread per column;
//   * W's KC rows are staged in shared memory, transposed so that the KC
//     weights of one θ row are contiguous and read as broadcasts; rows are
//     staged kRowsPerStage at a time, so any m fits in 32 KB;
//   * every sum runs over j = 0 .. m-1 in order with FMAs from 0. A zero
//     weight then adds exactly 0 to a finite sum, so extra zero columns
//     (pad slots of a cohort) leave every sum bit-for-bit unchanged.
#pragma once
#include <stdint.h>

namespace mix_rows {

constexpr int kThreads = 256;
constexpr int kRowsPerStage = 512;
constexpr int kBatch = 16;  // θ loads in flight together (memory-level parallelism)

// acc[i] = sum_{j < m} w[(r0 + i) * m + j] * theta[j * d + c] for i < KC;
// rules r0 + i >= k are all-zero rules. The block has kThreads threads,
// and every one must call it (it stages W between barriers); `live` says
// whether column c exists (c < d).
template <int KC>
__device__ __forceinline__ void accumulate(const float* __restrict__ w,
                                           const float* __restrict__ theta,
                                           int r0, int k, int m, int64_t d,
                                           int64_t c, bool live,
                                           float (&acc)[KC]) {
  __shared__ __align__(16) float ws[kRowsPerStage][KC];
#pragma unroll
  for (int i = 0; i < KC; ++i) acc[i] = 0.f;

  for (int j0 = 0; j0 < m; j0 += kRowsPerStage) {
    const int jn = m - j0 < kRowsPerStage ? m - j0 : kRowsPerStage;
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
}

}  // namespace mix_rows
