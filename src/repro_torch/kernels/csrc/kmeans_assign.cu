// K-means assignment: for every point, the nearest centroid and its
// squared distance, f32 in, int32 labels and f32 distances out.
//
// Replaces src/repro/kernels/kmeans_assign.py::kmeans_assign_pallas
// (_assign_kernel), which builds the whole (m, k) distance matrix on the
// MXU in one block, padding the centroids with 1e30 sentinel rows.
//
// What bounds it on an H100: nothing but latency. At the main path's shape
// (100 points and 4 centroids of width 100) the inputs are 42 KB and the
// work 80 kFLOP; the kernel runs 51 times per k-means, so launch and
// memory latency are all of its time.
//
// Design:
//   * one warp per point; the lanes stride over the feature axis and a
//     shuffle butterfly reduces, which leaves the same sum on every lane
//     (float addition commutes), so the argmin is warp-uniform;
//   * the same expanded form as the reference, (‖p‖² + ‖c‖²) − 2 p·c,
//     clamped at 0, so near-ties round the way the reference's do;
//   * centroids are walked by index up to k, with no sentinel rows;
//   * strict '<' keeps the lowest index on an exact tie, as jnp.argmin and
//     torch.argmin do.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
assign_kernel(const float* __restrict__ p, const float* __restrict__ c,
              int* __restrict__ labels, float* __restrict__ dist, int m,
              int k, int f) {
  const int point = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (point >= m) return;  // warp-uniform: a warp is one point
  const float* pr = p + static_cast<int64_t>(point) * f;
  float pp = 0.f;
  for (int t = lane; t < f; t += 32) pp = fmaf(pr[t], pr[t], pp);
  pp = warp_sum(pp);
  float best = INFINITY;
  int best_i = 0;
  for (int ci = 0; ci < k; ++ci) {
    const float* cr = c + static_cast<int64_t>(ci) * f;
    float dot = 0.f, cc = 0.f;
    for (int t = lane; t < f; t += 32) {
      const float cv = cr[t];
      dot = fmaf(pr[t], cv, dot);
      cc = fmaf(cv, cv, cc);
    }
    dot = warp_sum(dot);
    cc = warp_sum(cc);
    const float dd = fmaxf((pp + cc) - 2.f * dot, 0.f);
    if (dd < best) {
      best = dd;
      best_i = ci;
    }
  }
  if (lane == 0) {
    labels[point] = best_i;
    dist[point] = best;
  }
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// points (m, f), centroids (k, f): f32 row-major; labels (m,) int32,
// dist (m,) f32. m > 0, k > 0.
extern "C" int kmeans_assign_f32(const float* points, const float* centroids,
                                 int* labels, float* dist, int m, int k,
                                 int f, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int warps_per_block = kThreads / 32;
  const int blocks = (m + warps_per_block - 1) / warps_per_block;
  assign_kernel<<<blocks, kThreads, 0, st>>>(points, centroids, labels, dist,
                                             m, k, f);
  return cudaGetLastError();
}
