// K-means assignment: for every point, the nearest centroid and its
// squared distance, f32 in, int32 labels and f32 distances out.
//
// Replaces src/repro/kernels/kmeans_assign.py::kmeans_assign_pallas
// (_assign_kernel), which builds the whole (m, k) distance matrix on the
// MXU in one block, padding the centroids with 1e30 sentinel rows.
//
// What bounds it on an H100: nothing but latency. At the main path's shape
// (100 points and 4 centroids of width 100) the inputs are 42 KB and the
// work 80 kFLOP; the kernel runs 51 times per k-means, so the launch and
// the chain of dependent round trips, barriers and shuffles inside a block
// are all of its time. Algorithm 2's sweep (k up to m - 1) lengthens the
// chain with k, not the bytes.
//
// Design (kmeans_assign.py's `kmeans_plan` sizes it and must agree):
//   * one memory round trip a block: a block of P warps copies its P points
//     and a chunk of centroids (all of them whenever they fit the shared
//     memory the planner chose) into shared memory by cp.async, 16-byte
//     copies where f % 4 == 0 and both inputs are 16-byte aligned, every
//     copy issued before any is waited for; a further chunk takes one more
//     round trip;
//   * the lanes of a warp form G groups of L = 32 / G, G the power of two at
//     or above min(k, 32): small k splits the feature axis over L lanes,
//     large k gives every lane its own centroids. A butterfly over a
//     group's L lanes leaves the same sum on each (float addition commutes);
//   * ‖c‖² once per centroid per block, the block's groups taking the
//     centroids, not once per point;
//   * one warp per point, whose row is read once from global memory; a
//     group takes centroids g, g + G, ..., U of them in one pass over the
//     point's row (U = 4 when a chunk has more centroids than groups, else
//     1), each dot product as four chains of FMAs folded at the end;
//   * the reference's expanded form, (‖p‖² + ‖c‖²) − 2 p·c clamped at 0, so
//     near-ties round the way the reference's do;
//   * the argmin compares (distance, index) pairs, within a lane and across
//     lanes, so an exact tie goes to the lower index as jnp.argmin and
//     torch.argmin do.
// Shared rows are `stride` floats apart: f rounded up to 4 (zero-filled)
// with stride / 4 odd, so 8 lanes reading float4s of 8 rows hit 32 banks.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <climits>

namespace {

constexpr int kMaxSmemBytes = 232448;  // a block's most dynamic shared memory (H100)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 or 16 bytes from global to shared; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// rows [0, rows) of a (n, f) matrix, from row `first`, into `dst` at
// `stride` floats a row; rows past n and columns past f are zeros
template <bool VEC>
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src, int first,
                                           int rows, int n, int f, int stride) {
  if (VEC) {
    const int q4 = stride / 4;
    for (int t = threadIdx.x; t < rows * q4; t += blockDim.x) {
      const int r = t / q4, q = t % q4;
      const bool in = first + r < n && 4 * q < f;
      cp_async16(dst + r * stride + 4 * q,
                 in ? src + static_cast<int64_t>(first + r) * f + 4 * q : src, in ? 16 : 0);
    }
  } else {
    for (int t = threadIdx.x; t < rows * stride; t += blockDim.x) {
      const int r = t / stride, q = t % stride;
      const bool in = first + r < n && q < f;
      cp_async4(dst + r * stride + q, in ? src + static_cast<int64_t>(first + r) * f + q : src,
                in ? 4 : 0);
    }
  }
}

// s += a * b lane by lane: four independent chains, folded by `fold`
__device__ __forceinline__ void fma4(float4 a, float4 b, float4& s) {
  s.x = fmaf(a.x, b.x, s.x);
  s.y = fmaf(a.y, b.y, s.y);
  s.z = fmaf(a.z, b.z, s.z);
  s.w = fmaf(a.w, b.w, s.w);
}
__device__ __forceinline__ float fold(float4 s) { return (s.x + s.y) + (s.z + s.w); }

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// the sum over `lanes` (a power of two) neighbouring lanes, on each of them
__device__ __forceinline__ float group_sum(float v, int lanes) {
  for (int off = lanes >> 1; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ bool before(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

template <bool VEC, int U>
__global__ void __launch_bounds__(256)
assign_kernel(const float* __restrict__ p, const float* __restrict__ c, int* __restrict__ labels,
              float* __restrict__ dist, int m, int k, int f, int stride, int groups, int chunk) {
  extern __shared__ __align__(16) float smem[];
  const int warps = blockDim.x / 32;
  float* ps = smem;                      // warps x stride: the block's points
  float* cs = ps + warps * stride;       // chunk x stride: centroids
  float* cc = cs + chunk * stride;       // chunk: their squared norms
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int first = blockIdx.x * warps;
  const int point = first + warp;
  const int q4 = stride / 4;
  const int lanes = 32 / groups, g = lane / lanes, s = lane % lanes;
  const float* pr = ps + warp * stride;

  float pp = 0.f, best = INFINITY;
  int best_i = INT_MAX;
  stage_rows<VEC>(ps, p, first, warps, m, f, stride);
  for (int c0 = 0; c0 < k; c0 += chunk) {
    const int kc = min(chunk, k - c0);
    if (c0 > 0) __syncthreads();  // the last chunk's readers are done
    stage_rows<VEC>(cs, c, c0, kc, k, f, stride);
    cp_async_wait_all();
    __syncthreads();
    // norms: the block's lane groups take centroids, L lanes split each
    for (int j0 = warp * groups; j0 < kc; j0 += warps * groups) {  // warp-uniform
      const float* cr = cs + min(j0 + g, kc - 1) * stride;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int q = s; q < q4; q += lanes) fma4(ld4(cr + 4 * q), ld4(cr + 4 * q), v);
      const float n = group_sum(fold(v), lanes);
      if (j0 + g < kc && s == 0) cc[j0 + g] = n;
    }
    __syncthreads();
    if (point >= m) continue;  // warp-uniform: a warp is one point
    if (c0 == 0) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int q = lane; q < q4; q += 32) fma4(ld4(pr + 4 * q), ld4(pr + 4 * q), v);
      pp = group_sum(fold(v), 32);
    }
    // U centroids a lane in one pass over the point's row (the last pass
    // repeats row kc - 1 in the lanes past kc and drops their results)
    for (int j0 = 0; j0 < kc; j0 += U * groups) {
      const float* cr[U];
      float4 acc[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        cr[u] = cs + min(j0 + u * groups + g, kc - 1) * stride;
        acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll 2
      for (int q = s; q < q4; q += lanes) {
        const float4 x = ld4(pr + 4 * q);
#pragma unroll
        for (int u = 0; u < U; ++u) fma4(x, ld4(cr[u] + 4 * q), acc[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float dot = group_sum(fold(acc[u]), lanes);
        const int j = j0 + u * groups + g;
        if (j < kc) {
          const float dd = fmaxf((pp + cc[j]) - 2.f * dot, 0.f);
          if (before(dd, c0 + j, best, best_i)) {
            best = dd;
            best_i = c0 + j;
          }
        }
      }
    }
  }
  if (point >= m) return;
  for (int off = 16; off >= lanes; off >>= 1) {  // across the groups
    const float od = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, best_i, off);
    if (before(od, oi, best, best_i)) {
      best = od;
      best_i = oi;
    }
  }
  if (lane == 0) {
    labels[point] = best_i;
    dist[point] = best;
  }
}

// cudaFuncSetAttribute(MaxDynamicSharedMemorySize) for `kernel` once per
// device; `done` is the kernel instance's own set of devices
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <bool VEC, int U>
cudaError_t launch(const float* points, const float* centroids, int* labels, float* dist, int m,
                   int k, int f, int stride, int groups, int chunk, int warps, int blocks,
                   int smem_bytes, cudaStream_t st) {
  static std::atomic<unsigned long long> done{0};
  // the planner (kmeans_plan) and the kernel must agree on the layout
  const long long want_smem = 4LL * ((warps + chunk) * static_cast<long long>(stride) + chunk);
  if (warps < 1 || warps > 8 || chunk < 1 || stride % 4 || stride < f || (stride / 4) % 2 == 0 ||
      groups < 1 || groups > 32 || (groups & (groups - 1)) ||
      blocks != (m + warps - 1) / warps || smem_bytes != want_smem || smem_bytes > kMaxSmemBytes)
    return cudaErrorInvalidConfiguration;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = allow_smem(assign_kernel<VEC, U>, done);
    if (err != cudaSuccess) return err;
  }
  assign_kernel<VEC, U><<<blocks, 32 * warps, smem_bytes, st>>>(points, centroids, labels, dist, m,
                                                             k, f, stride, groups, chunk);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// points (m, f), centroids (k, f): f32 row-major; labels (m,) int32,
// dist (m,) f32. m, k, f > 0. `vec` picks the 16-byte copies (f % 4 == 0,
// both inputs 16-byte aligned); stride, groups, chunk, per_lane (centroids
// a lane takes in one pass: 1 or 4), warps a block, blocks and smem_bytes
// are the planner's, and a layout the kernel does not take is refused
// (cudaErrorInvalidConfiguration, or cudaErrorInvalidValue for per_lane).
extern "C" int kmeans_assign_f32(const float* points, const float* centroids, int* labels,
                                 float* dist, int m, int k, int f, int vec, int stride,
                                 int groups, int chunk, int per_lane, int warps, int blocks,
                                 int smem_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define KMEANS_LAUNCH(V, U)                                                                   \
  return launch<V, U>(points, centroids, labels, dist, m, k, f, stride, groups, chunk, warps, \
                      blocks, smem_bytes, st)
  if (per_lane == 1) {
    if (vec) KMEANS_LAUNCH(true, 1);
    KMEANS_LAUNCH(false, 1);
  }
  if (per_lane == 4) {
    if (vec) KMEANS_LAUNCH(true, 4);
    KMEANS_LAUNCH(false, 4);
  }
#undef KMEANS_LAUNCH
  return cudaErrorInvalidValue;
}
