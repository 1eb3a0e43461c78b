// Gram matrix G·Gᵀ of the (m, d) stacked client gradients, f32 in and out.
//
// Replaces src/repro/kernels/pairwise_delta.py::gram_pallas (_gram_kernel),
// which streams G once over d on the TPU while the (m, m) sum stays in VMEM
// from one sequential grid step to the next.
//
// What bounds it on an H100: at the main path's shape (m = 100,
// d = 47,571) the product is symmetric, so the function needs m(m+1)/2
// dot products of length d: 0.48 GFLOP over 19 MB. On the f32 CUDA cores
// (no TF32: the reference sums in full f32) that is about 7.2 us of
// arithmetic against about 5.7 us of memory traffic, so the work is
// arithmetic-bound, and an (m, m) output of one or a few tiles is far too
// little parallelism for 132 SMs.
//
// Design:
//   * split-K over d: grid = (row tiles, column tiles, splits). Each block
//     owns one 128 x 128 output tile and one contiguous range of d, and
//     writes its partial tile to a (splits, m, m) workspace. A second
//     kernel sums the partials in split order. Both passes are
//     deterministic (no atomics), and every output is summed in the same
//     order as its mirror, so the result is exactly symmetric;
//   * a 128 x 32 slice of G is staged in shared memory per step, read with
//     the lanes of a warp along d (coalesced) and stored transposed with a
//     one-float pad, so neither the stores nor the compute reads conflict;
//   * 256 threads, each owning an 8 x 8 register tile of outputs strided
//     by 16, so one step does 64 FMAs per 16 shared-memory loads;
//   * on a diagonal tile (all of it when m <= 128) both operands are the
//     same slice of G, which is loaded once;
//   * rows >= m and the ragged tail of d (47,571 is odd) are masked to 0.
// The tile computes the whole square, mirror half included: at m = 100 a
// 128-wide tile does 3.2x the products the symmetric result needs.
// Skipping the mirrored half, and tensor cores (wgmma on TF32 splits), are
// later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;
constexpr int kDepth = 32;
constexpr int kThreads = 256;
constexpr int kPer = kTile / 16;  // outputs per thread along each axis

__device__ __forceinline__ void load_slice(float (*s)[kTile + 1],
                                           const float* __restrict__ g,
                                           int row0, int m, int64_t d,
                                           int64_t k0, int64_t kend) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t k = k0 + lane;
#pragma unroll
  for (int it = 0; it < kTile / (kThreads / 32); ++it) {
    const int r = warp + (kThreads / 32) * it;
    const int row = row0 + r;
    float v = 0.f;
    if (row < m && k < kend) v = g[static_cast<int64_t>(row) * d + k];
    s[lane][r] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
gram_partial_kernel(const float* __restrict__ g, float* __restrict__ partial,
                    int m, int64_t d, int64_t chunk) {
  __shared__ float sa[kDepth][kTile + 1];
  __shared__ float sb[kDepth][kTile + 1];
  const int i0 = blockIdx.x * kTile;
  const int j0 = blockIdx.y * kTile;
  const bool diag = blockIdx.x == blockIdx.y;
  const int64_t kbeg = static_cast<int64_t>(blockIdx.z) * chunk;
  const int64_t kend = kbeg + chunk < d ? kbeg + chunk : d;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float (*sbb)[kTile + 1] = diag ? sa : sb;

  float acc[kPer][kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kPer; ++j) acc[i][j] = 0.f;

  for (int64_t k0 = kbeg; k0 < kend; k0 += kDepth) {
    load_slice(sa, g, i0, m, d, k0, kend);
    if (!diag) load_slice(sb, g, j0, m, d, k0, kend);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kDepth; ++kk) {
      float a[kPer], b[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) a[i] = sa[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kPer; ++j) b[j] = sbb[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = partial + static_cast<int64_t>(blockIdx.z) * m * m;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int row = i0 + ty + 16 * i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int col = j0 + tx + 16 * j;
      if (col < m) out[static_cast<int64_t>(row) * m + col] = acc[i][j];
    }
  }
}

__global__ void gram_reduce_kernel(const float* __restrict__ partial,
                                   float* __restrict__ out, int64_t mm,
                                   int splits) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= mm) return;
  float s = 0.f;
  for (int p = 0; p < splits; ++p) s += partial[static_cast<int64_t>(p) * mm + idx];
  out[idx] = s;
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// g (m, d) f32 row-major; partial (splits, m, m) f32 scratch; out (m, m) f32.
// Block z covers d-columns [z * chunk, min((z + 1) * chunk, d)).
extern "C" int gram_f32(const float* g, float* partial, float* out, int m,
                        long long d, int splits, long long chunk,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (m + kTile - 1) / kTile;
  gram_partial_kernel<<<dim3(tiles, tiles, splits), kThreads, 0, st>>>(
      g, partial, m, d, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t mm = static_cast<int64_t>(m) * m;
  gram_reduce_kernel<<<static_cast<unsigned>((mm + 255) / 256), 256, 0, st>>>(
      partial, out, mm, splits);
  return cudaGetLastError();
}
