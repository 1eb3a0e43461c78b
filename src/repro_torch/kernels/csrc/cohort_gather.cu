// Cohort gather out[i] = full[min(idx[i], m - 1)], f32, (m, d) -> (c, d).
//
// Replaces src/repro/kernels/masked_gather_mix_scatter.py::
// cohort_gather_pallas (_gather_kernel), which leaves full in HBM and
// copies each cohort row with one DMA, so traffic is O(c·d) at any m.
//
// What bounds it on an H100: it is a pure row copy, c·d·4 bytes read and
// the same written. At the main path's cohort (c = 50 slots of the
// 47,616-wide slab) that is 19.0 MB, about 5.7 us at 3.35 TB/s.
//
// Design: the grid covers (column tile, cohort row); a block reads its
// row's idx itself and clamps it to [0, m-1] (pad slots carry the
// sentinel m and read row m-1; a negative index is outside the slot
// contract and reads row 0, so no index can reach outside full). Each
// thread moves 16 bytes (float4) when d % 4 == 0 and both base pointers
// are 16-byte aligned (then every row base is: the slab's width is a
// multiple of 128), else 4; neighbouring threads move neighbouring
// words, so reads and writes are coalesced. Offsets are 64-bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kMaxGridY = 65535;

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const T* __restrict__ full, const int* __restrict__ idx,
              T* __restrict__ out, int c, int m, int64_t words) {
  const int64_t start = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int i = blockIdx.y; i < c; i += gridDim.y) {
    int r = idx[i];
    r = r < 0 ? 0 : (r > m - 1 ? m - 1 : r);
    const T* src = full + static_cast<int64_t>(r) * words;
    T* dst = out + static_cast<int64_t>(i) * words;
    for (int64_t t = start; t < words; t += stride) dst[t] = src[t];
  }
}

template <typename T>
cudaError_t launch(const void* full, const int* idx, void* out, int c, int m,
                   long long words, cudaStream_t st) {
  long long tiles = (words + kThreads - 1) / kThreads;
  if (tiles > 0x7fffffffLL) tiles = 0x7fffffffLL;  // the loop strides the rest
  const unsigned rows = c < static_cast<int>(kMaxGridY) ? c : kMaxGridY;
  gather_kernel<T><<<dim3(static_cast<unsigned>(tiles), rows), kThreads, 0, st>>>(
      static_cast<const T*>(full), idx, static_cast<T*>(out), c, m, words);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// full (m, d) and out (c, d): f32, row-major, contiguous; idx (c,) int32;
// m > 0, c > 0, d > 0. vec4 != 0 asks for the float4 path (d % 4 == 0 and
// both pointers 16-byte aligned, checked by the caller).
extern "C" int cohort_gather_f32(const float* full, const int* idx, float* out,
                                 int c, int m, long long d, int vec4,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec4) return launch<float4>(full, idx, out, c, m, d / 4, st);
  return launch<float>(full, idx, out, c, m, d, st);
}
