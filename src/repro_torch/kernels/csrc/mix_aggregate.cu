// User-centric mix out(k, d) = W(k, m) · θ(m, d), f32 in and out.
//
// Replaces src/repro/kernels/mix_aggregate.py::mix_aggregate_pallas
// (_mix_kernel), which keeps the small W resident in VMEM and streams θ
// through once, one d-block per grid step.
//
// What bounds it on an H100: θ is tall and skinny. For k = 4 (the clustered
// variant) it reads 19 MB and writes 0.8 MB, about 6 us at 3.35 TB/s: bytes.
// For full personalisation (k = m = 100 on the 47,616-wide slab) it moves
// 38 MB (11 us) for 0.95 GFLOP on the f32 CUDA cores (14 us): operations,
// near the ridge, and only if θ crosses HBM once.
//
// Design: the register-tiled ring of mix_tile.cuh (shared with
// masked_mix_scatter.cu), templated on its tile (T0, T1 or T2 by k;
// mix_aggregate.py's `mix_plan` picks one and must agree with `Tile`),
// and a dense store:
//   * a block covers BM (up to 128) rules, rows of W, for BN = 128 columns,
//     so at k <= 128 θ is read from HBM exactly once; a larger k takes
//     further row tiles, the row tile being the fastest grid index so the
//     blocks that share a column tile of θ run together and find it in L2;
//   * a warp whose rows all lie past k skips the FMAs (it still copies);
//   * every output is one FMA chain from +0 over j in order, whatever the
//     tile: two calls give the same bits, and so do zero columns of W.
// On the card (PERF.md) the k = 100 mix is 372 blocks of the 128-row tile
// on 264 resident slots (two blocks of 256 threads at 128 registers an
// SM): a second, partial wave of 108 blocks runs one to an SM, and each
// wave loads, computes and stores in step, so its time is about three
// times the bound, a little under cuBLAS's.
#include "mix_tile.cuh"

namespace {

using namespace mix_tile;

template <class T, bool VEC>
__global__ void __launch_bounds__(T::kThreads, T::MINB)
mix_kernel(const float* __restrict__ w, const float* __restrict__ theta,
           float* __restrict__ out, int k, int m, int64_t d, int row_tiles) {
  extern __shared__ __align__(16) float smem[];
  const int r0 = (blockIdx.x % row_tiles) * T::BM;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x / row_tiles) * T::BN;
  const int tr = threadIdx.x / T::TC;
  // a warp's rows start at its first thread's row: all past k, no FMAs
  const int warp_row0 = r0 + ((threadIdx.x & ~31) / T::TC) * T::RM;
  const bool live = warp_row0 < k;

  float acc[T::RM][T::RN];
  tile_sums<T, VEC>(w, theta, smem, r0, k, m, d, c0, live, acc);
  if (!live) return;
#pragma unroll
  for (int i = 0; i < T::RM; ++i) {
    const int r = r0 + tr * T::RM + i;
    if (r >= k) break;
    store_row<T, VEC>(out + static_cast<int64_t>(r) * d, acc[i], c0, d);
  }
}

template <class T, bool VEC>
cudaError_t launch(const float* w, const float* theta, float* out, int k, int m, long long d,
                   long long blocks, int smem_bytes, cudaStream_t st) {
  static std::atomic<unsigned long long> done{0};
  // the planner (mix_plan) and the kernel must agree on the tile
  if (!plan_agrees<T>(k, d, blocks, smem_bytes)) return cudaErrorInvalidConfiguration;
  const cudaError_t err = allow_smem<T>(mix_kernel<T, VEC>, done);
  if (err != cudaSuccess) return err;
  mix_kernel<T, VEC><<<static_cast<unsigned>(blocks), T::kThreads, T::kSmemBytes, st>>>(
      w, theta, out, k, m, d, (k + T::BM - 1) / T::BM);
  return cudaGetLastError();
}

template <class T>
cudaError_t launch_path(bool vec, const float* w, const float* theta, float* out, int k, int m,
                        long long d, long long blocks, int smem_bytes, cudaStream_t st) {
  return vec ? launch<T, true>(w, theta, out, k, m, d, blocks, smem_bytes, st)
             : launch<T, false>(w, theta, out, k, m, d, blocks, smem_bytes, st);
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// w (k, m), theta (m, d), out (k, d): f32, row-major, contiguous; k, m,
// d > 0. `tile` indexes the variants (T0, T1, T2), `vec` picks the 16-byte
// path (d % 4 == 0, theta and out 16-byte aligned), and `blocks` and
// `smem_bytes` are the planner's; a disagreement with the kernel's own
// count is refused (cudaErrorInvalidConfiguration).
extern "C" int mix_aggregate_f32(const float* w, const float* theta, float* out, int k, int m,
                                 long long d, int tile, int vec, long long blocks,
                                 int smem_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 0: return launch_path<T0>(vec, w, theta, out, k, m, d, blocks, smem_bytes, st);
    case 1: return launch_path<T1>(vec, w, theta, out, k, m, d, blocks, smem_bytes, st);
    case 2: return launch_path<T2>(vec, w, theta, out, k, m, d, blocks, smem_bytes, st);
    default: return cudaErrorInvalidValue;
  }
}
