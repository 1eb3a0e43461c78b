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
// Design: one register-tiled kernel, templated on its tile (two variants
// below, by k; mix_aggregate.py's `mix_plan` picks one and must agree
// with `Tile`):
//   * a block covers BM (up to 128) rules, rows of W, for BN = 128 columns,
//     so at k <= 128 θ is read from HBM exactly once; a larger k takes
//     further row tiles, the row tile being the fastest grid index so the
//     blocks that share a column tile of θ run together and find it in L2;
//   * W's (BM, BK) tile, transposed, and θ's (BK, BN) tile come into shared
//     memory through cp.async (16-byte copies of θ, 4-byte ones of W), in a
//     ring of STAGES chunks of BK = 16 rows of θ, so any m fits and the
//     copies of the next chunks overlap the FMAs of this one;
//   * each thread keeps an RM x RN tile of sums in registers and reads, per
//     j, RM weights and RN θ values from shared memory as float4, for
//     RM·RN FMAs (8 x 8: four 16-byte reads per 64 FMAs). A warp whose rows
//     all lie past k skips the FMAs (it still copies);
//   * every output sums over j = 0 .. m-1 in order with FMAs from +0, with
//     chunk tails and rows past k zero-filled. A zero weight adds exactly 0
//     to a sum that cannot be -0, so the bits are the same on every run and
//     appending zero columns to W (rows to θ) leaves every output unchanged;
//   * f32 on the CUDA cores: tensor cores would need a 3xTF32 split to keep
//     f32 accuracy and would give up the ordered sum;
//   * a scalar path (VEC = false) copies θ and stores the output 4 bytes at
//     a time, for d % 4 != 0 or θ / out not 16-byte aligned (leaf widths,
//     offset views): no 16-byte access ever goes past an end or misaligned.
// On the card (PERF.md) the k = 100 mix is 372 blocks of the 128-row tile
// on 264 resident slots (two blocks of 256 threads at 128 registers an
// SM): a second, partial wave of 108 blocks runs one to an SM, and each
// wave loads, computes and stores in step, so its time is about three
// times the bound, a little under cuBLAS's.
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int BK = 16;  // rows of θ (columns of W) a chunk of the ring

// A thread's RM x RN tile of sums; TR x TC threads, MINB blocks an SM
// (the launch bounds, which cap the registers). The RN columns are RN / 4
// float4 groups, group g at g * 4 * TC + 4 * tc, so a warp's θ reads are
// contiguous float4s; rows tr * RM .. tr * RM + RM - 1 are contiguous.
template <int RM_, int RN_, int TR_, int TC_, int STAGES_, int MINB_>
struct Tile {
  static constexpr int RM = RM_, RN = RN_, TR = TR_, TC = TC_, STAGES = STAGES_, MINB = MINB_;
  static constexpr int kThreads = TR * TC;
  static constexpr int BM = RM * TR;
  static constexpr int BN = RN * TC;
  static constexpr int NG = RN / 4;  // float4 groups a thread
  // W^T tile row stride: a multiple of 4 (float4 reads) with WS / 4 odd,
  // so that the transposing 4-byte copies (16 rows of W a warp) conflict at
  // most 2-way
  static constexpr int WS = (BM / 4) % 2 ? BM : BM + 4;
  static constexpr int kStageFloats = BK * WS + BK * BN;
  static constexpr int kSmemBytes = STAGES * kStageFloats * 4;
  static_assert(RN % 4 == 0 && RM % 4 == 0, "float4 reads of W and θ");
  static_assert(32 % TC == 0 || TC % 32 == 0, "a warp holds whole thread rows, or lies within one");
};

// the two variants, by index: mix_aggregate.py's MIX_TILES lists the same
using T0 = Tile<4, 4, 1, 32, 4, 16>;  // k <= 4 (ucfl_k4's rules): 32 threads, BM 4
using T1 = Tile<8, 8, 16, 16, 3, 2>;  // k > 4: 256 threads, BM 128, row tiles

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
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy chunk `c` (θ rows and W columns c*BK ..) into one stage of the ring.
template <class T, bool VEC>
__device__ __forceinline__ void load_chunk(float* ws, float* ts, const float* __restrict__ w,
                                           const float* __restrict__ theta, int r0, int k,
                                           int m, int64_t d, int64_t c0, int chunk) {
  const int j0 = chunk * BK;
  // W^T: element (row r, j0 + kk) to ws[kk * WS + r]; kk fastest across
  // threads, so a warp reads whole 64-byte runs of W's rows
  for (int t = threadIdx.x; t < BK * T::BM; t += T::kThreads) {
    const int kk = t % BK, r = t / BK;
    const bool in = r0 + r < k && j0 + kk < m;
    cp_async4(ws + kk * T::WS + r, in ? w + static_cast<int64_t>(r0 + r) * m + j0 + kk : w,
              in ? 4 : 0);
  }
  if (VEC) {  // d % 4 == 0 and θ 16-byte aligned: a float4 lies wholly in or out
    constexpr int Q = T::BN / 4;
    for (int t = threadIdx.x; t < BK * Q; t += T::kThreads) {
      const int kk = t / Q, q = t % Q;
      const int64_t col = c0 + 4 * q;
      const bool in = j0 + kk < m && col < d;
      cp_async16(ts + kk * T::BN + 4 * q,
                 in ? theta + static_cast<int64_t>(j0 + kk) * d + col : theta, in ? 16 : 0);
    }
  } else {
    for (int t = threadIdx.x; t < BK * T::BN; t += T::kThreads) {
      const int kk = t / T::BN, q = t % T::BN;
      const int64_t col = c0 + q;
      const bool in = j0 + kk < m && col < d;
      cp_async4(ts + kk * T::BN + q,
                in ? theta + static_cast<int64_t>(j0 + kk) * d + col : theta, in ? 4 : 0);
    }
  }
}

// acc += W^T[kk] x θ[kk] for one kk
template <class T>
__device__ __forceinline__ void fma_row(const float* ws, const float* ts, int tr, int tc,
                                        int kk, float (&acc)[T::RM][T::RN]) {
  float a[T::RM], b[T::RN];
#pragma unroll
  for (int i = 0; i < T::RM; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(ws + kk * T::WS + tr * T::RM + i);
    a[i] = v.x; a[i + 1] = v.y; a[i + 2] = v.z; a[i + 3] = v.w;
  }
#pragma unroll
  for (int g = 0; g < T::NG; ++g) {
    const float4 v = *reinterpret_cast<const float4*>(ts + kk * T::BN + g * 4 * T::TC + 4 * tc);
    b[4 * g] = v.x; b[4 * g + 1] = v.y; b[4 * g + 2] = v.z; b[4 * g + 3] = v.w;
  }
#pragma unroll
  for (int i = 0; i < T::RM; ++i)
#pragma unroll
    for (int j = 0; j < T::RN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
}

// acc += W^T[kk] x θ[kk] for kk = 0 .. n-1 in order: all BK rows of a full
// chunk, unrolled; n (a multiple of 4) rows of the tail chunk
template <class T>
__device__ __forceinline__ void fma_chunk(const float* ws, const float* ts, int tr, int tc,
                                          int n, float (&acc)[T::RM][T::RN]) {
  if (n == BK) {
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) fma_row<T>(ws, ts, tr, tc, kk, acc);
  } else {
#pragma unroll 1
    for (int k4 = 0; k4 < n; k4 += 4)
#pragma unroll
      for (int u = 0; u < 4; ++u) fma_row<T>(ws, ts, tr, tc, k4 + u, acc);
  }
}

template <class T, bool VEC>
__global__ void __launch_bounds__(T::kThreads, T::MINB)
mix_kernel(const float* __restrict__ w, const float* __restrict__ theta,
           float* __restrict__ out, int k, int m, int64_t d, int row_tiles) {
  extern __shared__ __align__(16) float smem[];
  const int r0 = (blockIdx.x % row_tiles) * T::BM;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x / row_tiles) * T::BN;
  const int tr = threadIdx.x / T::TC, tc = threadIdx.x % T::TC;
  // a warp's rows start at its first thread's row: all past k, no FMAs
  const int warp_row0 = r0 + ((threadIdx.x & ~31) / T::TC) * T::RM;
  const bool live = warp_row0 < k;
  const int chunks = (m + BK - 1) / BK;

  float acc[T::RM][T::RN];
#pragma unroll
  for (int i = 0; i < T::RM; ++i)
#pragma unroll
    for (int j = 0; j < T::RN; ++j) acc[i][j] = 0.f;

  auto ws_of = [&](int s) { return smem + s * T::kStageFloats; };
  auto ts_of = [&](int s) { return smem + s * T::kStageFloats + BK * T::WS; };
#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < chunks) load_chunk<T, VEC>(ws_of(s), ts_of(s), w, theta, r0, k, m, d, c0, s);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<T::STAGES - 2>();  // chunk c has landed (this thread's copies)
    __syncthreads();                 // everyone's copies; stage c-1 is free again
    const int next = c + T::STAGES - 1;
    if (next < chunks) {
      const int s = next % T::STAGES;
      load_chunk<T, VEC>(ws_of(s), ts_of(s), w, theta, r0, k, m, d, c0, next);
    }
    cp_async_commit();
    if (live) {
      const int s = c % T::STAGES;
      // the tail chunk runs its rows rounded up to 4; the rest are zeros
      fma_chunk<T>(ws_of(s), ts_of(s), tr, tc, min(BK, (m - c * BK + 3) & ~3), acc);
    }
  }
  cp_async_wait<0>();
  if (!live) return;

#pragma unroll
  for (int i = 0; i < T::RM; ++i) {
    const int r = r0 + tr * T::RM + i;
    if (r >= k) break;
    float* row = out + static_cast<int64_t>(r) * d;
#pragma unroll
    for (int g = 0; g < T::NG; ++g) {
      const int64_t col = c0 + g * 4 * T::TC + 4 * tc;
      if (VEC) {
        if (col < d)
          *reinterpret_cast<float4*>(row + col) =
              make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2], acc[i][4 * g + 3]);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (col + u < d) row[col + u] = acc[i][4 * g + u];
      }
    }
  }
}

// cudaFuncSetAttribute(MaxDynamicSharedMemorySize) for `kernel` once per
// device; `done` is the kernel instance's own set of devices
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <class T, bool VEC>
cudaError_t launch(const float* w, const float* theta, float* out, int k, int m, long long d,
                   long long blocks, int smem_bytes, cudaStream_t st) {
  static std::atomic<unsigned long long> done{0};
  const int row_tiles = (k + T::BM - 1) / T::BM;
  const long long want = row_tiles * ((d + T::BN - 1) / T::BN);
  // the planner (mix_plan) and the kernel must agree on the tile
  if (blocks != want || smem_bytes != T::kSmemBytes || blocks > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  if (T::kSmemBytes > 48 * 1024) {
    const cudaError_t err = allow_smem(mix_kernel<T, VEC>, T::kSmemBytes, done);
    if (err != cudaSuccess) return err;
  }
  mix_kernel<T, VEC><<<static_cast<unsigned>(blocks), T::kThreads, T::kSmemBytes, st>>>(
      w, theta, out, k, m, d, row_tiles);
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
// d > 0. `tile` indexes the variants (T0, T1), `vec` picks the 16-byte
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
    default: return cudaErrorInvalidValue;
  }
}
