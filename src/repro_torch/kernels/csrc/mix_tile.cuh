// The register-tiled core of the two mix kernels: mix_aggregate.cu (a
// dense store) and masked_mix_scatter.cu (a masked scatter into the slab)
// include it and differ only in which rows they keep and where they store.
//
// The core computes, for one block, the (BM, BN) tile of W(k, m) · θ(m, d)
// at rows r0 .. r0 + BM - 1 and columns c0 .. c0 + BN - 1:
//   * W's (BM, BK) tile, transposed, and θ's (BK, BN) tile come into shared
//     memory through cp.async (16-byte copies of θ, 4-byte ones of W), in a
//     ring of STAGES chunks of BK = 16 rows of θ, so any m fits and the
//     copies of the next chunks overlap the FMAs of this one;
//   * each thread keeps an RM x RN tile of sums in registers and reads, per
//     j, RM weights and RN θ values from shared memory as float4, for
//     RM·RN FMAs. A warp that the caller marks dead skips the FMAs (it
//     still copies and meets every barrier);
//   * every output sums over j = 0 .. m-1 in order with FMAs from +0, with
//     chunk tails and rows past k zero-filled. A zero weight adds exactly 0
//     to a sum that cannot be -0, so the bits are the same on every run and
//     for every tile, and appending zero columns to W (rows to θ) leaves
//     every output unchanged;
//   * f32 on the CUDA cores: tensor cores would need a 3xTF32 split to keep
//     f32 accuracy and would give up the ordered sum;
//   * a scalar path (VEC = false) copies θ and stores 4 bytes at a time,
//     for d % 4 != 0 or θ / the output not 16-byte aligned (leaf widths,
//     offset views): no 16-byte access ever goes past an end or misaligned.
// The tiles are T0, T1 and T2 below; mix_aggregate.py's MIX_TILES lists
// them by the same index, and its `tile_plan` picks one for both kernels.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace mix_tile {

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
  static_assert(kThreads % 32 == 0, "whole warps");
  static_assert(32 % TC == 0 || TC % 32 == 0, "a warp holds whole thread rows, or lies within one");
};

// the three variants, by index (MIX_TILES): which one a call takes is
// tile_plan's choice, by k
using T0 = Tile<4, 4, 1, 32, 4, 16>;  // k <= 4 (ucfl_k4's rules): 32 threads, BM 4
using T1 = Tile<8, 8, 16, 16, 3, 2>;  // k > 64 (full ucfl): 256 threads, BM 128, row tiles
using T2 = Tile<8, 4, 8, 32, 3, 3>;   // 5 <= k <= 64 (a 50-slot cohort): 256 threads, BM 64

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

// The block's tile of sums: acc = W[r0 + tr*RM + i, :] · θ[:, column of
// (g, u)] for this thread, over the ring. Every thread of the block calls
// it (it copies and meets the barriers); `live`, uniform over the warp,
// says whether the thread runs the FMAs. `smem` holds T::kSmemBytes.
template <class T, bool VEC>
__device__ __forceinline__ void tile_sums(const float* __restrict__ w,
                                         const float* __restrict__ theta, float* smem, int r0,
                                         int k, int m, int64_t d, int64_t c0, bool live,
                                         float (&acc)[T::RM][T::RN]) {
  const int tr = threadIdx.x / T::TC, tc = threadIdx.x % T::TC;
  const int chunks = (m + BK - 1) / BK;
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
}

// Store one row of a thread's sums (`sums`, RN values) into the output
// row `row` at the thread's columns: 16 bytes at a time on the VEC path,
// 4 on the scalar one; columns past d are not written.
template <class T, bool VEC>
__device__ __forceinline__ void store_row(float* row, const float (&sums)[T::RN], int64_t c0,
                                          int64_t d) {
  const int tc = threadIdx.x % T::TC;
#pragma unroll
  for (int g = 0; g < T::NG; ++g) {
    const int64_t col = c0 + g * 4 * T::TC + 4 * tc;
    if (VEC) {
      if (col < d)
        *reinterpret_cast<float4*>(row + col) =
            make_float4(sums[4 * g], sums[4 * g + 1], sums[4 * g + 2], sums[4 * g + 3]);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (col + u < d) row[col + u] = sums[4 * g + u];
    }
  }
}

// The planner's grid (one block per row tile and BN columns, the row tile
// fastest) and shared memory must be the tile's own.
template <class T>
bool plan_agrees(int k, long long d, long long blocks, int smem_bytes) {
  const long long want = static_cast<long long>((k + T::BM - 1) / T::BM) * ((d + T::BN - 1) / T::BN);
  return blocks == want && smem_bytes == T::kSmemBytes && blocks <= 0x7fffffffLL;
}

// cudaFuncSetAttribute(MaxDynamicSharedMemorySize) for `kernel` once per
// device; `done` is the kernel instance's own set of devices. A no-op for
// a tile within the default 48 KB.
template <class T, typename Kernel>
cudaError_t allow_smem(Kernel kernel, std::atomic<unsigned long long>& done) {
  if (T::kSmemBytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             T::kSmemBytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

}  // namespace mix_tile
