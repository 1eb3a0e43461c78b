// User-centric mix out(k, d) = W(k, m) · θ(m, d): W f32, θ and out f32 or
// bf16 (out in θ's dtype), every sum in f32.
//
// Replaces src/repro/kernels/mix_aggregate.py::mix_aggregate_pallas
// (_mix_kernel), which keeps the small W resident in VMEM and streams θ
// through once, one d-block per grid step, casting each θ block to f32 in
// VMEM and writing θ's dtype.
//
// Two routes, one C entry (mix_aggregate), one launch a call. The host plan
// (mix_aggregate.py's `mix_plan`) picks the route from k and m:
//   * the few-row route (k <= 16 and m <= 16, below): a streaming kernel
//     for the train step's 2-4 client rows at LLM width, f32 or bf16 θ;
//   * the tile route (k or m > 16, after it): the register-tiled ring of
//     mix_tile.cuh, f32 θ only (the wrapper mixes a bf16 θ there through
//     an f32 copy, which gives the same bits).
// Every output is one FMA chain from +0 over j = 0 .. m-1 in order on both
// routes, so at a shape both take an f32 output has the same bits on
// either, and a bf16 output is the f32 sum rounded once to nearest-even:
// the bits of the f32 tile route's output cast to bf16.
//
// The few-row route (mix_rows_kernel). What bounds it: bytes, (m + k)·d
// elements of θ's dtype at 3.35 TB/s, plus W (k·m floats): 1.963 ms for
// the f32 (4, 4)·(4, 205,520,896) mix of stablelm-1.6b's embedding, 0.982
// ms in bf16. A column carries k·m FMAs for (m + k) elements: at the
// route's most, k = m = 16, 256 FMAs a 64 bytes of bf16 (4 a byte), under
// the f32 CUDA cores' 8.6 FMA a byte at the HBM rate. The tile route's
// ring brings nothing here: at m = 2-4 rows there is nothing in θ to reuse,
// and its 16-row chunks carry 12-14 rows of zeros.
//   * loads: the columns in runs, a multiple of 8 long (whole 16-byte packs
//     of either dtype), run j taken by block j mod the grid (the plan gives
//     a run a block); a block's 256 threads walk its run in packs,
//     neighbouring threads on neighbouring packs of each row, and each
//     loads U packs of every row, kRowLoads = 16 in all (row_unroll),
//     before it sums, through the read-only path asking L2 for 256-byte
//     blocks (gram's few-row route measured that load at 90.5 % of the HBM
//     rate): two blocks an SM, 2 x 256 x 256 bytes = 128 KB in flight;
//     64-bit offsets, so θ may pass 2^31 elements;
//   * layout: at LLM width a run is one sweep of a block's loads (256 x U
//     packs) and the grid a block a run, so the blocks, which the card
//     starts in order, read and write every row in one moving window. On
//     an H100 that reached 88-93 % of the bound, where two long runs an SM
//     (each block streaming its own stretch of every row) reached 74-84 %
//     and two blocks an SM striding over sweeps 84-90 % (mix_variants.py,
//     PERF.md); a narrow d is spread over up to two blocks an SM instead;
//   * sums: W's k·m floats in shared memory, read as broadcasts; for each
//     output row i, a pack's 4 (f32) or 8 (bf16, widened by
//     __bfloat1622float2) columns summed over j in order with __fmaf_rn,
//     then stored as one 16-byte pack (bf16: __floats2bfloat162_rn, the
//     one rounding);
//   * the 16-byte path needs d a multiple of the pack (4 f32, 8 bf16) and
//     θ and out 16-byte aligned, so that every row's packs are; else the
//     scalar path loads and stores one element at a time. No 16-byte
//     access goes past an end.
//
// The tile route (mix_kernel). What bounds it on an H100: θ is tall and
// skinny. For full personalisation (k = m = 100 on the 47,616-wide slab)
// it moves 38 MB (11 us) for 0.95 GFLOP on the f32 CUDA cores (14 us):
// operations, near the ridge, and only if θ crosses HBM once.
// Design: the register-tiled ring of mix_tile.cuh (shared with
// masked_mix_scatter.cu), templated on its tile (T0, T1 or T2 by k;
// mix_aggregate.py's `tile_plan` picks one and must agree with `Tile`),
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
#include <cuda_bf16.h>

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
  // the planner (tile_plan) and the kernel must agree on the tile
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

// ------------------------------------------------------ the few-row route

constexpr int kRowsMax = 16;      // MIX_ROWS: the route's most rows of θ and of W
constexpr int kRowThreads = 256;
constexpr int kRowLoads = 16;     // ROW_LOADS: 16-byte packs a thread loads before it sums
constexpr int kRowMinBlocks = 2;  // blocks an SM, the launch bound: 128 registers a thread
constexpr int kRunAlign = 8;      // a run's columns: whole 16-byte packs of either dtype

// Packs of each row a thread loads before it sums: kRowLoads in flight,
// at least one of each row.
template <int M>
__host__ __device__ constexpr int row_unroll() {
  return kRowLoads / M < 1 ? 1 : kRowLoads / M;
}

// 16 bytes through the read-only path, asking L2 for the whole 256-byte
// block (gram.cu's ld_quad).
__device__ __forceinline__ uint4 ld_pack(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// 16 bytes stored as they come.
__device__ __forceinline__ void st_pack(void* p, uint4 v) {
  *reinterpret_cast<uint4*>(p) = v;
}

__device__ __forceinline__ float2 widen_pair(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

__device__ __forceinline__ uint32_t narrow_pair(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// How the route reads and writes θ's dtype T: on the 16-byte path (VEC) a
// pack of kLanes columns in a uint4, else one element.
template <class T, bool VEC>
struct Io;

template <>
struct Io<float, true> {
  using Raw = uint4;
  static constexpr int kLanes = 4;
  __device__ static Raw load(const float* p) { return ld_pack(p); }
  __device__ static void widen(const Raw& r, float (&x)[kLanes]) {
    x[0] = __uint_as_float(r.x);
    x[1] = __uint_as_float(r.y);
    x[2] = __uint_as_float(r.z);
    x[3] = __uint_as_float(r.w);
  }
  __device__ static void store(float* p, const float (&x)[kLanes]) {
    st_pack(p, make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]), __float_as_uint(x[2]),
                          __float_as_uint(x[3])));
  }
};

template <>
struct Io<__nv_bfloat16, true> {
  using Raw = uint4;
  static constexpr int kLanes = 8;
  __device__ static Raw load(const __nv_bfloat16* p) { return ld_pack(p); }
  __device__ static void widen(const Raw& r, float (&x)[kLanes]) {
    const uint32_t q[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = widen_pair(q[i]);  // the low half is the lower column
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float (&x)[kLanes]) {
    st_pack(p, make_uint4(narrow_pair(x[0], x[1]), narrow_pair(x[2], x[3]),
                          narrow_pair(x[4], x[5]), narrow_pair(x[6], x[7])));
  }
};

template <>
struct Io<float, false> {
  using Raw = float;
  static constexpr int kLanes = 1;
  __device__ static Raw load(const float* p) { return __ldg(p); }
  __device__ static void widen(const Raw& r, float (&x)[kLanes]) { x[0] = r; }
  __device__ static void store(float* p, const float (&x)[kLanes]) { *p = x[0]; }
};

template <>
struct Io<__nv_bfloat16, false> {
  using Raw = unsigned short;
  static constexpr int kLanes = 1;
  __device__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  __device__ static void widen(const Raw& r, float (&x)[kLanes]) {
    x[0] = __bfloat162float(__ushort_as_bfloat16(r));
  }
  __device__ static void store(__nv_bfloat16* p, const float (&x)[kLanes]) {
    *p = __float2bfloat16_rn(x[0]);
  }
};

// The k output packs of one column pack: out row i = sum over j of
// W[i, j] · θ row j, one FMA chain from +0 over j in order (mix_tile.cuh's
// order), stored at o + i·d.
template <class T, int M, bool VEC>
__device__ __forceinline__ void mix_pack(const float* ws, int k,
                                         const typename Io<T, VEC>::Raw (&x)[M], T* o,
                                         long long d) {
  using I = Io<T, VEC>;
  constexpr int L = I::kLanes;
#pragma unroll 1
  for (int i = 0; i < k; ++i) {
    float acc[L];
#pragma unroll
    for (int l = 0; l < L; ++l) acc[l] = 0.f;
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const float wij = ws[i * M + j];
      float xj[L];
      I::widen(x[j], xj);
#pragma unroll
      for (int l = 0; l < L; ++l) acc[l] = __fmaf_rn(wij, xj[l], acc[l]);
    }
    I::store(o + static_cast<long long>(i) * d, acc);
  }
}

// W(k, M) · θ(M, d) -> out(k, d) for M rows: the columns in runs of `run`,
// run j [j run, min((j + 1) run, d)) mixed by block j mod gridDim.x, so a
// block takes runs b, b + grid, b + 2 grid, ...; a run is a multiple of
// kRunAlign, so on the 16-byte path (d a multiple of the pack) every run
// is whole packs.
template <class T, int M, bool VEC>
__global__ void __launch_bounds__(kRowThreads, kRowMinBlocks)
mix_rows_kernel(const float* __restrict__ w, const T* __restrict__ theta, T* __restrict__ out,
                int k, long long d, long long run) {
  using I = Io<T, VEC>;
  constexpr int L = I::kLanes;
  constexpr int U = row_unroll<M>();
  __shared__ float ws[kRowsMax * kRowsMax];
  for (int t = threadIdx.x; t < k * M; t += kRowThreads) ws[t] = w[t];
  __syncthreads();

  const long long stride = static_cast<long long>(gridDim.x) * run;
  for (long long c0 = static_cast<long long>(blockIdx.x) * run; c0 < d; c0 += stride) {
    const long long packs = ((c0 + run < d ? c0 + run : d) - c0) / L;
    const T* base = theta + c0;
    T* obase = out + c0;
    long long p = threadIdx.x;
    for (; p + (U - 1) * kRowThreads < packs; p += U * kRowThreads) {
      typename I::Raw x[U][M];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int r = 0; r < M; ++r) x[u][r] = I::load(base + r * d + (p + u * kRowThreads) * L);
#pragma unroll
      for (int u = 0; u < U; ++u)
        mix_pack<T, M, VEC>(ws, k, x[u], obase + (p + u * kRowThreads) * L, d);
    }
    for (; p < packs; p += kRowThreads) {
      typename I::Raw x[M];
#pragma unroll
      for (int r = 0; r < M; ++r) x[r] = I::load(base + r * d + p * L);
      mix_pack<T, M, VEC>(ws, k, x, obase + p * L, d);
    }
  }
}

// Launch the instance for m rows (M up to kRowsMax).
template <class T, bool VEC, int M>
cudaError_t launch_rows(int m, const float* w, const T* theta, T* out, int k, long long d,
                        long long run, long long blocks, cudaStream_t st) {
  if (m == M) {
    mix_rows_kernel<T, M, VEC><<<static_cast<unsigned>(blocks), kRowThreads, 0, st>>>(
        w, theta, out, k, d, run);
    return cudaGetLastError();
  }
  if constexpr (M < kRowsMax)
    return launch_rows<T, VEC, M + 1>(m, w, theta, out, k, d, run, blocks, st);
  return cudaErrorInvalidValue;
}

template <class T>
cudaError_t launch_rows_path(bool vec, const float* w, const void* theta, void* out, int k,
                             int m, long long d, long long run, long long blocks,
                             cudaStream_t st) {
  const T* th = static_cast<const T*>(theta);
  T* o = static_cast<T*>(out);
  return vec ? launch_rows<T, true, 1>(m, w, th, o, k, d, run, blocks, st)
             : launch_rows<T, false, 1>(m, w, th, o, k, d, run, blocks, st);
}

// The planner's few-row launch (rows_plan) must be one the kernel takes:
// k and m within kRowsMax, runs a positive multiple of kRunAlign, no more
// blocks than runs (none empty), and on the 16-byte path d a multiple of
// the pack and θ and out 16-byte aligned.
bool rows_plan_agrees(int k, int m, long long d, int elem, bool vec, const void* theta,
                      const void* out, long long blocks, long long run) {
  if (k < 1 || k > kRowsMax || m < 1 || m > kRowsMax || d < 1) return false;
  if (run < kRunAlign || run % kRunAlign != 0 || blocks < 1 || blocks > 0x7fffffffLL ||
      blocks > (d + run - 1) / run)
    return false;
  const long long lanes = 16 / elem;
  const unsigned long long bases =
      reinterpret_cast<uintptr_t>(theta) | reinterpret_cast<uintptr_t>(out);
  return !vec || (d % lanes == 0 && bases % 16 == 0);
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// w (k, m) f32, theta (m, d) and out (k, d), row-major, contiguous; k, m,
// d > 0. `route` 0, the tile route: theta and out f32 (`bf16` 0), `tile`
// indexes the variants (T0, T1, T2), `vec` picks the 16-byte path (d % 4
// == 0, theta and out 16-byte aligned), and `blocks` and `smem_bytes` are
// the planner's (`run` unused). `route` 1, the few-row route: k, m <= 16,
// theta and out bf16 where `bf16`, else f32, `vec` the 16-byte path (d a
// multiple of 8 for bf16, of 4 for f32, both pointers 16-byte aligned),
// `blocks` and `run` the planner's (`tile`, `smem_bytes` unused). A plan
// the kernel does not take is refused (cudaErrorInvalidConfiguration).
extern "C" int mix_aggregate(const float* w, const void* theta, void* out, int k, int m,
                             long long d, int route, int bf16, int tile, int vec,
                             long long blocks, int smem_bytes, long long run, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (!rows_plan_agrees(k, m, d, bf16 ? 2 : 4, vec != 0, theta, out, blocks, run))
      return cudaErrorInvalidConfiguration;
    return bf16 ? launch_rows_path<__nv_bfloat16>(vec != 0, w, theta, out, k, m, d, run, blocks,
                                                  st)
                : launch_rows_path<float>(vec != 0, w, theta, out, k, m, d, run, blocks, st);
  }
  if (route != 0 || bf16) return cudaErrorInvalidValue;
  const float* th = static_cast<const float*>(theta);
  float* o = static_cast<float*>(out);
  switch (tile) {
    case 0: return launch_path<T0>(vec, w, th, o, k, m, d, blocks, smem_bytes, st);
    case 1: return launch_path<T1>(vec, w, th, o, k, m, d, blocks, smem_bytes, st);
    case 2: return launch_path<T2>(vec, w, th, o, k, m, d, blocks, smem_bytes, st);
    default: return cudaErrorInvalidValue;
  }
}
