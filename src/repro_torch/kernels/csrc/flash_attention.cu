// Forward attention with an online softmax, f32 or bf16 in, f32 inside.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention
// (_flash_kernel), which streams (block_k, Dh) tiles of K and V past a
// resident (block_q, Dh) tile of Q per (batch, q head, q block) and carries
// the running max, sum and accumulator in VMEM scratch across the
// sequential kv grid axis.
//
// What it computes, per q head h (kv head h / (Hq / Hkv), no expanded copy
// of K and V): s = (q . k) * Dh^-0.5, then softcap * tanh(s / softcap) when a
// softcap is set; columns outside the mask (col >= Sk; with causal,
// col > row, rows and cols both counted from 0, i.e. top-left alignment;
// with a window, col <= row - window) take -1e30; out = softmax(s) . v,
// accumulated in f32 and divided by max(l, 1e-30), stored in the input's
// type. A row whose every column is masked takes the uniform softmax over
// the Sk columns, as the plain version (kernels/ref.py) does.
//
// What bounds it on an H100: at the prefill shape (4, 28, 1024, 128),
// causal, the function needs 4*B*Hq*Sq*Sk*Dh/2 = 30 GFLOP against 59 MB of
// q, k, v and out, so the tensor cores (989 TFLOP/s bf16) bound it at
// 0.03 ms; the decode shape (Sq = 1, Sk = 160) moves 2.6 MB and is a
// memory and latency problem.
//
// Design (a first, simple kernel: right before fast): one block of 256
// threads per (64-row q tile, q head, batch). Q's tile, K's tile
// (transposed) and V's tile live in shared memory as f32, so one code path
// serves both input types; both products are f32 FMAs on the CUDA cores
// (67 TFLOP/s peak), 4x4 scores and 4 x (16 NJ) outputs per thread. Each
// row's 16 threads are 16 lanes of one warp, so the row max and row sum
// are shuffles. The kv loop visits only the tiles the causal and window
// masks leave reachable from the block's rows. At Dh = 128 a block holds
// 123 KB of shared memory, one block per SM. Measured on the card, the FMA
// loops bound it (about 10 TFLOP/s at the prefill shape; unrolling the tile
// loads changed nothing), and a one-query decode tile spends 63 of its 64
// rows on padding. Tensor-core products (mma / wgmma), packing a GQA
// group's heads into the rows of a decode tile, TMA and a pipeline of K/V
// tiles are the next steps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // q rows per block
constexpr int BK = 64;        // kv rows per tile
constexpr int kThreads = 256;
constexpr int KT = BK + 1;    // stride of the transposed K tile: conflict-free stores
constexpr int PS = BK + 16;   // stride of the P tile: the two rows a warp reads sit 16 banks apart
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long qs[3], ks[3], vs[3], os[3];  // batch, head, sequence strides (elements)
  int hq, group, sq, sk, dh;
  int causal, has_window, window, has_softcap;
  float softcap, scale;
};

// first and last reachable column of query row r; lo > hi when none is
__device__ __forceinline__ int col_lo(const Args& a, int r) {
  return a.has_window ? max(0, r - a.window + 1) : 0;
}
__device__ __forceinline__ int col_hi(const Args& a, int r) {
  return a.causal ? min(r, a.sk - 1) : a.sk - 1;
}

// shared-memory floats of one block for a head dim padded to 16 * NJ
template <int NJ>
constexpr int smem_floats() {
  return BQ * (16 * NJ + 16) + 16 * NJ * KT + BK * 16 * NJ + BQ * PS;
}

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads) flash_fwd(Args a) {
  constexpr int DP = 16 * NJ;  // head dim held in shared memory (zero padded)
  constexpr int QS = DP + 16;  // Q row stride: a warp's two rows 16 banks apart
  extern __shared__ float smem[];
  float* Qs = smem;             // [BQ][QS]
  float* Kt = Qs + BQ * QS;     // [DP][KT]  K transposed
  float* Vs = Kt + DP * KT;     // [BK][DP]
  float* Ps = Vs + BK * DP;     // [BQ][PS]

  const int tid = threadIdx.x;
  const int tc = tid % 16;  // column lane within a row group
  const int tr = tid / 16;  // row group: rows tr + 16 i
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / a.group;
  const T* qg = static_cast<const T*>(a.q) + b * a.qs[0] + h * a.qs[1];
  const T* kg = static_cast<const T*>(a.k) + b * a.ks[0] + kvh * a.ks[1];
  const T* vg = static_cast<const T*>(a.v) + b * a.vs[0] + kvh * a.vs[1];
  T* og = static_cast<T*>(a.o) + b * a.os[0] + h * a.os[1];
  const int dh = a.dh;

  for (int idx = tid; idx < BQ * DP; idx += kThreads) {
    const int r = idx / DP, c = idx % DP;
    Qs[r * QS + c] = (q0 + r < a.sq && c < dh) ? load_f(qg + (q0 + r) * a.qs[2] + c) : 0.f;
  }

  // the kv range this block needs: the masks' bounds move monotonically
  // with the row, and rows with no reachable column form a suffix
  const int last = min(q0 + BQ, a.sq) - 1;
  const bool any_empty = col_lo(a, last) > col_hi(a, last);
  const int kv_lo = any_empty ? 0 : col_lo(a, q0);
  const int kv_hi = any_empty ? a.sk - 1 : col_hi(a, last);

  int row[4];
  bool empty[4];
  float m_run[4], l_run[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    row[i] = q0 + tr + 16 * i;
    empty[i] = col_lo(a, row[i]) > col_hi(a, row[i]);
    m_run[i] = kNegInf;
    l_run[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = (kv_lo / BK) * BK; k0 <= kv_hi; k0 += BK) {
    __syncthreads();  // the previous tile's P and V are consumed
    for (int idx = tid; idx < BK * DP; idx += kThreads) {
      const int r = idx / DP, c = idx % DP;
      const bool in = k0 + r < a.sk && c < dh;
      Kt[c * KT + r] = in ? load_f(kg + (k0 + r) * a.ks[2] + c) : 0.f;
      Vs[r * DP + c] = in ? load_f(vg + (k0 + r) * a.vs[2] + c) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < dh; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(tr + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = Kt[d * KT + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tc + 16 * j;
        float x = s[i][j] * a.scale;
        if (a.has_softcap) x = a.softcap * tanhf(x / a.softcap);
        bool keep = (!a.causal || col <= row[i]) && (!a.has_window || col > row[i] - a.window);
        if (empty[i]) {  // no reachable column: the uniform softmax
          x = 0.f;
          keep = true;
        }
        x = keep ? x : kNegInf;
        if (col >= a.sk) x = -INFINITY;  // outside the keys: weight exactly 0
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[i], mx);
      const float alpha = expf(m_run[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(tr + 16 * i) * PS + tc + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_run[i] = alpha * l_run[i] + sum;
      m_run[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    const int kn = min(BK, a.sk - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float pa[4], vb[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = Ps[(tr + 16 * i) * PS + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vb[j] = Vs[kk * DP + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pa[i], vb[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (row[i] >= a.sq) continue;
    const float inv = 1.f / fmaxf(l_run[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tc + 16 * j;
      if (c < dh) store_f(og + row[i] * a.os[2] + c, acc[i][j] * inv);
    }
  }
}

template <typename T, int NJ>
cudaError_t launch(const Args& a, int b, cudaStream_t st) {
  const size_t smem = sizeof(float) * smem_floats<NJ>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd<T, NJ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sq + BQ - 1) / BQ, a.hq, b);
  flash_fwd<T, NJ><<<grid, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a, int b, cudaStream_t st) {
  if (a.dh <= 32) return launch<T, 2>(a, b, st);
  if (a.dh <= 64) return launch<T, 4>(a, b, st);
  if (a.dh <= 128) return launch<T, 8>(a, b, st);
  return launch<T, 16>(a, b, st);
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q (B, Hq, Sq, Dh), k and v (B, Hkv, Sk, Dh), out (B, Hq, Sq, Dh), each
// given by its batch, head and sequence strides in elements (last dim
// contiguous). dtype 0 = float32, 1 = bfloat16. 1 <= Dh <= 256, Sk >= 1,
// Sq >= 1, B >= 1, Hq = group * Hkv; window 0 means none, softcap 0 means
// none; scale is Dh^-0.5 as the caller rounds it. Returns
// cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   const long long* strides, int dtype, int b, int hq,
                                   int hkv, int sq, int sk, int dh, int causal,
                                   int window, float softcap, float scale, void* stream) {
  if (dh < 1 || dh > 256 || b < 1 || hq < 1 || hkv < 1 || hq % hkv || sq < 1 || sk < 1 ||
      b > 65535 || hq > 65535 || window < 0 || softcap < 0.f)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = out;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = strides[i];
    a.ks[i] = strides[3 + i];
    a.vs[i] = strides[6 + i];
    a.os[i] = strides[9 + i];
  }
  a.hq = hq;
  a.group = hq / hkv;
  a.sq = sq;
  a.sk = sk;
  a.dh = dh;
  a.causal = causal != 0;
  a.has_window = window > 0;
  a.window = window;
  a.has_softcap = softcap > 0.f;
  a.softcap = softcap;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(dispatch<float>(a, b, st));
  if (dtype == 1) return static_cast<int>(dispatch<__nv_bfloat16>(a, b, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
