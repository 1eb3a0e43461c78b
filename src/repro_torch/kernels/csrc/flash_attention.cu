// Forward attention with an online softmax: a bf16 tensor-core tile for
// prefill, a split-KV decode kernel for one query (Sq = 1), and an f32 FMA
// kernel for everything else (f32 prefill, Sq 2-15, unaligned views, odd
// head dims).
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention
// (_flash_kernel), which streams (block_k, Dh) tiles of K and V past a
// resident (block_q, Dh) tile of Q per (batch, q head, q block) and carries
// the running max, sum and accumulator in VMEM scratch across the
// sequential kv grid axis.
//
// What all three kernels compute, per q head h (kv head h / (Hq / Hkv), no
// expanded copy of K and V): s = (q . k) * scale (the caller's Dh^-0.5),
// then softcap * tanh(s / softcap) in f32 when a softcap is set; columns
// outside the mask (with causal, col > row, rows and cols both counted from
// 0, i.e. top-left alignment; with a window, col <= row - window) take
// -1e30, columns at or past Sk take nothing (a weight of exactly 0);
// out = softmax(s) . v, accumulated in f32 and divided by max(l, 1e-30),
// stored in the input's type to the (B, Sq, Hq, Dh) memory behind the
// caller's view. A row whose every column is masked takes the uniform
// softmax over the Sk columns, as the plain version (kernels/ref.py) does.
// kernels/flash_attention.py::flash_route picks the kernel by a stated rule.
//
// flash_attention_tc (flash_tc): bf16, Sq >= 16, Dh % 8 == 0, 16-byte
// aligned pointers and strides. What bounds it on an H100: at qwen2-7b's
// prefill shape (4, 28, 1024, 128), causal, the function needs
// 4*B*Hq*Dh FLOP per kept (row, col) pair, 30 GFLOP against 59 MB of q, k,
// v and out, so the tensor cores bound it (0.03 ms at 989 TFLOP/s bf16;
// the bytes take 0.018 ms). Design: one block of 4 warps per (q head,
// batch, 64-row q tile), each warp owning 16 rows; the heaviest q tiles
// (the last ones, under a causal mask) launch first. K and V come in
// 64-key tiles (32 at Dh 256) by 16-byte cp.async (zero-filled past Sk and
// past Dh) into a two-stage ring; shared rows are padded by 16 bytes, so
// the 8 rows an ldmatrix reads fall in 8 distinct bank groups. Both
// products are mma.sync m16n8k16 (bf16 in, f32 accumulate): Q's A
// fragments come from ldmatrix once and stay in registers at Dh 128; at
// Dh 256 they and the 16x256 f32 accumulator would need more than 255
// registers, and at Dh 64 the register copy ran slower on the card, so
// there they are re-read from shared memory at every k-step. K's B
// fragments come from ldmatrix and V's from ldmatrix.trans. The tile
// sizes were chosen on the card: 8 warps and 128 rows, or Q from shared
// memory at Dh 128, ran no faster at qwen2-7b's prefill shape, and 64-key
// tiles at Dh 256 spilled registers and ran slower. The scores stay in
// the m16n8 accumulators: scale, softcap, mask and the online softmax run there
// (row max and sum are quad shuffles), and P goes from that layout
// straight into A fragments, never through shared memory. Precision of
// P: the TPU kernel keeps P in f32 for the P . v product; a bf16 P would
// keep 8 significant bits of f32's 24. So each probability is split into
// two bf16 terms, hi = bf16(p) and lo = bf16(p - hi), and both go through the
// tensor cores into the same f32 accumulator: hi + lo carries p to a
// relative 2^-16 (16 significant bits), V is exact in bf16 and the
// products are exact in f32. It costs one more mma per P . v step, 1.5x
// the tensor work of a bf16-P tile. Head dims are templated on a padded
// width in {64, 128, 256} (Dh 32 runs on 64, Dh 80 on 128, zero-filled).
// Causal work: the kv loop stops at the block's last reachable tile, a
// warp skips a tile its mask hides from all its rows (those columns would
// add weights of exactly 0), and only tiles that cross the diagonal, a
// window's edge or Sk evaluate the mask (a template flag, as the softcap
// is, so unmasked tiles take the exponent as one FFMA and one ex2).
//
// flash_attention_decode (flash_decode): Sq = 1, f32 or bf16, Dh % 8 == 0
// up to 256, 16-byte aligned pointers and strides. What bounds it on an
// H100: at qwen2-7b's decode shape (4, 28, 1, 128) over 160 keys it moves
// 1.4 MB (0.0004 ms at 3.35 TB/s), so latency sets its time; over 4,096
// keys its 33.6 MB take 0.010 ms, and on the card each warp's chain of
// dependent instructions, not the bytes, sets it (warm and cold L2 timed
// alike). Design, for parallel blocks and K and V read once:
// - GQA packing: one block per (split of the keys, kv head and row tile,
//   batch); its rows are the query heads of the group that read that kv
//   head (7 for qwen2, 2 for gemma2, 1 for MHA; tiles of 8 rows beyond 8),
//   so each K and V row leaves HBM once per (batch, kv head).
// - Inside a block: 8 warps in up to 4 row groups times key slices. The
//   q rows stay in registers as f32; a key row is spread over 4-32 lanes
//   with 16-byte loads, scores are lane dots summed by shuffles, and each
//   group of lanes keeps its own online softmax with P in f32 for P . v on
//   the CUDA cores (at 8 rows a tensor-core tile would be mostly padding).
//   At 128 registers two blocks share an SM; on the card 4 warps a block
//   at 255 registers, each warp owning all 8 rows, ran slower at both key
//   counts.
// - Flash-decoding: kernels/flash_attention.py::decode_splits cuts the
//   keys into S balanced ranges so the grid fills one wave of the resident
//   block slots. Each split writes (max, sum, accumulators) per row to a
//   workspace, then raises its (batch, kv head, row tile) counter
//   (__threadfence, then atomicAdd); the last block to arrive merges the S
//   partials in split order 0..S-1, writes the output and resets the
//   counter to 0. With one split the block writes the output directly.
// - Merge order: lane groups by a fixed shuffle tree, key slices in order,
//   splits in order, so the bits do not depend on which block runs when
//   (strided views give the bits of contiguous inputs). A split whose
//   columns are all masked (causal with Sq = 1 keeps column 0 only) has
//   max -1e30 and merges with a weight of exactly 0.
//
// flash_attention_fwd (flash_fwd): f32 or bf16, any head dim 1..256, any
// strides with a contiguous last dim. f32 prefill (the reduced models'
// agreement checks), Sq 2-15, and unaligned or odd-Dh inputs run here. What
// bounds it: at the reduced models' f32 prefill (4, 4, 40, 32) it moves
// 0.25 MB, so latency sets its time. Design (the first, simple kernel):
// one block of 256 threads per (64-row q tile, q head, batch); Q's, K's
// (transposed) and V's tiles live in shared memory as f32, so one code path
// serves both input types; both products are f32 FMAs on the CUDA cores
// (67 TFLOP/s peak), 4x4 scores and 4 x (16 NJ) outputs per thread; each
// row's 16 threads are 16 lanes of one warp, so the row max and row sum
// are shuffles. Measured on the card, the FMA loops bound it at prefill
// shapes (about 10 TFLOP/s, hence the tile above), and a one-query decode
// tile spent 63 of its 64 rows on padding and re-read each kv head's K and
// V once per query head (hence the decode kernel above).
//
// The tile's and the FMA kernel's dynamic shared memory limit is set once
// per template instance and device (allow_smem), not before every launch;
// the decode kernel's shared memory is static (under 48 KB).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

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

// ------------------------------------------------------------ tensor-core tile
using bf16 = __nv_bfloat16;

constexpr int TC_ROWS = 64;      // q rows per block: 4 warps x 16
constexpr int TC_THREADS = 128;
constexpr int TC_PAD = 8;        // bf16 padding per shared row (16 bytes)
constexpr float kLog2e = 1.4426950408889634f;

template <int DH>
__host__ __device__ constexpr int tc_stride() { return DH + TC_PAD; }
// keys per K/V tile: 32 at Dh 256, where 64-key scores beside the 16x256
// f32 accumulator spill registers
template <int DH>
__host__ __device__ constexpr int tc_bk() { return DH > 128 ? 32 : 64; }
// Q's fragments stay in registers at Dh 128 only: at Dh 256 they do not
// fit beside the accumulator, and at Dh 64 re-reading them from shared
// memory ran faster on the card
template <int DH>
__host__ __device__ constexpr bool tc_qreg() { return DH == 128; }
// Q's tile, then the K and V rings of two tiles each
template <int DH>
constexpr int tc_smem_bytes() { return (TC_ROWS + 4 * tc_bk<DH>()) * tc_stride<DH>() * 2; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c (16x8 f32) += a (16x16 bf16, row-major) * b (16x8 bf16, col-major)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit; results below 2^-126 flush to 0
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (x0, x1) as two bf16 pairs, hi = bf16(x) and lo = bf16(x - hi); the
// low half of each register holds x0, the element of the lower column
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(const bf16* dst, const bf16* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ROWS rows of DH columns from src (row stride `stride` elements) into
// shared memory, zero past row nvalid and past column dh
template <int DH, int ROWS>
__device__ __forceinline__ void tc_load(bf16* dst, const bf16* src, long long stride, int nvalid,
                                        int dh) {
  constexpr int CH = DH / 8;  // 16-byte chunks a row
  static_assert(ROWS * CH % TC_THREADS == 0, "every thread copies as many chunks");
#pragma unroll
  for (int n = 0; n < ROWS * CH / TC_THREADS; ++n) {
    const int i = threadIdx.x + n * TC_THREADS;
    const int r = i / CH, c = (i % CH) * 8;
    const bool in = r < nvalid && c < dh;
    cp_async16(dst + r * tc_stride<DH>() + c, in ? src + r * stride + c : src, in ? 16 : 0);
  }
}

// A warp's 16 rows: this thread holds rows g and g + 8 (g = lane / 4),
// and of each 8-wide column block the columns 2t, 2t + 1 (t = lane % 4);
// l is the thread's partial row sum, summed over the quad at the end.
template <int DH>
struct TcRows {
  float m[2], l[2];
  float acc[DH / 8][4];
};

// One warp's 16 rows against the tc_bk<DH>() keys at Kt and Vt (k0 the first
// key's index): s = q . k on the tensor cores, scale, softcap (SOFTCAP),
// mask (MASK), the online softmax in the accumulators, then acc += P . v
// with P split into hi and lo bf16 A fragments. Q's fragments come from
// qf (QREG) or from the warp's shared rows at Qw.
template <int DH, bool QREG, bool SOFTCAP, bool MASK>
__device__ __forceinline__ void tc_tile(const Args& a, TcRows<DH>& st,
                                        const uint32_t (&qf)[QREG ? DH / 16 : 1][4],
                                        const bf16* Qw, const bf16* Kt, const bf16* Vt, int k0,
                                        const int (&row)[2], const bool (&empty)[2]) {
  constexpr int RS = tc_stride<DH>();
  constexpr int NT = tc_bk<DH>() / 8;  // 8-key column blocks
  const int lane = threadIdx.x % 32, t = lane % 4;
  float s[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;

#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    uint32_t af[4];
    if constexpr (QREG) {
#pragma unroll
      for (int e = 0; e < 4; ++e) af[e] = qf[kk][e];
    } else {
      ldsm_x4(af, Qw + (lane % 16) * RS + kk * 16 + (lane / 16) * 8);
    }
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t b[4];  // keys 8j.. and 8(j+1).., dims 16kk.. and 16kk + 8..
      ldsm_x4(b, Kt + (j * 8 + (lane & 7) + ((lane >> 4) << 3)) * RS + kk * 16 +
                     ((lane >> 3) & 1) * 8);
      mma_bf16(s[j], af, b[0], b[1]);
      mma_bf16(s[j + 1], af, b[2], b[3]);
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {  // rows g (elements 0, 1) and g + 8 (2, 3)
    float mx = kNegInf;
    if constexpr (MASK || SOFTCAP) {
      // a row that reaches no key takes x = 0 on every column below Sk
      const bool none = MASK && empty[hr];
      const float fs = none ? 0.f : a.scale;
      const int hi = (MASK && a.causal && !none) ? row[hr] : INT_MAX;
      const int lo = (MASK && a.has_window && !none) ? row[hr] - a.window : INT_MIN;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = s[j][2 * hr + e] * fs;
          if constexpr (SOFTCAP) x = a.softcap * tanhf(x / a.softcap);
          if constexpr (MASK) {
            const int col = k0 + j * 8 + 2 * t + e;
            x = (col <= hi && col > lo) ? x : kNegInf;
            x = col < a.sk ? x : -INFINITY;
          }
          s[j][2 * hr + e] = x;
          mx = fmaxf(mx, x);
        }
    } else {  // the scale is positive: max(s) * scale is the scaled row's max
#pragma unroll
      for (int j = 0; j < NT; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hr], s[j][2 * hr + 1]));
      mx *= a.scale;
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(st.m[hr], mx);
    const float alpha = exp2_ftz((st.m[hr] - m_new) * kLog2e);
    const float sl = a.scale * kLog2e, ml = m_new * kLog2e;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[j][2 * hr + e];
        // unmasked, x = s * scale and m_new is a real score: one FFMA
        x = (MASK || SOFTCAP) ? exp2_ftz((x - m_new) * kLog2e) : exp2_ftz(fmaf(x, sl, -ml));
        sum += x;
      }
    st.l[hr] = alpha * st.l[hr] + sum;
    st.m[hr] = m_new;
    // alpha is exactly 1 where no row max of the warp moved
    if (__any_sync(0xffffffffu, alpha != 1.f)) {
#pragma unroll
      for (int d = 0; d < DH / 8; ++d) {
        st.acc[d][2 * hr] *= alpha;
        st.acc[d][2 * hr + 1] *= alpha;
      }
    }
  }

#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {  // 16 keys a k-step
    uint32_t ph[4], pl[4];
    split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
    split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
    split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
    split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
    const bf16* vrow = Vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS + (lane >> 4) * 8;
#pragma unroll
    for (int d = 0; d < DH / 8; d += 2) {
      uint32_t b[4];  // keys 16kk.., 16kk + 8.. of dims 8d.. and 8(d+1)..
      ldsm_x4_trans(b, vrow + d * 8);
      mma_bf16(st.acc[d], ph, b[0], b[1]);
      mma_bf16(st.acc[d + 1], ph, b[2], b[3]);
      mma_bf16(st.acc[d], pl, b[0], b[1]);
      mma_bf16(st.acc[d + 1], pl, b[2], b[3]);
    }
  }
}

template <int DH, bool SOFTCAP>
__global__ void __launch_bounds__(TC_THREADS) flash_tc(Args a) {
  constexpr int RS = tc_stride<DH>();
  constexpr int BK = tc_bk<DH>();
  constexpr int TS = BK * RS;
  constexpr bool QREG = tc_qreg<DH>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [TC_ROWS][RS]
  bf16* Ks = Qs + TC_ROWS * RS;                  // [2][BK][RS]
  bf16* Vs = Ks + 2 * TS;                        // [2][BK][RS]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * TC_ROWS;  // the last q tiles first
  const int h = blockIdx.x, b = blockIdx.y, kvh = h / a.group;
  const bf16* qg = static_cast<const bf16*>(a.q) + b * a.qs[0] + h * a.qs[1];
  const bf16* kg = static_cast<const bf16*>(a.k) + b * a.ks[0] + kvh * a.ks[1];
  const bf16* vg = static_cast<const bf16*>(a.v) + b * a.vs[0] + kvh * a.vs[1];
  bf16* og = static_cast<bf16*>(a.o) + b * a.os[0] + h * a.os[1];

  // the kv tiles this block needs, as flash_fwd finds them
  const int last = min(q0 + TC_ROWS, a.sq) - 1;
  const bool any_empty = col_lo(a, last) > col_hi(a, last);
  const int t_lo = (any_empty ? 0 : col_lo(a, q0)) / BK;
  const int t_hi = (any_empty ? a.sk - 1 : col_hi(a, last)) / BK;
  auto load_kv = [&](int tile, int buf) {
    const int k0 = tile * BK;
    tc_load<DH, BK>(Ks + buf * TS, kg + k0 * a.ks[2], a.ks[2], a.sk - k0, a.dh);
    tc_load<DH, BK>(Vs + buf * TS, vg + k0 * a.vs[2], a.vs[2], a.sk - k0, a.dh);
  };
  tc_load<DH, TC_ROWS>(Qs, qg + q0 * a.qs[2], a.qs[2], a.sq - q0, a.dh);
  load_kv(t_lo, 0);
  cp_async_commit();

  // the warp's rows w_lo..w_hi (valid ones); rows that reach no key form
  // a suffix, so the warp's last valid row tells whether it has any
  const int w_lo = q0 + warp * 16;
  const bool live = w_lo < a.sq;
  const int w_hi = min(w_lo + 15, a.sq - 1);
  const bool warp_empty = live && col_lo(a, w_hi) > col_hi(a, w_hi);
  int row[2];
  bool empty[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    row[hr] = w_lo + lane / 4 + 8 * hr;
    empty[hr] = col_lo(a, row[hr]) > col_hi(a, row[hr]);
  }
  const bf16* Qw = Qs + warp * 16 * RS;
  TcRows<DH> st;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    st.m[hr] = kNegInf;
    st.l[hr] = 0.f;
  }
#pragma unroll
  for (int d = 0; d < DH / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) st.acc[d][e] = 0.f;
  uint32_t qf[QREG ? DH / 16 : 1][4];

  for (int it = t_lo; it <= t_hi; ++it) {
    const int buf = (it - t_lo) & 1;
    if (it < t_hi) {
      load_kv(it + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (QREG) {
      if (it == t_lo) {  // Q arrived with the first K/V tile
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk)
          ldsm_x4(qf[kk], Qw + (lane % 16) * RS + kk * 16 + (lane / 16) * 8);
      }
    }
    const int k0 = it * BK;
    // a tile the masks hide from all the warp's rows: weights of exactly 0
    const bool hidden = !live || (!warp_empty && ((a.causal && k0 > w_hi) ||
                                                  (a.has_window &&
                                                   k0 + BK - 1 <= w_lo - a.window)));
    const bool need_mask = warp_empty || k0 + BK > a.sk ||
                           (a.causal && k0 + BK - 1 > w_lo) ||
                           (a.has_window && k0 <= w_hi - a.window);
    const bf16* Kt = Ks + buf * TS;
    const bf16* Vt = Vs + buf * TS;
    if (!hidden && need_mask)
      tc_tile<DH, QREG, SOFTCAP, true>(a, st, qf, Qw, Kt, Vt, k0, row, empty);
    else if (!hidden)
      tc_tile<DH, QREG, SOFTCAP, false>(a, st, qf, Qw, Kt, Vt, k0, row, empty);
    __syncthreads();  // the slot is free for the load two tiles on
  }

  const int t = lane % 4;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float l = st.l[hr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    if (row[hr] >= a.sq) continue;
    bf16* orow = og + row[hr] * a.os[2];
#pragma unroll
    for (int d = 0; d < DH / 8; ++d) {
      const int c = d * 8 + 2 * t;  // dh % 8 == 0: c and c + 1 are both in or both out
      if (c < a.dh)
        *reinterpret_cast<__nv_bfloat162*>(orow + c) =
            __floats2bfloat162_rn(st.acc[d][2 * hr] * inv, st.acc[d][2 * hr + 1] * inv);
    }
  }
}

// ------------------------------------------------------------- decode (Sq = 1)
constexpr int DEC_WARPS = 8;
constexpr int DEC_THREADS = 32 * DEC_WARPS;
// q rows (heads of one GQA group) a block takes: at most 4 row groups of
// 2 rows, so a lane's q slices and accumulators stay in 32 registers
constexpr int DEC_ROWS = 8;
// floats of one split's partial record: m and l per row, then the rows'
// accumulators at the widest head dim
constexpr int DEC_REC = DEC_ROWS * (2 + 256);
// the most splits a launch takes (the planner's cap): the merging block
// holds every split's row weights in shared memory
constexpr int DEC_MAX_SPLITS = 64;

// a 16-byte vector of T as f32: 4 floats, or 8 from bf16 pairs (exact)
__device__ __forceinline__ void unpack(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* f, __nv_bfloat16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// One block of DEC_WARPS warps per (split of the keys, kv head and row
// tile, batch). Its G padded rows are the query heads kvh * group +
// tile * DEC_ROWS + r that read kv head kvh. The warps form WR row groups
// of RPW rows times NK key slices: warp (rg, ks) takes rows rg * RPW.. and
// every NK-th chunk of the split's keys from chunk ks on. A key row is read
// by LK lanes, 16 bytes each (E dims a lane, NV loads); a warp takes KW keys
// a step and C steps a chunk, the next chunk's K and V loads in flight
// while it computes. Each group of LK lanes keeps its own online softmax;
// groups merge by shuffles, key slices through shared memory and splits
// through `partials`, each in a fixed order.
template <typename T, int DP, int G>
__global__ void __launch_bounds__(DEC_THREADS, 2) flash_decode(Args a, int splits, int* counters,
                                                               float* partials) {
  constexpr int VEC = 16 / sizeof(T);                 // elements of a 16-byte load
  constexpr int LK = DP / VEC < 32 ? DP / VEC : 32;   // lanes across one key row
  constexpr int E = DP / LK;                          // dims a lane holds
  constexpr int NV = E / VEC;                         // 16-byte loads a lane and row
  constexpr int KW = 32 / LK;                         // keys a warp takes a step
  constexpr int C = NV == 1 ? 4 : 2;                  // steps a chunk: loads in flight
  constexpr int WR = G < 4 ? G : 4;                   // row groups
  constexpr int RPW = G / WR;                         // rows a warp
  constexpr int NK = DEC_WARPS / WR;                  // key slices
  __shared__ __align__(16) float s_acc[NK][G][DP];
  __shared__ float s_m[NK][G], s_l[NK][G];
  __shared__ float s_w[DEC_MAX_SPLITS * G], s_lw[DEC_MAX_SPLITS * G], s_sum[G];
  __shared__ bool s_last;

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int r0 = (warp % WR) * RPW, ks = warp / WR;
  const int grp = lane / LK, d0 = (lane % LK) * E;
  const int tiles = gridDim.y / (a.hq / a.group);
  const int kvh = blockIdx.y / tiles, tile = blockIdx.y % tiles, b = blockIdx.z;
  const int split = blockIdx.x;
  const int h0 = kvh * a.group + tile * DEC_ROWS;
  const int rows = min(G, a.group - tile * DEC_ROWS);
  // balanced splits: each holds floor or ceil of sk / splits keys
  const int k_begin = static_cast<int>(static_cast<long long>(split) * a.sk / splits);
  const int k_end = static_cast<int>(static_cast<long long>(split + 1) * a.sk / splits);
  const T* qg = static_cast<const T*>(a.q) + b * a.qs[0] + h0 * a.qs[1];
  const T* kg = static_cast<const T*>(a.k) + b * a.ks[0] + kvh * a.ks[1];
  const T* vg = static_cast<const T*>(a.v) + b * a.vs[0] + kvh * a.vs[1];

  // the C steps of chunk ci of K or V rows into dst: zero past the split
  // (which covers chunks past the last) and past Dh
  uint4 kr[C][NV], vr[C][NV];
  auto load_rows = [&](uint4(&dst)[C][NV], const T* src, long long stride, int ci) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int key = k_begin + (ci * C + c) * KW + grp;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int d = d0 + v * VEC;
        dst[c][v] = key < k_end && d < a.dh
                        ? __ldg(reinterpret_cast<const uint4*>(src + key * stride + d))
                        : make_uint4(0, 0, 0, 0);
      }
    }
  };
  // the first chunk's loads go out before q's, so their latencies overlap
  load_rows(kr, kg, a.ks[2], ks);
  load_rows(vr, vg, a.vs[2], ks);
  float q[RPW][E], acc[RPW][E], m[RPW], l[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = r0 + i;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int d = d0 + v * VEC;
      const uint4 u = (r < rows && d < a.dh)
                          ? __ldg(reinterpret_cast<const uint4*>(qg + r * a.qs[1] + d))
                          : make_uint4(0, 0, 0, 0);
      unpack(u, q[i] + v * VEC, T());
    }
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e] = 0.f;
    m[i] = kNegInf;
    l[i] = 0.f;
  }

  const int nsteps = (k_end - k_begin + KW - 1) / KW;
  const int nchunks = (nsteps + C - 1) / C;
  for (int ci = ks; ci < nchunks; ci += NK) {
    float s[C][RPW];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int key = k_begin + (ci * C + c) * KW + grp;
      float kf[E];
#pragma unroll
      for (int v = 0; v < NV; ++v) unpack(kr[c][v], kf + v * VEC, T());
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        float x = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) x = fmaf(q[i][e], kf[e], x);
#pragma unroll
        for (int off = LK / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
        x *= a.scale;
        if (a.has_softcap) x = a.softcap * tanhf(x / a.softcap);
        // row 0: causal keeps column 0 only; a window (>= 1) keeps every column
        if (a.causal && key != 0) x = kNegInf;
        if (key >= k_end) x = -INFINITY;  // outside the split: weight exactly 0
        s[c][i] = x;
      }
    }
    // this chunk's K is consumed: the next chunk's K loads overlap its P . V
    load_rows(kr, kg, a.ks[2], ci + NK);
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      float mx = m[i];
#pragma unroll
      for (int c = 0; c < C; ++c) mx = fmaxf(mx, s[c][i]);
      const float alpha = exp2_ftz((m[i] - mx) * kLog2e);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        s[c][i] = exp2_ftz((s[c][i] - mx) * kLog2e);
        sum += s[c][i];
      }
      l[i] = alpha * l[i] + sum;
      m[i] = mx;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[i][e] *= alpha;
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float vf[E];
#pragma unroll
      for (int v = 0; v < NV; ++v) unpack(vr[c][v], vf + v * VEC, T());
#pragma unroll
      for (int i = 0; i < RPW; ++i)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[i][e] = fmaf(s[c][i], vf[e], acc[i][e]);
    }
    load_rows(vr, vg, a.vs[2], ci + NK);
  }

  // the warp's KW key groups into group 0, a fixed tree
#pragma unroll
  for (int off = LK; off < 32; off <<= 1) {
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const float mo = __shfl_down_sync(0xffffffffu, m[i], off);
      const float lo = __shfl_down_sync(0xffffffffu, l[i], off);
      const float mx = fmaxf(m[i], mo);
      const float wa = exp2_ftz((m[i] - mx) * kLog2e), wb = exp2_ftz((mo - mx) * kLog2e);
      l[i] = wa * l[i] + wb * lo;
      m[i] = mx;
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[i][e] = wa * acc[i][e] + wb * __shfl_down_sync(0xffffffffu, acc[i][e], off);
    }
  }
  if (grp == 0) {
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
#pragma unroll
      for (int e = 0; e < E; e += 4)
        *reinterpret_cast<float4*>(&s_acc[ks][r0 + i][d0 + e]) =
            make_float4(acc[i][e], acc[i][e + 1], acc[i][e + 2], acc[i][e + 3]);
      if (lane == 0) {
        s_m[ks][r0 + i] = m[i];
        s_l[ks][r0 + i] = l[i];
      }
    }
  }
  __syncthreads();

  T* og = static_cast<T*>(a.o) + b * a.os[0] + h0 * a.os[1];
  // this (batch, kv head, row tile)'s counter and partial records
  const int slot = blockIdx.z * gridDim.y + blockIdx.y;
  float* recs = partials + static_cast<long long>(slot) * splits * DEC_REC;
  // the key slices in order 0..NK-1; with one split, straight to the output
  for (int i = threadIdx.x; i < G * DP; i += DEC_THREADS) {
    const int r = i / DP, d = i % DP;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < NK; ++w) mx = fmaxf(mx, s_m[w][r]);
    float sum = 0.f, val = 0.f;
#pragma unroll
    for (int w = 0; w < NK; ++w) {
      const float wt = exp2_ftz((s_m[w][r] - mx) * kLog2e);
      sum += wt * s_l[w][r];
      val += wt * s_acc[w][r][d];
    }
    if (splits == 1) {
      if (r < rows && d < a.dh) store_f(og + r * a.os[1] + d, val / fmaxf(sum, 1e-30f));
    } else {
      float* rec = recs + split * DEC_REC;
      if (d == 0) {
        rec[r] = mx;
        rec[DEC_ROWS + r] = sum;
      }
      rec[2 * DEC_ROWS + i] = val;
    }
  }
  if (splits == 1) return;

  // the last split of this (batch, kv head, row tile) to arrive merges all
  // of them in split order, so the bits do not depend on which block that is
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(counters + slot, 1) == splits - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int i = threadIdx.x; i < splits * G; i += DEC_THREADS) {
    const float* rec = recs + (i / G) * DEC_REC;
    s_w[i] = __ldcg(rec + i % G);
    s_lw[i] = __ldcg(rec + DEC_ROWS + i % G);
  }
  __syncthreads();
  if (threadIdx.x < G) {
    const int r = threadIdx.x;
    float mx = kNegInf;
    for (int sp = 0; sp < splits; ++sp) mx = fmaxf(mx, s_w[sp * G + r]);
    float sum = 0.f;
    for (int sp = 0; sp < splits; ++sp) {
      // a split whose columns are all masked has max -1e30: a weight of 0
      const float wt = exp2_ftz((s_w[sp * G + r] - mx) * kLog2e);
      s_w[sp * G + r] = wt;
      sum += wt * s_lw[sp * G + r];
    }
    s_sum[r] = sum;
  }
  __syncthreads();
  constexpr int EPT = (G * DP + DEC_THREADS - 1) / DEC_THREADS;  // elements a thread
  float val[EPT];
#pragma unroll
  for (int j = 0; j < EPT; ++j) val[j] = 0.f;
#pragma unroll 4
  for (int sp = 0; sp < splits; ++sp) {
    const float* acc_sp = recs + sp * DEC_REC + 2 * DEC_ROWS;
#pragma unroll
    for (int j = 0; j < EPT; ++j) {
      const int i = threadIdx.x + j * DEC_THREADS;
      if (i < G * DP) val[j] += s_w[sp * G + i / DP] * __ldcg(acc_sp + i);
    }
  }
#pragma unroll
  for (int j = 0; j < EPT; ++j) {
    const int i = threadIdx.x + j * DEC_THREADS, r = i / DP, d = i % DP;
    if (i < G * DP && r < rows && d < a.dh)
      store_f(og + r * a.os[1] + d, val[j] / fmaxf(s_sum[r], 1e-30f));
  }
  if (threadIdx.x == 0) counters[slot] = 0;  // ready for the next launch on this stream
}

// ------------------------------------------------------------------ launches
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

template <typename T, int NJ>
cudaError_t launch(const Args& a, int b, cudaStream_t st) {
  static std::atomic<unsigned long long> done{0};
  const size_t smem = sizeof(float) * smem_floats<NJ>();
  cudaError_t err = allow_smem(flash_fwd<T, NJ>, smem, done);
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

template <int DH, bool SOFTCAP>
cudaError_t launch_tc(const Args& a, int b, cudaStream_t st) {
  static std::atomic<unsigned long long> done{0};
  constexpr size_t smem = tc_smem_bytes<DH>();
  static_assert(smem <= 232448, "a block's shared memory on sm_90");
  cudaError_t err = allow_smem(flash_tc<DH, SOFTCAP>, smem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.hq, b, (a.sq + TC_ROWS - 1) / TC_ROWS);
  flash_tc<DH, SOFTCAP><<<grid, TC_THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

template <bool SOFTCAP>
cudaError_t dispatch_tc(const Args& a, int b, cudaStream_t st) {
  if (a.dh <= 64) return launch_tc<64, SOFTCAP>(a, b, st);
  if (a.dh <= 128) return launch_tc<128, SOFTCAP>(a, b, st);
  return launch_tc<256, SOFTCAP>(a, b, st);
}

template <typename T, int DP, int G>
cudaError_t launch_decode(const Args& a, int b, int splits, int* counters, float* partials,
                          cudaStream_t st) {
  const int tiles = (a.group + DEC_ROWS - 1) / DEC_ROWS;
  const dim3 grid(splits, (a.hq / a.group) * tiles, b);
  flash_decode<T, DP, G><<<grid, DEC_THREADS, 0, st>>>(a, splits, counters, partials);
  return cudaGetLastError();
}

// the padded rows a block holds: the group (at most DEC_ROWS) rounded up
// to a power of 2
template <typename T, int DP>
cudaError_t dispatch_decode_rows(const Args& a, int b, int splits, int* counters,
                                 float* partials, cudaStream_t st) {
  if (a.group == 1) return launch_decode<T, DP, 1>(a, b, splits, counters, partials, st);
  if (a.group == 2) return launch_decode<T, DP, 2>(a, b, splits, counters, partials, st);
  if (a.group <= 4) return launch_decode<T, DP, 4>(a, b, splits, counters, partials, st);
  return launch_decode<T, DP, DEC_ROWS>(a, b, splits, counters, partials, st);
}

template <typename T>
cudaError_t dispatch_decode(const Args& a, int b, int splits, int* counters, float* partials,
                            cudaStream_t st) {
  if (a.dh <= 32) return dispatch_decode_rows<T, 32>(a, b, splits, counters, partials, st);
  if (a.dh <= 64) return dispatch_decode_rows<T, 64>(a, b, splits, counters, partials, st);
  if (a.dh <= 128) return dispatch_decode_rows<T, 128>(a, b, splits, counters, partials, st);
  return dispatch_decode_rows<T, 256>(a, b, splits, counters, partials, st);
}

// the Args of q (B, Hq, Sq, Dh), k and v (B, Hkv, Sk, Dh) and out, each
// given by its batch, head and sequence strides in elements
Args make_args(const void* q, const void* k, const void* v, void* out,
               const long long* strides, int hq, int hkv, int sq, int sk, int dh, int causal,
               int window, float softcap, float scale) {
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
  return a;
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The FMA kernel. q (B, Hq, Sq, Dh), k and v (B, Hkv, Sk, Dh), out
// (B, Hq, Sq, Dh), each given by its batch, head and sequence strides in
// elements (last dim contiguous): strides[0..2] q's, [3..5] k's, [6..8]
// v's, [9..11] out's. dtype 0 = float32, 1 = bfloat16. 1 <= Dh <= 256,
// Sk >= 1, Sq >= 1, B >= 1, Hq = group * Hkv; window 0 means none, softcap
// 0 means none; scale is Dh^-0.5 as the caller rounds it. Returns
// cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   const long long* strides, int dtype, int b, int hq,
                                   int hkv, int sq, int sk, int dh, int causal,
                                   int window, float softcap, float scale, void* stream) {
  if (dh < 1 || dh > 256 || b < 1 || hq < 1 || hkv < 1 || hq % hkv || sq < 1 || sk < 1 ||
      b > 65535 || hq > 65535 || window < 0 || softcap < 0.f)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(q, k, v, out, strides, hq, hkv, sq, sk, dh, causal, window, softcap,
                           scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(dispatch<float>(a, b, st));
  if (dtype == 1) return static_cast<int>(dispatch<__nv_bfloat16>(a, b, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tensor-core tile, bf16 only, with the FMA kernel's arguments (no
// dtype). It also needs Sq >= 16, Dh % 8 == 0 and every pointer and
// stride a multiple of 16 bytes (16-byte cp.async and bf16-pair stores);
// it refuses anything else with cudaErrorInvalidValue.
extern "C" int flash_attention_tc(const void* q, const void* k, const void* v, void* out,
                                  const long long* strides, int b, int hq, int hkv, int sq,
                                  int sk, int dh, int causal, int window, float softcap,
                                  float scale, void* stream) {
  bool ok = dh >= 8 && dh <= 256 && dh % 8 == 0 && b >= 1 && b <= 65535 && hq >= 1 &&
            hkv >= 1 && hq % hkv == 0 && sq >= 16 && sk >= 1 &&
            (sq + TC_ROWS - 1) / TC_ROWS <= 65535 && window >= 0 && softcap >= 0.f;
  const void* ptrs[4] = {q, k, v, out};
  for (const void* p : ptrs) ok = ok && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  for (int i = 0; i < 12; ++i) ok = ok && (strides[i] * 2) % 16 == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(q, k, v, out, strides, hq, hkv, sq, sk, dh, causal, window, softcap,
                           scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(a.has_softcap ? dispatch_tc<true>(a, b, st)
                                        : dispatch_tc<false>(a, b, st));
}

// The decode kernel: Sq = 1, f32 (dtype 0) or bf16 (dtype 1), with the FMA
// kernel's other arguments, then the split count, `n_counters` int
// counters, one per (batch, kv head, row tile) and zero between launches
// (the merging block of a launch resets its own), and `n_partials` floats
// for one record of DEC_REC floats per (batch, kv head, row tile, split);
// with one split neither buffer is read. Needs Dh % 8 == 0, Dh <= 256,
// every pointer and stride a multiple of 16 bytes and 1 <= splits <=
// min(Sk, DEC_MAX_SPLITS); refuses anything else with cudaErrorInvalidValue.
extern "C" int flash_attention_decode(const void* q, const void* k, const void* v, void* out,
                                      const long long* strides, int dtype, int b, int hq,
                                      int hkv, int sq, int sk, int dh, int causal, int window,
                                      float softcap, float scale, int splits, void* counters,
                                      int n_counters, void* partials, long long n_partials,
                                      void* stream) {
  const int esize = dtype == 0 ? 4 : 2;
  const long long tiles = hkv >= 1 && hq % hkv == 0 ? (hq / hkv + DEC_ROWS - 1) / DEC_ROWS : 0;
  const long long slots = static_cast<long long>(b) * hkv * tiles;
  bool ok = (dtype == 0 || dtype == 1) && dh >= 8 && dh <= 256 && dh % 8 == 0 && b >= 1 &&
            b <= 65535 && hq >= 1 && hkv >= 1 && hq % hkv == 0 && hkv * tiles <= 65535 &&
            sq == 1 && sk >= 1 && window >= 0 && softcap >= 0.f && splits >= 1 &&
            splits <= sk && splits <= DEC_MAX_SPLITS &&
            (splits == 1 || (counters != nullptr && partials != nullptr && n_counters >= slots &&
                             n_partials >= slots * splits * DEC_REC));
  const void* ptrs[4] = {q, k, v, out};
  for (const void* p : ptrs) ok = ok && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  for (int i = 0; i < 12; ++i) ok = ok && (strides[i] * esize) % 16 == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(q, k, v, out, strides, hq, hkv, sq, sk, dh, causal, window, softcap,
                           scale);
  int* cnt = static_cast<int*>(counters);
  float* part = static_cast<float*>(partials);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(dispatch_decode<float>(a, b, splits, cnt, part, st));
  return static_cast<int>(dispatch_decode<__nv_bfloat16>(a, b, splits, cnt, part, st));
}
