// Gram matrix G·Gᵀ of the (m, d) stacked client gradients, f32 in and out.
//
// Replaces src/repro/kernels/pairwise_delta.py::gram_pallas (_gram_kernel),
// which streams G once over d on the TPU while the (m, m) sum stays in VMEM
// from one sequential grid step to the next.
//
// Two routes, one C entry (gram_f32), one launch a call. The host plan
// (pairwise_delta.gram_plan) picks the route from m alone and names it in
// its first value:
//   * the few-row route (m <= M_ROWS, below): a streaming kernel on the
//     CUDA cores for the collaboration round's 2-4 rows at LLM width;
//   * the tensor-core route (m > M_ROWS, after it): wgmma 3xTF32 tiles.
//
// The few-row route (gram_rows_kernel). What bounds it: bytes, m·d·4 at
// 3.35 TB/s (2.945 ms at stablelm-1.6b's (4, 616,599,552) rows). A column
// carries m(m+1)/2 multiply-adds for 4m bytes: at m = 16, 136 FMA a 64
// bytes, 7.1 T FMA/s at the HBM rate, a quarter of the f32 CUDA cores'.
// So no tensor core: the tensor-core route's 128-row box carries 124 rows
// of zeros at m = 4, 512 useful bytes a stage, about 90 GB/s.
//   * loads: a block owns one run of columns (a multiple of 4 long, so
//     16-byte aligned on aligned rows; 64-bit offsets, so d up to 2^33
//     needs no windows); its 256 threads walk the run in float4 quads,
//     neighbouring threads on neighbouring quads of each of the m rows,
//     and each loads U quads of every row (row_unroll: about 32 loads,
//     512 bytes, as far as registers allow) before it multiplies, so an
//     SM keeps 48-128 KB in flight (Little's law wants about 32 KB at
//     3.35 TB/s over ~1.3 us and 132 SMs). The last run masks d % 4;
//   * sums: each thread keeps the m(m+1)/2 upper-triangle sums in f32
//     registers (136 at m = 16: the route's most rows, kRowsMax). A thread
//     sums about d / 33,792 columns in order (18,248 at stablelm's rows),
//     so its f32 rounding grows as 2^-24 · sqrt(n): measured 2e-6 to 3e-5
//     of the largest entry against an f64 Gram over 0.6-3.2 G columns,
//     17x or more under chip_smoke's gate (F64_GRAM_TOL, 5e-4); f64 sums
//     would cost registers and the conversion pipe for nothing it holds;
//   * a deterministic merge in the same launch: shuffles within a warp
//     (a fixed tree), the 8 warps in order, each block's triangle to the
//     workspace; the last block through an atomic ticket (release by
//     __threadfence, acquire likewise) sums the blocks' triangles in block
//     order (up to 8 contiguous runs a sum, the runs in order), writes
//     G_ij and G_ji from one sum, and puts the ticket back to zero. No
//     atomics on the sums: two calls give the same bits;
//   * the threshold, M_ROWS = kRowsMax = 16 (pairwise_delta.py): the route
//     is faster than the tensor-core route at every m it holds, so it
//     takes all of them. kernel_turns.py's crossover on the H100 (80GB
//     HBM3, 700 W): at 47,616 columns 8.35 / 9.66 / 11.47 / 14.18 us at
//     m = 4 / 8 / 12 / 16 against 20.3-20.8 us (about 0.49 us more a row:
//     the two would meet near 28 rows); at 2^27 columns 0.718 / 1.455 /
//     2.194 / 2.920 ms against 23.8 ms (near 130 rows). Past 16 rows the
//     sums and one quad of each row no longer fit a thread's 255
//     registers (m = 16 takes 215, m = 14 all 255, no spills), and the
//     pairs would have to be split over lanes; m >= 50 (FedFomo's cohort,
//     the special round's 100) stays on the tensor-core route.
// Measured on three H100s (80GB HBM3, 700 W; PERF.md, the gram findings):
// 3.23-3.40 ms at (4, 616,599,552), 87-91 % of the bytes bound and 12x
// under `g @ g.T`; 83-92 % of it at 0.93-1.71 G columns; at 47,616
// columns 8.5-8.8 us, the launch and the ticket's merge (a one-element
// zero_() takes 5.0 us).
//
// The tensor-core route (gram_kernel).
// What bounds it on an H100 (the function's own work: G read once, the
// (m, m) result written once, m(m+1)/2 dot products of length d):
//   * m = 100, d = 47,616 (the special round's aligned rows): 19 MB, 0.48
//     GFLOP. Bytes bound it: 5.7 us at 3.35 TB/s, against 2.9 us of
//     3xTF32 tensor work (3 x FLOP / 495 TFLOP/s) and 7.2 us on the f32
//     CUDA cores. But the triangle is small: 100 rows give one block tile,
//     so the work must be cut along d into ~130 pieces whose partial
//     triangles are then summed, and that sum is on the critical path.
//   * m = 512: 98.5 MB, 12.5 GFLOP. The tensor work bounds it: 76 us in
//     3xTF32 (29 us of bytes; 186 us on the CUDA cores).
//
// Design:
//   * the upper triangle only. Rows are cut into 128-row tiles and only
//     tiles (bi, bj) with bi <= bj are computed. A tile is up to four jobs
//     of 64 x 64 outputs (row half h, column half c), and a diagonal tile
//     drops the job below its diagonal (h = 1, c = 0): at m = 100, 3 jobs,
//     12,288 sums for the 5,050 needed (the old 128 x 128 square: 16,384).
//     The merge writes G_ij and G_ji from one sum, so the output is
//     exactly symmetric by construction;
//   * 3xTF32 on the tensor cores, by wgmma (A from registers, B from
//     shared memory; m64n128k8 for a warpgroup's two adjacent jobs,
//     m64n64k8 for one): each element x splits into big = tf32(x) and
//     small = tf32(x - big) (both rounded to nearest, see split()), and
//     every 8 columns of d add small·bigᵀ, then big·smallᵀ, then big·bigᵀ
//     into the same f32 registers. The dropped small·smallᵀ term is ~2^-22
//     of each product. A warpgroup's 64 rows are split in registers after
//     ldmatrix; the column operand is split once a stage by the whole
//     block into a big and a small copy in shared memory, in the layout
//     TMA wrote (the split is elementwise), double-buffered. The tensor
//     core's additions truncate, which over a split's whole chunk (1,284
//     additions a sum at m = 512) biased G by -4.5e-5 of itself on the
//     H100: so each stage's 12 products a job start from zero (scale-d 0)
//     and the stage sums are added in f32, rounded to nearest, in the
//     registers. mma.sync m16n8k8, which covers the triangle in finer
//     16 x 8 units but splits both operands in registers for every
//     product, was no faster at m = 100 and slower at m = 512 (PERF.md,
//     the gram findings);
//   * G read once, by TMA: thread 0 keeps a ring of `stages` 32-column
//     slices in flight (128 bytes a row, the 128-byte swizzle, which is
//     also the layout wgmma reads; rows past m and columns past d arrive
//     as zeros), each signalled by an mbarrier, and refills a slot as soon
//     as the block's barrier after a stage shows that every thread has
//     read it. A diagonal tile loads each slice once for both operands; an
//     off-diagonal tile loads its row and column slices. A TMA coordinate
//     is a signed 32-bit int, so the host encodes one map a window of
//     2^31 columns, the windows' bases 2^30 columns apart, and a split (at
//     most 2^30 columns) reads through the window of its first column, its
//     coordinates counted from that base: d up to 2^33 columns (kMaxWindows
//     maps; two such f32 rows alone would fill 64 GiB). No producer warp:
//     wgmma kernels get registers by the warpgroup, and a ninth warp would
//     cap the two consumer warpgroups at 168 registers (they use ~200);
//   * software-pipelined: stage i's products run while stage i + 1's slice
//     is waited for, split and loaded; two warpgroups, one a row half;
//   * split-K over d in one wave and one launch: the host plan
//     (pairwise_delta.gram_plan) gives each tile a number of splits in
//     proportion to its jobs, at most one block per SM; each block writes
//     its partial tile (the part of the triangle it holds) to a workspace,
//     the grid meets at a barrier (a cooperative launch guarantees that
//     every block is resident), and then every block sums its share of the
//     triangle's m(m+1)/2 elements over the splits in a fixed order
//     (contiguous runs of splits in order, then the runs in order), so two
//     calls give the same bits and no block merges alone. The barrier's two
//     counters start at zero and the last block out puts them back to zero.
// The plan is checked here against the tiles the kernel computes; a plan
// it cannot take is refused with cudaErrorInvalidValue before any launch.
//
// Measured on the H100 (PERF.md, the gram findings): neither bound is
// reached. At m = 100 the launch, the partials' merge and a per-stage
// latency set the time, the latter mostly the column operand's split
// through shared memory, whose traffic shares the bandwidth that wgmma's
// operand reads need; at m = 512 that split and the products, and G's row
// tiles are read by four tiles each.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;                   // rows (and columns) of a block tile
constexpr int kHalf = 64;                    // rows and columns of a job
constexpr int kDepth = 32;                   // columns of G a stage: 128 bytes a row
constexpr int kSlice = kTile * kDepth * 4;   // bytes of one 128 x 32 slice
constexpr int kThreads = 256;                // two warpgroups
constexpr int kPartial = kTile * kTile;      // floats of one (tile, split) partial
constexpr int kMaxTiles = 64;                // tiles of a plan: m <= 10 x 128
constexpr int kMinStages = 2;
constexpr int kMaxStages = 6;
constexpr int kRuns = 8;                     // most runs of splits an element's merge takes
constexpr int kPlanHead = 7;                 // m, d, tiles, blocks, stages, slices, smem
constexpr int kPlanTile = 7;                 // bi, bj, jobs, splits, chunk, first, part
constexpr long long kWindow = 1LL << 30;     // columns between two maps' bases; a split's most
constexpr int kMaxWindows = 8;               // maps: d <= kMaxWindows * kWindow

// One TMA map of G a window: map j starts at column j * kWindow and spans
// up to 2 * kWindow columns (to d in the last).
struct Maps {
  CUtensorMap map[kMaxWindows];
};

struct Plan {
  int m, row_tiles, tiles, stages, slices;
  long long d;
  int bi[kMaxTiles], bj[kMaxTiles], splits[kMaxTiles], chunk[kMaxTiles];
  int first[kMaxTiles + 1];        // first block of each tile; first[tiles] = blocks
  long long part[kMaxTiles + 1];   // float offset of each tile's (splits, 128, 128) partials
};

// 64-row halves of tile b that start below m (1 or 2).
__host__ __device__ inline int halves(int m, int b) {
  return m - b * kTile > kHalf ? 2 : 1;
}

// Jobs (h, c) of tile (bi, bj): every row half h and column half c below
// m, but on a diagonal tile only c >= h.
__host__ __device__ inline int tile_jobs(int m, int bi, int bj) {
  const int nh = halves(m, bi), nc = halves(m, bj);
  int n = 0;
  for (int h = 0; h < nh; ++h) n += nc - (bi == bj ? h : 0);
  return n;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// x = big + small + O(2^-22 x). big is x rounded to TF32 (11 significant
// bits, to nearest, ties away: add half a TF32 step to the bits, clear the
// 13 below it); small = x - big is exact in f32, and it goes to the tensor
// core with half a step added, which reads a .tf32 operand's top 19 bits
// only, so it too counts rounded to nearest. Three integer operations and
// one f32 subtraction, where two cvt.rna.tf32.f32 would take the slower
// conversion pipe, which made the kernel slower.
__device__ __forceinline__ void split(uint32_t raw, uint32_t& big, uint32_t& small) {
  big = (raw + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(__uint_as_float(raw) - __uint_as_float(big)) + 0x1000u;
}

// The shared-memory matrix descriptor of a K-major operand in the 128-byte
// swizzle: 8-row atoms of 128-byte rows, 1,024 bytes apart.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// d (+)= a · b for a 64 x 64 x 8 TF32 step: a this warp's 16 x 8 rows in
// registers (the m16n8k8 A layout), b 64 rows of 8 columns at `desc`;
// scale_d 0 starts d from zero.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// The same for 64 x 128 (two adjacent jobs in one instruction): d holds
// the first job's 32 values a thread, then the second's.
__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// Keep the compiler from moving reads or writes of `x` across the async
// products' issue and wait.
__device__ __forceinline__ void fence_operand(float& x) { asm volatile("" : "+f"(x)::"memory"); }
__device__ __forceinline__ void fence_operand(uint32_t& x) {
  asm volatile("" : "+r"(x)::"memory");
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void red_release(int* p) {
  asm volatile("red.release.gpu.global.add.s32 [%0], 1;\n" ::"l"(p) : "memory");
}

// Sum of the partials at p, p + stride, ... over splits [s0, s1), in
// order (32 loads in flight).
__device__ __forceinline__ float sum_splits(const float* __restrict__ p, long long stride,
                                            int s0, int s1) {
  float acc = 0.f;
  for (int s = s0; s < s1; s += 32) {
    float v[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) v[j] = s + j < s1 ? __ldcg(p + (s + j) * stride) : 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j)
      if (s + j < s1) acc += v[j];
  }
  return acc;
}

// Stage i's slice (one or two 128 x 32 boxes) into ring slot i % S, by one
// thread; the slot's barrier completes when the bytes have landed. k0 is
// the split's first column counted from `map`'s base (below kWindow).
__device__ __forceinline__ void load_stage(int i, const CUtensorMap* map, uint32_t ring,
                                           uint32_t stage_bytes, int S, bool diag, int bi, int bj,
                                           long long k0, uint64_t* full_bar) {
  const int s = i % S;
  const uint32_t bar = smem_u32(&full_bar[s]);
  const uint32_t dst = ring + s * stage_bytes;
  const int col = static_cast<int>(k0 + static_cast<long long>(i) * kDepth);
  mbar_expect_tx(bar, diag ? kSlice : 2 * kSlice);
  tma_load(dst, map, bar, col, bi * kTile);
  if (!diag) tma_load(dst + kSlice, map, bar, col, bj * kTile);
}

// Stage i's loads: wait for its slice, split its column operand (all 256
// threads, 64 bytes each) into buffer i & 1, and load this warp's 16 rows
// of A for its 4 k-steps (raw; split_a splits them).
__device__ __forceinline__ void prepare_stage(int i, uint32_t ring, uint8_t* ring_p,
                                              uint32_t stage_bytes, uint32_t split_off, int S,
                                              bool diag, int jobs, int a_row, int a_hi, int sw,
                                              uint64_t* full_bar, uint32_t (&raw)[4][4]) {
  const int s = i % S;
  mbar_wait(smem_u32(&full_bar[s]), (i / S) & 1);
  __syncwarp();  // the lanes leave the wait together for ldmatrix
  const uint32_t sb_off = s * stage_bytes + (diag ? 0 : kSlice);
  const uint32_t big_off = split_off + (i & 1) * 2 * kSlice;
#pragma unroll
  for (int k = 0; k < kSlice / (16 * kThreads); ++k) {
    const uint32_t off = (k * kThreads + threadIdx.x) * 16;
    const uint4 x = *reinterpret_cast<const uint4*>(ring_p + sb_off + off);
    uint4 b, sm;
    split(x.x, b.x, sm.x);
    split(x.y, b.y, sm.y);
    split(x.z, b.z, sm.z);
    split(x.w, b.w, sm.w);
    *reinterpret_cast<uint4*>(ring_p + big_off + off) = b;
    *reinterpret_cast<uint4*>(ring_p + big_off + kSlice + off) = sm;
  }
  if (jobs > 0) {
    const uint32_t sa = ring + s * stage_bytes;
#pragma unroll
    for (int ks = 0; ks < kDepth / 8; ++ks)
      ldsm_x4(raw[ks], sa + a_row * 128 + static_cast<uint32_t>(((2 * ks + a_hi) ^ sw) << 4));
  }
}

__device__ __forceinline__ void split_a(const uint32_t (&raw)[4][4], uint32_t (&ab)[4][4],
                                        uint32_t (&as)[4][4]) {
#pragma unroll
  for (int ks = 0; ks < kDepth / 8; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r) split(raw[ks][r], ab[ks][r], as[ks][r]);
}

// Stage i's split copies are complete and its slice read by every thread:
// make the copies visible to the tensor cores' (async) proxy, meet, and
// refill the slot with stage i + S.
__device__ __forceinline__ void publish_stage(int i, int steps, const CUtensorMap* map,
                                              uint32_t ring, uint32_t stage_bytes, int S,
                                              bool diag, int bi, int bj, long long k0,
                                              uint64_t* full_bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0 && i + S < steps)
    load_stage(i + S, map, ring, stage_bytes, S, diag, bi, bj, k0, full_bar);
}

// One 8-column step of a warpgroup's JOBS jobs (1: a 64 x 64 product; 2:
// both in one 64 x 128 product, the jobs' columns being adjacent).
template <int JOBS>
__device__ __forceinline__ void mma_step(float (&acc)[JOBS == 2 ? 64 : 32], const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d) {
  if constexpr (JOBS == 2)
    wgmma_tf32_n128(acc, a, desc, scale_d);
  else
    wgmma_tf32(acc, a, desc, scale_d);
}

// The K loop of a warpgroup with JOBS jobs (0, 1 or 2: one template each,
// so that the products and their wait lie on one straight path). Stage i's
// products run while stage i + 1's column operand is split and its A rows
// are loaded: a stage's split goes to buffer i & 1, and the barrier after
// each stage's wait makes both buffers safe to reuse. sums[j] gathers job
// j's stage sums in f32.
template <int JOBS>
__device__ __forceinline__ void stage_loop(int steps, const CUtensorMap* map, uint32_t ring,
                                           uint8_t* ring_p, uint32_t stage_bytes,
                                           uint32_t split_off, int S, bool diag, int bi, int bj,
                                           long long k0, int c_lo, int a_row, int a_hi, int sw,
                                           uint64_t* full_bar, float (&sums)[2][32]) {
  constexpr int kAcc = JOBS == 2 ? 64 : 32;  // two jobs: one 64 x 128 product
  float acc[kAcc];
#pragma unroll
  for (int r = 0; r < kAcc; ++r) acc[r] = 0.f;
  uint32_t ab[4][4], as[4][4], raw[4][4];
  if (steps > 0) {
    prepare_stage(0, ring, ring_p, stage_bytes, split_off, S, diag, JOBS, a_row, a_hi, sw,
                  full_bar, raw);
    split_a(raw, ab, as);
    publish_stage(0, steps, map, ring, stage_bytes, S, diag, bi, bj, k0, full_bar);
  }
  for (int i = 0; i < steps; ++i) {
    if (JOBS > 0) {
      const uint32_t big = ring + split_off + (i & 1) * 2 * kSlice, small = big + kSlice;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      const uint32_t rows = static_cast<uint32_t>(c_lo * kHalf * 128);
#pragma unroll
      for (int ks = 0; ks < kDepth / 8; ++ks) {
        const uint32_t k_off = static_cast<uint32_t>(ks * 32);
        mma_step<JOBS>(acc, as[ks], desc_sw128(big + rows + k_off), ks > 0);
        mma_step<JOBS>(acc, ab[ks], desc_sw128(small + rows + k_off), 1);
        mma_step<JOBS>(acc, ab[ks], desc_sw128(big + rows + k_off), 1);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    }
    if (i + 1 < steps)
      prepare_stage(i + 1, ring, ring_p, stage_bytes, split_off, S, diag, JOBS, a_row, a_hi, sw,
                    full_bar, raw);
    if (JOBS > 0) {
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int ks = 0; ks < kDepth / 8; ++ks)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          fence_operand(ab[ks][r]);
          fence_operand(as[ks][r]);
        }
#pragma unroll
      for (int r = 0; r < kAcc; ++r) {
        fence_operand(acc[r]);
        sums[r / 32][r % 32] += acc[r];
      }
    }
    if (i + 1 < steps) {
      split_a(raw, ab, as);
      publish_stage(i + 1, steps, map, ring, stage_bytes, S, diag, bi, bj, k0, full_bar);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
gram_kernel(const __grid_constant__ Maps maps, const __grid_constant__ Plan plan,
            float* __restrict__ partial, int* __restrict__ counters, float* __restrict__ out) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kMaxStages];
  __shared__ float runs[kThreads];
  // the swizzled slices need 1024-byte alignment
  uint8_t* ring_p = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t ring = smem_u32(ring_p);
  const int m = plan.m, S = plan.stages;
  const uint32_t stage_bytes = static_cast<uint32_t>(plan.slices * kSlice);
  // two buffers of the column operand's split, each a big and a small copy
  const uint32_t split_off = static_cast<uint32_t>(S) * stage_bytes;

  int t = 0;
  while (t + 1 < plan.tiles && plan.first[t + 1] <= static_cast<int>(blockIdx.x)) ++t;
  const int bi = plan.bi[t], bj = plan.bj[t];
  const bool diag = bi == bj;
  const int split_id = blockIdx.x - plan.first[t];
  const long long k0 = static_cast<long long>(split_id) * plan.chunk[t];
  const long long k1 = k0 + plan.chunk[t] < plan.d ? k0 + plan.chunk[t] : plan.d;
  const int steps = k1 > k0 ? static_cast<int>((k1 - k0 + kDepth - 1) / kDepth) : 0;
  // the split's map and its first column in it (below kWindow)
  const CUtensorMap* map = &maps.map[k0 / kWindow];
  const long long kw = k0 % kWindow;
  // warp-uniform as far as the compiler can see (a shuffle from lane 0), so
  // that the branches on the warp's role and jobs do not serialize wgmma
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 5), 0);
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) mbar_init(smem_u32(&full_bar[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < S && i < steps; ++i)
      load_stage(i, map, ring, stage_bytes, S, diag, bi, bj, kw, full_bar);
  }
  __syncthreads();

  {
    // consumers: warpgroup h takes the jobs of row half h, column halves
    // c_lo .. nc - 1 (at most 2); warp wl of it rows 16 wl .. 16 wl + 15
    const int h = warp >> 2, wl = warp & 3;
    const int c_lo = diag ? h : 0;
    const int jobs = h < halves(m, bi) ? halves(m, bj) - c_lo : 0;  // uniform in the warpgroup
    const int a_row = kHalf * h + 16 * wl + (lane & 7) + 8 * ((lane >> 3) & 1);
    const int a_hi = lane >> 4, sw = lane & 7;
    float sums[2][32];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 32; ++r) sums[j][r] = 0.f;

    if (jobs == 2)
      stage_loop<2>(steps, map, ring, ring_p, stage_bytes, split_off, S, diag, bi, bj, kw, c_lo,
                    a_row, a_hi, sw, full_bar, sums);
    else if (jobs == 1)
      stage_loop<1>(steps, map, ring, ring_p, stage_bytes, split_off, S, diag, bi, bj, kw, c_lo,
                    a_row, a_hi, sw, full_bar, sums);
    else
      stage_loop<0>(steps, map, ring, ring_p, stage_bytes, split_off, S, diag, bi, bj, kw, c_lo,
                    a_row, a_hi, sw, full_bar, sums);

    // this split's partial tile, rows and columns of the tile, where they
    // hold an element of the triangle: d[4i + 2hi + lo] is row g + 8 hi,
    // column 8 i + 2 t + lo of the warp's 16 x 64 block
    float* dst = partial + plan.part[t] + static_cast<long long>(split_id) * kPartial;
    const int g = lane >> 2, tq = lane & 3;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (j >= jobs) continue;
#pragma unroll
      for (int r = 0; r < 32; r += 2) {
        const int row = kHalf * h + 16 * wl + g + 8 * ((r >> 1) & 1);
        const int col = kHalf * (c_lo + j) + 8 * (r >> 2) + 2 * tq;
        const int grow = bi * kTile + row, gcol = bj * kTile + col;
        if (grow < m && gcol < m && gcol + 1 >= grow)
          *reinterpret_cast<float2*>(dst + row * kTile + col) =
              make_float2(sums[j][r], sums[j][r + 1]);
      }
    }
  }

  // every block's partials are written: meet at the grid barrier (the
  // block barrier orders this block's stores before thread 0's release)
  __syncthreads();
  if (threadIdx.x == 0) {
    red_release(&counters[0]);
    while (ld_acquire(&counters[0]) < static_cast<int>(gridDim.x)) {
    }
  }
  __syncwarp();
  __syncthreads();

  // the merge: this block's share of the triangle's elements (row-major,
  // row <= col), each summed over its tile's splits in `nr` contiguous runs
  // (a thread a run), the runs then added in order
  const long long total = static_cast<long long>(m) * (m + 1) / 2;
  const long long e_beg = total * blockIdx.x / gridDim.x;
  const long long e_end = total * (blockIdx.x + 1) / gridDim.x;
  const int n_e = static_cast<int>(e_end - e_beg);
  int nr = n_e > 0 ? kThreads / n_e : 1;
  nr = nr < 1 ? 1 : nr > kRuns ? kRuns : nr;
  const int per_pass = kThreads / nr;
  const int run = threadIdx.x / per_pass, slot = threadIdx.x % per_pass;
  for (int base = 0; base < n_e; base += per_pass) {
    const bool mine = run < nr && base + slot < n_e;
    int row = 0, col = 0;
    if (mine) {
      // row r starts at element r m - r (r - 1) / 2
      const long long e = e_beg + base + slot;
      int lo = 0, hi = m - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) / 2;
        if (static_cast<long long>(mid) * m - static_cast<long long>(mid) * (mid - 1) / 2 <= e)
          lo = mid;
        else
          hi = mid - 1;
      }
      row = lo;
      col = row + static_cast<int>(e - (static_cast<long long>(row) * m -
                                       static_cast<long long>(row) * (row - 1) / 2));
      const int ti = row / kTile, tj = col / kTile;
      const int tt = ti * plan.row_tiles - ti * (ti - 1) / 2 + (tj - ti);
      const int sp = plan.splits[tt];
      runs[threadIdx.x] = sum_splits(
          partial + plan.part[tt] + (row - ti * kTile) * kTile + (col - tj * kTile), kPartial,
          sp * run / nr, sp * (run + 1) / nr);
    }
    __syncthreads();
    if (mine && run == 0) {
      float sum = runs[slot];
      for (int r = 1; r < nr; ++r) sum += runs[r * per_pass + slot];
      out[static_cast<long long>(row) * m + col] = sum;
      out[static_cast<long long>(col) * m + row] = sum;
    }
    __syncthreads();
  }

  // the last block out leaves both counters at zero for the next launch
  if (threadIdx.x == 0) {
    if (atomicAdd(&counters[1], 1) == static_cast<int>(gridDim.x) - 1) {
      counters[0] = 0;
      counters[1] = 0;
      __threadfence();
    }
  }
}

// ------------------------------------------------------ the few-row route

constexpr int kRouteTiles = 0;      // a plan's first value: the tensor-core route
constexpr int kRouteRows = 1;       // the few-row route
constexpr int kRowsMax = 16;        // most rows the few-row route takes
constexpr int kRowThreads = 256;
constexpr int kRowsPlanLen = 6;     // route, m, d, blocks, run, partial floats
constexpr int kMaxRowBlocks = 1024; // more than any card's SMs (the plan: one block an SM)

// Quads (float4) of each row a thread loads before it multiplies: about 32
// loads, as far as they and the m(m+1)/2 sums fit 160 registers; at least 1.
template <int M>
__host__ __device__ constexpr int row_unroll() {
  constexpr int by_loads = 32 / M, by_regs = (160 - M * (M + 1) / 2) / (4 * M);
  constexpr int u = by_loads < by_regs ? by_loads : by_regs;
  return u < 1 ? 1 : u;
}

// A float4 through the read-only path, asking L2 for the whole 256-byte
// block. gram_variants.py at (4, 616.6 M) columns on an H100 (80GB HBM3,
// 700 W): 90.5 % of the HBM rate, against 90.0 % without the prefetch
// size, 87.6 % evict-first (ld.cs) and 77.9 % with L1::no_allocate;
// g.sum() reads the same bytes at 91.8 %.
__device__ __forceinline__ float4 ld_quad(const float* p) {
  float4 v;
  asm volatile("ld.global.nc.L2::256B.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

// One quad of each of the M rows at p, rows `stride` floats apart.
template <int M>
__device__ __forceinline__ void load_quads(float4 (&x)[M], const float* __restrict__ p,
                                           long long stride) {
#pragma unroll
  for (int r = 0; r < M; ++r) x[r] = ld_quad(p + r * stride);
}

// sums[p] += x_i · x_j over the quad, p the row-major index of (i, j),
// i <= j, in the upper triangle.
template <int M>
__device__ __forceinline__ void add_products(float (&sums)[M * (M + 1) / 2],
                                             const float4 (&x)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = i; j < M; ++j) {
      const int p = i * M - i * (i - 1) / 2 + (j - i);
      float s = sums[p];
      s = fmaf(x[i].x, x[j].x, s);
      s = fmaf(x[i].y, x[j].y, s);
      s = fmaf(x[i].z, x[j].z, s);
      s = fmaf(x[i].w, x[j].w, s);
      sums[p] = s;
    }
}

// G Gᵀ for M rows: block b sums columns [b run, min((b + 1) run, d)) into
// its triangle (partial[b P, (b + 1) P)); the last block to finish sums
// the blocks' triangles in block order into out. counters[0] is the
// ticket: zero on entry and on exit.
template <int M>
__global__ void __launch_bounds__(kRowThreads, 1)
gram_rows_kernel(const float* __restrict__ g, long long stride, long long d, long long run,
                 float* __restrict__ partial, int* __restrict__ counters,
                 float* __restrict__ out) {
  constexpr int P = M * (M + 1) / 2;
  constexpr int U = row_unroll<M>();
  constexpr int kWarps = kRowThreads / 32;
  constexpr int kRuns = kRowThreads / P < 8 ? kRowThreads / P : 8;
  __shared__ float warp_sums[kWarps][P];
  __shared__ float run_sums[kRuns][P];
  __shared__ int last;
  float sums[P];
#pragma unroll
  for (int p = 0; p < P; ++p) sums[p] = 0.f;

  const long long c0 = static_cast<long long>(blockIdx.x) * run;
  const long long width = (c0 + run < d ? c0 + run : d) - c0;  // at least 1 (the plan)
  const long long quads = width >> 2;
  const float* base = g + c0;
  long long q = threadIdx.x;
  for (; q + (U - 1) * kRowThreads < quads; q += U * kRowThreads) {
    float4 x[U][M];
#pragma unroll
    for (int u = 0; u < U; ++u) load_quads<M>(x[u], base + 4 * (q + u * kRowThreads), stride);
#pragma unroll
    for (int u = 0; u < U; ++u) add_products<M>(sums, x[u]);
  }
  for (; q < quads; q += kRowThreads) {
    float4 x[M];
    load_quads<M>(x, base + 4 * q, stride);
    add_products<M>(sums, x);
  }
  // the last run's d % 4 columns past its whole quads
  const int tail = static_cast<int>(width & 3);
  if (tail > 0 && threadIdx.x == 0) {
    float4 x[M];
    const float* p = base + 4 * quads;
#pragma unroll
    for (int r = 0; r < M; ++r) {
      const float* pr = p + r * stride;
      x[r] = make_float4(pr[0], tail > 1 ? pr[1] : 0.f, tail > 2 ? pr[2] : 0.f, 0.f);
    }
    add_products<M>(sums, x);
  }

  // the block's triangle: each warp's by a fixed shuffle tree, then the
  // warps in order
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    float v = sums[p];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) warp_sums[warp][p] = v;
  }
  __syncthreads();
  if (threadIdx.x < P) {
    float s = warp_sums[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += warp_sums[w][threadIdx.x];
    partial[static_cast<long long>(blockIdx.x) * P + threadIdx.x] = s;
  }
  // publish the triangle, then take a ticket; the last block merges
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&counters[0], 1) == static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // element p over the blocks in nr contiguous runs (a thread a run), the
  // runs then added in order
  const int blocks = static_cast<int>(gridDim.x);
  const int nr = kRuns < blocks ? kRuns : blocks;
  const int r = threadIdx.x / P, p = threadIdx.x % P;
  if (r < nr) run_sums[r][p] = sum_splits(partial + p, P, blocks * r / nr, blocks * (r + 1) / nr);
  __syncthreads();
  if (threadIdx.x < P) {
    float s = run_sums[0][p];
    for (int k = 1; k < nr; ++k) s += run_sums[k][p];
    int i = 0, rest = p;  // (i, j) of the row-major index p
    while (rest >= M - i) {
      rest -= M - i;
      ++i;
    }
    const int j = i + rest;
    out[i * M + j] = s;
    out[j * M + i] = s;
  }
  if (threadIdx.x == 0) counters[0] = 0;
}

// Launch the instance for m rows (M up to kRowsMax).
template <int M>
int launch_rows(int m, const float* g, long long stride, long long d, long long run, int blocks,
                float* partial, int* counters, float* out, cudaStream_t stream) {
  if (m == M) {
    gram_rows_kernel<M><<<blocks, kRowThreads, 0, stream>>>(g, stride, d, run, partial,
                                                            counters, out);
    return cudaGetLastError();
  }
  if constexpr (M < kRowsMax)
    return launch_rows<M + 1>(m, g, stride, d, run, blocks, partial, counters, out, stream);
  return cudaErrorInvalidValue;
}

// Check a few-row plan (route, m, d, blocks, run, partial floats): runs a
// positive multiple of 4 columns, the blocks covering d with none empty,
// the partials within the workspace.
bool read_rows_plan(const long long* a, int len, int m, long long d, long long partial_len,
                    int* blocks, long long* run) {
  if (len != kRowsPlanLen || a[0] != kRouteRows || a[1] != m || a[2] != d || m < 1 ||
      m > kRowsMax || d < 1 || d > kMaxWindows * kWindow)
    return false;
  const long long b = a[3], r = a[4], floats = a[5];
  if (r < 4 || r % 4 != 0 || b < 1 || b > kMaxRowBlocks || b * r < d || (b - 1) * r >= d ||
      floats != b * m * (m + 1) / 2 || floats > partial_len)
    return false;
  *blocks = static_cast<int>(b);
  *run = r;
  return true;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Read the tensor-core plan (after its route: kPlanHead values, then
// kPlanTile a tile) into `plan` and check it against the tiles this kernel
// computes. Returns false if the kernel cannot take it.
bool read_plan(const long long* a, int len, int m, long long d, long long partial_len,
               Plan* plan, int* blocks, int* smem) {
  if (len < kPlanHead) return false;
  const int tiles = static_cast<int>(a[2]);
  if (a[0] != m || a[1] != d || m < 1 || d < 1 || d > kMaxWindows * kWindow || tiles < 1 ||
      tiles > kMaxTiles || len != kPlanHead + kPlanTile * tiles)
    return false;
  const int row_tiles = (m + kTile - 1) / kTile;
  if (tiles != row_tiles * (row_tiles + 1) / 2) return false;
  plan->m = m;
  plan->d = d;
  plan->row_tiles = row_tiles;
  plan->tiles = tiles;
  plan->stages = static_cast<int>(a[4]);
  plan->slices = static_cast<int>(a[5]);
  if (plan->stages < kMinStages || plan->stages > kMaxStages ||
      plan->slices != (tiles > 1 ? 2 : 1))
    return false;
  int t = 0;
  long long first = 0, part = 0;
  for (int bi = 0; bi < row_tiles; ++bi) {
    for (int bj = bi; bj < row_tiles; ++bj, ++t) {
      const long long* r = a + kPlanHead + kPlanTile * t;
      const long long splits = r[3], chunk = r[4];
      // a split's columns lie in its window: chunk <= kWindow
      if (r[0] != bi || r[1] != bj || r[2] != tile_jobs(m, bi, bj) || chunk < kDepth ||
          chunk > kWindow || chunk % kDepth != 0 || splits < 1 || splits * chunk < d ||
          (splits - 1) * chunk >= d || r[5] != first || r[6] != part)
        return false;
      plan->bi[t] = bi;
      plan->bj[t] = bj;
      plan->splits[t] = static_cast<int>(splits);
      plan->chunk[t] = static_cast<int>(chunk);
      plan->first[t] = static_cast<int>(first);
      plan->part[t] = part;
      first += splits;
      part += splits * kPartial;
    }
  }
  plan->first[tiles] = static_cast<int>(first);
  plan->part[tiles] = part;
  *blocks = static_cast<int>(first);
  // the ring, then the split copies (two buffers of a big and a small slice)
  *smem = 1024 + (plan->stages * plan->slices + 4) * kSlice;
  return a[3] == first && a[6] == *smem && part <= partial_len;
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// g: (m, d) f32 rows `row_stride` floats apart, g and the stride 16-byte
// aligned; plan: gram_plan's values, the route first (see read_rows_plan
// and read_plan); partial: at least the plan's partial floats; counters:
// two ints, zero on entry and on exit; out: (m, m) f32. One launch on
// `stream`: the few-row kernel, or the tensor-core kernel (cooperative).
extern "C" int gram_f32(const float* g, long long row_stride, int m, long long d,
                        const long long* plan_values, int plan_len, float* partial,
                        long long partial_len, int* counters, float* out, void* stream) {
  if (plan_len < 1 || reinterpret_cast<uintptr_t>(g) % 16 != 0 || (row_stride * 4) % 16 != 0 ||
      (m > 1 && row_stride < d))
    return cudaErrorInvalidValue;
  if (plan_values[0] == kRouteRows) {
    int blocks = 0;
    long long run = 0;
    if (!read_rows_plan(plan_values, plan_len, m, d, partial_len, &blocks, &run))
      return cudaErrorInvalidValue;
    return launch_rows<1>(m, g, row_stride, d, run, blocks, partial, counters, out,
                          static_cast<cudaStream_t>(stream));
  }
  Plan plan;  // copied into the launch's parameters
  int blocks = 0, smem = 0;
  if (plan_values[0] != kRouteTiles ||
      !read_plan(plan_values + 1, plan_len - 1, m, d, partial_len, &plan, &blocks, &smem))
    return cudaErrorInvalidValue;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  Maps maps = {};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(row_stride) * 4};
  const cuuint32_t box[2] = {kDepth, kTile};
  const cuuint32_t unit[2] = {1, 1};
  for (long long j = 0; j * kWindow < d; ++j) {
    const long long base = j * kWindow;
    const long long width = d - base < 2 * kWindow ? d - base : 2 * kWindow;
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(width), static_cast<cuuint64_t>(m)};
    if (encode(&maps.map[j], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(g + base),
               dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  static int smem_set[64] = {};  // the attribute's value on each device
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (smem > smem_set[device]) {
    err = cudaFuncSetAttribute(gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set[device] = smem;
  }
  void* args[] = {&maps, &plan, &partial, &counters, &out};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(gram_kernel), dim3(blocks),
                                    dim3(kThreads), args, static_cast<size_t>(smem),
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
