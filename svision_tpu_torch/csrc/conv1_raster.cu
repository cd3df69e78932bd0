// K3: the space-to-depth raster fused into conv1, endpoints + folded conv1
// weights -> conv1 pre-activation [N,55,55,96].
//
// Replaces svision_tpu/ops/fused_conv1.py:conv1_fused_raster (kernel
// _fused_kernel, predicate _predicate_s2d). Plain version:
// svision_tpu_torch/ops/fused_conv1.py:conv1_fused_raster_plain, that is
// render_raster_s2d followed by a 3x3 VALID conv with w_s2d [3,3,48,96].
//
// Bound on an H100 at B=128: bytes. The output is 74.3 MB in bf16 (22 us
// at 3.35 TB/s) and 148.7 MB in f32 (44 us). Each image is two clipped
// segments, so under 1% of the predicate is lit and the operations this
// data needs take far less. Done densely, the implicit GEMM [N*55*55, 432]
// x [432, 96] is 32.1 GFLOP: 32 us on bf16 tensor cores, 479 us as f32 FMAs,
// both floors above the byte bound. So both dtypes multiply only where the
// predicate is lit, and the output write streams out behind them. Times:
// PERF.md.
//
// bf16, the engine's fast path: a wgmma implicit GEMM (namespace tc).
//  * Persistent grid, one 384-thread block per SM: a producer warpgroup
//    and two consumer warpgroups. A block takes a contiguous run of work
//    items, (image, band of 8 output rows).
//  * The consumers first copy the weights into shared memory with cp.async,
//    as wgmma's B operand: HWIO [k][n] is already MN-major once each k
//    row's 16-byte run of 8 n values lands in its 8x8 core matrix. No
//    swizzle, so the 27 K steps need no power-of-two swizzle atom.
//  * The producer builds each band's s2d predicate in shared memory from
//    the closed-form run tables (raster_common.cuh), as wgmma's K-major A
//    operand: per 8-channel chunk a [10 rows][58 cols] plane of 16-byte
//    cells. A 64-row M tile is 8 output rows x 8 output columns, so the A
//    operand of tap (dr, dc) is a descriptor into the planes offset by
//    (dr, dc): no im2col copy and no ldmatrix. The predicate is double
//    buffered (named barriers): the next band is built while the consumers
//    multiply this one, and it never reaches device memory.
//  * A 16-channel K step is one image channel at one tap (k = c*16 + p*4 +
//    q), and most are dark over a whole tile. The producer marks, per tile,
//    the K steps whose A chunk holds a lit value; the others would add exact
//    zeros, so skipping them leaves the f32 sums bit for bit as they were.
//  * A consumer warpgroup takes every other tile of the block's stream (7
//    per band) and issues one wgmma.m64n96k16 per lit K step (at most 27),
//    f32 accumulators in registers. Its epilogue rounds to bf16, stages the
//    tile in shared memory and writes it with coalesced 16-byte stores,
//    dropping the padding column 55 and row 55, while the other warpgroup
//    multiplies.
//
// f32 (namespace simt): the sums on CUDA cores, over the lit terms only.
// TF32 would miss the f32 bar, and a three-way bf16 split of the weights
// would need three 83 KB B operands, more than a block's shared memory. The
// predicate is {0,1}, so every product is a weight exactly: an output is
// the sum of the weight rows of its lit (tap, channel) terms, and the dark
// terms, exact zeros, are skipped without changing it.
//  * Persistent grid, one 1024-thread block per SM, which takes every
//    gridDim.x-th item (image, band of 8 output rows), so that the bands of
//    a heavily lit image spread over the SMs. The consumers copy the f32
//    weights [432][96] (162 KB) into shared memory once, with cp.async.
//  * A producer of four warps builds each band's lists in shared memory
//    from the closed-form run tables: per s2d cell a 48-bit mask of its lit
//    channels, then per output pixel a 9-bit mask of the taps whose cell
//    holds one. They are double buffered (named barriers): the next band's
//    lists are built while the consumers write this one.
//  * The band's output is one contiguous run of float4s. 28 consumer warps
//    stream it out with 16-byte __stcs stores: 12 threads a pixel, each
//    holding 2 of its 24 channel quads, so neighbouring threads store
//    neighbouring quads. A pixel with no lit tap stores zeros; a lit one
//    first adds the thread's weight quads of each lit term, one term a
//    step (scripts/torch_k3_variants.py times the other choices).

#include <cstdint>

#include "raster_common.cuh"

namespace {

constexpr int kOut = 55;              // output rows / cols
constexpr int kS2d = 57;              // s2d raster rows / cols
constexpr int kCin = 48;              // s2d channels (c, p, q)
constexpr int kCout = 96;
constexpr int kTaps = 9;
constexpr int kK = kTaps * kCin;      // 432, the GEMM's depth

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// ---------------------------------------------------------------------------
// bf16: wgmma implicit GEMM
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kBand = 8;                                 // output rows / item
constexpr int kBands = (kOut + kBand - 1) / kBand;       // 7
constexpr int kTileCols = 8;                             // 8 x 8 = 64 M rows
constexpr int kTiles = (kOut + kTileCols - 1) / kTileCols;  // 7 per band
constexpr int kPredRows = kBand + 2;                     // 10
constexpr int kPredCols = kTiles * kTileCols + 2;        // 58
constexpr int kCell = 16;                                // bytes: 8 bf16
constexpr int kPlane = kPredRows * kPredCols * kCell;    // 9,280 B
constexpr int kPredBytes = (kCin / 8) * kPlane;          // 55,680 B
constexpr int kPixRows = 4 * kPredRows;                  // 40
constexpr int kPixCols = 4 * kPredCols;                  // 232
constexpr int kKSteps = kK / 16;                         // 27
constexpr int kBChunk = kCout * kCell;                   // 1,536 B
constexpr int kBBytes = kK * kCout * 2;                  // 82,944 B
constexpr int kStageStride = kCout + 8;                  // bf16, conflict-free
constexpr int kStageBytes = 64 * kStageStride * 2;       // 13,312 B
constexpr int kTableInts = 2 * svt::kSegs * kPixRows + kPixCols;
constexpr int kLitRows = 3 * kPredRows;                  // 64-bit masks
constexpr int kThreads = 384;
constexpr size_t kSmem = kBBytes + 2 * kPredBytes + 2 * kStageBytes
                         + sizeof(int) * kTableInts
                         + sizeof(uint64_t) * kLitRows
                         + sizeof(uint32_t) * 2 * kTiles;      // 222,792 B

// named barriers (0 is __syncthreads)
constexpr int kBarFull = 1;       // + buffer: predicate built
constexpr int kBarEmpty = 3;      // + buffer: predicate consumed
constexpr int kBarProducer = 5;   // the producer's run tables
constexpr int kBarStage = 6;      // + consumer: its staging buffer
constexpr int kBarWeights = 8;    // the consumers: B copied

// Makes this thread's shared-memory stores visible to wgmma, which reads
// its operands through the async proxy.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// wgmma shared-memory matrix descriptor without swizzle: core matrices of
// 8 rows x 16 contiguous bytes; lbo is the byte step between core matrices
// along K, sbo the byte step between them along M (A) or N (B).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(lbo >> 4) << 16)
         | (static_cast<uint64_t>(sbo >> 4) << 32);
}

// Keeps the compiler from moving accumulator accesses across wgmma.
__device__ __forceinline__ void fence_acc(float (&d)[48]) {
#pragma unroll
  for (int i = 0; i < 48; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64x96] += A[64x16] * B[16x96], bf16 from shared memory: A K-major, B
// MN-major (the transpose flag).
__device__ __forceinline__ void wgmma_m64n96k16(float (&d)[48], uint64_t a,
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47}, %48, %49, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(a), "l"(b), "r"(1));
}

// Two bf16 {0,1} values packed into one 32-bit word (low half first).
__device__ __forceinline__ uint32_t pack2(bool lo, bool hi) {
  return (lo ? 0x3F80u : 0u) | (hi ? 0x3F800000u : 0u);
}

// The producer warpgroup (ptid 0..127) builds the predicate of band oy0
// of the image with segments a, b into pred: channel ci = ch*16 + p*4 + q
// of cell (prow, pcol) at byte (ci / 8) * kPlane + (prow * kPredCols +
// pcol) * 16 + (ci % 8) * 2. Cells outside the 57x57 raster stay 0.
// Bit s = tap * 3 + ch of steps[t] is set where K step s of M tile t holds
// a lit value. The per-column lit-row counts of channel 1 depend on the
// image only, so they are computed for its first band and kept.
__device__ void build_band(const svt::Seg& a, const svt::Seg& b, int oy0,
                           bool new_image, unsigned char* pred,
                           uint32_t* steps, int* tables, uint32_t* lit,
                           int ptid) {
  using namespace svt;
  int* clo_s = tables;
  int* chi_s = clo_s + kSegs * kPixRows;
  int* rows_s = chi_s + kSegs * kPixRows;   // lit rows per pixel column
  bar_sync(kBarProducer, 128);   // the previous band is done with the tables
  for (int i = ptid; i < kSegs * kPixRows; i += 128) {
    row_run(i < kPixRows ? a : b, 4 * oy0 + i % kPixRows, clo_s[i], chi_s[i]);
  }
  if (new_image) {
    for (int c = ptid; c < kPixCols; c += 128) rows_s[c] = col_rows(a, b, c);
  }
  for (int i = ptid; i < 2 * kLitRows; i += 128) lit[i] = 0;
  if (ptid < kTiles) steps[ptid] = 0;
  bar_sync(kBarProducer, 128);

  // one unit = one cell x one half of its p rows (ph): 8 pixels, written
  // as one 16-byte chunk in each of the three channel planes. Most units
  // are dark, and four compares against the row runs find them.
  constexpr int kCells = kPredRows * kPredCols;
  for (int u = ptid; u < 2 * kCells; u += 128) {
    const int ph = u / kCells, cell = u % kCells;
    const int prow = cell / kPredCols, pcol = cell % kPredCols;
    const int lr0 = 4 * prow + 2 * ph, c0 = 4 * pcol;
    bool any = false;
#pragma unroll
    for (int i = 0; i < 2 * kSegs; ++i) {
      const int r = (i / 2) * kPixRows + lr0 + i % 2;
      any |= clo_s[r] <= c0 + 3 && chi_s[r] >= c0;
    }
    any = any && oy0 + prow < kS2d && pcol < kS2d;
    uint4* dst = reinterpret_cast<uint4*>(pred + ph * kPlane + cell * kCell);
    constexpr int kPlane16 = kPlane / 16;
    if (!any) {
      dst[0] = dst[2 * kPlane16] = dst[4 * kPlane16] = make_uint4(0, 0, 0, 0);
      continue;
    }
    uint32_t w0[4], w1[4], w2[4];
#pragma unroll
    for (int pp = 0; pp < 2; ++pp) {
      const int lr = lr0 + pp;
      const int alo = clo_s[lr], ahi = chi_s[lr];
      const int blo = clo_s[kPixRows + lr], bhi = chi_s[kPixRows + lr];
#pragma unroll
      for (int qq = 0; qq < 2; ++qq) {
        bool l0[2], l1[2], l2[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = c0 + 2 * qq + h;
          const bool la = in_run(c, alo, ahi);
          const bool lb = in_run(c, blo, bhi);
          l0[h] = la || lb;
          l1[h] = l0[h] && rows_s[c] >= 2;
          l2[h] = (la && a.rev) || (lb && b.rev);
        }
        w0[2 * pp + qq] = pack2(l0[0], l0[1]);
        w1[2 * pp + qq] = pack2(l1[0], l1[1]);
        w2[2 * pp + qq] = pack2(l2[0], l2[1]);
      }
    }
    dst[0] = make_uint4(w0[0], w0[1], w0[2], w0[3]);
    dst[2 * kPlane16] = make_uint4(w1[0], w1[1], w1[2], w1[3]);
    dst[4 * kPlane16] = make_uint4(w2[0], w2[1], w2[2], w2[3]);
    uint32_t* word = lit + 2 * prow + (pcol >> 5);
    const uint32_t bit = 1u << (pcol & 31);
    if (w0[0] | w0[1] | w0[2] | w0[3]) atomicOr(word, bit);
    if (w1[0] | w1[1] | w1[2] | w1[3]) atomicOr(word + 2 * kPredRows, bit);
    if (w2[0] | w2[1] | w2[2] | w2[3]) atomicOr(word + 4 * kPredRows, bit);
  }

  // lit[ch * kPredRows + prow] is a 64-bit mask over pcol of the cells
  // whose channel ch holds a lit pixel. K step (dr, dc, ch) of tile t reads
  // cells (dr + 0..7, 8 t + dc + 0..7): one thread per (t, ch, dr).
  bar_sync(kBarProducer, 128);
  if (ptid < kTiles * 9) {
    const int t = ptid / 9, ch = ptid % 9 / 3, dr = ptid % 3;
    const uint64_t* lit64 = reinterpret_cast<const uint64_t*>(lit);
    uint64_t rows = 0;
#pragma unroll
    for (int g = 0; g < kBand; ++g) rows |= lit64[ch * kPredRows + dr + g];
    uint32_t bits = 0;
#pragma unroll
    for (int dc = 0; dc < 3; ++dc) {
      if ((rows >> (t * kTileCols + dc)) & 0xFF) {
        bits |= 1u << ((dr * 3 + dc) * 3 + ch);
      }
    }
    if (bits) atomicOr(steps + t, bits);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
conv1_raster_wgmma(const int* __restrict__ ep,
                   const unsigned char* __restrict__ vis,
                   const unsigned char* __restrict__ rev,
                   const __nv_bfloat16* __restrict__ w,
                   __nv_bfloat16* __restrict__ out, int n_img) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* w_s = smem;
  unsigned char* pred_s = w_s + kBBytes;
  __nv_bfloat16* stage_s =
      reinterpret_cast<__nv_bfloat16*>(pred_s + 2 * kPredBytes);
  int* tables = reinterpret_cast<int*>(pred_s + 2 * kPredBytes
                                       + 2 * kStageBytes);
  uint32_t* lit_s = reinterpret_cast<uint32_t*>(tables + kTableInts);
  uint32_t* steps_s = lit_s + 2 * kLitRows;   // per buffer, kTiles words
  const int tid = threadIdx.x;
  // the block's items, a contiguous run: consecutive bands of one image
  // share the producer's column table
  const int items = n_img * kBands;
  const int first = static_cast<int>(1LL * blockIdx.x * items / gridDim.x);
  const int last = static_cast<int>(1LL * (blockIdx.x + 1) * items / gridDim.x);

  if (tid < 128) {
    // producer: build item j's predicate into buffer j % 2
    for (int item = first, j = 0; item < last; ++item, ++j) {
      const int buf = j & 1;
      if (j >= 2) bar_sync(kBarEmpty + buf, kThreads);
      const int n = item / kBands;
      build_band(svt::load_seg(ep, vis, rev, n, 0),
                 svt::load_seg(ep, vis, rev, n, 1), (item % kBands) * kBand,
                 j == 0 || item % kBands == 0, pred_s + buf * kPredBytes,
                 steps_s + buf * kTiles, tables, lit_s, tid);
      fence_async_smem();
      bar_arrive(kBarFull + buf, kThreads);
    }
    return;
  }

  // consumers, while the producer builds the first band: copy B, which
  // the HWIO weights [k][n] already are in wgmma's MN-major layout once each
  // k row's 16-byte run of 8 n values lands in its core matrix (k / 8, n / 8)
  for (int i = tid - 128; i < kK * (kCout / 8); i += kThreads - 128) {
    const int k = i / (kCout / 8), ng = i % (kCout / 8);
    const uint32_t dst = smem_u32(w_s + (k / 8) * kBChunk + ng * 128
                                  + (k % 8) * kCell);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
                 "l"(w + k * kCout + ng * 8)
                 : "memory");
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  fence_async_smem();
  bar_sync(kBarWeights, kThreads - 128);

  // consumers: warpgroup wg takes the tiles g of the block's tile stream
  // (7 per item) with g % 2 == wg
  const int wg = __shfl_sync(0xffffffffu, tid / 128 - 1, 0);
  const int ctid = tid % 128;
  const int lane = ctid % 32;
  const int m0 = 16 * (ctid / 32) + lane / 4;   // accumulator rows m0, m0+8
  __nv_bfloat16* stage = stage_s + wg * 64 * kStageStride;
  const uint32_t b_base = smem_u32(w_s);
  for (int item = first, j = 0; item < last; ++item, ++j) {
    const int buf = j & 1;
    const int n = item / kBands;
    const int oy0 = (item % kBands) * kBand;
    const uint32_t a_base = smem_u32(pred_s + buf * kPredBytes);
    bar_sync(kBarFull + buf, kThreads);
    for (int t = (wg ^ j) & 1; t < kTiles; t += 2) {
      const int ox0 = t * kTileCols;
      // lit K steps, broadcast from lane 0: the compiler then sees a
      // warp-uniform value and branches on it without serialising the MMAs
      const uint32_t steps =
          __shfl_sync(0xffffffffu, steps_s[buf * kTiles + t], 0);
      float acc[48];
#pragma unroll
      for (int i = 0; i < 48; ++i) acc[i] = 0.f;
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int s = 0; s < kKSteps; ++s) {
        if (!((steps >> s) & 1)) continue;
        const int tap = s / 3, ch = s % 3;
        const int dr = tap / 3, dc = tap % 3;
        // A: rows m = 8 * g + i <- cell (dr + g, ox0 + dc + i), channels
        // 16 * ch .. 16 * ch + 15 (planes 2 * ch, 2 * ch + 1)
        const uint64_t da = desc(
            a_base + 2 * ch * kPlane + (dr * kPredCols + ox0 + dc) * kCell,
            kPlane, kPredCols * kCell);
        const uint64_t db = desc(b_base + 2 * s * kBChunk, kBChunk, 128);
        wgmma_m64n96k16(acc, da, db);
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fence_acc(acc);

      // epilogue: fragment (rows m0, m0 + 8; cols 8 * jn + 2 * (lane % 4)
      // + {0, 1}) -> bf16 stage -> 16-byte stores of the valid pixels
      bar_sync(kBarStage + wg, 128);   // the previous tile's stores read it
#pragma unroll
      for (int jn = 0; jn < kCout / 8; ++jn) {
        const int col = 8 * jn + 2 * (lane % 4);
        *reinterpret_cast<__nv_bfloat162*>(stage + m0 * kStageStride + col) =
            __floats2bfloat162_rn(acc[4 * jn], acc[4 * jn + 1]);
        *reinterpret_cast<__nv_bfloat162*>(stage + (m0 + 8) * kStageStride
                                           + col) =
            __floats2bfloat162_rn(acc[4 * jn + 2], acc[4 * jn + 3]);
      }
      bar_sync(kBarStage + wg, 128);
      __nv_bfloat16* tile_out =
          out + ((size_t)(n * kOut + oy0) * kOut + ox0) * kCout;
#pragma unroll
      for (int r = 0; r < 64 * (kCout / 8) / 128; ++r) {
        const int u = ctid + 128 * r;
        const int m = u / (kCout / 8), part = u % (kCout / 8);
        const int g = m / kTileCols, i = m % kTileCols;
        if (oy0 + g < kOut && ox0 + i < kOut) {
          *reinterpret_cast<uint4*>(tile_out + (g * kOut + i) * kCout
                                    + part * 8) =
              *reinterpret_cast<const uint4*>(stage + m * kStageStride
                                              + part * 8);
        }
      }
    }
    if (item + 2 < last) bar_arrive(kBarEmpty + buf, kThreads);
  }
}

int launch(const void* ep, const void* vis, const void* rev, const void* w,
           void* out, int n, int sms, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      conv1_raster_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int items = n * kBands;
  const int grid = items < sms ? items : sms;
  conv1_raster_wgmma<<<grid, kThreads, kSmem, s>>>(
      static_cast<const int*>(ep), static_cast<const unsigned char*>(vis),
      static_cast<const unsigned char*>(rev),
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(out),
      n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// ---------------------------------------------------------------------------
// f32: only the lit terms, on CUDA cores
// ---------------------------------------------------------------------------
namespace simt {

constexpr int kBand = 8;                                 // output rows / item
constexpr int kBands = (kOut + kBand - 1) / kBand;       // 7
constexpr int kPredRows = kBand + 2;                     // 10
constexpr int kPixRows = 4 * kPredRows;                  // 40
constexpr int kPixCols = 4 * kS2d;                       // 228
constexpr int kCells = kPredRows * kS2d;                 // 570
constexpr int kPixels = kBand * kOut;                    // 440
constexpr int kQuads = kCout / 4;                        // 24 float4 a pixel
constexpr int kLaneQuads = 2;                 // float4s a consumer thread owns
constexpr int kPixThreads = kQuads / kLaneQuads;         // threads a pixel
constexpr int kProducers = 128;
constexpr int kConsumers = 896;
constexpr int kThreads = kProducers + kConsumers;
constexpr int kTableInts = 2 * svt::kSegs * kPixRows + kPixCols;
constexpr size_t kWBytes = sizeof(float) * kK * kCout;   // 165,888 B
constexpr size_t kMaskBytes = sizeof(uint64_t) * kCells;  // 4,560 B
constexpr size_t kTapBytes = sizeof(uint16_t) * kPixels;  // 880 B
constexpr size_t kSmem = kWBytes + 2 * kMaskBytes + 2 * kTapBytes
                         + sizeof(int) * kTableInts;     // 178,880 B

// named barriers (0 is __syncthreads)
constexpr int kBarFull = 1;       // + buffer: lists built
constexpr int kBarEmpty = 3;      // + buffer: lists consumed
constexpr int kBarProducer = 5;   // the producer's run tables
constexpr int kBarWeights = 6;    // the consumers: weights copied

// The producer warps (ptid 0..127) build the lists of band oy0 of the image
// with segments a and b:
//  * mask[prow * 57 + pcol]: bit k = ch*16 + p*4 + q of s2d cell (oy0 + prow,
//    pcol) is set where that predicate value is lit (pixel (4*(oy0 + prow)
//    + p, 4*pcol + q), channel ch);
//  * taps[g * 55 + ox]: bit dr*3 + dc is set where output pixel (oy0 + g,
//    ox) reads a cell (oy0 + g + dr, ox + dc) with a lit value.
__device__ void build_lists(const svt::Seg& a, const svt::Seg& b, int oy0,
                            uint64_t* mask, uint16_t* taps, int* tables,
                            int ptid) {
  using namespace svt;
  int* clo_s = tables;
  int* chi_s = clo_s + kSegs * kPixRows;
  int* rows_s = chi_s + kSegs * kPixRows;   // lit rows per pixel column
  bar_sync(kBarProducer, kProducers);   // the previous band is done with them
  for (int i = ptid; i < kSegs * kPixRows; i += kProducers) {
    row_run(i < kPixRows ? a : b, 4 * oy0 + i % kPixRows, clo_s[i], chi_s[i]);
  }
  for (int c = ptid; c < kPixCols; c += kProducers) {
    rows_s[c] = col_rows(a, b, c);
  }
  bar_sync(kBarProducer, kProducers);

  // one thread a cell: four compares against the row runs find a dark one
  for (int cell = ptid; cell < kCells; cell += kProducers) {
    const int prow = cell / kS2d, pcol = cell % kS2d;
    const int lr0 = 4 * prow, c0 = 4 * pcol;
    bool any = false;
#pragma unroll
    for (int i = 0; i < 4 * kSegs; ++i) {
      const int r = (i / 4) * kPixRows + lr0 + i % 4;
      any |= clo_s[r] <= c0 + 3 && chi_s[r] >= c0;
    }
    uint64_t m = 0;
    if (any && oy0 + prow < kS2d) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int lr = lr0 + p;
        const int alo = clo_s[lr], ahi = chi_s[lr];
        const int blo = clo_s[kPixRows + lr], bhi = chi_s[kPixRows + lr];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = c0 + q;
          const bool la = in_run(c, alo, ahi);
          const bool lb = in_run(c, blo, bhi);
          const bool l0 = la || lb;
          const bool l1 = l0 && rows_s[c] >= 2;
          const bool l2 = (la && a.rev) || (lb && b.rev);
          const int bit = p * 4 + q;
          m |= (static_cast<uint64_t>(l0) << bit)
               | (static_cast<uint64_t>(l1) << (16 + bit))
               | (static_cast<uint64_t>(l2) << (32 + bit));
        }
      }
    }
    mask[cell] = m;
  }
  bar_sync(kBarProducer, kProducers);

  for (int px = ptid; px < kPixels; px += kProducers) {
    const int g = px / kOut, ox = px % kOut;
    uint32_t t = 0;
#pragma unroll
    for (int tap = 0; tap < kTaps; ++tap) {
      if (mask[(g + tap / 3) * kS2d + ox + tap % 3]) t |= 1u << tap;
    }
    taps[px] = static_cast<uint16_t>(t);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
conv1_raster_f32(const int* __restrict__ ep,
                 const unsigned char* __restrict__ vis,
                 const unsigned char* __restrict__ rev,
                 const float* __restrict__ w, float* __restrict__ out,
                 int n_img) {
  extern __shared__ __align__(16) unsigned char smem[];
  const float* w_s = reinterpret_cast<const float*>(smem);
  uint64_t* mask_s = reinterpret_cast<uint64_t*>(smem + kWBytes);
  uint16_t* taps_s = reinterpret_cast<uint16_t*>(smem + kWBytes
                                                 + 2 * kMaskBytes);
  int* tables = reinterpret_cast<int*>(smem + kWBytes + 2 * kMaskBytes
                                       + 2 * kTapBytes);
  const int tid = threadIdx.x;
  // the block's items: every gridDim.x-th, so that the bands of a heavily
  // lit image spread over the blocks
  const int items = n_img * kBands;

  if (tid < kProducers) {
    // producer: build the block's item j's lists into buffer j % 2
    for (int item = blockIdx.x, j = 0; item < items;
         item += gridDim.x, ++j) {
      const int buf = j & 1;
      if (j >= 2) bar_sync(kBarEmpty + buf, kThreads);
      const int n = item / kBands;
      build_lists(svt::load_seg(ep, vis, rev, n, 0),
                  svt::load_seg(ep, vis, rev, n, 1), (item % kBands) * kBand,
                  mask_s + buf * kCells, taps_s + buf * kPixels, tables, tid);
      bar_arrive(kBarFull + buf, kThreads);
    }
    return;
  }

  // consumers, while the producer builds the first band: copy the weights
  // HWIO [k = tap * 48 + ch][o] as they are
  const int ctid = tid - kProducers;
  for (int i = ctid; i < static_cast<int>(kWBytes / 16); i += kConsumers) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                 ::"r"(smem_u32(smem + 16 * i)), "l"(w + 4 * i)
                 : "memory");
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  bar_sync(kBarWeights, kConsumers);

  // consumers: the band's output is one contiguous run of float4s. Thread
  // unit f holds quads u * kPixThreads + f % kPixThreads of pixel px = f /
  // kPixThreads (u < kLaneQuads): neighbouring threads store neighbouring
  // quads. A pixel whose taps are dark is an exact zero; a lit one sums the
  // weight rows of its lit (tap, channel) terms, in the order of k = tap *
  // 48 + ch, each product of a {0,1} predicate value and a weight being
  // that weight exactly.
  for (int item = blockIdx.x, j = 0; item < items; item += gridDim.x, ++j) {
    const int buf = j & 1;
    const int n = item / kBands;
    const int oy0 = (item % kBands) * kBand;
    const uint64_t* mask = mask_s + buf * kCells;
    const uint16_t* taps = taps_s + buf * kPixels;
    const int units = min(kBand, kOut - oy0) * kOut * kPixThreads;
    float4* dst = reinterpret_cast<float4*>(
        out + ((size_t)n * kOut + oy0) * kOut * kCout);
    bar_sync(kBarFull + buf, kThreads);
    for (int f = ctid; f < units; f += kConsumers) {
      const int px = f / kPixThreads;
      const int quad = f - px * kPixThreads;
      uint32_t t = taps[px];
      float4 acc[kLaneQuads];
#pragma unroll
      for (int u = 0; u < kLaneQuads; ++u) {
        acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      if (t) {
        const int g = px / kOut, ox = px - g * kOut;
        const float* wq = w_s + 4 * quad;
        do {
          const int tap = __ffs(t) - 1;
          t &= t - 1;
          uint64_t m = mask[(g + tap / 3) * kS2d + ox + tap % 3];
          const float* wt = wq + tap * kCin * kCout;
          do {
            const float* row = wt + (__ffsll(m) - 1) * kCout;
            m &= m - 1;
#pragma unroll
            for (int u = 0; u < kLaneQuads; ++u) {
              const float4 v = *reinterpret_cast<const float4*>(
                  row + 4 * kPixThreads * u);
              acc[u].x += v.x;
              acc[u].y += v.y;
              acc[u].z += v.z;
              acc[u].w += v.w;
            }
          } while (m);
        } while (t);
      }
#pragma unroll
      for (int u = 0; u < kLaneQuads; ++u) {
        __stcs(dst + px * kQuads + u * kPixThreads + quad, acc[u]);
      }
    }
    if (item + 2 * static_cast<int>(gridDim.x) < items) {
      bar_arrive(kBarEmpty + buf, kThreads);
    }
  }
}

int launch(const void* ep, const void* vis, const void* rev, const void* w,
           void* out, int n, int sms, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      conv1_raster_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int items = n * kBands;
  const int grid = items < sms ? items : sms;
  conv1_raster_f32<<<grid, kThreads, kSmem, s>>>(
      static_cast<const int*>(ep), static_cast<const unsigned char*>(vis),
      static_cast<const unsigned char*>(rev), static_cast<const float*>(w),
      static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt

}  // namespace

// ep int32 [n,2,4], vis/rev bool [n,2], w [3,3,48,96] and out
// [n,55,55,96] both bf16 when bf16 != 0, else f32; all contiguous on the
// current device, w 16-byte aligned.
extern "C" int svt_conv1_fused_raster(const void* ep, const void* vis,
                                      const void* rev, const void* w,
                                      void* out, int n, int bf16,
                                      void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return bf16 ? tc::launch(ep, vis, rev, w, out, n, sms, s)
              : simt::launch(ep, vis, rev, w, out, n, sms, s);
}
