// The backward of K2's function, relu(x + bias) -> 3x3 stride-2 VALID
// maxpool -> LRN, channels-last: dx and the bias gradient db from x, the
// bias and dy, the gradient of K2's output.
//
// The JAX package has no backward kernel for K2: its
// svision_tpu/ops/fused_pool_lrn.py:76 bias_relu_pool_lrn has no custom_vjp,
// and its trainer differentiates the XLA composition of
// svision_tpu/models/train.py:44-47 (alexnet._maxpool, alexnet.lrn). This
// kernel is the backward of svision_tpu_torch/ops/fused_pool_lrn.py's
// BiasReluPoolLRN, whose forward is K2 (pool_lrn.cu). Plain version:
// fused_pool_lrn.py:bias_relu_pool_lrn_backward_plain.
//
// With y = relu(x + b) (added in f32, as K2 adds), p the pool of y, a(o) the
// first position in row-major window order where output o's maximum lies,
// v_c = 1 + alpha * sum_{|j-c|<=2} p_j^2 and beta = 0.75:
//   dp_c = dy_c v_c^-beta - 2 alpha beta p_c sum_{|j-c|<=2} dy_j p_j v_j^(-beta-1)
//   dx   = (x + b > 0) * the sum of dp(o) over the windows o with a(o) at x
//   db   = the sum of dx over n, h and w
// Ties route to the first maximum of the rounded relu(x + b), as
// F.max_pool2d and XLA's select-and-scatter (select 'ge') route them: in f32
// two distinct x can round to one x + b, and the raw x's maximum would then
// send the gradient elsewhere. Math is f32 inside, in the plain version's
// order, with one rounding of dx; the taps of an input are summed in
// row-major window order, so dx is bit-equal to the plain version.
//
// Bound on an H100: bytes. x, the bias and dy are read once, dx and db
// written once: at batch 64 in bf16 83.3 MB at the conv1 tail (24.9 us at
// 3.35 TB/s) and 53.3 MB at the conv2 tail (15.9 us); in f32 twice that.
// The first design, a block per output row, recomputed output row ho-1
// beside ho (every row formed twice), read x's window taps and relu's mask
// from global memory (x about 5.5 times through L1 and L2), kept few bytes
// in flight, and left the bias partials to a second launch (a torch sum);
// it ran at 15-30% of the bound. So:
// - Persistent grid, kMaxBlocksPerSm blocks an SM at most. Each block
//   walks a contiguous run of output rows in flattened (n, ho) order, split
//   statically, so a device and shape fix every block's rows and every
//   sum's order: the results are deterministic (graph replays equal eager
//   calls).
// - A producer thread fills two rings in shared memory with 1-D bulk copies
//   (cp.async.bulk; bulk_ring.cuh: full and empty mbarriers, a trap on a
//   wait of seconds): x's input rows (a run fetches each once, two per
//   output row, three where it starts or enters an image) and dy's rows
//   (each once). C % 8 == 0 and 16-byte aligned x and dy make every row a
//   whole number of 16-byte units at a 16-byte-aligned address, so K2's
//   handling of ragged rows is not needed here.
// - Rolling dp. Input row 2ho takes gradient from output rows ho-1 and ho,
//   row 2ho+1 from ho. Each output row's window maxima, winning taps, LRN
//   and dp are formed once into shared memory and kept (three rows deep)
//   for the next row's gather; only a run that starts mid-image forms the
//   row before it as well.
// - One pass a row, one barrier a step. A lane owns kV = 8 consecutive
//   channels of one output pixel (16-byte loads of the ring's bf16 rows) and
//   forms p, the taps, u, t and dp in registers; the LRN's neighbouring
//   channels come from the adjacent lanes by __shfl_sync. relu's mask is
//   folded into dp: a window's maximum lies at its winning tap, so x + b >
//   0 there exactly where p > 0. The input rows are freed as soon as every
//   warp has formed its part of the row.
// - Gather, don't scatter: after the barrier, a thread takes a 2x2 block of
//   input pixels at fixed channels (at most 4, 2, 2 and 1 taps reach them),
//   sums the dp of the windows whose winning tap lies there in row-major
//   tap order, and writes dx once with 16-byte streaming stores. The
//   image's last output row also writes the rows below it (an even H's last
//   row receives nothing).
// - The bias gradient in the kernel. Each thread sums the dx it writes;
//   each block sums its threads' sums in a fixed order into one f32 row of
//   a [blocks, C] partial; the block that takes the call's last ticket (a
//   counter in the caller's scratch, zeroed on the stream before the
//   launch, so two calls on two streams never share one) sums the rows in
//   a fixed order and writes db in the bias's type. No torch op follows.
// - A row too wide for the ring (three x rows, two dy rows and three f32
//   dp rows in shared memory) takes the simple path: a block per output row
//   reading x and dy from global memory, the same row and gather code.
// What holds it back (PERF.md): the phases of a step run one after the
// other on at most 11-13 busy warps an SM, so the card idles on latency.
// The constants below were chosen by scripts/torch_k2_variants.py
// --backward on the card, which also times copies with one part of the
// work cut. Above 48 KB of shared memory the launch opts in once per device
// and size, before any CUDA graph capture, because the trainers' first
// steps run eagerly.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bulk_ring.cuh"

namespace {

using namespace svt;

constexpr float kAlpha = 2e-5f;
constexpr float kBiasK = 1.0f;
constexpr float kTwoAlphaBeta = 3e-5f;  // 2 * alpha * beta
constexpr int kV = 8;                   // channels a thread: 8 or 4
constexpr int kW = kV / 4;              // 16-byte quads of kV f32
constexpr int kMaxC = 3072;             // channels the kernels take
// the ring path
constexpr int kConsumerWarps = 15;
constexpr int kThreads = 32 * (kConsumerWarps + 1);  // + one producer warp
constexpr int kMaxSlots = 6;            // x rows in the ring, at most
constexpr int kDySlots = 2;             // dy rows in the ring
constexpr int kMaxBlocksPerSm = 1;
// the simple path: a block per output row, a thread for each channel group
constexpr int kRowThreads = kMaxC / kV;
// shared memory: an SM's 228 KB, of which each block reserves 1 KB, and a
// block's own static bytes
constexpr int kSmemPerSm = 228 * 1024;
constexpr int kReservedPerBlock = 1024;
constexpr int kStaticSmem = 16;
constexpr int kMaxSmem = kSmemPerSm - kReservedPerBlock - kStaticSmem;
constexpr unsigned kAll = 0xffffffffu;

struct Args {
  const void* x;
  const void* bias;
  const void* dy;
  void* dx;
  void* db;
  float* part;        // [grid, C]: each block's bias-gradient sums
  unsigned* ticket;   // blocks done, zeroed before the launch
  long long rows;     // n * Ho output rows
  int H, W, C, Ho, Wo;
  int bias_bf16;
  // the ring path
  int x_slot;         // bytes of an x row, W * C * sizeof(T)
  int dy_slot;        // bytes of a dy row, Wo * C * sizeof(T)
  int slots;          // x rows the ring holds
  int work;           // floats of the dp rows (D[3])
};

union Bf162Bits {
  uint32_t u;
  __nv_bfloat162 h;
};

// kV consecutive elements as f32: kW 16-byte accesses in f32, one access of
// kV * 2 bytes in bf16
__device__ __forceinline__ void load_vec(const float* p, float (&v)[kV]) {
#pragma unroll
  for (int h = 0; h < kW; ++h) {
    const float4 a = reinterpret_cast<const float4*>(p)[h];
    v[4 * h] = a.x;
    v[4 * h + 1] = a.y;
    v[4 * h + 2] = a.z;
    v[4 * h + 3] = a.w;
  }
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&v)[kV]) {
  uint32_t w[kV / 2];
  if constexpr (kV == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x; w[1] = u.y;
  }
#pragma unroll
  for (int k = 0; k < kV / 2; ++k) {
    Bf162Bits b;
    b.u = w[k];
    v[2 * k] = __low2float(b.h);
    v[2 * k + 1] = __high2float(b.h);
  }
}

__device__ __forceinline__ float4 quad(const float (&v)[kV], int h) {
  return make_float4(v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]);
}

__device__ __forceinline__ void store_vec(float* p, const float (&v)[kV]) {
#pragma unroll
  for (int h = 0; h < kW; ++h) reinterpret_cast<float4*>(p)[h] = quad(v, h);
}

__device__ __forceinline__ uint32_t pack_bf16(const float (&v)[kV], int k) {
  Bf162Bits b;
  b.h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  return b.u;
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&v)[kV]) {
  if constexpr (kV == 8) {
    *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16(v, 0), pack_bf16(v, 1),
                                              pack_bf16(v, 2), pack_bf16(v, 3));
  } else {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v, 0), pack_bf16(v, 1));
  }
}

// dx, written once and not read again: streaming stores
__device__ __forceinline__ void store_dx(float* p, const float (&v)[kV]) {
#pragma unroll
  for (int h = 0; h < kW; ++h) __stcs(reinterpret_cast<float4*>(p) + h, quad(v, h));
}

__device__ __forceinline__ void store_dx(__nv_bfloat16* p, const float (&v)[kV]) {
  if constexpr (kV == 8) {
    __stcs(reinterpret_cast<uint4*>(p),
           make_uint4(pack_bf16(v, 0), pack_bf16(v, 1), pack_bf16(v, 2),
                      pack_bf16(v, 3)));
  } else {
    __stcs(reinterpret_cast<uint2*>(p), make_uint2(pack_bf16(v, 0), pack_bf16(v, 1)));
  }
}

__device__ __forceinline__ float bias_at(const Args& a, int c) {
  return a.bias_bf16
             ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.bias)[c])
             : static_cast<const float*>(a.bias)[c];
}

// ---------------------------------------------------------------------------
// one output row's forward and dp, and the gather of dx
// ---------------------------------------------------------------------------

// The window maxima p of relu(x + b) at output pixel (., wo), channels
// c0.., from input rows r[0..2] (x's type), and their first winning taps
// in row-major order. The first maximum of x + b is the first maximum of
// relu(x + b) where that is positive; where it is not, every tap ties at 0
// and the first, tap 0, wins. So relu applies once, after the 9 taps.
template <typename T>
__device__ __forceinline__ void window_max(const T* const (&r)[3], int wo,
                                           int C, int c0, const float (&b)[kV],
                                           float (&best)[kV], int (&arg)[kV]) {
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    float y[kV];
    load_vec(r[t / 3] + (2 * wo + t % 3) * C + c0, y);
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      const float v = __fadd_rn(y[i], b[i]);
      if (t == 0 || v > best[i]) {
        best[i] = v;
        arg[i] = t;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    if (!(best[i] > 0.f)) {
      best[i] = 0.f;
      arg[i] = 0;
    }
  }
}

// A dp row in shared memory holds an output row's Wo * C values in kW
// planes, plane h holding channels 4h .. 4h+3 of each group of kV: a
// thread's 16-byte accesses then hit consecutive addresses across a warp
// (no bank conflict). `at` = wo * C + c0, `plane` = Wo * C / kW.
__device__ __forceinline__ void load_dp(const float* D, int plane, int at,
                                        float (&v)[kV]) {
#pragma unroll
  for (int h = 0; h < kW; ++h) {
    const float4 a = *reinterpret_cast<const float4*>(D + h * plane + at / kW);
    v[4 * h] = a.x;
    v[4 * h + 1] = a.y;
    v[4 * h + 2] = a.z;
    v[4 * h + 3] = a.w;
  }
}

__device__ __forceinline__ void store_dp(float* D, int plane, int at,
                                         const float (&v)[kV]) {
#pragma unroll
  for (int h = 0; h < kW; ++h) {
    *reinterpret_cast<float4*>(D + h * plane + at / kW) = quad(v, h);
  }
}

// Output row ho's window maxima, winning taps (into A) and dp (into D, in
// planes) at every (wo, channel group) of the row, from input rows r[0..2]
// and dy row g (x's type; shared or global memory), by warps [0, warps).
// A lane takes one task of the row's flattened (wo, group) axis, a warp 32
// consecutive ones; where a pixel's groups do not tile the warp, one halo
// lane at each end forms the neighbouring group's p and t only. The LRN's
// windows take their c-2, c-1, c+kV, c+kV+1 from the adjacent lanes by
// __shfl_sync, first of p, then of t:
//   r = (1 + alpha * window sum of p^2)^-1/2, u = dy r sqrt(r),
//   t = u p r^2, dp = u - 2 alpha beta p (window sum of t),
// the windows summed from c-2 to c+2, zeros past the channel edges.
template <typename T>
__device__ __forceinline__ void form_row(const T* const (&r)[3], const T* g,
                                         const float* bias_s, int C, int Wo,
                                         int warp, int warps, int lane,
                                         float* D, unsigned char* A) {
  const int L = C / kV, tasks = Wo * L, plane = Wo * C / kW;
  const int halo = 32 % L == 0 ? 0 : 1;
  const int per_warp = 32 - 2 * halo;
  const int chunks = (tasks + per_warp - 1) / per_warp;
  for (int k = warp; k < chunks; k += warps) {
    const int q = k * per_warp + lane - halo;
    const bool valid = q >= 0 && q < tasks;
    const int wo = valid ? q / L : 0;
    const int c0 = valid ? (q - wo * L) * kV : 0;
    const int at = wo * C + c0;
    float p[kV], dy[kV];
    int arg[kV];
    if (valid) {
      float b[kV];
      load_vec(bias_s + c0, b);
      window_max(r, wo, C, c0, b, p, arg);
      load_vec(g + at, dy);
    } else {
#pragma unroll
      for (int i = 0; i < kV; ++i) p[i] = dy[i] = 0.f;
    }
    // p at channels c0-2, c0-1 (lane-1's last two) and c0+8, c0+9 (lane+1's
    // first two), zeros past the channel edges; invalid lanes hold zeros
    const bool left = c0 > 0, right = c0 + kV < C;
    float w[kV + 4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float l = __shfl_up_sync(kAll, p[kV - 2 + i], 1);
      const float rt = __shfl_down_sync(kAll, p[i], 1);
      w[i] = left ? l : 0.f;
      w[kV + 2 + i] = right ? rt : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kV; ++i) w[2 + i] = p[i];
    float u[kV], t[kV];
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      float sq = 0.f;
#pragma unroll
      for (int m = 0; m < 5; ++m) sq = __fadd_rn(sq, __fmul_rn(w[i + m], w[i + m]));
      const float rr = rsqrtf(__fadd_rn(kBiasK, __fmul_rn(kAlpha, sq)));
      u[i] = __fmul_rn(dy[i], __fmul_rn(rr, sqrtf(rr)));
      t[i] = __fmul_rn(__fmul_rn(u[i], p[i]), __fmul_rn(rr, rr));
    }
    // t likewise at c0-2 .. c0+9 (a halo lane's own t is right where its
    // neighbour reads it)
    float tw[kV + 4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float l = __shfl_up_sync(kAll, t[kV - 2 + i], 1);
      const float rt = __shfl_down_sync(kAll, t[i], 1);
      tw[i] = left ? l : 0.f;
      tw[kV + 2 + i] = right ? rt : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kV; ++i) tw[2 + i] = t[i];
    if (!valid || lane < halo || lane >= 32 - halo) continue;
    float d[kV];
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      float sum = 0.f;
#pragma unroll
      for (int m = 0; m < 5; ++m) sum = __fadd_rn(sum, tw[i + m]);
      d[i] = __fsub_rn(u[i], __fmul_rn(__fmul_rn(kTwoAlphaBeta, p[i]), sum));
      // relu's mask: a window's maximum lies at its winning tap, so x + b
      // > 0 there exactly where p > 0
      if (!(p[i] > 0.f)) d[i] = 0.f;
    }
    store_dp(D, plane, at, d);
    uint32_t word[kW] = {};
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      word[i / 4] |= static_cast<uint32_t>(arg[i]) << (8 * (i % 4));
    }
    if constexpr (kW == 2) {
      *reinterpret_cast<uint2*>(A + at) = make_uint2(word[0], word[1]);
    } else {
      *reinterpret_cast<uint32_t*>(A + at) = word[0];
    }
  }
}

// One output pixel's dp and winning taps at channels c0.., or none (taps
// 0xff match no tap). The taps stay packed, a byte a channel.
struct Taps {
  float d[kV];
  uint32_t t[kW];
};

__device__ __forceinline__ void load_taps(const float* D, const unsigned char* A,
                                          int plane, int at, bool present,
                                          Taps& o) {
  if (present) {
    load_dp(D, plane, at, o.d);
    if constexpr (kW == 2) {
      const uint2 u = *reinterpret_cast<const uint2*>(A + at);
      o.t[0] = u.x;
      o.t[1] = u.y;
    } else {
      o.t[0] = *reinterpret_cast<const uint32_t*>(A + at);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kV; ++i) o.d[i] = 0.f;
#pragma unroll
    for (int h = 0; h < kW; ++h) o.t[h] = 0xffffffffu;
  }
}

__device__ __forceinline__ void add_tap(float (&acc)[kV], const Taps& o,
                                        unsigned tap) {
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    if (((o.t[i / 4] >> (8 * (i % 4))) & 0xffu) == tap) {
      acc[i] = __fadd_rn(acc[i], o.d[i]);
    }
  }
}

// Add acc to the bias gradient and store it at dx.
template <typename T>
__device__ __forceinline__ void emit_dx(float (&acc)[kV], float (&db)[kV],
                                        T* dx) {
#pragma unroll
  for (int i = 0; i < kV; ++i) db[i] = __fadd_rn(db[i], acc[i]);
  store_dx(dx, acc);
}

// dx of input rows 2h and 2h+1 (those above H) of image n, from output row
// h (dp Dc, taps Ac) and h-1 (Dp, Ap); either may be null. The dp rows hold
// relu's mask already. Task (k, channel group): input columns 2k and 2k+1,
// which output columns k and k-1 reach. Threads [0, active) take the
// tasks, a thread's channels c0 fixed.
template <typename T>
__device__ __forceinline__ void dx_rows(const Args& a, int C, int L, long long n,
                                        int h, const float* Dc,
                                        const unsigned char* Ac, const float* Dp,
                                        const unsigned char* Ap, int tid,
                                        int active, int c0, float (&db)[kV]) {
  const int W = a.W, Wo = a.Wo, tasks = (Wo + 1) * L, plane = Wo * C / kW;
  const bool lower = 2 * h + 1 < a.H;
  T* dx0 = static_cast<T*>(a.dx) + (n * a.H + 2 * h) * W * C + c0;
  T* dx1 = dx0 + static_cast<long long>(W) * C;
  for (int q = tid; q < tasks; q += active) {
    const int k = q / L, at = k * C + c0;
    const bool right = 2 * k + 1 < W;
    Taps c0k, c1k, p0k, p1k;  // (cur, prev) x (column k, column k-1)
    load_taps(Dc, Ac, plane, at, Dc && k < Wo, c0k);
    load_taps(Dc, Ac, plane, at - C, Dc && k > 0, c1k);
    load_taps(Dp, Ap, plane, at, Dp && k < Wo, p0k);
    load_taps(Dp, Ap, plane, at - C, Dp && k > 0, p1k);
    const int w0 = 2 * k * C, w1 = w0 + C;
    float acc[kV];
    // (2h, 2k): taps 0, 2, 6, 8
#pragma unroll
    for (int i = 0; i < kV; ++i) acc[i] = 0.f;
    add_tap(acc, c0k, 0);
    add_tap(acc, c1k, 2);
    add_tap(acc, p0k, 6);
    add_tap(acc, p1k, 8);
    emit_dx(acc, db, dx0 + w0);
    if (right) {  // (2h, 2k+1): taps 1, 7
#pragma unroll
      for (int i = 0; i < kV; ++i) acc[i] = 0.f;
      add_tap(acc, c0k, 1);
      add_tap(acc, p0k, 7);
      emit_dx(acc, db, dx0 + w1);
    }
    if (lower) {  // (2h+1, 2k): taps 3, 5; (2h+1, 2k+1): tap 4
#pragma unroll
      for (int i = 0; i < kV; ++i) acc[i] = 0.f;
      add_tap(acc, c0k, 3);
      add_tap(acc, c1k, 5);
      emit_dx(acc, db, dx1 + w0);
      if (right) {
#pragma unroll
        for (int i = 0; i < kV; ++i) acc[i] = 0.f;
        add_tap(acc, c0k, 4);
        emit_dx(acc, db, dx1 + w1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the bias gradient across blocks
// ---------------------------------------------------------------------------

struct BlockSync {
  __device__ void operator()() const { __syncthreads(); }
};

// the ring path's consumer warps (named barrier 1)
struct ConsumerSync {
  __device__ void operator()() const {
    asm volatile("bar.sync 1, %0;" ::"n"(32 * kConsumerWarps) : "memory");
  }
};

// db holds a thread's sums of the dx it wrote at channels (tid % L) * kV,
// for the threads [0, active), active a multiple of L; red has active * kV
// floats of shared memory; every thread that sync waits for calls this.
// The block's sums go to part row blockIdx.x; the block that takes the last
// ticket sums the rows, each channel group's rows g, g + G, ... by group g
// of G, then the groups in order, and writes db in the bias's type.
template <typename Sync>
__device__ void bias_gradient(const Args& a, const float (&db)[kV], float* red,
                              int tid, int active, int L, Sync sync) {
  __shared__ int last;
  const int C = a.C, c0 = (tid % L) * kV;
  if (tid < active) store_vec(red + tid * kV, db);
  sync();
  if (tid < L) {
    float s[kV];
#pragma unroll
    for (int i = 0; i < kV; ++i) s[i] = 0.f;
    for (int k = tid; k < active; k += L) {
      float v[kV];
      load_vec(red + k * kV, v);
#pragma unroll
      for (int i = 0; i < kV; ++i) s[i] = __fadd_rn(s[i], v[i]);
    }
    store_vec(a.part + static_cast<long long>(blockIdx.x) * C + c0, s);
    __threadfence();
  }
  sync();
  if (tid == 0) last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
  sync();
  if (!last) return;
  __threadfence();
  const int groups = active / L;
  if (tid < active) {
    float s[kV];
#pragma unroll
    for (int i = 0; i < kV; ++i) s[i] = 0.f;
    for (int r = tid / L; r < static_cast<int>(gridDim.x); r += groups) {
      const float4* p = reinterpret_cast<const float4*>(
          a.part + static_cast<long long>(r) * C + c0);
#pragma unroll
      for (int h = 0; h < kW; ++h) {
        const float4 u = __ldcg(p + h);
        s[4 * h] = __fadd_rn(s[4 * h], u.x);
        s[4 * h + 1] = __fadd_rn(s[4 * h + 1], u.y);
        s[4 * h + 2] = __fadd_rn(s[4 * h + 2], u.z);
        s[4 * h + 3] = __fadd_rn(s[4 * h + 3], u.w);
      }
    }
    store_vec(red + tid * kV, s);
  }
  sync();
  if (tid < L) {
    float s[kV];
#pragma unroll
    for (int i = 0; i < kV; ++i) s[i] = 0.f;
    for (int k = tid; k < active; k += L) {
      float v[kV];
      load_vec(red + k * kV, v);
#pragma unroll
      for (int i = 0; i < kV; ++i) s[i] = __fadd_rn(s[i], v[i]);
    }
    if (a.bias_bf16) {
      store_vec(static_cast<__nv_bfloat16*>(a.db) + c0, s);
    } else {
      store_vec(static_cast<float*>(a.db) + c0, s);
    }
  }
}

// ---------------------------------------------------------------------------
// the ring path
// ---------------------------------------------------------------------------

// C = kC, or a.C when kC is 0. Shared memory: the x ring, the dy ring, the
// dp rows of the last three output rows (D, or at the end the bias
// gradient's sums), their winning taps (A), the bias, the mbarriers.
template <typename T, int kC>
__global__ void __launch_bounds__(kThreads, kMaxBlocksPerSm)
pool_lrn_backward_ring(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = kC ? kC : a.C, L = C / kV, Ho = a.Ho, WC = a.Wo * C;
  unsigned char* xring = smem;
  unsigned char* yring = xring + a.slots * a.x_slot;
  float* D = reinterpret_cast<float*>(yring + kDySlots * a.dy_slot);
  unsigned char* A = reinterpret_cast<unsigned char*>(D + a.work);
  float* bias_s = reinterpret_cast<float*>(A + ((3 * WC + 15) & ~15));
  uint64_t* full = reinterpret_cast<uint64_t*>(bias_s + C);
  uint64_t* empty = full + a.slots;
  uint64_t* yfull = empty + a.slots;
  uint64_t* yempty = yfull + kDySlots;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    for (int s = 0; s < a.slots; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    for (int s = 0; s < kDySlots; ++s) {
      mbar_init(&yfull[s], 1);
      mbar_init(&yempty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // this block's run of output rows [row0, row1); its steps start one row
  // earlier where the run starts mid-image, to form that row's dp
  const long long row0 = a.rows * blockIdx.x / gridDim.x;
  const long long row1 = a.rows * (blockIdx.x + 1) / gridDim.x;
  const long long step0 = row0 - (row0 % Ho > 0 ? 1 : 0);

  if (warp == kConsumerWarps) {
    // producer: one thread keeps both rings full. x fetch f goes to slot
    // f % slots in round f / slots; dy fetch g (step g's row) likewise.
    if (lane != 0) return;
    const unsigned char* x = static_cast<const unsigned char*>(a.x);
    const unsigned char* dy = static_cast<const unsigned char*>(a.dy);
    int f = 0, g = 0;
    for (long long j = step0; j < row1; ++j, ++g) {
      const long long n = j / Ho;
      const int ho = static_cast<int>(j - n * Ho);
      const bool first = j == step0 || ho == 0;
      for (int h = first ? 2 * ho : 2 * ho + 1; h <= 2 * ho + 2; ++h, ++f) {
        const int s = f % a.slots, round = f / a.slots;
        if (round > 0) mbar_wait(&empty[s], (round - 1) & 1);
        mbar_arrive_expect_tx(&full[s], a.x_slot);
        bulk_load(xring + s * a.x_slot, x + (n * a.H + h) * a.x_slot,
                  a.x_slot, &full[s]);
      }
      const int s = g % kDySlots, round = g / kDySlots;
      if (round > 0) mbar_wait(&yempty[s], (round - 1) & 1);
      mbar_arrive_expect_tx(&yfull[s], a.dy_slot);
      bulk_load(yring + s * a.dy_slot, dy + j * a.dy_slot, a.dy_slot, &yfull[s]);
    }
    return;
  }

  const ConsumerSync sync{};
  const int active = 32 * kConsumerWarps / L * L;  // whole channel groups
  const int c0 = (tid % L) * kV;
  for (int c = tid; c < C; c += 32 * kConsumerWarps) bias_s[c] = bias_at(a, c);
  sync();
  float db[kV];
#pragma unroll
  for (int i = 0; i < kV; ++i) db[i] = 0.f;

  int f = 0, step = 0;
  for (long long j = step0; j < row1; ++j, ++step) {
    const long long n = j / Ho;
    const int ho = static_cast<int>(j - n * Ho);
    const int f0 = (j == step0 || ho == 0) ? f : f - 1;
    f = f0 + 3;
    const T* rows[3];
#pragma unroll
    for (int dr = 0; dr < 3; ++dr) {
      const int fr = f0 + dr, s = fr % a.slots;
      mbar_wait(&full[s], (fr / a.slots) & 1);
      rows[dr] = reinterpret_cast<const T*>(xring + s * a.x_slot);
    }
    const int ys = step % kDySlots;
    mbar_wait(&yfull[ys], (step / kDySlots) & 1);
    float* Dc = D + (step % 3) * WC;
    unsigned char* Ac = A + (step % 3) * WC;
    form_row(rows, reinterpret_cast<const T*>(yring + ys * a.dy_slot), bias_s,
             C, a.Wo, warp, kConsumerWarps, lane, Dc, Ac);
    // this warp has read the dy row and input rows 2ho and 2ho+1; 2ho+2
    // too unless the next step is the next row of the same image
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(&yempty[ys]);
      mbar_arrive(&empty[f0 % a.slots]);
      mbar_arrive(&empty[(f0 + 1) % a.slots]);
      if (j + 1 == row1 || ho + 1 == Ho) mbar_arrive(&empty[(f0 + 2) % a.slots]);
    }
    // every warp's part of the row is formed; the last gather that read the
    // buffers this step wrote (three steps back) is done
    sync();
    if (j >= row0 && tid < active) {
      const int sp = (step + 2) % 3;
      dx_rows<T>(a, C, L, n, ho, Dc, Ac, ho > 0 ? D + sp * WC : nullptr,
                 A + sp * WC, tid, active, c0, db);
      if (ho + 1 == Ho) {  // the rows below the image's last output row
        dx_rows<T>(a, C, L, n, Ho, nullptr, nullptr, Dc, Ac, tid, active, c0,
                   db);
      }
    }
  }
  sync();  // D is done with: it holds the bias-gradient sums
  bias_gradient(a, db, D, tid, active, L, sync);
}

// ---------------------------------------------------------------------------
// the simple path, for rows too wide for the ring
// ---------------------------------------------------------------------------

// A block of kRowThreads per output row (n, ho), reading x and dy from
// global memory: it forms the dp of output rows ho-1 and ho, then gathers
// input rows 2ho and 2ho+1. Shared memory: the two dp rows (or the bias
// gradient's sums), their taps, the bias.
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
pool_lrn_backward_rows(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = a.C, WC = a.Wo * C, L = C / kV;
  const int tid = threadIdx.x, active = kRowThreads / L * L;
  float* D = reinterpret_cast<float*>(smem);
  unsigned char* A = reinterpret_cast<unsigned char*>(D + a.work);
  float* bias_s = reinterpret_cast<float*>(A + ((2 * WC + 15) & ~15));
  const long long n = blockIdx.x / a.Ho;
  const int ho = static_cast<int>(blockIdx.x - n * a.Ho);
  const T* x = static_cast<const T*>(a.x) + n * a.H * a.W * C;
  const T* dy = static_cast<const T*>(a.dy) + n * a.Ho * WC;
  for (int c = tid; c < C; c += kRowThreads) bias_s[c] = bias_at(a, c);
  __syncthreads();
  for (int slot = ho > 0 ? 0 : 1; slot < 2; ++slot) {
    const int ro = ho - 1 + slot;
    const T* const r[3] = {x + 2 * ro * a.W * C, x + (2 * ro + 1) * a.W * C,
                           x + (2 * ro + 2) * a.W * C};
    form_row(r, dy + ro * WC, bias_s, C, a.Wo, tid / 32, kRowThreads / 32,
             tid % 32, D + slot * WC, A + slot * WC);
  }
  __syncthreads();
  const int c0 = (tid % L) * kV;
  float db[kV];
#pragma unroll
  for (int i = 0; i < kV; ++i) db[i] = 0.f;
  if (tid < active) {
    dx_rows<T>(a, C, L, n, ho, D + WC, A + WC, ho > 0 ? D : nullptr, A, tid,
               active, c0, db);
    if (ho + 1 == a.Ho) {
      dx_rows<T>(a, C, L, n, a.Ho, nullptr, nullptr, D + WC, A + WC, tid,
                 active, c0, db);
    }
  }
  __syncthreads();  // D is done with
  bias_gradient(a, db, D, tid, active, L, BlockSync());
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// The shared-memory opt-in and the grid of one kernel, worked out once per
// device and size.
struct LaunchCache {
  int dev = -1;
  size_t smem = 0;
  int grid = 0;
};

// kernel on a persistent grid of up to max_per_sm blocks per SM, as many as
// fit and no more than output rows, or else on a block per output row;
// returns the CUDA error.
template <typename Kernel>
int launch_kernel(Kernel kernel, int threads, size_t smem, int max_per_sm,
                  LaunchCache& cache, const Args& a, bool persistent,
                  cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev != cache.dev || smem != cache.smem) {
    int sms = 0, per_sm = 0;
    if ((err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             static_cast<int>(smem))) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, threads, smem)) != cudaSuccess) {
      return static_cast<int>(err);
    }
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    cache.dev = dev;
    cache.smem = smem;
    cache.grid = sms * (per_sm < max_per_sm ? per_sm : max_per_sm);
  }
  const long long grid = persistent && a.rows > cache.grid ? cache.grid : a.rows;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<int>(grid), threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The ring path where its rows fit (at least 3 x slots beside the rest),
// else the simple path.
template <typename T>
int launch(Args& a, cudaStream_t stream) {
  const int L = a.C / kV, WC = a.Wo * a.C;
  a.x_slot = a.W * a.C * static_cast<int>(sizeof(T));
  a.dy_slot = WC * static_cast<int>(sizeof(T));
  if (L <= 32 * kConsumerWarps) {
    const int active = 32 * kConsumerWarps / L * L;
    const int work = 3 * WC > active * kV ? 3 * WC : active * kV;
    const long long rest = static_cast<long long>(kDySlots) * a.dy_slot +
                           4LL * work + ((3LL * WC + 15) & ~15LL) +
                           4LL * a.C + 16LL * kDySlots;
    const long long slots = (kSmemPerSm / kMaxBlocksPerSm - kReservedPerBlock -
                             kStaticSmem - rest) /
                            (a.x_slot + 16LL);
    if (slots >= 3) {
      a.work = work;
      a.slots = static_cast<int>(slots < kMaxSlots ? slots : kMaxSlots);
      const size_t smem = static_cast<size_t>(a.slots) * (a.x_slot + 16) + rest;
      static thread_local LaunchCache cache[3];
      if (a.C == 96) {
        return launch_kernel(pool_lrn_backward_ring<T, 96>, kThreads, smem,
                             kMaxBlocksPerSm, cache[0], a, true, stream);
      }
      if (a.C == 256) {
        return launch_kernel(pool_lrn_backward_ring<T, 256>, kThreads, smem,
                             kMaxBlocksPerSm, cache[1], a, true, stream);
      }
      return launch_kernel(pool_lrn_backward_ring<T, 0>, kThreads, smem,
                           kMaxBlocksPerSm, cache[2], a, true, stream);
    }
  }
  const int active = kRowThreads / L * L;
  a.work = 2 * WC > active * kV ? 2 * WC : active * kV;
  const long long smem = 4LL * a.work + ((2LL * WC + 15) & ~15LL) + 4LL * a.C;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  static thread_local LaunchCache cache;
  return launch_kernel(pool_lrn_backward_rows<T>, kRowThreads,
                       static_cast<size_t>(smem), 1, cache, a, false, stream);
}

}  // namespace

// x [n,H,W,C] and dy [n,Ho,Wo,C] (bf16 when bf16 != 0, else f32), bias [C]
// (bf16 when bias_bf16 != 0, else f32), all contiguous; writes dx
// [n,H,W,C] of x's type and db [C] of the bias's type; scratch holds
// n * Ho * C + 4 floats (the blocks' bias-gradient sums, then the ticket);
// all on the current device. C a multiple of 8 up to kMaxC; x, dy, dx,
// db and scratch 16-byte aligned. The ticket is zeroed on the stream before
// the launch.
extern "C" int svt_bias_relu_pool_lrn_backward(const void* x, const void* bias,
                                               const void* dy, void* dx,
                                               void* db, void* scratch, int n,
                                               int H, int W, int C, int bf16,
                                               int bias_bf16, void* stream) {
  if (n <= 0) return 0;
  if (H < 3 || W < 3 || C < 8 || C % 8 || C > kMaxC ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy) |
       reinterpret_cast<uintptr_t>(dx) | reinterpret_cast<uintptr_t>(db) |
       reinterpret_cast<uintptr_t>(scratch)) %
          16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.x = x;
  a.bias = bias;
  a.dy = dy;
  a.dx = dx;
  a.db = db;
  a.H = H;
  a.W = W;
  a.C = C;
  a.Ho = (H - 3) / 2 + 1;
  a.Wo = (W - 3) / 2 + 1;
  a.rows = static_cast<long long>(n) * a.Ho;
  a.bias_bf16 = bias_bf16;
  a.part = static_cast<float*>(scratch);
  a.ticket = reinterpret_cast<unsigned*>(a.part + a.rows * C);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(a.ticket, 0, sizeof(unsigned), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return bf16 ? launch<__nv_bfloat16>(a, s) : launch<float>(a, s);
}
