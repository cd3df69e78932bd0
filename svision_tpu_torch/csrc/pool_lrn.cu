// K2: relu(x + bias) -> 3x3 stride-2 VALID maxpool -> LRN, channels-last.
//
// Replaces svision_tpu/ops/fused_pool_lrn.py:76 bias_relu_pool_lrn (kernel
// _kernel, _pool_rows, _lrn_f32). Plain version:
// svision_tpu_torch/ops/fused_pool_lrn.py:bias_relu_pool_lrn_plain.
// LRN has TF semantics: p / (1 + 2e-5 * sum_{c-2..c+2} p^2)^0.75. Math is
// f32 inside with one rounding at the output, in the plain version's order
// (window summed c-2..c+2 left to right, rsqrtf, r * sqrt(r)), so bf16 is
// bit-equal to it.
//
// Bound on an H100: bytes. At B=128 in bf16 the conv1 tail moves 92.3 MB
// (27.5 us at 3.35 TB/s) and the conv2 tail 58.9 MB (17.6 us); in f32 twice
// that. A block per output row with scalar loads was held back by load
// latency, not bandwidth: too few bytes in flight per SM, each input row
// fetched 1.5 times, nothing overlapped inside a block. So:
// - Persistent grid, one or two blocks per SM. Each block walks a
//   contiguous run of output rows in flattened (n, ho) order. Consecutive
//   rows of one image share input row 2ho+2, so a block fetches two new
//   input rows per output row, and three only where its run starts or
//   crosses into the next image.
// - A producer warp fills a ring of input-row slots in shared memory, one
//   1-D bulk copy (cp.async.bulk) per row, completed on a full mbarrier;
//   consumer warps free a slot on its empty mbarrier (bulk_ring.cuh, shared
//   with the backward). Up to `slots` rows
//   (tens of KB) are in flight per block while the current rows are pooled.
// - Consumer lanes each own V consecutive channels of one output pixel (V
//   = 8 on the main path: 16-byte shared loads for the 3x3 window, one
//   16-byte store). The window's max is taken on the raw inputs (bf16 two
//   at a time) and the bias added once after it, which gives the same
//   value since rounding x + b is monotone in x. The LRN's c-2, c-1, c+V,
//   c+V+1 neighbours come from the adjacent lanes by __shfl_sync. Where a
//   pixel's lanes do not tile the warp (96 channels = 12 lanes), a warp
//   covers 30 lanes' work with one halo lane on each side.
// - C is a template parameter for the two tails (96, 256); one runtime-C
//   instance per vector width (8, 4, 2, 1 channels) takes any other C.
//   A row whose byte length is not a multiple of 16 is copied from its
//   16-byte-aligned cover, and the bytes past the tensor's last 16-byte
//   boundary are loaded by the producer thread itself.
// - The split network (models/alexnet.py) keeps conv2's two groups apart,
//   as two contiguous NHWC tensors of C/2 channels. Two template forms
//   read or write such halves in place, so that nothing joins or copies
//   them around the kernel. kSplitIn: a row arrives as two bulk copies,
//   one a half, into one slot, half 1 after half 0; a lane reads its
//   channels in its half with the half's pixel stride. The lanes keep
//   their channel order, so the LRN's neighbours across the boundary
//   come from the same shuffles. kSplitOut: a lane stores its channels
//   to its half. Either takes C % 16 == 0, so that no lane of 8 channels
//   straddles the halves and each half's row is a multiple of 16 bytes.
//   With both false the kernel is the joined one.
// The constants below were chosen by scripts/torch_k2_variants.py on the
// card (PERF.md has the sweep). The same script times the simpler fills of
// scripts/k2_variants.cu, which share pool_row: a ring filled with 16-byte
// cp.async by all threads, and no staging at all. Both were slower. The
// launch opts into more than 48 KB of dynamic shared memory once per
// instantiation and size.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bulk_ring.cuh"

namespace {

using namespace svt;

constexpr float kAlpha = 2e-5f;
constexpr float kBiasK = 1.0f;
constexpr int kConsumerWarps = 8;
constexpr int kThreads = 32 * (kConsumerWarps + 1);  // + one producer warp
constexpr int kMaxSlots = 6;
constexpr int kMaxBlocksPerSm = 2;
constexpr int kMaxSmem = 227 * 1024;
constexpr unsigned kAll = 0xffffffffu;

struct Args {
  const void* x;
  const void* bias;
  void* out;
  long long rows;     // n * Ho output rows
  long long x_bytes;  // n * H * row_bytes
  int H, C, Ho, Wo;
  int row_bytes;      // W * C * sizeof(T)
  int slot_bytes;     // a multiple of 16
  int slots;
  int bias_bf16;
  const void* x1;     // the split forms: channel half 1 of x (x is half 0)
  void* out1;         // and of out
  int half_bytes;     // W * C/2 * sizeof(T): a half's row, a multiple of 16
};

// ---------------------------------------------------------------------------
// V consecutive elements, in one access of V * sizeof(T) bytes
// ---------------------------------------------------------------------------

template <int V>
__device__ __forceinline__ void load_f32(const float* p, float (&v)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      const float4 f = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = f.x;
      v[4 * i + 1] = f.y;
      v[4 * i + 2] = f.z;
      v[4 * i + 3] = f.w;
    }
  } else if constexpr (V == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x;
    v[1] = f.y;
  } else {
    v[0] = *p;
  }
}

union Bf162Bits {
  uint32_t u;
  __nv_bfloat162 h;
};

__device__ __forceinline__ __nv_bfloat162 bf162_of(uint32_t u) {
  Bf162Bits b;
  b.u = u;
  return b.h;
}

// The 3x3 window's max of the raw inputs at r[dr] + dc * stride, as f32.
// (Adding the bias after the max gives the value of adding it before:
// rounding x + b is monotone in x.) bf16 takes the max two values at once.
template <int V>
__device__ __forceinline__ void window_max(const __nv_bfloat16* const (&r)[3],
                                           int stride, float (&m)[V]) {
  if constexpr (V == 1) {
    __nv_bfloat16 acc = r[0][0];
#pragma unroll
    for (int t = 1; t < 9; ++t) acc = __hmax(acc, r[t / 3][(t % 3) * stride]);
    m[0] = __bfloat162float(acc);
  } else {
    constexpr int P = V / 2;
    __nv_bfloat162 acc[P];
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const __nv_bfloat16* q = r[t / 3] + (t % 3) * stride;
      uint32_t w[P];
      if constexpr (P == 4) {
        const uint4 u = *reinterpret_cast<const uint4*>(q);
        w[0] = u.x;
        w[1] = u.y;
        w[2] = u.z;
        w[3] = u.w;
      } else if constexpr (P == 2) {
        const uint2 u = *reinterpret_cast<const uint2*>(q);
        w[0] = u.x;
        w[1] = u.y;
      } else {
        w[0] = *reinterpret_cast<const uint32_t*>(q);
      }
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const __nv_bfloat162 v = bf162_of(w[k]);
        acc[k] = t ? __hmax2(acc[k], v) : v;
      }
    }
#pragma unroll
    for (int k = 0; k < P; ++k) {
      m[2 * k] = __low2float(acc[k]);
      m[2 * k + 1] = __high2float(acc[k]);
    }
  }
}

template <int V>
__device__ __forceinline__ void window_max(const float* const (&r)[3],
                                           int stride, float (&m)[V]) {
  load_f32<V>(r[0], m);
#pragma unroll
  for (int t = 1; t < 9; ++t) {
    float v[V];
    load_f32<V>(r[t / 3] + (t % 3) * stride, v);
#pragma unroll
    for (int i = 0; i < V; ++i) m[i] = fmaxf(m[i], v[i]);
  }
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  Bf162Bits b;
  b.h = __floats2bfloat162_rn(lo, hi);
  return b.u;
}

template <int V>
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, const float (&v)[V]) {
  if constexpr (V == 8) {
    *reinterpret_cast<uint4*>(p) = make_uint4(
        pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
        pack2(v[6], v[7]));
  } else if constexpr (V == 4) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack2(v[0], v[1]),
                                              pack2(v[2], v[3]));
  } else if constexpr (V == 2) {
    *reinterpret_cast<uint32_t*>(p) = pack2(v[0], v[1]);
  } else {
    *p = __float2bfloat16_rn(v[0]);
  }
}

template <int V>
__device__ __forceinline__ void store_f32(float* p, const float (&v)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      reinterpret_cast<float4*>(p)[i] =
          make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
    }
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// ---------------------------------------------------------------------------
// one output row
// ---------------------------------------------------------------------------

// The bias as f32, staged in shared memory by threads [0, threads).
__device__ __forceinline__ void stage_bias(const Args& a, int C, float* bias_s,
                                           int tid, int threads) {
  for (int c = tid; c < C; c += threads) {
    bias_s[c] = a.bias_bf16
                    ? __bfloat162float(
                          static_cast<const __nv_bfloat16*>(a.bias)[c])
                    : static_cast<const float*>(a.bias)[c];
  }
}

// Output row orow[0] (Wo pixels of C channels) from input rows r[0..2], by
// kConsumerWarps warps. A lane owns kV channels (one group) of one output
// pixel; lane task q runs along the row's flattened (wo, group) axis. Chunk
// k of the row goes to warp (rot + k) % kConsumerWarps; returns the next
// row's rot, which turns so that no warp always takes the extra chunk.
// kSplitIn: each input row holds half 1's pixels half_elems elements after
// half 0's; kSplitOut: orow[0] and orow[1] are the row's two halves.
template <typename T, int kV, bool kSplitIn, bool kSplitOut>
__device__ __forceinline__ int pool_row(const T* const (&r)[3],
                                        const float* bias_s,
                                        T* const (&orow)[2], int C,
                                        int half_elems, int Wo, int warp,
                                        int lane, int rot) {
  const int L = C / kV;                       // groups per pixel
  const int tasks = Wo * L;
  const int reach = kV >= 2 ? 1 : 2;          // neighbour groups the LRN needs
  const int halo = 32 % L == 0 ? 0 : reach;   // pixels tile the warp: none
  const int per_warp = 32 - 2 * halo;
  const int chunks = (tasks + per_warp - 1) / per_warp;
  for (int k = (warp - rot + kConsumerWarps) % kConsumerWarps; k < chunks;
       k += kConsumerWarps) {
    const int q = k * per_warp + lane - halo;
    const bool valid = q >= 0 && q < tasks;
    const int wo = valid ? q / L : 0;
    const int c0 = (q - wo * L) * kV;
    float p[kV];
#pragma unroll
    for (int i = 0; i < kV; ++i) p[i] = 0.f;
    if (valid) {
      int off, stride = C;
      if constexpr (kSplitIn) {
        const int hi = c0 >= C / 2;
        stride = C / 2;
        off = hi * half_elems + 2 * wo * stride + c0 - hi * stride;
      } else {
        off = 2 * wo * C + c0;
      }
      const T* const win[3] = {r[0] + off, r[1] + off, r[2] + off};
      float m[kV], b[kV];
      window_max<kV>(win, stride, m);
      load_f32<kV>(bias_s + c0, b);
      // relu then max == max(0, max(x) + b)
#pragma unroll
      for (int i = 0; i < kV; ++i) p[i] = fmaxf(0.f, __fadd_rn(m[i], b[i]));
    }
    // the LRN window's neighbours: channels c0-2, c0-1 from the lanes
    // before, c0+kV, c0+kV+1 from the lanes after
    float l2, l1, r1, r2;
    if constexpr (kV >= 2) {
      l2 = __shfl_up_sync(kAll, p[kV - 2], 1);
      l1 = __shfl_up_sync(kAll, p[kV - 1], 1);
      r1 = __shfl_down_sync(kAll, p[0], 1);
      r2 = __shfl_down_sync(kAll, p[1], 1);
    } else {
      l2 = __shfl_up_sync(kAll, p[0], 2);
      l1 = __shfl_up_sync(kAll, p[0], 1);
      r1 = __shfl_down_sync(kAll, p[0], 1);
      r2 = __shfl_down_sync(kAll, p[0], 2);
    }
    if (valid && lane >= halo && lane < 32 - halo) {
      float w[kV + 4];
      w[0] = c0 >= 2 ? l2 : 0.f;
      w[1] = c0 >= 1 ? l1 : 0.f;
#pragma unroll
      for (int i = 0; i < kV; ++i) w[i + 2] = p[i];
      w[kV + 2] = c0 + kV < C ? r1 : 0.f;
      w[kV + 3] = c0 + kV + 1 < C ? r2 : 0.f;
      float o[kV];
#pragma unroll
      for (int i = 0; i < kV; ++i) {
        // window sum in the order of alexnet.lrn: c-2, c-1, c, c+1, c+2
        float s = 0.f;
#pragma unroll
        for (int t = 0; t < 5; ++t) s = __fadd_rn(s, __fmul_rn(w[i + t], w[i + t]));
        const float rs = rsqrtf(__fadd_rn(kBiasK, __fmul_rn(kAlpha, s)));
        o[i] = __fmul_rn(p[i], __fmul_rn(rs, sqrtf(rs)));
      }
      if constexpr (kSplitOut) {
        const int hi = c0 >= C / 2;
        store_f32<kV>(orow[hi] + wo * (C / 2) + c0 - hi * (C / 2), o);
      } else {
        store_f32<kV>(orow[0] + wo * C + c0, o);
      }
    }
  }
  return (rot + chunks) % kConsumerWarps;
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// C = kC, or a.C when kC is 0; kV channels per lane, kV | C; the split
// forms as in the header note.
template <typename T, int kC, int kV, bool kSplitIn, bool kSplitOut>
__global__ void __launch_bounds__(kThreads, kMaxBlocksPerSm)
pool_lrn_ring(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = kC ? kC : a.C;
  unsigned char* ring = smem;
  float* bias_s = reinterpret_cast<float*>(smem + a.slots * a.slot_bytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(bias_s + ((C + 3) & ~3));
  uint64_t* empty = full + a.slots;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    for (int s = 0; s < a.slots; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // this block's run of output rows; fetch f (a count of input rows in the
  // order the run needs them) goes to slot f % slots, in round f / slots
  const long long row0 = a.rows * blockIdx.x / gridDim.x;
  const long long row1 = a.rows * (blockIdx.x + 1) / gridDim.x;

  if (warp == kConsumerWarps) {
    // producer: one thread keeps the ring full
    if (lane != 0) return;
    const unsigned char* x = static_cast<const unsigned char*>(a.x);
    const long long x_floor = a.x_bytes & ~15LL;
    int f = 0;
    for (long long j = row0; j < row1; ++j) {
      const long long n = j / a.Ho;
      const int ho = static_cast<int>(j - n * a.Ho);
      const bool first = j == row0 || ho == 0;
      for (int h = first ? 2 * ho : 2 * ho + 1; h <= 2 * ho + 2; ++h, ++f) {
        const int s = f % a.slots, round = f / a.slots;
        if (round > 0) mbar_wait(&empty[s], (round - 1) & 1);
        unsigned char* slot = ring + s * a.slot_bytes;
        if constexpr (kSplitIn) {
          // each half's rows are 16-byte multiples from 16-byte-aligned
          // bases: a whole bulk copy each, nothing past either tensor
          const long long start = (n * a.H + h) * a.half_bytes;
          mbar_arrive_expect_tx(&full[s], 2u * a.half_bytes);
          bulk_load(slot, x + start, a.half_bytes, &full[s]);
          bulk_load(slot + a.half_bytes,
                    static_cast<const unsigned char*>(a.x1) + start,
                    a.half_bytes, &full[s]);
          continue;
        }
        const long long start = (n * a.H + h) * a.row_bytes;
        const long long end = start + a.row_bytes;
        const long long lo = start & ~15LL;
        const long long copy_end = min((end + 15) & ~15LL, x_floor);
        // bytes past the tensor's last 16-byte boundary: no bulk copy
        // may read beyond the tensor
        if (max(copy_end, start) < end) {
          for (long long b = max(copy_end, start); b < end;
               b += static_cast<long long>(sizeof(T))) {
            *reinterpret_cast<T*>(slot + (b - lo)) =
                *reinterpret_cast<const T*>(x + b);
          }
          // order these stores before later bulk copies into the slot
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        }
        const uint32_t bytes = static_cast<uint32_t>(max(copy_end - lo, 0LL));
        mbar_arrive_expect_tx(&full[s], bytes);
        if (bytes) bulk_load(slot, x + lo, bytes, &full[s]);
      }
    }
    return;
  }

  // consumers stage the bias while the first rows are in flight
  stage_bias(a, C, bias_s, tid, 32 * kConsumerWarps);
  asm volatile("bar.sync 1, %0;" ::"n"(32 * kConsumerWarps) : "memory");

  int f = 0, rot = 0;
  for (long long j = row0; j < row1; ++j) {
    const long long n = j / a.Ho;
    const int ho = static_cast<int>(j - n * a.Ho);
    const int f0 = (j == row0 || ho == 0) ? f : f - 1;
    f = f0 + 3;
    const T* rows[3];
#pragma unroll
    for (int dr = 0; dr < 3; ++dr) {
      const int fr = f0 + dr, s = fr % a.slots;
      mbar_wait(&full[s], (fr / a.slots) & 1);
      // a split row starts on its slot; a joined one at its offset from
      // its 16-byte cover
      const long long start =
          kSplitIn ? 0 : (n * a.H + 2 * ho + dr) * a.row_bytes;
      rows[dr] = reinterpret_cast<const T*>(ring + s * a.slot_bytes +
                                            (start & 15));
    }
    T* orow[2];
    if constexpr (kSplitOut) {
      orow[0] = static_cast<T*>(a.out) + j * a.Wo * (C / 2);
      orow[1] = static_cast<T*>(a.out1) + j * a.Wo * (C / 2);
    } else {
      orow[0] = static_cast<T*>(a.out) + j * a.Wo * C;
      orow[1] = nullptr;
    }
    rot = pool_row<T, kV, kSplitIn, kSplitOut>(
        rows, bias_s, orow, C, a.half_bytes / static_cast<int>(sizeof(T)),
        a.Wo, warp, lane, rot);

    // free rows 2ho and 2ho+1; 2ho+2 too unless the next row of this run
    // is the next row of the same image
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(&empty[f0 % a.slots]);
      mbar_arrive(&empty[(f0 + 1) % a.slots]);
      if (j + 1 == row1 || ho + 1 == a.Ho) mbar_arrive(&empty[(f0 + 2) % a.slots]);
    }
  }
}

// The shared-memory opt-in and the grid of one kernel, worked out once per
// device and size.
struct LaunchCache {
  int dev = -1;
  size_t smem = 0;
  int grid = 0;
};

// kernel on a persistent grid of up to max_per_sm blocks per SM, as many as
// fit, and no more blocks than output rows.
template <typename Kernel>
int launch_persistent(Kernel kernel, int threads, size_t smem, int max_per_sm,
                      LaunchCache& cache, const Args& a, cudaStream_t stream) {
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
  const long long grid = a.rows < cache.grid ? a.rows : cache.grid;
  kernel<<<static_cast<int>(grid), threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kC, int kV, bool kSplitIn = false,
          bool kSplitOut = false>
int launch(const Args& a, cudaStream_t stream) {
  static thread_local LaunchCache cache;
  const size_t smem = static_cast<size_t>(a.slots) * a.slot_bytes +
                      sizeof(float) * ((a.C + 3) & ~3) +
                      2 * sizeof(uint64_t) * a.slots;
  return launch_persistent(pool_lrn_ring<T, kC, kV, kSplitIn, kSplitOut>,
                           kThreads, smem, kMaxBlocksPerSm, cache, a, stream);
}

template <typename T>
int dispatch(const Args& a, cudaStream_t s) {
  if (a.C == 96) return launch<T, 96, 8>(a, s);
  if (a.C == 256) return launch<T, 256, 8>(a, s);
  if (a.C % 8 == 0) return launch<T, 0, 8>(a, s);
  if (a.C % 4 == 0) return launch<T, 0, 4>(a, s);
  if (a.C % 2 == 0) return launch<T, 0, 2>(a, s);
  return launch<T, 0, 1>(a, s);
}

// the split forms, C % 16 == 0: 8 channels a lane
template <typename T, bool kSplitIn, bool kSplitOut>
int dispatch_split(const Args& a, cudaStream_t s) {
  if (a.C == 96) return launch<T, 96, 8, kSplitIn, kSplitOut>(a, s);
  if (a.C == 256) return launch<T, 256, 8, kSplitIn, kSplitOut>(a, s);
  return launch<T, 0, 8, kSplitIn, kSplitOut>(a, s);
}

template <typename T>
int dispatch_form(const Args& a, cudaStream_t s) {
  return a.x1 ? dispatch_split<T, true, false>(a, s)
              : dispatch_split<T, false, true>(a, s);
}

// The entry point's arguments as Args, with a ring of up to max_slots row
// slots in kMaxSmem; cudaErrorInvalidValue for a shape the kernel does
// not take.
int make_args(Args& a, const void* x, const void* bias, void* out, int n,
              int H, int W, int C, int bf16, int bias_bf16, int max_slots) {
  const long long row_bytes =
      static_cast<long long>(W) * C * (bf16 ? 2 : 4);
  if (H < 3 || W < 3 || C < 1 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      row_bytes > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.x = x;
  a.bias = bias;
  a.out = out;
  a.H = H;
  a.C = C;
  a.Ho = (H - 3) / 2 + 1;
  a.Wo = (W - 3) / 2 + 1;
  a.rows = static_cast<long long>(n) * a.Ho;
  a.row_bytes = static_cast<int>(row_bytes);
  a.x_bytes = static_cast<long long>(n) * H * row_bytes;
  // a row whose length is not a multiple of 16 lands in its 16-byte cover
  a.slot_bytes = static_cast<int>(
      row_bytes % 16 == 0 ? row_bytes : (row_bytes + 15) / 16 * 16 + 16);
  const long long extra = 4LL * ((C + 3) & ~3);
  long long slots = (kMaxSmem - extra) / (a.slot_bytes + 16);
  if (slots < 3) return static_cast<int>(cudaErrorInvalidValue);
  a.slots = static_cast<int>(slots < max_slots ? slots : max_slots);
  a.bias_bf16 = bias_bf16;
  a.x1 = nullptr;
  a.out1 = nullptr;
  a.half_bytes = static_cast<int>(row_bytes / 2);
  return 0;
}

}  // namespace

// x [n,H,W,C] (bf16 when bf16 != 0, else f32), contiguous and 16-byte
// aligned; bias [C] (bf16 when bias_bf16 != 0, else f32); out [n,Ho,Wo,C]
// of x's type, contiguous; all on the current device.
extern "C" int svt_bias_relu_pool_lrn(const void* x, const void* bias,
                                      void* out, int n, int H, int W, int C,
                                      int bf16, int bias_bf16, void* stream) {
  if (n <= 0) return 0;
  Args a;
  const int err = make_args(a, x, bias, out, n, H, W, C, bf16, bias_bf16,
                            kMaxSlots);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(a, s) : dispatch<float>(a, s);
}

// svt_bias_relu_pool_lrn with x or out as two channel halves, C % 16 == 0:
// x1 non-null reads x as halves x [n,H,W,C/2] and x1, or out1 non-null
// writes out as halves out [n,Ho,Wo,C/2] and out1; every half contiguous
// and 16-byte aligned.
extern "C" int svt_bias_relu_pool_lrn_split(const void* x, const void* x1,
                                            const void* bias, void* out,
                                            void* out1, int n, int H, int W,
                                            int C, int bf16, int bias_bf16,
                                            void* stream) {
  if (n <= 0) return 0;
  if (C % 16 != 0 || (x1 != nullptr) == (out1 != nullptr) ||
      reinterpret_cast<uintptr_t>(x1) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out1) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  const int err = make_args(a, x, bias, out, n, H, W, C, bf16, bias_bf16,
                            kMaxSlots);
  if (err) return err;
  a.x1 = x1;
  a.out1 = out1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch_form<__nv_bfloat16>(a, s)
              : dispatch_form<float>(a, s);
}
