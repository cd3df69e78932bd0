// The backward of K2's function, relu(x + bias) -> 3x3 stride-2 VALID
// maxpool -> LRN, channels-last: dx and the bias gradient from x, the bias
// and dy, the gradient of K2's output.
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
// send the gradient elsewhere. Math is f32 inside, with one rounding of dx.
//
// Bound on an H100: bytes. It reads x and dy and writes dx: at batch 64 in
// bf16 83.3 MB at the conv1 tail (24.9 us at 3.35 TB/s) and 53.3 MB at the
// conv2 tail (15.9 us); in f32 twice that. Design, simple first:
// - Nothing of the forward is saved. A block takes one output row (n, ho)
//   and recomputes y's window maxima, their positions, p and v for output
//   rows ho-1 and ho into shared memory, then dp for both rows.
// - Gather, don't scatter: input row r receives from output rows r/2 - 1
//   and r/2 (even r) or (r-1)/2 (odd r), so the block writes input rows 2ho
//   and 2ho+1 (the image's last block also the rows below), each dx once,
//   with no atomics, the window taps summed in row-major order.
// - A thread owns kV = 8 consecutive channels (one 16-byte bf16 access,
//   two f32 ones; so C % 8 == 0 and 16-byte aligned x, dy and dx) and steps
//   over the pixels of a row in groups; its 9 window taps are 9
//   independent loads. A thread per channel with scalar loads, the first
//   design, was latency-bound (PERF.md).
// - The bias gradient: each block sums its dx per channel in a fixed order
//   into one f32 row of a [n * Ho, C] partial; the wrapper sums the rows.
// - Above 48 KB of shared memory (the conv2 tail: 62 KB) the launch opts in
//   once per device and size, before any CUDA graph capture, because the
//   trainers' first steps run eagerly.

#include <atomic>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kAlpha = 2e-5f;
constexpr float kBiasK = 1.0f;
constexpr float kTwoAlphaBeta = 3e-5f;  // 2 * alpha * beta
constexpr int kV = 8;                   // channels a thread
constexpr int kGroupThreads = 384;      // threads a block, in whole groups
constexpr int kMinBlocks = 2;           // blocks an SM holds
constexpr int kMaxSmem = 227 * 1024;
constexpr int kMaxDevices = 64;

struct Args {
  const void* x;
  const void* bias;
  const void* dy;
  void* dx;
  float* db_part;  // [n * Ho, C]
  int H, W, C, Ho, Wo;
  int bias_bf16;
};

union Bf162Bits {
  uint32_t u;
  __nv_bfloat162 h;
};

// kV consecutive elements as f32, in one 16-byte access (two in f32)
__device__ __forceinline__ void load_vec(const float* p, float (&v)[kV]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&v)[kV]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    Bf162Bits b;
    b.u = w[k];
    v[2 * k] = __low2float(b.h);
    v[2 * k + 1] = __high2float(b.h);
  }
}

__device__ __forceinline__ void store_vec(float* p, const float (&v)[kV]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&v)[kV]) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    Bf162Bits b;
    b.h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    w[k] = b.u;
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// q[c0-2 .. c0+kV+1] of one pixel's row of C values in shared memory, zeros
// past the edges
__device__ __forceinline__ void window(const float* q, int c0, int C,
                                       float (&w)[kV + 4]) {
  w[0] = c0 >= 2 ? q[c0 - 2] : 0.f;
  w[1] = c0 >= 1 ? q[c0 - 1] : 0.f;
  load_vec(q + c0, reinterpret_cast<float(&)[kV]>(w[2]));
  w[kV + 2] = c0 + kV < C ? q[c0 + kV] : 0.f;
  w[kV + 3] = c0 + kV + 1 < C ? q[c0 + kV + 1] : 0.f;
}

// A block per output row (n, ho); threads = L * G with L = C / kV lanes a
// pixel, so a thread keeps its channels c0 = (tid % L) * kV over its tasks.
template <typename T>
__global__ void __launch_bounds__(kGroupThreads, kMinBlocks)
pool_lrn_backward(const Args a, int red_floats) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = a.C, Wo = a.Wo, WC = Wo * C, L = C / kV;
  const int tid = threadIdx.x, threads = blockDim.x;
  const int c0 = (tid % L) * kV;
  float* bias_s = reinterpret_cast<float*>(smem);
  float* P = bias_s + C;     // p of the output row being formed
  float* Q = P + WC;         // its dy p v^(-beta-1)
  float* red = P;            // later: the bias gradient's per-thread sums
  float* D = P + red_floats; // u = dy v^-beta, then dp, of rows ho-1 and ho
  unsigned char* A = reinterpret_cast<unsigned char*>(D + 2 * WC);

  const long long n = blockIdx.x / a.Ho;
  const int ho = static_cast<int>(blockIdx.x - n * a.Ho);
  const T* x = static_cast<const T*>(a.x);
  const T* dy = static_cast<const T*>(a.dy);
  T* dx = static_cast<T*>(a.dx);
  for (int i = tid; i < C; i += threads) {
    bias_s[i] = a.bias_bf16
                    ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.bias)[i])
                    : static_cast<const float*>(a.bias)[i];
  }
  __syncthreads();
  float b[kV];
  load_vec(bias_s + c0, b);

  // dp of output rows ho-1 (slot 0) and ho (slot 1)
  const int tasks = Wo * L;
  for (int slot = ho > 0 ? 0 : 1; slot < 2; ++slot) {
    const int ro = ho - 1 + slot;
    const long long top = (n * a.H + 2 * ro) * a.W;  // pixel (n, 2ro, 0)
    float* Ds = D + slot * WC;
    unsigned char* As = A + slot * WC;
    for (int q = tid; q < tasks; q += threads) {
      const int wo = q / L, at = wo * C + c0;  // (wo, c0) in the row
      float best[kV];
      int arg[kV];
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const long long pix = top + (t / 3) * a.W + 2 * wo + t % 3;
        float y[kV];
        load_vec(x + pix * C + c0, y);
#pragma unroll
        for (int i = 0; i < kV; ++i) {
          const float v = fmaxf(0.f, __fadd_rn(y[i], b[i]));
          if (t == 0 || v > best[i]) {
            best[i] = v;
            arg[i] = t;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kV; ++i) As[at + i] = static_cast<unsigned char>(arg[i]);
      store_vec(P + at, best);
    }
    __syncthreads();
    const long long orow = (n * a.Ho + ro) * Wo;
    for (int q = tid; q < tasks; q += threads) {
      const int at = (q / L) * C + c0;
      float w[kV + 4], g[kV], u[kV], t[kV];
      window(P + (q / L) * C, c0, C, w);
      load_vec(dy + orow * C + at, g);
#pragma unroll
      for (int i = 0; i < kV; ++i) {
        float sq = 0.f;
#pragma unroll
        for (int j = 0; j < 5; ++j) sq = __fadd_rn(sq, __fmul_rn(w[i + j], w[i + j]));
        const float r = rsqrtf(__fadd_rn(kBiasK, __fmul_rn(kAlpha, sq)));
        u[i] = __fmul_rn(g[i], __fmul_rn(r, sqrtf(r)));
        t[i] = __fmul_rn(__fmul_rn(u[i], w[i + 2]), __fmul_rn(r, r));
      }
      store_vec(Q + at, t);
      store_vec(Ds + at, u);
    }
    __syncthreads();
    for (int q = tid; q < tasks; q += threads) {
      const int at = (q / L) * C + c0;
      float w[kV + 4], p[kV], d[kV];
      window(Q + (q / L) * C, c0, C, w);
      load_vec(P + at, p);
      load_vec(Ds + at, d);
#pragma unroll
      for (int i = 0; i < kV; ++i) {
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < 5; ++j) s = __fadd_rn(s, w[i + j]);
        d[i] = __fsub_rn(d[i], __fmul_rn(__fmul_rn(kTwoAlphaBeta, p[i]), s));
      }
      store_vec(Ds + at, d);
    }
    __syncthreads();
  }

  // input rows 2ho and 2ho+1, and in the image's last block every row below
  const int rows = (ho + 1 == a.Ho ? a.H : 2 * ho + 2) - 2 * ho;
  const int row_tasks = a.W * L;
  float db[kV];
#pragma unroll
  for (int i = 0; i < kV; ++i) db[i] = 0.f;
  for (int q = tid; q < rows * row_tasks; q += threads) {
    const int r = 2 * ho + q / row_tasks;
    const int w = (q % row_tasks) / L;
    float acc[kV];
#pragma unroll
    for (int i = 0; i < kV; ++i) acc[i] = 0.f;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int rr = r - t / 3, cc = w - t % 3;
      if (rr < 0 || cc < 0 || (rr & 1) || (cc & 1)) continue;
      const int ro = rr >> 1, wo = cc >> 1;
      if (ro >= a.Ho || wo >= Wo) continue;
      const int i0 = (ro - ho + 1) * WC + wo * C + c0;  // ro is ho-1 or ho
      float d[kV];
      load_vec(D + i0, d);
#pragma unroll
      for (int i = 0; i < kV; ++i) {
        if (A[i0 + i] == t) acc[i] = __fadd_rn(acc[i], d[i]);
      }
    }
    const long long at = ((n * a.H + r) * a.W + w) * C + c0;
    float xv[kV];
    load_vec(x + at, xv);
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      if (!(__fadd_rn(xv[i], b[i]) > 0.f)) acc[i] = 0.f;
      db[i] = __fadd_rn(db[i], acc[i]);
    }
    store_vec(dx + at, acc);
  }
  store_vec(red + tid * kV, db);  // P and Q are done with
  __syncthreads();
  if (tid < L) {
    float s[kV];
#pragma unroll
    for (int i = 0; i < kV; ++i) s[i] = 0.f;
    for (int k = tid; k < threads; k += L) {
#pragma unroll
      for (int i = 0; i < kV; ++i) s[i] = __fadd_rn(s[i], red[k * kV + i]);
    }
    store_vec(a.db_part + static_cast<long long>(blockIdx.x) * C + c0, s);
  }
}

// Bytes of dynamic shared memory each instantiation was opted into, per
// device; the first launch at a size sets it.
std::atomic<int> opted[2][kMaxDevices];

template <typename T>
int launch(const Args& a, long long blocks, int slot, cudaStream_t stream) {
  const int L = a.C / kV;
  const int threads = kGroupThreads / L * L;
  const long long wc = static_cast<long long>(a.Wo) * a.C;
  // P and Q, or the per-thread sums after them; D; A; and the bias
  const long long red = wc * 2 > threads * kV ? wc * 2 : threads * kV;
  const long long smem = 4 * (a.C + red + 2 * wc) + 2 * wc;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = pool_lrn_backward<T>;
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
    if (opted[slot][dev].load() < smem) {
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      opted[slot][dev].store(static_cast<int>(smem));
    }
  }
  kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      a, static_cast<int>(red));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [n,H,W,C] and dy [n,Ho,Wo,C] (bf16 when bf16 != 0, else f32), bias [C]
// (bf16 when bias_bf16 != 0, else f32), all contiguous; writes dx
// [n,H,W,C] of x's type and db_part [n*Ho, C] f32 (the bias gradient's
// per-row partial sums); all on the current device. C a multiple of 8 up
// to 8 * 384; x, dy, dx and db_part 16-byte aligned.
extern "C" int svt_bias_relu_pool_lrn_backward(const void* x, const void* bias,
                                               const void* dy, void* dx,
                                               void* db_part, int n, int H,
                                               int W, int C, int bf16,
                                               int bias_bf16, void* stream) {
  if (n <= 0) return 0;
  if (H < 3 || W < 3 || C < kV || C % kV || C / kV > kGroupThreads ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy) |
       reinterpret_cast<uintptr_t>(dx) | reinterpret_cast<uintptr_t>(db_part)) %
          16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.x = x;
  a.bias = bias;
  a.dy = dy;
  a.dx = dx;
  a.db_part = static_cast<float*>(db_part);
  a.H = H;
  a.W = W;
  a.C = C;
  a.Ho = (H - 3) / 2 + 1;
  a.Wo = (W - 3) / 2 + 1;
  a.bias_bf16 = bias_bf16;
  const long long blocks = static_cast<long long>(n) * a.Ho;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(a, blocks, 0, s)
              : launch<float>(a, blocks, 1, s);
}
