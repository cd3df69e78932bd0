// The sparse layer of a V-MoE (svision_tpu_torch/models/vit.py, Riquelme et
// al., NeurIPS 2021): y + sum_j g_j MLP_{e_j}(u) over each token's top-k
// experts, as four kernels around two grouped matrix products.
//
// Replaces no TPU kernel: the JAX package runs no mixture of experts. The
// port added the layer with the V-MoE-B/16 configuration, and these
// kernels because the engine captures each replica's step once in a CUDA
// graph (svision_tpu_torch/graphs.py) while the rows each expert gets
// change with every batch. So the routing, the experts' offsets, the
// gather into expert order and the weighted combine run here, on the
// card, with fixed shapes and no host synchronisation; the grouped
// products (torch._grouped_mm) read the offsets from device memory.
// Plain versions: svision_tpu_torch/ops/moe.py (*_plain), which a CPU
// tensor goes to.
//
//   moe_route_kernel     router logits f32 [T,E] -> each token's top-k
//                        experts (largest logit first, the lower index on
//                        ties) and gates softmax(logits)[e] (not
//                        renormalised); each (token, j)'s rank among the
//                        pairs of its block of kRouteTokens tokens that
//                        chose its expert, in (token, j) order; the
//                        block's count of each expert. The last block to
//                        finish (a ticket) turns the counts into each
//                        block's first slot of each expert, writes the
//                        experts' cumulative ends (the grouped products'
//                        offsets) and adds each expert's rows into the
//                        replica's histogram. Bound by latency: 3.9 MB at
//                        128 images a batch.
//   moe_dispatch_kernel  a warp a token: its slot for each j (its block's
//                        first slot of the expert plus its rank), and its
//                        row of u copied to each slot of xs [T*k, D], in
//                        16-byte vectors. Bound by bytes.
//   moe_bias_gelu_kernel in place over the first product's [T*k, M]: each
//                        row adds its expert's bias (its expert found from
//                        the offsets) and takes the exact GELU, in f32,
//                        rounded once to bf16. Bound by bytes.
//   moe_combine_kernel   a warp a token: y + sum_j g_j (h[slot_j] +
//                        b2[e_j]) in f32, rounded once to bf16, in token
//                        order, so no atomics and the same answer whatever
//                        the order of rows within an expert. Bound by bytes.
//
// Slots follow (expert, token, j) order, so the plain version's stable sort
// gives the same slots bit for bit. bf16 activations only; the wrappers
// raise on anything else.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRouteTokens = 128;   // a route block's tokens: ops/moe.py ROUTE_TOKENS
constexpr int kMaxExperts = 128;
constexpr int kMaxK = 8;
constexpr int kWarps = kRouteTokens / 32;
constexpr int kCopyThreads = 256;   // dispatch and combine: 8 tokens a block
constexpr int kRowThreads = 128;    // bias-GELU: a row a block

__global__ void __launch_bounds__(kRouteTokens)
moe_route_kernel(const float* __restrict__ logits, int tokens, int experts,
                 int k, int* __restrict__ top, float* __restrict__ gates,
                 int* __restrict__ ranks, int* __restrict__ bases,
                 int* __restrict__ offsets, long long* __restrict__ hist,
                 unsigned int* __restrict__ ticket) {
  __shared__ int warp_count[kWarps][kMaxExperts];
  __shared__ int start[kMaxExperts];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = blockIdx.x * kRouteTokens + threadIdx.x;
  const bool live = t < tokens;

  int sel[kMaxK];
  int rank[kMaxK];
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) sel[j] = -1, rank[j] = 0;
  if (live) {
    const float* row = logits + static_cast<size_t>(t) * experts;
    float m = -INFINITY;
    for (int e = 0; e < experts; ++e) m = fmaxf(m, row[e]);
    float sum = 0.f;
    for (int e = 0; e < experts; ++e) sum += expf(row[e] - m);
    // pick j: the largest (logit, -index) below pick j - 1's
    float pv = 0.f;
    int pe = -1;
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) {
      if (j < k) {
        float bv = 0.f;
        int be = -1;
        for (int e = 0; e < experts; ++e) {
          const float v = row[e];
          const bool below = pe < 0 || v < pv || (v == pv && e > pe);
          if (below && (be < 0 || v > bv)) bv = v, be = e;
        }
        sel[j] = be;
        top[t * k + j] = be;
        gates[t * k + j] = expf(bv - m) / sum;
        pv = bv, pe = be;
      }
    }
  }
  // each pair's rank among its warp's pairs of its expert, and the warp's
  // count of each expert; a token's k experts differ
  const unsigned lower = (1u << lane) - 1u;
  for (int e = 0; e < experts; ++e) {
    unsigned any = 0u;
#pragma unroll
    for (int j = 0; j < kMaxK; ++j)
      if (j < k) any |= __ballot_sync(0xffffffffu, sel[j] == e);
#pragma unroll
    for (int j = 0; j < kMaxK; ++j)
      if (j < k && sel[j] == e) rank[j] = __popc(any & lower);
    if (lane == 0) warp_count[warp][e] = __popc(any);
  }
  __syncthreads();
  // the block's count of each expert; each warp's first rank in it
  for (int e = threadIdx.x; e < experts; e += kRouteTokens) {
    int run = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_count[w][e];
      warp_count[w][e] = run;
      run += c;
    }
    bases[blockIdx.x * experts + e] = run;
  }
  __syncthreads();
  if (live) {
#pragma unroll
    for (int j = 0; j < kMaxK; ++j)
      if (j < k) ranks[t * k + j] = rank[j] + warp_count[warp][sel[j]];
  }

  // the last block turns every block's counts into its first slots
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int blocks = gridDim.x;
  for (int e = threadIdx.x; e < experts; e += kRouteTokens) {
    int total = 0;
    for (int b = 0; b < blocks; ++b) total += __ldcg(bases + b * experts + e);
    start[e] = total;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int e = 0; e < experts; ++e) {
      const int c = start[e];
      start[e] = run;
      run += c;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < experts; e += kRouteTokens) {
    int run = start[e];
    for (int b = 0; b < blocks; ++b) {
      const int c = __ldcg(bases + b * experts + e);
      bases[b * experts + e] = run;
      run += c;
    }
    offsets[e] = run;
    if (hist != nullptr) hist[e] += run - start[e];
  }
}

__device__ __forceinline__ void unpack(const uint4& v, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x, f[2 * i + 1] = p.y;
  }
}

__device__ __forceinline__ uint4 pack(const float* f) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}

__global__ void __launch_bounds__(kCopyThreads)
moe_dispatch_kernel(const uint4* __restrict__ u, int tokens, int vecs,
                    int experts, int k, const int* __restrict__ top,
                    const int* __restrict__ ranks,
                    const int* __restrict__ bases, int* __restrict__ slots,
                    uint4* __restrict__ xs) {
  const int lane = threadIdx.x & 31;
  const int t = (blockIdx.x * kCopyThreads + threadIdx.x) >> 5;
  if (t >= tokens) return;   // whole warps: the shuffles below stay full
  int mine = 0;
  if (lane < k) {
    const int e = top[t * k + lane];
    mine = bases[(t / kRouteTokens) * experts + e] + ranks[t * k + lane];
    slots[t * k + lane] = mine;
  }
  int slot[kMaxK];
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) slot[j] = __shfl_sync(0xffffffffu, mine, j);
  const uint4* src = u + static_cast<size_t>(t) * vecs;
  for (int c = lane; c < vecs; c += 32) {
    const uint4 v = __ldg(src + c);
#pragma unroll
    for (int j = 0; j < kMaxK; ++j)
      if (j < k) xs[static_cast<size_t>(slot[j]) * vecs + c] = v;
  }
}

__global__ void __launch_bounds__(kRowThreads)
moe_bias_gelu_kernel(uint4* __restrict__ h, const uint4* __restrict__ bias,
                     int vecs, int experts, const int* __restrict__ offsets) {
  const int r = blockIdx.x;
  // the row's expert: the first whose cumulative end lies past it
  int lo = 0, hi = experts;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(offsets + mid) <= r) lo = mid + 1; else hi = mid;
  }
  uint4* row = h + static_cast<size_t>(r) * vecs;
  const uint4* b = bias + static_cast<size_t>(lo) * vecs;
  for (int c = threadIdx.x; c < vecs; c += kRowThreads) {
    float x[8], y[8];
    unpack(row[c], x);
    unpack(__ldg(b + c), y);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float v = __fadd_rn(x[i], y[i]);
      x[i] = __fmul_rn(__fmul_rn(v, 0.5f),
                       __fadd_rn(1.f, erff(__fmul_rn(v, 0.70710678118654752f))));
    }
    row[c] = pack(x);
  }
}

__global__ void __launch_bounds__(kCopyThreads)
moe_combine_kernel(const uint4* __restrict__ y, const uint4* __restrict__ h,
                   const uint4* __restrict__ bias, const int* __restrict__ top,
                   const float* __restrict__ gates,
                   const int* __restrict__ slots, int tokens, int vecs, int k,
                   uint4* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int t = (blockIdx.x * kCopyThreads + threadIdx.x) >> 5;
  if (t >= tokens) return;
  int s = 0, e = 0;
  float g = 0.f;
  if (lane < k) {
    s = slots[t * k + lane];
    e = top[t * k + lane];
    g = gates[t * k + lane];
  }
  int slot[kMaxK], expert[kMaxK];
  float gate[kMaxK];
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) {
    slot[j] = __shfl_sync(0xffffffffu, s, j);
    expert[j] = __shfl_sync(0xffffffffu, e, j);
    gate[j] = __shfl_sync(0xffffffffu, g, j);
  }
  for (int c = lane; c < vecs; c += 32) {
    float acc[8], x[8], b[8];
    unpack(__ldg(y + static_cast<size_t>(t) * vecs + c), acc);
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) {
      if (j < k) {
        unpack(__ldg(h + static_cast<size_t>(slot[j]) * vecs + c), x);
        unpack(__ldg(bias + static_cast<size_t>(expert[j]) * vecs + c), b);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          acc[i] = __fadd_rn(acc[i], __fmul_rn(gate[j], __fadd_rn(x[i], b[i])));
      }
    }
    out[static_cast<size_t>(t) * vecs + c] = pack(acc);
  }
}

int blocks_of(long long threads, int per_block) {
  return static_cast<int>((threads + per_block - 1) / per_block);
}

}  // namespace

extern "C" {

// logits f32 [tokens, experts] -> top, ranks int32 [tokens, k], gates f32
// [tokens, k], bases int32 [blocks, experts], offsets int32 [experts];
// hist int64 [experts] (or null) gains each expert's rows; ticket one
// zeroed uint32.
int svt_moe_route(const void* logits, void* top, void* gates, void* ranks,
                  void* bases, void* offsets, void* hist, void* ticket,
                  int tokens, int experts, int k, void* stream) {
  if (tokens < 1 || experts < 1 || experts > kMaxExperts || k < 1 ||
      k > kMaxK || k > experts)
    return static_cast<int>(cudaErrorInvalidValue);
  moe_route_kernel<<<blocks_of(tokens, kRouteTokens), kRouteTokens, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), tokens, experts, k,
      static_cast<int*>(top), static_cast<float*>(gates),
      static_cast<int*>(ranks), static_cast<int*>(bases),
      static_cast<int*>(offsets), static_cast<long long*>(hist),
      static_cast<unsigned int*>(ticket));
  return static_cast<int>(cudaGetLastError());
}

// u bf16 [tokens, dim] -> xs bf16 [tokens * k, dim] in expert order, slots
// int32 [tokens, k]; dim a multiple of 8, u and xs 16-byte aligned.
int svt_moe_dispatch(const void* u, const void* top, const void* ranks,
                     const void* bases, void* slots, void* xs, int tokens,
                     int dim, int experts, int k, void* stream) {
  if (tokens < 1 || dim % 8 || k < 1 || k > kMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  moe_dispatch_kernel<<<blocks_of(32LL * tokens, kCopyThreads), kCopyThreads,
                        0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(u), tokens, dim / 8, experts, k,
      static_cast<const int*>(top), static_cast<const int*>(ranks),
      static_cast<const int*>(bases), static_cast<int*>(slots),
      static_cast<uint4*>(xs));
  return static_cast<int>(cudaGetLastError());
}

// h bf16 [rows, dim] in place: gelu(h + bias[expert of the row]), bias bf16
// [experts, dim]; dim a multiple of 8, both 16-byte aligned.
int svt_moe_bias_gelu(void* h, const void* bias, const void* offsets,
                      int rows, int dim, int experts, void* stream) {
  if (rows < 1 || dim % 8 || experts < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  moe_bias_gelu_kernel<<<rows, kRowThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(h), static_cast<const uint4*>(bias), dim / 8,
      experts, static_cast<const int*>(offsets));
  return static_cast<int>(cudaGetLastError());
}

// out bf16 [tokens, dim] = y + sum_j gates[:, j] (h[slots[:, j]] +
// bias[top[:, j]]); dim a multiple of 8, every tensor 16-byte aligned.
int svt_moe_combine(const void* y, const void* h, const void* bias,
                    const void* top, const void* gates, const void* slots,
                    void* out, int tokens, int dim, int k, void* stream) {
  if (tokens < 1 || dim % 8 || k < 1 || k > kMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  moe_combine_kernel<<<blocks_of(32LL * tokens, kCopyThreads), kCopyThreads,
                       0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(y), static_cast<const uint4*>(h),
      static_cast<const uint4*>(bias), static_cast<const int*>(top),
      static_cast<const float*>(gates), static_cast<const int*>(slots),
      tokens, dim / 8, k, static_cast<uint4*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
