// Other ways to feed K2's consumer code (svision_tpu_torch/csrc/pool_lrn.cu),
// built and timed against the shipped bulk-copy ring by
// scripts/torch_k2_variants.py. Not on any path of the package.
//
// Build with -I of a directory holding pool_lrn.cu and one of
//   -DK2_CP_ASYNC  all threads fill the same kind of row ring with 16-byte
//                  cp.async, kDepth output rows ahead, one commit group per
//                  output row, staged with __syncthreads (no mbarrier, no
//                  producer warp);
//   -DK2_DIRECT    no staging: every lane loads its 3x3 window straight from
//                  global memory with 16-byte loads, L1 and L2 catching the
//                  overlap of neighbouring windows and rows;
// and -DK2_BLOCKS=<blocks per SM at most>, -DK2_DEPTH=<rows ahead>. The
// persistent grid, the run of output rows per block and the consumer code
// (pool_row) are the shipped kernel's. Only the two tails (C = 96, 256)
// are taken.

#define svt_bias_relu_pool_lrn svt_bias_relu_pool_lrn_ring
#include "pool_lrn.cu"
#undef svt_bias_relu_pool_lrn

#ifndef K2_BLOCKS
#define K2_BLOCKS 2
#endif
#ifndef K2_DEPTH
#define K2_DEPTH 2
#endif

namespace {

constexpr int kBlocks = K2_BLOCKS;
constexpr int kDepth = K2_DEPTH;
constexpr int kVarThreads = 32 * kConsumerWarps;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// The input rows output row j of the run [row0, row1) adds to the ring,
// from fetch f on; returns the next fetch. Nothing past row1.
template <typename T>
__device__ __forceinline__ int fetch_rows(const Args& a, unsigned char* ring,
                                          long long j, long long row0,
                                          long long row1, int f, int tid) {
  if (j >= row1) return f;
  const unsigned char* x = static_cast<const unsigned char*>(a.x);
  const long long x_floor = a.x_bytes & ~15LL;
  const long long n = j / a.Ho;
  const int ho = static_cast<int>(j - n * a.Ho);
  const bool first = j == row0 || ho == 0;
  for (int h = first ? 2 * ho : 2 * ho + 1; h <= 2 * ho + 2; ++h, ++f) {
    unsigned char* slot = ring + (f % a.slots) * a.slot_bytes;
    const long long start = (n * a.H + h) * a.row_bytes;
    const long long end = start + a.row_bytes;
    const long long lo = start & ~15LL;
    const long long copy_end = min((end + 15) & ~15LL, x_floor);
    for (long long b = lo + 16LL * tid; b < copy_end; b += 16LL * kVarThreads)
      cp_async16(slot + (b - lo), x + b);
    constexpr long long kT = sizeof(T);
    for (long long b = max(copy_end, start) + kT * tid; b < end;
         b += kT * kVarThreads) {
      *reinterpret_cast<T*>(slot + (b - lo)) =
          *reinterpret_cast<const T*>(x + b);
    }
  }
  return f;
}

template <typename T, int kC, int kV>
__global__ void __launch_bounds__(kVarThreads)
pool_lrn_cp_async(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int C = kC;
  unsigned char* ring = smem;
  float* bias_s = reinterpret_cast<float*>(smem + a.slots * a.slot_bytes);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long row0 = a.rows * blockIdx.x / gridDim.x;
  const long long row1 = a.rows * (blockIdx.x + 1) / gridDim.x;

  // visible after the first row's __syncthreads
  stage_bias(a, C, bias_s, tid, kVarThreads);
  int fi = 0;
  for (int d = 0; d < kDepth; ++d) {
    fi = fetch_rows<T>(a, ring, row0 + d, row0, row1, fi, tid);
    cp_async_commit();
  }
  // ring slots = 3 * kDepth: the rows of the kDepth - 1 rows ahead and of
  // the row fetched next never reach a slot still being read
  int f = 0, rot = 0;
  for (long long j = row0; j < row1; ++j) {
    const long long n = j / a.Ho;
    const int ho = static_cast<int>(j - n * a.Ho);
    const int f0 = (j == row0 || ho == 0) ? f : f - 1;
    f = f0 + 3;
    cp_async_wait<kDepth - 1>();
    __syncthreads();
    const T* rows[3];
#pragma unroll
    for (int dr = 0; dr < 3; ++dr) {
      const long long start = (n * a.H + 2 * ho + dr) * a.row_bytes;
      rows[dr] = reinterpret_cast<const T*>(
          ring + ((f0 + dr) % a.slots) * a.slot_bytes + (start & 15));
    }
    T* const orow[2] = {static_cast<T*>(a.out) + j * a.Wo * C, nullptr};
    rot = pool_row<T, kV, false, false>(rows, bias_s, orow, C, 0, a.Wo, warp,
                                        lane, rot);
    __syncthreads();
    fi = fetch_rows<T>(a, ring, j + kDepth, row0, row1, fi, tid);
    cp_async_commit();
  }
}

template <typename T, int kC, int kV>
__global__ void __launch_bounds__(kVarThreads)
pool_lrn_direct(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int C = kC;
  float* bias_s = reinterpret_cast<float*>(smem);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  stage_bias(a, C, bias_s, tid, kVarThreads);
  __syncthreads();
  const long long row0 = a.rows * blockIdx.x / gridDim.x;
  const long long row1 = a.rows * (blockIdx.x + 1) / gridDim.x;
  const long long row_elems = a.row_bytes / static_cast<int>(sizeof(T));
  int rot = 0;
  for (long long j = row0; j < row1; ++j) {
    const long long n = j / a.Ho;
    const int ho = static_cast<int>(j - n * a.Ho);
    const T* r0 = static_cast<const T*>(a.x) + (n * a.H + 2 * ho) * row_elems;
    const T* const rows[3] = {r0, r0 + row_elems, r0 + 2 * row_elems};
    T* const orow[2] = {static_cast<T*>(a.out) + j * a.Wo * C, nullptr};
    rot = pool_row<T, kV, false, false>(rows, bias_s, orow, C, 0, a.Wo, warp,
                                        lane, rot);
  }
}

template <typename T, int kC>
int launch_variant(const Args& a, cudaStream_t s) {
  static thread_local LaunchCache cache;
#if defined(K2_CP_ASYNC)
  const size_t smem =
      static_cast<size_t>(a.slots) * a.slot_bytes + sizeof(float) * kC;
  return launch_persistent(pool_lrn_cp_async<T, kC, 8>, kVarThreads, smem,
                           kBlocks, cache, a, s);
#elif defined(K2_DIRECT)
  return launch_persistent(pool_lrn_direct<T, kC, 8>, kVarThreads,
                           sizeof(float) * kC, kBlocks, cache, a, s);
#else
#error "define K2_CP_ASYNC or K2_DIRECT"
#endif
}

template <typename T>
int dispatch_variant(const Args& a, cudaStream_t s) {
  if (a.C == 96) return launch_variant<T, 96>(a, s);
  if (a.C == 256) return launch_variant<T, 256>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The shipped entry point's interface.
extern "C" int svt_bias_relu_pool_lrn(const void* x, const void* bias,
                                      void* out, int n, int H, int W, int C,
                                      int bf16, int bias_bf16, void* stream) {
  if (n <= 0) return 0;
  Args a;
  const int err = make_args(a, x, bias, out, n, H, W, C, bf16, bias_bf16,
                            3 * kDepth);
  if (err) return err;
  if (a.slots < 3 * kDepth) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch_variant<__nv_bfloat16>(a, s)
              : dispatch_variant<float>(a, s);
}
