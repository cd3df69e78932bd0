// K1: the similarity-image raster, endpoints -> {0,1} image [N,227,227,3].
//
// Replaces svision_tpu/ops/pallas_raster.py:render_raster_pallas (kernel
// _raster_kernel, predicate _membership). Plain version:
// svision_tpu_torch/ops/rasterize.py:render_raster; the plain twin of this
// kernel's shared-memory tables is rasterize.py:raster_tables, expanded by
// raster_from_tables.
//
// Bound on an H100: the output write. At B=128 that is 79.1 MB in f32,
// 23.6 us at 3.35 TB/s, and 39.6 MB in bf16, 11.8 us; the inputs are 36
// bytes an image at two segments. The segment count S is a template
// argument, 1 to 4: candidates carry two segments, and training's
// fragmentation (models/train.py) makes four.
//
// Every value depends on a few numbers per row and per column: segment s
// lights one column run [clo, chi] in each image row, and channel 1 keeps
// channel 0 in the columns with at least two lit rows. So the work per
// value is a few bit operations on tables built once per block:
//  * A block takes a band of kBandRows rows of one image: a grid of N x
//    kBands blocks, enough to fill the card at N = 128. S threads
//    normalise the segments (load_seg) into shared memory.
//  * Tables, in shared memory. Each thread of warps 0-7 takes one column
//    and finds whether it holds two or more lit rows (col_rows_n), kept as
//    a 227-bit mask built with warp ballots; the last threads take one
//    (row, segment) each and find that segment's column run in the row
//    (row_run). These are the integer divisions: 227 * S a band for the
//    columns, (kBandRows + 1) * S for the rows. Then (row, word) threads
//    turn the runs into two bit masks a row: the lit pixels and the lit
//    pixels of reverse segments.
//  * Stores: the band's output is a contiguous run of the flat
//    [N*227*227*3] tensor. Its 16-byte-aligned middle goes out as 16-byte
//    vectors (4 f32 or 8 bf16 values: 2 to 4 pixels, across channels and
//    at times across a row end), consecutive threads on consecutive
//    vectors, so a warp writes 512 contiguous bytes, with streaming
//    (evict-first) stores. A block's threads step kThreads vectors, a
//    whole number of pixels, so each thread keeps its channel phase and
//    steps its pixel's row and column without a division. A vector's
//    pixels are a funnel shift of its row's mask: a dark vector, most of
//    them, costs two shared loads and a compare, whatever S is.
//  * Image and band bases are not 16-byte aligned (an image holds 154,587
//    values, an odd number), so the under-16-byte head and tail of each
//    band are written one value at a time by a few threads.
// One launch per call, no allocation, no host synchronisation: the call
// can be captured in a CUDA graph. Times and the variants measured:
// scripts/torch_k1_variants.py, PERF.md.

#include <cstdint>

#include "raster_common.cuh"

namespace {

using svt::kCanvas;

constexpr int kRowElems = 3 * kCanvas;                      // 681
constexpr long long kImageElems = 1LL * kCanvas * kRowElems;  // 154,587
constexpr int kBandRows = 29;
constexpr int kBands = (kCanvas + kBandRows - 1) / kBandRows;   // 8
constexpr int kThreads = 384;
constexpr int kWords = (kCanvas + 31) / 32 + 1;   // a row's bits, then a 0
static_assert(kThreads % 96 == 0,
              "whole warps, and a block's vectors a whole number of pixels");

// Bits q of x at bits 3q (x under 16).
__device__ __forceinline__ unsigned spread3(unsigned x) {
  return (x & 1) | ((x & 2) << 2) | ((x & 4) << 4) | ((x & 8) << 6);
}

// Bits c, c + 1, ... of a row bit mask w[kWords].
__device__ __forceinline__ unsigned bits_from(const unsigned* w, int c) {
  return __funnelshift_r(w[c >> 5], w[(c >> 5) + 1], c & 31);
}

// The 16-byte vector of value bits m (bit i: value i) as 4 f32 or 8 bf16
// values in {0, 1}.
__device__ __forceinline__ uint4 pack_bits(float*, unsigned m) {
  return make_uint4((m & 1) ? 0x3F800000u : 0u, (m & 2) ? 0x3F800000u : 0u,
                    (m & 4) ? 0x3F800000u : 0u, (m & 8) ? 0x3F800000u : 0u);
}
__device__ __forceinline__ uint4 pack_bits(__nv_bfloat16*, unsigned m) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[i] = ((m >> (2 * i)) & 1 ? 0x3F80u : 0u) |
           ((m >> (2 * i + 1)) & 1 ? 0x3F800000u : 0u);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T, int S>
__global__ void __launch_bounds__(kThreads)
raster_kernel(const int* __restrict__ ep, const unsigned char* __restrict__ vis,
              const unsigned char* __restrict__ rev, T* __restrict__ out) {
  using namespace svt;
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kStep = kThreads * kVec / 3;   // pixels a block step advances
  __shared__ Seg seg_s[S];
  // S column runs a row, from row r0 on; one more row for the vectors that
  // end in the next one (rows past the image stay dark)
  __shared__ int2 run_s[kBandRows + 1][S];
  // those rows as bit masks: [0] lit pixels (channel 0), [1] lit pixels
  // of reverse segments (channel 2)
  __shared__ unsigned bits_s[kBandRows + 1][2][kWords];
  __shared__ unsigned dup_s[kWords];   // columns with two or more lit rows

  const int n = blockIdx.x / kBands;
  const int r0 = (blockIdx.x % kBands) * kBandRows;
  const int r1 = min(r0 + kBandRows, kCanvas);
  const int tid = threadIdx.x;

  if (tid < S) seg_s[tid] = load_seg(ep, vis, rev, n, tid, S);
  if (tid == 0) dup_s[kWords - 1] = 0;
  __syncthreads();
  // word w of the column mask on warp w (mod the warps): warp-uniform
  for (int w = tid >> 5; w < kWords - 1; w += kThreads / 32) {
    Seg g[S];
#pragma unroll
    for (int s = 0; s < S; ++s) g[s] = seg_s[s];
    const int c = 32 * w + (tid & 31);
    const bool dup = c < kCanvas && col_rows_n<S>(g, c) >= 2;
    const unsigned bits = __ballot_sync(0xFFFFFFFFu, dup);
    if ((tid & 31) == 0) dup_s[w] = bits;
  }
  // (row, segment) i on thread kThreads - 1 - i, past the column warps
  for (int i = kThreads - 1 - tid; i < (kBandRows + 1) * S; i += kThreads) {
    const int r = r0 + i / S;
    int clo = kCanvas + 1, chi = -1;
    if (r < kCanvas) row_run(seg_s[i % S], r, clo, chi);
    run_s[i / S][i % S] = make_int2(clo, chi);
  }
  __syncthreads();
  unsigned revm = 0;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    revm |= static_cast<unsigned>(seg_s[s].rev) << s;
  }
  for (int i = tid; i < (kBandRows + 1) * kWords; i += kThreads) {
    const int row = i / kWords, w = i % kWords;
    unsigned b0 = 0, b2 = 0;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int2 rr = run_s[row][s];
      const int lo = max(rr.x, 32 * w);
      const int hi = min(rr.y, min(32 * w + 31, kCanvas - 1));
      if (lo <= hi) {
        const unsigned m = ((2u << (hi - lo)) - 1) << (lo - 32 * w);
        b0 |= m;
        b2 |= (revm >> s) & 1 ? m : 0u;
      }
    }
    bits_s[row][0][w] = b0;
    bits_s[row][1][w] = b2;
  }
  __syncthreads();

  // the band's elements [a, b) of the flat output; whole vectors [va, vb)
  const long long img = n * kImageElems;
  const long long a = img + 1LL * r0 * kRowElems;
  const long long b = img + 1LL * r1 * kRowElems;
  const long long va = (a + kVec - 1) / kVec, vb = b / kVec;
  uint4* vout = reinterpret_cast<uint4*>(out);
  long long v = va + tid;
  if (v < vb) {
    // a thread's vectors all start at the same channel and span the same
    // pixel count: its first pixel steps kStep pixels a turn
    const unsigned e = static_cast<unsigned>(v * kVec - img);
    const unsigned ch = e % 3;
    const int npix = (ch + kVec - 1) / 3 + 1;
    const unsigned wide = (1u << npix) - 1;
    const int p0 = e / 3;
    int r = p0 / kCanvas - r0, c = p0 % kCanvas;
    for (; v < vb; v += kThreads) {
      // pixel masks from column c of band row r on; a vector that ends in
      // the next row takes that row's first pixels
      const bool wraps = c + npix > kCanvas;
      unsigned m0 = bits_from(bits_s[r][0], c);
      if (wraps) m0 |= bits_s[r + 1][0][0] << (kCanvas - c);
      m0 &= wide;
      uint4 q = make_uint4(0u, 0u, 0u, 0u);
      if (m0 != 0) {
        unsigned m2 = bits_from(bits_s[r][1], c);
        unsigned d = bits_from(dup_s, c);
        if (wraps) {
          m2 |= bits_s[r + 1][1][0] << (kCanvas - c);
          d |= dup_s[0] << (kCanvas - c);
        }
        const unsigned m =
            spread3(m0) | (spread3(m0 & d) << 1) | (spread3(m2 & wide) << 2);
        q = pack_bits(static_cast<T*>(nullptr), m >> ch);
      }
      __stcs(vout + v, q);   // streaming: written once, read by the next op
      c += kStep % kCanvas;
      r += kStep / kCanvas;
      if (c >= kCanvas) {
        c -= kCanvas;
        ++r;
      }
    }
  }

  // the head [a, ha) and tail [tb, b), each under one vector
  const long long ha = min(va * kVec, b), tb = max(vb * kVec, ha);
  const int nh = static_cast<int>(ha - a), nt = static_cast<int>(b - tb);
  for (int i = tid; i < nh + nt; i += kThreads) {
    const long long at = i < nh ? a + i : tb + (i - nh);
    const int e = static_cast<int>(at - img);
    const int p = e / 3, c = p % kCanvas, row = p / kCanvas - r0;
    const unsigned bit = 1u << (c & 31);
    const bool lit = bits_s[row][0][c >> 5] & bit;
    const int k = e - 3 * p;
    const bool on = k == 0   ? lit
                    : k == 1 ? lit && (dup_s[c >> 5] & bit)
                             : (bits_s[row][1][c >> 5] & bit) != 0;
    store_val(out + at, on ? 1.f : 0.f);
  }
}

template <typename T>
cudaError_t launch(const int* ep, const unsigned char* vis,
                   const unsigned char* rev, T* out, int n, int segs,
                   cudaStream_t stream) {
  const dim3 grid(n * kBands);
  switch (segs) {
    case 1: raster_kernel<T, 1><<<grid, kThreads, 0, stream>>>(ep, vis, rev, out); break;
    case 2: raster_kernel<T, 2><<<grid, kThreads, 0, stream>>>(ep, vis, rev, out); break;
    case 3: raster_kernel<T, 3><<<grid, kThreads, 0, stream>>>(ep, vis, rev, out); break;
    case 4: raster_kernel<T, 4><<<grid, kThreads, 0, stream>>>(ep, vis, rev, out); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// ep int32 [n,segs,4], vis/rev bool [n,segs] with 1 <= segs <= 4, out
// [n,227,227,3] (bf16 when bf16 != 0, else f32), all contiguous on the
// current device, out 16-byte aligned.
extern "C" int svt_render_raster(const void* ep, const void* vis,
                                 const void* rev, void* out, int n, int segs,
                                 int bf16, void* stream) {
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* e = static_cast<const int*>(ep);
  const unsigned char* v = static_cast<const unsigned char*>(vis);
  const unsigned char* r = static_cast<const unsigned char*>(rev);
  const cudaError_t err =
      bf16 ? launch(e, v, r, static_cast<__nv_bfloat16*>(out), n, segs, s)
           : launch(e, v, r, static_cast<float*>(out), n, segs, s);
  return static_cast<int>(err);
}
