// Closed-form Bresenham membership shared by the raster kernels
// (raster.cu, conv1_raster.cu). Device-side twin of the plain PyTorch
// formulation in svision_tpu_torch/ops/rasterize.py ("runs" form of
// render_raster_s2d), which is bit-exact against the JAX package.
//
// A segment is a clipped line (c0, r0, c1, r1) on the 227x227 canvas,
// normalized left to right as cv.line does. For major-axis index i its
// minor-axis offset is k(i) = max(0, ceil((2*minor*i - major) / (2*major))).
// Every image row then holds one column run of a segment and every image
// column one row run, so a pixel test is two compares and the duplication
// channel's per-column lit-row count is the union size of the segments' row
// runs (two for a candidate, up to four for fragmented training segments).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace svt {

constexpr int kCanvas = 227;
constexpr int kSegs = 2;

// Floor division for a positive divisor. CUDA's / and % truncate toward
// zero, and the numerators below are negative (k(0) has num = -major).
__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

struct Seg {
  int c0n, r0n, sy, major, minor;
  bool xmajor, vis, rev;
};

// Segment s of image n from endpoints int32 [N,segs,4] and bool [N,segs]
// flags.
__device__ __forceinline__ Seg load_seg(const int* __restrict__ ep,
                                        const unsigned char* __restrict__ vis,
                                        const unsigned char* __restrict__ rev,
                                        int n, int s, int segs = kSegs) {
  const int* e = ep + (n * segs + s) * 4;
  const int c0 = e[0], r0 = e[1], c1 = e[2], r1 = e[3];
  const bool swap = c1 < c0;
  Seg g;
  g.c0n = swap ? c1 : c0;
  g.r0n = swap ? r1 : r0;
  const int r1n = swap ? r0 : r1;
  const int dx = (swap ? c0 : c1) - g.c0n;
  const int dy = r1n - g.r0n;
  const int ady = dy < 0 ? -dy : dy;
  g.sy = dy >= 0 ? 1 : -1;
  g.xmajor = dx >= ady;
  g.major = max(dx, ady);
  g.minor = min(dx, ady);
  g.vis = vis[n * segs + s] != 0;
  g.rev = rev[n * segs + s] != 0;
  return g;
}

// Minor-axis offset k(i).
__device__ __forceinline__ int k_of(const Seg& g, int i) {
  if (g.major == 0) return 0;
  return max(0, -floordiv(-(2 * g.minor * i - g.major), 2 * g.major));
}

// Inverse of k: the run [ilo, ihi] of major-axis indices with k(i) == j.
__device__ __forceinline__ void k_runs(const Seg& g, int j, int& ilo,
                                       int& ihi) {
  if (g.minor == 0) {
    ilo = 0;
    ihi = g.major;
    return;
  }
  const int den = 2 * g.minor;
  ilo = max(0, floordiv(g.major * (2 * j - 1), den) + 1);
  ihi = min(g.major, floordiv(g.major * (2 * j + 1), den));
}

// Column run [clo, chi] that segment g lights in image row r (empty when
// clo > chi).
__device__ __forceinline__ void row_run(const Seg& g, int r, int& clo,
                                        int& chi) {
  const int j = g.sy * (r - g.r0n);
  if (!g.vis || j < 0 || j > (g.xmajor ? g.minor : g.major)) {
    clo = kCanvas + 1;
    chi = -1;
    return;
  }
  if (g.xmajor) {
    int ilo, ihi;
    k_runs(g, j, ilo, ihi);
    clo = g.c0n + ilo;
    chi = g.c0n + ihi;
  } else {
    clo = chi = g.c0n + k_of(g, j);
  }
}

// Row run [rlo, rhi] that segment g lights in image column c (empty when
// rlo > rhi).
__device__ __forceinline__ void col_run(const Seg& g, int c, int& rlo,
                                        int& rhi) {
  const int i = c - g.c0n;
  if (!g.vis || i < 0 || i > (g.xmajor ? g.major : g.minor)) {
    rlo = 1;
    rhi = 0;
    return;
  }
  int lo, hi;
  if (g.xmajor) {
    lo = hi = k_of(g, i);
  } else {
    k_runs(g, i, lo, hi);
  }
  const int ra = g.r0n + g.sy * lo, rb = g.r0n + g.sy * hi;
  rlo = min(ra, rb);
  rhi = max(ra, rb);
}

// Lit rows of channel 0 in image column c: the union of both segments'
// row runs (inclusion-exclusion).
__device__ __forceinline__ int col_rows(const Seg& a, const Seg& b, int c) {
  int alo, ahi, blo, bhi;
  col_run(a, c, alo, ahi);
  col_run(b, c, blo, bhi);
  const int inter = max(min(ahi, bhi) - max(alo, blo) + 1, 0);
  return max(ahi - alo + 1, 0) + max(bhi - blo + 1, 0) - inter;
}

// Lit rows of channel 0 in image column c over S segments: the size of the
// union of their row runs. Inclusion-exclusion holds for two runs only, so
// the runs are sorted by start (a fixed bubble network: static register
// indices) and each adds the rows past the furthest end before it.
template <int S>
__device__ __forceinline__ int col_rows_n(const Seg* g, int c) {
  if constexpr (S == 2) {
    return col_rows(g[0], g[1], c);
  } else {
    int lo[S], hi[S];
#pragma unroll
    for (int s = 0; s < S; ++s) col_run(g[s], c, lo[s], hi[s]);
#pragma unroll
    for (int i = 0; i < S - 1; ++i) {
#pragma unroll
      for (int j = 0; j < S - 1 - i; ++j) {
        if (lo[j] > lo[j + 1]) {
          const int tl = lo[j], th = hi[j];
          lo[j] = lo[j + 1];
          hi[j] = hi[j + 1];
          lo[j + 1] = tl;
          hi[j + 1] = th;
        }
      }
    }
    int rows = 0, end = -1;   // rows are >= 0
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (lo[s] > hi[s]) continue;   // empty run
      rows += max(hi[s] - max(lo[s], end + 1) + 1, 0);
      end = max(end, hi[s]);
    }
    return rows;
  }
}

// Whether pixel column c lies in the run [lo, hi].
__device__ __forceinline__ bool in_run(int c, int lo, int hi) {
  return c >= lo && c <= hi;
}

__device__ __forceinline__ void store_val(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_val(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ float load_val(const float* p) { return *p; }
__device__ __forceinline__ float load_val(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

}  // namespace svt
