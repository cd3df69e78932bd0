// A dispatch's endpoints: candidate specs int64 [n,12] -> clipped pixel
// endpoints int32 [n,2,4], visible bool [n,2], reverse bool [n,2].
//
// Replaces no TPU kernel: the JAX package makes the endpoints on the host
// in numpy (svision_tpu/ops/rasterize.py:specs_to_endpoints, with
// ops/bresenham.py:clip_lines_batch), and so did the port's engine until
// this kernel moved them to the head of each replica's dispatch, where
// the host thread of a data-parallel engine spent half its time on them.
// Plain version: svision_tpu_torch/ops/endpoints.py:specs_endpoints_plain.
//
// The same arithmetic as specs_to_endpoints, bit for bit, per segment:
// the int64 segment rebuild (length = ye - ys; xe = xs +/- (length - 1);
// ye = ys + length - 1), the float64 ratio max(max(read_len, ref_len) /
// 227, 1) with IEEE division (the library is built without fast math),
// each coordinate divided by it and truncated toward zero, cv::clipLine's
// fixed two-phase clip with truncating int64 division (a zero divisor
// gives the dividend, as clip_lines_batch's guarded divide does), the
// int32 wrap of .astype(np.int32), and reverse = !forward. Rows whose
// segment is invisible get the clip's endpoints too, as numpy's do.
//
// Bound on an H100: latency. A row reads 96 bytes and writes 36; a chunk
// of 1,024 rows a card moves 135 KB (40 ns at 3.35 TB/s), far under a
// launch. One thread a row, with no shared memory and no synchronisation,
// so the launch is as short as the card allows; one launch per dispatch,
// no allocation, no host synchronisation, so it is captured in the
// replica's CUDA graph.

#include <cstdint>

#include "raster_common.cuh"

namespace {

using svt::kCanvas;
using svt::kSegs;

constexpr int kThreads = 128;
constexpr int kFields = 12;   // bed columns of a spec
constexpr long long kRight = kCanvas - 1, kBottom = kCanvas - 1;

__device__ __forceinline__ int outcode(long long x, long long y) {
  return (x < 0) | ((x > kRight) << 1) | ((y < 0) << 2) | ((y > kBottom) << 3);
}

// Truncating division; a zero divisor gives the dividend.
__device__ __forceinline__ long long tdiv(long long a, long long b) {
  return b == 0 ? a : a / b;
}

// Coordinate / ratio in float64, truncated toward zero.
__device__ __forceinline__ long long scale(long long v, double ratio) {
  return static_cast<long long>(static_cast<double>(v) / ratio);
}

// cv::clipLine to the canvas in place; returns whether any of the line is
// left. The y overflow of end 1, then of end 2, each with the other's
// coordinates as updated so far, then the x overflow of both.
__device__ __forceinline__ bool clip(long long& x1, long long& y1,
                                     long long& x2, long long& y2) {
  int c1 = outcode(x1, y1), c2 = outcode(x2, y2);
  if ((c1 & c2) == 0 && (c1 | c2) != 0) {
    if (c1 & 12) {
      const long long a = c1 < 8 ? 0 : kBottom;
      x1 += tdiv((a - y1) * (x2 - x1), y2 - y1);
      y1 = a;
    }
    c1 = outcode(x1, y1) & 3;
    if (c2 & 12) {
      const long long a = c2 < 8 ? 0 : kBottom;
      x2 += tdiv((a - y2) * (x2 - x1), y2 - y1);
      y2 = a;
    }
    c2 = outcode(x2, y2) & 3;
    if ((c1 & c2) == 0 && (c1 | c2) != 0) {
      if (c1) {
        const long long a = c1 == 1 ? 0 : kRight;
        y1 += tdiv((a - x1) * (y2 - y1), x2 - x1);
        x1 = a;
        c1 = 0;
      }
      if (c2) {
        const long long a = c2 == 1 ? 0 : kRight;
        y2 += tdiv((a - x2) * (y2 - y1), x2 - x1);
        x2 = a;
        c2 = 0;
      }
    }
  }
  return (c1 | c2) == 0;
}

__global__ void __launch_bounds__(kThreads)
specs_endpoints_rows(const long long* __restrict__ specs,
                     int4* __restrict__ ep, uchar2* __restrict__ vis,
                     uchar2* __restrict__ rev, int n) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= n) return;
  long long v[kFields];
#pragma unroll
  for (int i = 0; i < kFields; ++i) v[i] = __ldg(specs + 1LL * kFields * row + i);
  const long long longest = v[10] > v[11] ? v[10] : v[11];
  const double ratio = fmax(static_cast<double>(longest) / 227.0, 1.0);
  unsigned char lit[kSegs], back[kSegs];
#pragma unroll
  for (int g = 0; g < kSegs; ++g) {
    // x = read axis (image row), y = reference axis (image column)
    const long long xs = v[5 * g], ys = v[5 * g + 2];
    const long long length = v[5 * g + 3] - ys;
    const bool fwd = v[5 * g + 4] != 0;
    const long long xe = fwd ? xs + (length - 1) : xs - (length - 1);
    const long long ye = ys + (length - 1);
    long long c0 = scale(ys, ratio), r0 = scale(xs, ratio);
    long long c1 = scale(ye, ratio), r1 = scale(xe, ratio);
    lit[g] = clip(c0, r0, c1, r1);
    ep[kSegs * row + g] = make_int4(static_cast<int>(c0), static_cast<int>(r0),
                                    static_cast<int>(c1), static_cast<int>(r1));
    back[g] = !fwd;
  }
  vis[row] = make_uchar2(lit[0], lit[1]);
  rev[row] = make_uchar2(back[0], back[1]);
}

}  // namespace

// specs int64 [n,12], ep int32 [n,2,4] (16-byte aligned), vis/rev bool
// [n,2], all contiguous on the current device.
extern "C" int svt_specs_endpoints(const void* specs, void* ep, void* vis,
                                   void* rev, int n, void* stream) {
  if (reinterpret_cast<uintptr_t>(specs) % 8 != 0 ||
      reinterpret_cast<uintptr_t>(ep) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(vis) % 2 != 0 ||
      reinterpret_cast<uintptr_t>(rev) % 2 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (n > 0) {
    specs_endpoints_rows<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(specs), static_cast<int4*>(ep),
        static_cast<uchar2*>(vis), static_cast<uchar2*>(rev), n);
  }
  return static_cast<int>(cudaGetLastError());
}
