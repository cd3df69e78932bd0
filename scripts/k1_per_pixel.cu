// K1's per-pixel design, kept as a yardstick for csrc/raster.cu: built
// and timed beside the shipped kernel by scripts/torch_k1_variants.py. Not
// on any path of the package. Build with -I svision_tpu_torch/csrc; its C
// entry has the shipped kernel's name and arguments.
//
// One thread per output pixel, all three channels, so a warp stores 96
// consecutive values, one at a time. Each thread reloads the segments and
// finds its row's column runs (row_run) and its column's lit-row count
// (col_rows_n) itself: about 150 integer operations a pixel at two
// segments, with two or three software divisions per segment.

#include "raster_common.cuh"

namespace {

template <typename T, int S>
__global__ void __launch_bounds__(256)
raster_kernel(const int* __restrict__ ep, const unsigned char* __restrict__ vis,
              const unsigned char* __restrict__ rev, T* __restrict__ out) {
  using namespace svt;
  const int n = blockIdx.x;
  const int pix = blockIdx.y * blockDim.x + threadIdx.x;
  if (pix >= kCanvas * kCanvas) return;
  const int r = pix / kCanvas, c = pix % kCanvas;
  Seg g[S];
  bool ch0 = false, ch2 = false;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    g[s] = load_seg(ep, vis, rev, n, s, S);
    int lo, hi;
    row_run(g[s], r, lo, hi);
    const bool lit = in_run(c, lo, hi);
    ch0 = ch0 || lit;
    ch2 = ch2 || (lit && g[s].rev);
  }
  const bool ch1 = ch0 && col_rows_n<S>(g, c) >= 2;
  T* o = out + ((size_t)n * kCanvas * kCanvas + pix) * 3;
  store_val(o + 0, ch0 ? 1.f : 0.f);
  store_val(o + 1, ch1 ? 1.f : 0.f);
  store_val(o + 2, ch2 ? 1.f : 0.f);
}

template <typename T>
cudaError_t launch(const int* ep, const unsigned char* vis,
                   const unsigned char* rev, T* out, int n, int segs,
                   cudaStream_t stream) {
  const dim3 grid(n, (svt::kCanvas * svt::kCanvas + 255) / 256);
  switch (segs) {
    case 1: raster_kernel<T, 1><<<grid, 256, 0, stream>>>(ep, vis, rev, out); break;
    case 2: raster_kernel<T, 2><<<grid, 256, 0, stream>>>(ep, vis, rev, out); break;
    case 3: raster_kernel<T, 3><<<grid, 256, 0, stream>>>(ep, vis, rev, out); break;
    case 4: raster_kernel<T, 4><<<grid, 256, 0, stream>>>(ep, vis, rev, out); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// ep int32 [n,segs,4], vis/rev bool [n,segs] with 1 <= segs <= 4, out
// [n,227,227,3] (bf16 when bf16 != 0, else f32), all contiguous on the
// current device.
extern "C" int svt_render_raster(const void* ep, const void* vis,
                                 const void* rev, void* out, int n, int segs,
                                 int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* e = static_cast<const int*>(ep);
  const unsigned char* v = static_cast<const unsigned char*>(vis);
  const unsigned char* r = static_cast<const unsigned char*>(rev);
  const cudaError_t err =
      bf16 ? launch(e, v, r, static_cast<__nv_bfloat16*>(out), n, segs, s)
           : launch(e, v, r, static_cast<float*>(out), n, segs, s);
  return static_cast<int>(err);
}
