// K4 upfirdn2d: zero-insert upsample -> pad/crop -> FIR correlate ->
// decimate, for NCHW images, in one pass.
//
// Replaces (JAX): panic3d_tpu/ops/upfirdn2d.py:upfirdn2d (:238) and its three
// per-case lowerings (_fir_conv, _fir_unrolled, _fir_poly_up, dispatched at
// :211). On the slice's path it runs inside upsample2d (:286, the skip-image
// upsample of every synthesis block) and conv2d_resample(up=2) (ops/conv.py:48,
// before each upsampling 3x3 conv).
//
// What bounds it on the H100: bytes. The slice's filter is the 4x4
// [1,3,3,1] outer product; with up=2 only 4 of its 16 taps meet a non-zero
// input, so a call does ~4 multiply-adds per output pixel and reads each
// input pixel once. The largest call (SR block 1: [2,256,256,256] bf16 in,
// [2,256,514,514] bf16 out) moves ~334 MB, so it is bound by HBM bandwidth.
//
// Design: one block per 32x32 output tile of one (n, c) image. The block
// stages the input window the tile needs (tile footprint / up, plus the
// filter halo) in shared memory as f32, zero outside the image, so each input
// pixel is read from device memory once per tile. Each thread computes 4
// outputs of a column, skipping the taps that land on inserted zeros, with
// f32 accumulation; the result is stored in the input's dtype.
#include "common.cuh"

namespace {

constexpr int TILE = 32;
constexpr int ROWS = 8;   // blockDim.y; each thread computes TILE / ROWS outputs
constexpr int MAX_TAPS = 64;

struct Taps { float f[MAX_TAPS]; };   // [fh][fw], flipped and gained: correlate

template <typename T>
__global__ void __launch_bounds__(TILE * ROWS) upfirdn2d_kernel(
    const T* __restrict__ x, T* __restrict__ y, int H, int W, int OH, int OW,
    int upx, int upy, int downx, int downy, int px0, int py0, int fw, int fh,
    Taps taps, int tw, int th) {
  extern __shared__ float tile[];
  const long long nc = blockIdx.z;
  const int ox0 = blockIdx.x * TILE, oy0 = blockIdx.y * TILE;
  // input coordinates of the window's top-left corner
  const int ix0 = floor_div(ox0 * downx - px0, upx);
  const int iy0 = floor_div(oy0 * downy - py0, upy);
  const T* src = x + nc * H * W;
  for (int i = threadIdx.y * TILE + threadIdx.x; i < tw * th; i += TILE * ROWS) {
    const int iy = iy0 + i / tw, ix = ix0 + i % tw;
    tile[i] = (iy >= 0 && iy < H && ix >= 0 && ix < W) ? to_f(src[(long long)iy * W + ix]) : 0.f;
  }
  __syncthreads();

  const int ox = ox0 + threadIdx.x;
  if (ox >= OW) return;
  T* dst = y + nc * OH * OW;
  for (int oy = oy0 + threadIdx.y; oy < oy0 + TILE && oy < OH; oy += ROWS) {
    float acc = 0.f;
    for (int a = 0; a < fh; ++a) {
      const int Y = oy * downy + a - py0;   // row in the zero-inserted image
      if (floor_mod(Y, upy) != 0) continue;
      const int ty = floor_div(Y, upy) - iy0;
      for (int b = 0; b < fw; ++b) {
        const int X = ox * downx + b - px0;
        if (floor_mod(X, upx) != 0) continue;
        acc = fmaf(taps.f[a * fw + b], tile[ty * tw + floor_div(X, upx) - ix0], acc);
      }
    }
    dst[(long long)oy * OW + ox] = from_f<T>(acc);
  }
}

template <typename T>
cudaError_t launch(const void* x, void* y, int NC, int H, int W, int OH, int OW, int upx,
                   int upy, int downx, int downy, int px0, int py0, int fw, int fh,
                   const Taps& taps, cudaStream_t stream) {
  // window the tile needs: input rows from floor((oy0*down - py0)/up) to
  // floor(((oy0+TILE-1)*down + fh-1 - py0)/up), at most this many
  const int tw = ((TILE - 1) * downx + fw - 1) / upx + 2;
  const int th = ((TILE - 1) * downy + fh - 1) / upy + 2;
  const size_t smem = (size_t)tw * th * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(upfirdn2d_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((OW + TILE - 1) / TILE, (OH + TILE - 1) / TILE, NC);
  upfirdn2d_kernel<T><<<grid, dim3(TILE, ROWS), smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), H, W, OH, OW, upx, upy, downx, downy,
      px0, py0, fw, fh, taps, tw, th);
  return cudaGetLastError();
}

}  // namespace

// x: [NC, H, W] (f32 or bf16), y: [NC, OH, OW] in the same dtype; f: fh*fw
// host floats (<= 64 taps), already flipped and gained (the kernel
// correlates). Padding px0/py0 is relative to the zero-inserted image and
// may be negative (a crop); px1/py1 enter only through OH/OW. NC <= 65535.
PANIC3D_EXPORT int upfirdn2d(const void* x, void* y, int dtype, int NC, int H, int W,
                             int OH, int OW, int upx, int upy, int downx, int downy,
                             int px0, int py0, const float* f, int fw, int fh,
                             void* stream) {
  if (fw * fh > MAX_TAPS || fw < 1 || fh < 1 || NC < 1 || NC > 65535 || OH < 1 || OW < 1)
    return (int)cudaErrorInvalidValue;
  Taps taps;
  for (int i = 0; i < fw * fh; ++i) taps.f[i] = f[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16)
    return (int)launch<__nv_bfloat16>(x, y, NC, H, W, OH, OW, upx, upy, downx, downy, px0,
                                      py0, fw, fh, taps, s);
  return (int)launch<float>(x, y, NC, H, W, OH, OW, upx, upy, downx, downy, px0, py0, fw,
                            fh, taps, s);
}
