// K4 upfirdn2d: zero-insert upsample -> pad/crop -> FIR correlate ->
// decimate, for NCHW images, in one pass.
//
// Replaces (JAX): panic3d_tpu/ops/upfirdn2d.py:upfirdn2d (:238) and its three
// per-case lowerings (_fir_conv, _fir_unrolled, _fir_poly_up, dispatched at
// :211). On the slice's path it runs inside upsample2d (:286, the skip-image
// upsample of every synthesis block) and conv2d_resample(up=2) (ops/conv.py:48,
// before each upsampling 3x3 conv).
//
// What bounds it on the H100: bytes. Every call on the path has up=2, down=1
// and the 4x4 [1,3,3,1] outer product, so each output pixel takes 4 of the 16
// taps (the others meet inserted zeros) and each input pixel is read once.
// The largest call (SR block 1: [2,256,256,256] bf16 in, [2,256,514,514] bf16
// out) moves ~337 MB, 80 % of it the output: ~0.1 ms at 3.35 TB/s.
//
// Two kernels, chosen inside the entry point on the call's shape alone:
//
// upfirdn2d_up2_kernel, up=2, down=1, 4x4 filter: the polyphase form of
// _fir_poly_up (:155). Output pixel (2m+ry, 2n+rx) is a 2x2 correlation of
// the original image at rows m+sy[ry]+{0,1} and columns n+sx[rx]+{0,1}, with
// the phase's four taps; the wrapper computes the taps and the source offsets
// once per (filter, padding). For a 4-tap filter at up=2 the two phases'
// offsets are equal or one apart, so the window of an output pair-row is 2 or
// 3 input rows (DY) by 2 or 3 columns (DX), fixed at compile time: 4 FMAs per
// output and no per-tap index arithmetic. A warp owns 32 consecutive
// pair-columns and walks down a strip of pair-rows, keeping the window's rows
// in registers (each input row is loaded once per strip, one element per lane,
// the next row's load in flight while the current pair-row computes) and
// taking the neighbouring columns from the next lanes by shuffles. Each lane
// stores its two outputs of a row as one 4-byte (bf16x2) or 8-byte (float2)
// store, so a warp writes 128 or 256 contiguous bytes per output row. Enough
// warps stay resident (small blocks, few registers) to hide the loads.
//
// upfirdn2d_kernel, any other call (down=2, other factors or filters): one
// block per 32x32 output tile of one (n, c) image; the block stages the input
// window the tile needs in shared memory as f32 (zero outside the image), and
// each thread computes 4 outputs of a column, skipping the taps that land on
// inserted zeros.
//
// upfirdn2d_large_kernel, a filter of more than MAX_TAPS taps (the
// equivariance metrics' 47x47 resampling filter at up=4 and their 11x11
// pseudo-rotation filter, eval/equivariance.py): the generic kernel's tiles,
// with the taps read from a device buffer that the block stages in shared
// memory (a new filter for every random angle, so nothing is cached on the
// host), and each output visiting only the taps of its phase (for 47x47 at
// up=4, 144 of the 2,209: a tap meets an inserted zero unless its row and
// column are the output's phase). Bound: operations, ~144 FMAs an output.
//
// All accumulate in f32 and round once to the input's dtype.
#include "common.cuh"

namespace {

// ---- the generic kernel ----

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

// ---- more than MAX_TAPS taps: the large-filter kernel ----

template <typename T>
__global__ void __launch_bounds__(TILE * ROWS) upfirdn2d_large_kernel(
    const T* __restrict__ x, T* __restrict__ y, int H, int W, int OH, int OW,
    int upx, int upy, int downx, int downy, int px0, int py0, int fw, int fh,
    const float* __restrict__ f, int tw, int th) {
  extern __shared__ float smem[];
  float* taps = smem;              // [fh][fw]
  float* tile = smem + fw * fh;    // [th][tw]
  const long long nc = blockIdx.z;
  const int ox0 = blockIdx.x * TILE, oy0 = blockIdx.y * TILE;
  const int ix0 = floor_div(ox0 * downx - px0, upx);
  const int iy0 = floor_div(oy0 * downy - py0, upy);
  const T* src = x + nc * H * W;
  const int tid = threadIdx.y * TILE + threadIdx.x;
  for (int i = tid; i < fw * fh; i += TILE * ROWS) taps[i] = f[i];
  for (int i = tid; i < tw * th; i += TILE * ROWS) {
    const int iy = iy0 + i / tw, ix = ix0 + i % tw;
    tile[i] = (iy >= 0 && iy < H && ix >= 0 && ix < W) ? to_f(src[(long long)iy * W + ix]) : 0.f;
  }
  __syncthreads();

  const int ox = ox0 + threadIdx.x;
  if (ox >= OW) return;
  // the first column tap of this output's phase: X = ox*downx + b - px0 is
  // a multiple of upx
  const int b0 = floor_mod(px0 - ox * downx, upx);
  const int tx0 = floor_div(ox * downx + b0 - px0, upx) - ix0;
  T* dst = y + nc * OH * OW;
  for (int oy = oy0 + threadIdx.y; oy < oy0 + TILE && oy < OH; oy += ROWS) {
    const int a0 = floor_mod(py0 - oy * downy, upy);
    const int ty0 = floor_div(oy * downy + a0 - py0, upy) - iy0;
    float acc = 0.f;
    for (int a = a0, ty = ty0; a < fh; a += upy, ++ty) {
      const float* frow = taps + a * fw;
      const float* trow = tile + ty * tw + tx0;
      for (int b = b0, j = 0; b < fw; b += upx, ++j) acc = fmaf(frow[b], trow[j], acc);
    }
    dst[(long long)oy * OW + ox] = from_f<T>(acc);
  }
}

template <typename T>
cudaError_t launch_large(const void* x, void* y, int NC, int H, int W, int OH, int OW, int upx,
                         int upy, int downx, int downy, int px0, int py0, int fw, int fh,
                         const float* f, cudaStream_t stream) {
  const int tw = ((TILE - 1) * downx + fw - 1) / upx + 2;
  const int th = ((TILE - 1) * downy + fh - 1) / upy + 2;
  const size_t smem = ((size_t)tw * th + (size_t)fw * fh) * sizeof(float);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(upfirdn2d_large_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((OW + TILE - 1) / TILE, (OH + TILE - 1) / TILE, NC);
  upfirdn2d_large_kernel<T><<<grid, dim3(TILE, ROWS), smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), H, W, OH, OW, upx, upy, downx, downy,
      px0, py0, fw, fh, f, tw, th);
  return cudaGetLastError();
}

// ---- up=2, down=1, 4x4 filter: the polyphase kernel ----

constexpr int STRIP = 16;   // pair-rows per warp
constexpr int WARPS = 4;    // warps per block, stacked down the image
constexpr unsigned FULL = 0xffffffffu;

struct Phases { float t[2][2][2][2]; };   // [ry][rx][j][i]: the tap of x[m+sy+j][n+sx+i]

// one input row as the warp loads it: lane L holds column col0 + L, and lanes
// 0..DX the halo columns col0 + 32 + L
struct Raw { float v, h; };

template <typename T, int DX>
__device__ __forceinline__ Raw load_row(const T* __restrict__ src, int iy, int H, int W,
                                        int col0, int lane) {
  Raw r{0.f, 0.f};
  if (iy >= 0 && iy < H) {   // uniform across the warp
    const T* row = src + (long long)iy * W;
    const int c = col0 + lane, ch = col0 + 32 + lane;
    if (c >= 0 && c < W) r.v = to_f(row[c]);
    if (lane <= DX && ch >= 0 && ch < W) r.h = to_f(row[ch]);
  }
  return r;
}

// the window columns of lane L: w[k] = column col0 + L + k, k <= 1 + DX
template <int DX>
__device__ __forceinline__ void expand(const Raw& r, int lane, float w[3]) {
  w[0] = r.v;
  const float d1 = __shfl_down_sync(FULL, r.v, 1);
  const float h0 = __shfl_sync(FULL, r.h, 0);
  w[1] = lane == 31 ? h0 : d1;
  if (DX) {
    const float d2 = __shfl_down_sync(FULL, r.v, 2);
    const float h = __shfl_sync(FULL, r.h, lane & 1);   // lane 30: col0+32, lane 31: col0+33
    w[2] = lane >= 30 ? h : d2;
  }
}

template <typename T>
__device__ __forceinline__ void store_pair(T* p, float a, float b, bool paired, bool second);

template <>
__device__ __forceinline__ void store_pair<__nv_bfloat16>(__nv_bfloat16* p, float a, float b,
                                                          bool paired, bool second) {
  if (paired) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    p[0] = __float2bfloat16(a);
    if (second) p[1] = __float2bfloat16(b);
  }
}

template <>
__device__ __forceinline__ void store_pair<float>(float* p, float a, float b, bool paired,
                                                  bool second) {
  if (paired) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    p[0] = a;
    if (second) p[1] = b;
  }
}

// DY / DX: the odd phase's source row / column offset minus the even phase's
// (0 or 1); by / bx: the even phase's offsets sy[0] / sx[0]
template <typename T, int DY, int DX>
__global__ void __launch_bounds__(32 * WARPS) upfirdn2d_up2_kernel(
    const T* __restrict__ x, T* __restrict__ y, int H, int W, int OH, int OW, int by, int bx,
    Phases ph) {
  constexpr int NR = 2 + DY;   // window rows of one pair-row
  const int lane = threadIdx.x;
  const int MY = (OH + 1) / 2, MX = (OW + 1) / 2;
  const int m0 = (blockIdx.y * WARPS + threadIdx.y) * STRIP;
  if (m0 >= MY) return;        // uniform across the warp
  const long long nc = blockIdx.z;
  const T* src = x + nc * H * W;
  T* dst = y + nc * OH * OW;
  const int n = blockIdx.x * 32 + lane;      // this lane's pair-column
  const int col0 = blockIdx.x * 32 + bx;     // input column of lane 0's window
  const bool active = n < MX;
  const bool paired = (OW & 1) == 0;         // 2n is even: pair stores are aligned
  const bool second = 2 * n + 1 < OW;

  float w[NR][3];
#pragma unroll
  for (int k = 0; k < NR - 1; ++k)
    expand<DX>(load_row<T, DX>(src, m0 + by + k, H, W, col0, lane), lane, w[k]);
  Raw next = load_row<T, DX>(src, m0 + by + NR - 1, H, W, col0, lane);
  const int m_end = min(m0 + STRIP, MY);
#pragma unroll 2
  for (int m = m0; m < m_end; ++m) {
    expand<DX>(next, lane, w[NR - 1]);
    if (m + 1 < m_end) next = load_row<T, DX>(src, m + by + NR, H, W, col0, lane);
#pragma unroll
    for (int ry = 0; ry < 2; ++ry) {
      const int oy = 2 * m + ry;
      const int r0 = ry ? DY : 0;
      float o[2];
#pragma unroll
      for (int rx = 0; rx < 2; ++rx) {
        const int c0 = rx ? DX : 0;
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i) acc = fmaf(ph.t[ry][rx][j][i], w[r0 + j][c0 + i], acc);
        o[rx] = acc;
      }
      if (active && oy < OH)
        store_pair<T>(dst + (long long)oy * OW + 2 * n, o[0], o[1], paired, second);
    }
#pragma unroll
    for (int k = 0; k < NR - 1; ++k)
#pragma unroll
      for (int c = 0; c < 2 + DX; ++c) w[k][c] = w[k + 1][c];
  }
}

template <typename T, int DY, int DX>
cudaError_t launch_up2(const void* x, void* y, int NC, int H, int W, int OH, int OW, int by,
                       int bx, const Phases& ph, cudaStream_t stream) {
  const int MY = (OH + 1) / 2, MX = (OW + 1) / 2;
  dim3 grid((MX + 31) / 32, (MY + STRIP * WARPS - 1) / (STRIP * WARPS), NC);
  upfirdn2d_up2_kernel<T, DY, DX><<<grid, dim3(32, WARPS), 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), H, W, OH, OW, by, bx, ph);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_up2(const void* x, void* y, int NC, int H, int W, int OH, int OW,
                         int by, int bx, int dy, int dx, const Phases& ph, cudaStream_t s) {
  if (dy == 0 && dx == 0) return launch_up2<T, 0, 0>(x, y, NC, H, W, OH, OW, by, bx, ph, s);
  if (dy == 0 && dx == 1) return launch_up2<T, 0, 1>(x, y, NC, H, W, OH, OW, by, bx, ph, s);
  if (dy == 1 && dx == 0) return launch_up2<T, 1, 0>(x, y, NC, H, W, OH, OW, by, bx, ph, s);
  return launch_up2<T, 1, 1>(x, y, NC, H, W, OH, OW, by, bx, ph, s);
}

}  // namespace

// x: [NC, H, W] (f32 or bf16), y: [NC, OH, OW] in the same dtype; f: fh*fw
// host floats (<= 64 taps), already flipped and gained (the kernel
// correlates); a filter of more than 64 taps comes instead as f_dev, fh*fw
// floats on the device (f is then null) and runs the large-filter kernel. Padding px0/py0 is relative to the zero-inserted image and
// may be negative (a crop); px1/py1 enter only through OH/OW. NC <= 65535.
// phase_taps / phase_src: the polyphase table of an up=2, down=1, 4x4 call
// (ops/upfirdn2d.py:k4_plan): 16 taps [ry][rx][j][i] and the source offsets
// (sy0, sy1, sx0, sx1), whose two phases are equal or one apart for 4 taps.
// Such a call runs the polyphase kernel, any other call the generic kernel;
// both tables may be null for a call outside that family.
PANIC3D_EXPORT int upfirdn2d(const void* x, void* y, int dtype, int NC, int H, int W,
                             int OH, int OW, int upx, int upy, int downx, int downy,
                             int px0, int py0, const float* f, int fw, int fh,
                             const float* phase_taps, const int* phase_src,
                             const float* f_dev, void* stream) {
  if (fw < 1 || fh < 1 || NC < 1 || NC > 65535 || OH < 1 || OW < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fw * fh > MAX_TAPS) {
    if (f_dev == nullptr) return (int)cudaErrorInvalidValue;
    if (dtype == DT_BF16)
      return (int)launch_large<__nv_bfloat16>(x, y, NC, H, W, OH, OW, upx, upy, downx, downy,
                                              px0, py0, fw, fh, f_dev, s);
    return (int)launch_large<float>(x, y, NC, H, W, OH, OW, upx, upy, downx, downy, px0, py0,
                                    fw, fh, f_dev, s);
  }
  const bool up2 = upx == 2 && upy == 2 && downx == 1 && downy == 1 && fw == 4 && fh == 4;
  if (up2) {
    if (phase_taps == nullptr || phase_src == nullptr) return (int)cudaErrorInvalidValue;
    const int dy = phase_src[1] - phase_src[0], dx = phase_src[3] - phase_src[2];
    if (dy < 0 || dy > 1 || dx < 0 || dx > 1) return (int)cudaErrorInvalidValue;
    Phases ph;
    for (int i = 0; i < 16; ++i) (&ph.t[0][0][0][0])[i] = phase_taps[i];
    if (dtype == DT_BF16)
      return (int)dispatch_up2<__nv_bfloat16>(x, y, NC, H, W, OH, OW, phase_src[0],
                                              phase_src[2], dy, dx, ph, s);
    return (int)dispatch_up2<float>(x, y, NC, H, W, OH, OW, phase_src[0], phase_src[2], dy,
                                    dx, ph, s);
  }
  Taps taps;
  for (int i = 0; i < fw * fh; ++i) taps.f[i] = f[i];
  if (dtype == DT_BF16)
    return (int)launch<__nv_bfloat16>(x, y, NC, H, W, OH, OW, upx, upy, downx, downy, px0,
                                      py0, fw, fh, taps, s);
  return (int)launch<float>(x, y, NC, H, W, OH, OW, upx, upy, downx, downy, px0, py0, fw,
                            fh, taps, s);
}
