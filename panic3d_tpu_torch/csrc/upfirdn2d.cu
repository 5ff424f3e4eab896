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
// upfirdn2d_cols_kernel and upfirdn2d_rows_kernel, a 1-D pass at up = down
// = 1 (a filter of one column or one row: the equivariance metrics' EQ-T_frac
// windowed sincs, 6x1 and 1x6 on [4,3,512,512] f32, eval/equivariance.py).
// Bound: bytes (each input read once, each output written once: ~25.5 MB a
// pass there, ~7.6 us), at a few instructions an output (6 FMAs). The 2-D
// tile of the generic kernel spent most of its instructions on index
// arithmetic (a division a staged element, floor_div / floor_mod a tap).
// - Column form (fw == 1): a lane owns one output column, or in f32 up to
//   16 taps 4 adjacent columns read and written as one float4 where the
//   rows are 16-byte aligned, and a strip of 16 (8) output rows. It loads
//   each input row of the strip's window once (a coalesced warp-wide read;
//   the loads do not depend on one another, so they are in flight
//   together) into registers, and each output row slides its fh-row window
//   down them: no shared memory and no division.
// - Row form (fh == 1): a warp owns a run of ROW_RUN outputs of one row. Its
//   lanes stage the run's inputs plus the fw - 1 halo in shared memory (16-
//   or 8-byte loads where the input rows are aligned, f32 or bf16; scalar
//   loads otherwise), each lane reads its
//   window of 3 + fw inputs back as float4s and computes its 4 adjacent
//   outputs from it; the outputs go out as one vector store a lane where the
//   output rows are aligned, else through the staged row as coalesced
//   scalar stores.
// Both take the taps by value (K >= the taps, unrolled: the taps past the
// filter's are predicated off), zero the padding where a row or a run
// leaves the image, and sum each output's taps in order with fmaf from 0,
// as the generic kernel does, so their outputs equal its bit for bit.
//
// upfirdn2d_fir4_kernel, a 4x4 filter at up = 1 and down = 2 on both axes
// (the "down2" form: the discriminator's downsample2d, models/stylegan2.py's
// skip images and the dual discriminator's image resize) or down = 1 (the
// "fir4" form: conv2d_resample's filter pass before a conv of stride 2,
// ops/conv.py). Bound: bytes (at down=2 each output reads 4 inputs' worth:
// bf16 [2,256,256,256] -> 128^2 moves ~84 MB, ~25 us). The generic kernel
// spent its instructions on index arithmetic (a division a staged element,
// floor_div / floor_mod a tap) and read its window with 2-way bank
// conflicts. Here a block stages a 32 x 64 output tile's input window once
// (16-byte loads and stores of aligned chunks, bf16 widened as it is
// staged), and each lane walks down 8 outputs of its column, keeping the 4
// window rows of an output in registers and reading DOWN new rows a step
// (8-byte shared reads at down=2); the 16 taps are constant operands,
// summed in the generic kernel's order (a then b, fmaf from 0), so the
// output equals the generic kernel's bit for bit; stores are coalesced.
//
// upfirdn2d_kernel, any other call (other factors or filters): one
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

// ---- a 1-D pass at up = down = 1: the column and row forms ----

constexpr int COL_WARPS = 4;   // warps a block of the column form, stacked down the image
constexpr int ROW_WARPS = 8;   // warps a block of the row form, one output row each
constexpr int ROW_RUN = 128;   // outputs a warp of the row form, 4 a lane

// four adjacent values of a row as floats, and back (16 bytes of f32, 8 of bf16)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  // a bf16 is the top half of its f32: widening is a shift
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  auto bits = [](float f) { return (unsigned)__bfloat16_as_ushort(__float2bfloat16(f)); };
  *reinterpret_cast<uint2*>(p) = make_uint2(bits(v.x) | bits(v.y) << 16,
                                            bits(v.z) | bits(v.w) << 16);
}

template <typename T>
inline bool aligned4(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T)) == 0;
}

// V adjacent columns a lane (1, or 4 as one float4), R output rows a lane, K
// >= fh taps unrolled. Output (oy, ox) = sum_a taps[a] x[oy + a - py0, ox - px0].
template <typename T, int V, int K, int R>
__global__ void __launch_bounds__(32 * COL_WARPS) upfirdn2d_cols_kernel(
    const T* __restrict__ x, T* __restrict__ y, int H, int W, int OH, int OW, int px0, int py0,
    int fh, Taps taps) {
  const int oy0 = (blockIdx.y * COL_WARPS + threadIdx.y) * R;
  if (oy0 >= OH) return;   // uniform across the warp
  const long long nc = blockIdx.z;
  const T* src = x + nc * H * W;
  T* dst = y + nc * OH * OW;
  const int ox = (blockIdx.x * 32 + threadIdx.x) * V;
  const int ix = ox - px0;
  // V = 4 runs only where W, OW and px0 are multiples of 4: a lane's four
  // columns are all inside the image or all outside it
  const bool col_in = ix >= 0 && ix + V <= W;
  const int iy0 = oy0 - py0;
  // the strip's R + fh - 1 input rows, zero outside the image: one
  // coalesced warp-wide read each, all in flight together
  float in[R + K - 1][V];
#pragma unroll
  for (int i = 0; i < R + K - 1; ++i) {
    const int iy = iy0 + i;
    const bool load = i < R + fh - 1 && col_in && iy >= 0 && iy < H;
    if constexpr (V == 4) {
      float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
      if (load) q = load4(src + (long long)iy * W + ix);
      in[i][0] = q.x; in[i][1] = q.y; in[i][2] = q.z; in[i][3] = q.w;
    } else {
      in[i][0] = load ? to_f(src[(long long)iy * W + ix]) : 0.f;
    }
  }
  if (ox >= OW) return;
  // output row oy0 + r: its window in[r .. r + fh - 1], the taps in order
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.f;
#pragma unroll
    for (int a = 0; a < K; ++a) {
      if (a < fh) {
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] = fmaf(taps.f[a], in[r + a][v], acc[v]);
      }
    }
    const int oy = oy0 + r;
    T* out = dst + (long long)oy * OW + ox;
    if (oy < OH) {
      if constexpr (V == 4) store4(out, make_float4(acc[0], acc[1], acc[2], acc[3]));
      else out[0] = from_f<T>(acc[0]);
    }
  }
}

// A warp: ROW_RUN outputs of one row, 4 adjacent a lane; K >= fw taps
// unrolled. VIN / VOUT: the input / output rows are aligned for 4-wide
// accesses. Output (oy, ox) = sum_b taps[b] x[oy - py0, ox + b - px0].
template <typename T, int K, bool VIN, bool VOUT>
__global__ void __launch_bounds__(32 * ROW_WARPS) upfirdn2d_rows_kernel(
    const T* __restrict__ x, T* __restrict__ y, int H, int W, int OH, int OW, int px0, int py0,
    int fw, Taps taps) {
  // the run's inputs, then room for the last lane's aligned window reads
  constexpr int SLEN = ROW_RUN + K + 4;
  __shared__ __align__(16) float stage[ROW_WARPS][SLEN];
  const int lane = threadIdx.x;
  const int oy = blockIdx.y * ROW_WARPS + threadIdx.y;
  if (oy >= OH) return;   // uniform across the warp; the warp syncs only itself
  float* s = stage[threadIdx.y];
  const long long nc = blockIdx.z;
  const int iy = oy - py0;
  const bool row_in = iy >= 0 && iy < H;
  const T* row = x + (nc * H + (row_in ? iy : 0)) * W;
  const int ox0 = blockIdx.x * ROW_RUN;
  const int start = ox0 - px0;          // the input of output ox0's first tap
  const int len = ROW_RUN + fw - 1;     // s[j] = x[iy, start + j], 0 outside the image
  if (VIN) {
    // aligned 4-wide chunks from the one holding `start`; W % 4 == 0, so a
    // chunk is inside the row or outside it as a whole
    const int base = start & ~3;
    const int chunks = (start + len - base + 3) >> 2;
    for (int c = lane; c < chunks; c += 32) {
      const int g = base + 4 * c;
      float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row_in && g >= 0 && g < W) q = load4(row + g);
      const float e[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = g + k - start;
        if (j >= 0 && j < len) s[j] = e[k];
      }
    }
  } else {
    const bool inside = start >= 0 && start + len <= W;
    for (int j = lane; j < len; j += 32) {
      const int g = start + j;
      s[j] = row_in && (inside || (g >= 0 && g < W)) ? to_f(row[g]) : 0.f;
    }
  }
  __syncwarp();
  // lane l's window: s[4 l + i], i < K + 4 (4 outputs read up to 3 + fw)
  float w[K + 4];
#pragma unroll
  for (int q = 0; q < K / 4 + 1; ++q) {
    const float4 v = *reinterpret_cast<const float4*>(s + 4 * lane + 4 * q);
    w[4 * q] = v.x; w[4 * q + 1] = v.y; w[4 * q + 2] = v.z; w[4 * q + 3] = v.w;
  }
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int b = 0; b < K; ++b) {
    if (b < fw) {
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[v] = fmaf(taps.f[b], w[v + b], acc[v]);
    }
  }
  T* out = y + (nc * OH + oy) * OW + ox0;
  if (VOUT) {
    if (ox0 + 4 * lane < OW) store4(out + 4 * lane, make_float4(acc[0], acc[1], acc[2], acc[3]));
  } else {
    // through the staged row: lane l stores outputs l, l + 32, ... (coalesced)
    __syncwarp();
    *reinterpret_cast<float4*>(s + 4 * lane) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = lane + 32 * k;
      if (ox0 + j < OW) out[j] = from_f<T>(s[j]);
    }
  }
}

template <typename T, int K>
cudaError_t launch_cols(const void* x, void* y, int NC, int H, int W, int OH, int OW, int px0,
                        int py0, int fh, const Taps& taps, cudaStream_t s) {
  // 4 columns a lane (one float4) in f32 up to 16 taps: a lane holds
  // (R + K - 1) x V inputs
  constexpr bool wide = sizeof(T) == 4 && K <= 16;
  const bool v4 = wide && W % 4 == 0 && OW % 4 == 0 && px0 % 4 == 0 && aligned4<T>(x) &&
                  aligned4<T>(y);
  const int V = v4 ? 4 : 1, R = v4 ? 8 : 16;
  const int strips = (OH + R - 1) / R;
  dim3 grid((OW + 32 * V - 1) / (32 * V), (strips + COL_WARPS - 1) / COL_WARPS, NC);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if constexpr (wide) {
    if (v4) {
      upfirdn2d_cols_kernel<T, 4, K, 8><<<grid, dim3(32, COL_WARPS), 0, s>>>(
          xt, yt, H, W, OH, OW, px0, py0, fh, taps);
      return cudaGetLastError();
    }
  }
  upfirdn2d_cols_kernel<T, 1, K, 16><<<grid, dim3(32, COL_WARPS), 0, s>>>(
      xt, yt, H, W, OH, OW, px0, py0, fh, taps);
  return cudaGetLastError();
}

template <typename T, int K>
cudaError_t launch_rows(const void* x, void* y, int NC, int H, int W, int OH, int OW, int px0,
                        int py0, int fw, const Taps& taps, cudaStream_t s) {
  const bool vin = W % 4 == 0 && aligned4<T>(x), vout = OW % 4 == 0 && aligned4<T>(y);
  dim3 grid((OW + ROW_RUN - 1) / ROW_RUN, (OH + ROW_WARPS - 1) / ROW_WARPS, NC);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const dim3 block(32, ROW_WARPS);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
#define P3D_ROWS(VI, VO)                                                                  \
  upfirdn2d_rows_kernel<T, K, VI, VO><<<grid, block, 0, s>>>(xt, yt, H, W, OH, OW, px0, py0, \
                                                             fw, taps)
  if (vin && vout) P3D_ROWS(true, true);
  else if (vin) P3D_ROWS(true, false);
  else if (vout) P3D_ROWS(false, true);
  else P3D_ROWS(false, false);
#undef P3D_ROWS
  return cudaGetLastError();
}

// a 1-D pass (fh == 1: the row form, else fw == 1: the column form), its
// taps unrolled to the next of 8, 16, 32, 64
template <typename T>
cudaError_t launch_1d(const void* x, void* y, int NC, int H, int W, int OH, int OW, int px0,
                      int py0, int fw, int fh, const Taps& taps, cudaStream_t s) {
  const int n = fh == 1 ? fw : fh;
#define P3D_1D(KK)                                                                          \
  return fh == 1 ? launch_rows<T, KK>(x, y, NC, H, W, OH, OW, px0, py0, fw, taps, s)        \
                 : launch_cols<T, KK>(x, y, NC, H, W, OH, OW, px0, py0, fh, taps, s)
  if (n <= 8) P3D_1D(8);
  if (n <= 16) P3D_1D(16);
  if (n <= 32) P3D_1D(32);
  P3D_1D(64);
#undef P3D_1D
}

// ---- a 4x4 filter at up = 1, down = 2 (or 1) on both axes: the 4x4 form ----

constexpr int F4_X = 64;      // output columns a block: one a lane, two warps across
constexpr int F4_WARPS = 8;   // warps a block: 2 across, 4 down the tile
constexpr int F4_R = 8;       // output rows a warp: its strip
constexpr int F4_Y = F4_WARPS / 2 * F4_R;   // output rows a block

struct Taps16 { float f[16]; };   // [a][b], flipped and gained: correlate

// the window's values a lane reads from one staged row (p: the row at the
// lane's first column): w[b] = input column DOWN * ox + b - px0. At DOWN = 2
// a lane's columns are 2 lx + b: two 8-byte reads (a half-warp reads 128
// contiguous bytes, no bank conflict), or, where the row's first needed
// column is odd in the staged frame (ODD), one 8-byte read between two
// scalar ones. At DOWN = 1 four scalar reads (consecutive lanes,
// consecutive banks).
template <int DOWN, bool ODD>
__device__ __forceinline__ void fir4_row(const float* p, float w[4]) {
  if constexpr (DOWN == 1) {
#pragma unroll
    for (int b = 0; b < 4; ++b) w[b] = p[b];
  } else if constexpr (ODD) {
    const float2 m = *reinterpret_cast<const float2*>(p + 1);
    w[0] = p[0]; w[1] = m.x; w[2] = m.y; w[3] = p[3];
  } else {
    const float2 l = *reinterpret_cast<const float2*>(p);
    const float2 h = *reinterpret_cast<const float2*>(p + 2);
    w[0] = l.x; w[1] = l.y; w[2] = h.x; w[3] = h.y;
  }
}

// A block: an F4_Y x F4_X output tile of one image. (1) It stages the
// tile's input window, DOWN (F4_Y - 1) + 4 rows of DOWN (F4_X - 1) + 4
// columns, once, as f32 in shared memory, zero outside the image: where
// the rows are aligned (VEC), with 16-byte loads of aligned chunks, all of
// a thread's loads in flight before its 16-byte stores (the staged row then
// starts at the chunk holding the first column, `off` columns before it),
// else with scalar accesses. (2) Each
// warp walks down its strip of F4_R output rows, a lane an output column,
// keeping the 4 window rows of its current output row in registers and
// reading DOWN new rows a step. Each output sums its 16 taps (constant
// operands) in the generic kernel's order, a then b, with fmaf from 0, so
// it equals the generic kernel's output bit for bit. Stores are coalesced
// (32 consecutive outputs a warp).
template <typename T, int DOWN, bool VEC, bool ODD>
__global__ void __launch_bounds__(32 * F4_WARPS) upfirdn2d_fir4_kernel(
    const T* __restrict__ x, T* __restrict__ y, int H, int W, int OH, int OW, int px0,
    int py0, Taps16 taps) {
  constexpr int WIN_X = DOWN * (F4_X - 1) + 4, WIN_Y = DOWN * (F4_Y - 1) + 4;
  constexpr int V = 16 / (int)sizeof(T);              // elements of a 16-byte chunk
  constexpr int NCH = (WIN_X + 2 * (V - 1)) / V;      // chunks a staged row, at most
  constexpr int SW = VEC ? V * NCH : (WIN_X + 1) & ~1;  // staged row stride, floats (even)
  __shared__ __align__(16) float win[WIN_Y * SW];
  constexpr int NT = 32 * F4_WARPS;
  const int tid = threadIdx.y * 32 + threadIdx.x;
  const long long nc = blockIdx.z;
  const int ox0 = blockIdx.x * F4_X, oy0 = blockIdx.y * F4_Y;
  const int sx = DOWN * ox0 - px0, sy = DOWN * oy0 - py0;   // the window's first input
  const T* src = x + nc * H * W;
  int off = 0;
  if constexpr (VEC) {
    // W % V == 0: a chunk is inside the row or outside it as a whole
    constexpr int ITER = (WIN_Y * NCH + NT - 1) / NT;
    const int base = sx & ~(V - 1);
    off = sx - base;
    uint4 raw[ITER];
#pragma unroll
    for (int k = 0; k < ITER; ++k) {
      const int i = tid + k * NT, r = i / NCH, c = i - r * NCH;
      const int iy = sy + r, g = base + V * c;
      raw[k] = make_uint4(0u, 0u, 0u, 0u);
      if (i < WIN_Y * NCH && iy >= 0 && iy < H && g >= 0 && g < W)
        raw[k] = *reinterpret_cast<const uint4*>(src + (long long)iy * W + g);
    }
#pragma unroll
    for (int k = 0; k < ITER; ++k) {
      const int i = tid + k * NT;
      if (i >= WIN_Y * NCH) break;
      const int r = i / NCH, c = i - r * NCH;
      float4* dst = reinterpret_cast<float4*>(win + r * SW + V * c);
      const uint4 u = raw[k];
      if constexpr (sizeof(T) == 4) {
        dst[0] = make_float4(__uint_as_float(u.x), __uint_as_float(u.y), __uint_as_float(u.z),
                             __uint_as_float(u.w));
      } else {
        // a bf16 is the top half of its f32: widening is a shift
        dst[0] = make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                             __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
        dst[1] = make_float4(__uint_as_float(u.z << 16), __uint_as_float(u.z & 0xffff0000u),
                             __uint_as_float(u.w << 16), __uint_as_float(u.w & 0xffff0000u));
      }
    }
  } else {
    for (int i = tid; i < WIN_Y * WIN_X; i += NT) {
      const int r = i / WIN_X, c = i - r * WIN_X;
      const int iy = sy + r, ix = sx + c;
      win[r * SW + c] = iy >= 0 && iy < H && ix >= 0 && ix < W
                            ? to_f(src[(long long)iy * W + ix]) : 0.f;
    }
  }
  __syncthreads();

  const int lx = (threadIdx.y & 1) * 32 + threadIdx.x, ox = ox0 + lx;
  const int r0 = (threadIdx.y >> 1) * F4_R;        // the strip's first output row in the tile
  if (oy0 + r0 >= OH) return;                      // uniform across the warp
  const float* col = win + off + DOWN * lx;        // the lane's first window column
  // the strip's outputs in this column: one pointer, moved a row at a time
  T* dst = y + (nc * OH + oy0 + r0) * OW + ox;
  const int rows = ox < OW ? min(F4_R, OH - oy0 - r0) : 0;
  // w[k]: window row DOWN * (row - oy0) + k of the current output row
  float w[4][4];
#pragma unroll
  for (int k = 0; k < 4 - DOWN; ++k) fir4_row<DOWN, ODD>(col + (DOWN * r0 + k) * SW, w[k]);
#pragma unroll
  for (int r = 0; r < F4_R; ++r) {
    const int wr = DOWN * (r0 + r);
#pragma unroll
    for (int k = 4 - DOWN; k < 4; ++k) fir4_row<DOWN, ODD>(col + (wr + k) * SW, w[k]);
    float acc = 0.f;
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc = fmaf(taps.f[a * 4 + b], w[a][b], acc);
    const T v = from_f<T>(acc);
    if (r < rows) *dst = v;
    dst += OW;
#pragma unroll
    for (int k = 0; k < 4 - DOWN; ++k)
#pragma unroll
      for (int b = 0; b < 4; ++b) w[k][b] = w[k + DOWN][b];
  }
}

template <typename T, int DOWN>
cudaError_t launch_fir4(const void* x, void* y, int NC, int H, int W, int OH, int OW, int px0,
                        int py0, const Taps16& taps, cudaStream_t s) {
  constexpr int V = 16 / (int)sizeof(T);
  const bool vec = W % V == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  dim3 grid((OW + F4_X - 1) / F4_X, (OH + F4_Y - 1) / F4_Y, NC);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const dim3 block(32, F4_WARPS);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
#define P3D_FIR4(VEC, ODD)                                                                \
  upfirdn2d_fir4_kernel<T, DOWN, VEC, ODD><<<grid, block, 0, s>>>(xt, yt, H, W, OH, OW, px0, \
                                                                  py0, taps)
  if (!vec) P3D_FIR4(false, false);
  else if constexpr (DOWN == 1) P3D_FIR4(true, false);
  // ODD: with the aligned staging the lanes' first columns lie at odd
  // offsets in the staged row when px0 is odd (the window starts at 2 ox0 - px0)
  else if (px0 & 1) P3D_FIR4(true, true);
  else P3D_FIR4(true, false);
#undef P3D_FIR4
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
// Such a call runs the polyphase kernel; a 4x4 filter at up = 1 and down = 2
// (or 1) on both axes the 4x4 form; a filter of one row or one column at
// up = down = 1 the row or the column form; any other call the generic
// kernel (ops/upfirdn2d.py:k4_plan names the same variant). Both tables may
// be null for a call outside the polyphase family.
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
  if (fw == 4 && fh == 4 && upx == 1 && upy == 1 && downx == downy &&
      (downx == 1 || downx == 2)) {
    Taps16 t16;
    for (int i = 0; i < 16; ++i) t16.f[i] = f[i];
#define P3D_F4(T, D) return (int)launch_fir4<T, D>(x, y, NC, H, W, OH, OW, px0, py0, t16, s)
    if (dtype == DT_BF16) {
      if (downx == 2) P3D_F4(__nv_bfloat16, 2);
      P3D_F4(__nv_bfloat16, 1);
    }
    if (downx == 2) P3D_F4(float, 2);
    P3D_F4(float, 1);
#undef P3D_F4
  }
  Taps taps;
  for (int i = 0; i < fw * fh; ++i) taps.f[i] = f[i];
  if (upx == 1 && upy == 1 && downx == 1 && downy == 1 && (fh == 1 || fw == 1)) {
    if (dtype == DT_BF16)
      return (int)launch_1d<__nv_bfloat16>(x, y, NC, H, W, OH, OW, px0, py0, fw, fh, taps, s);
    return (int)launch_1d<float>(x, y, NC, H, W, OH, OW, px0, py0, fw, fh, taps, s);
  }
  if (dtype == DT_BF16)
    return (int)launch<__nv_bfloat16>(x, y, NC, H, W, OH, OW, upx, upy, downx, downy, px0,
                                      py0, fw, fh, taps, s);
  return (int)launch<float>(x, y, NC, H, W, OH, OW, upx, upy, downx, downy, px0, py0, fw,
                            fh, taps, s);
}
