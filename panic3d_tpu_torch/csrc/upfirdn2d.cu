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
// The 4x4 form: a 4x4 filter at up = 1 and down = 2 on both axes (the
// "down2" form: the discriminator's downsample2d, models/stylegan2.py's
// skip images and the dual discriminator's image resize, and the transposed
// pass of every up=2 call in training) or down = 1 (the "fir4" form:
// conv2d_resample's filter pass before a conv of stride 2, ops/conv.py, and
// its transposed pass), templated on the filter's size for any other 2-D
// filter of at most 4x4 at up = down = 1 ("fir_small": a 3x3 blur). Bound:
// bytes (at down=2 each output reads 4 inputs' worth: bf16 [8,256,514,514]
// -> 256^2 moves 1.35 GB, 0.40 ms). Every output sums its taps in the
// generic kernel's order (a then b, fmaf from 0), so each plan's outputs
// equal that kernel's bit for bit. Its block plans
// (ops/upfirdn2d.py:fir4_block_plan chooses):
// - upfirdn2d_fir4_planes_kernel, rows of at most 32 outputs, 16 where
//   the rows are 16-byte aligned (training's 512-channel calls of 4^2..16^2
//   outputs, 4,096 planes a call): a thread an output column of a strip of
//   up to 4 rows of one plane, so a block of 256 threads takes 4 to 16
//   planes; it reads its strip's window straight from global memory (every
//   load in flight at once, the overlap through L1). A block a plane,
//   staging a 32 x 64 tile's 36 KB window for a ~2 KB plane, ran these
//   calls 1.8-5.8x slower than a depthwise conv2d.
// - upfirdn2d_fir4_kernel, wider rows: a block a 32 x 64 output tile, its
//   window staged once as f32, with 16-byte loads of aligned chunks where
//   the rows are 16-byte aligned (the "rows" plan), else element by element
//   ("rows_scalar", for a call of fewer than 528 64-row tiles), a lane a
//   column walking 8 outputs down a register window.
// - upfirdn2d_fir4_flat_kernel, wider rows that are not 16-byte aligned, in
//   a call of at least 528 64-row tiles (the "flat" plan: training's large
//   calls have odd or 2 mod 8 widths, 513, 511, 514, which the rows plan
//   could only stage element by element, at 40-46 % of the bound): the
//   window staged by cp.async in the input's dtype as 16-byte chunks of the
//   flat tensor, each row from the chunk that holds its first column,
//   widened as read; a lane owns 2 adjacent output columns of a 64 x 64
//   tile and stores them as one pair. Taking the aligned rows too, it ran
//   10-31 % slower than the rows plan there (scripts/k4_fir4_variants.py).
//
// upfirdn2d_rows2_kernel and upfirdn2d_cols2_kernel, a 1-D pass at up 2 or
// down 2 on its axis, the other unscaled, at most 16 taps ("row_up2",
// "row_down2", "column_up2", "column_down2": the unfused K11 composition's
// 1x12 up=2 pass and its transpose, a 1x12 down=2 pass, and ADA's sym6
// passes, panic3d_tpu/training/augment.py:226,250). Bound: bytes (the 1x12
// up=2 pass, bf16 [4,287,276,276] -> 276x562, moves 531 MB: 0.159 ms). The
// generic kernel ran it at 4 % of that, 5 % slower than a depthwise
// conv_transpose2d: its 32x32 tile computed 4 outputs a thread with a
// floor_div and a floor_mod a tap and skipped the half of the taps that
// meet inserted zeros one by one. The polyphase forms are the row and
// column forms above with the scaling folded into the taps: at up 2 output
// phase r takes only the taps of its parity (fw / 2 of them, by value, from
// the host's phase table), at down 2 an output reads fw inputs at stride 2;
// the run or strip is staged once, the stores are vector or pair stores
// where the rows allow it, and each output sums its nonzero taps in the
// generic kernel's fmaf order from 0, so the outputs equal its bit for bit.
//
// upfirdn2d_kernel, any other call (other factors or filters, e.g. a 5x5 at
// up 2): one block per 32x32 output tile of one (n, c) image; the block
// stages the input window the tile needs in shared memory as f32 (zero
// outside the image), and each thread computes 4 outputs of a column,
// skipping the taps that land on inserted zeros.
//
// A filter of more than MAX_TAPS taps (the equivariance metrics' 47x47
// resampling filter at up=4 and their 11x11 pseudo-rotation filter,
// eval/equivariance.py) comes as a device buffer that each block stages in
// shared memory (a new filter for every random angle, so nothing is cached
// on the host); each output visits only the taps of its phase (for 47x47 at
// up=4, 121-144 of the 2,209: a tap meets an inserted zero unless its row
// and column are the output's phase). Bound: operations, ~138 FMAs an
// output there (f32 [4,3,512,512] -> 2094^2: 7.3 G FMAs, 0.22 ms).
// - upfirdn2d_large_phase_kernel, at down 1 (up <= 4 on x, at most 16 taps
//   in a phase's row and at least 4 rows: both calls of the metrics). An
//   FMA fed from shared memory twice (a tap and an input, as the generic
//   kernel does) runs at a quarter of the FMA rate at best. Here the block stages the taps
//   phase-major (each phase's sub-filter contiguous, rows padded to a
//   multiple of 4), and a lane keeps a 4 x 4 block of outputs of one phase
//   in registers: each staged input it loads feeds up to 16 FMAs and each
//   tap (a float4 of 4, broadcast to the warp) 4, ~0.1 shared loads an FMA.
//   The outputs of a row phase go through shared memory to coalesced
//   stores. Each output's taps are summed in the generic kernel's order
//   (rows, then columns, ascending; fmaf from 0), so it equals that
//   kernel's output bit for bit.
// - upfirdn2d_large_kernel, any other large filter (down > 1, or a phase
//   beyond those bounds): the generic kernel's tiles with the staged taps,
//   each output walking its phase's.
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

// ---- a filter of at most 4x4 at up = 1, down = 1 or 2 on both axes: the 4x4 form ----
//
// Four block plans. ops/upfirdn2d.py:fir4_block_plan picks one for each
// call from its shape and x's alignment, and the entry point launches the
// plan it names (F4_PLAN_*), refusing one the call cannot take: "planes"
// (rows of few outputs), "rows" (16-byte aligned rows, staged by 16-byte
// chunks), "rows_scalar" (the same tiles staged element by element:
// unaligned rows of few tiles), "flat" (unaligned rows of many tiles). The
// -D macros below are design choices; scripts/k4_fir4_variants.py builds
// and times the others.

#ifndef F4_PAIR
#define F4_PAIR 2       // adjacent output columns a lane of the flat plan (1 or 2)
#endif
#ifndef F4_Y
#define F4_Y 64         // output rows a flat tile
#endif
#ifndef F4_MINB
#define F4_MINB 6       // blocks of the flat plan an SM must hold (caps its registers)
#endif

enum { F4_PLAN_PLANES = 1, F4_PLAN_ROWS = 2, F4_PLAN_ROWS_SCALAR = 3, F4_PLAN_FLAT = 4 };

constexpr int F4_THREADS = 256;             // threads a block, every plan
constexpr int F4_TX = 64;                   // output columns a tile (rows and flat plans)
constexpr int F4_P = F4_PAIR;
constexpr int F4_WX = F4_TX / (32 * F4_P);  // warps across a flat tile
constexpr int F4_PR = 4;                    // most output rows a thread of the planes plan
static_assert(F4_P == 1 || F4_P == 2, "a lane takes 1 or 2 columns of a flat tile");

struct Taps16 { float f[16]; };   // [a][b], flipped and gained: correlate

// The planes plan: a thread owns output column ox of a strip of `rows`
// (<= F4_PR) output rows of one (n, c) plane, threads in the order of
// column, strip, plane, so a block takes F4_THREADS / (OW x strips)
// planes. The thread reads its strip's window, DOWN (rows - 1) + FH rows of
// FW columns (zero outside the image), straight from global memory: every
// load in flight before the first tap, the neighbours' overlap served by
// L1; no shared memory, no barrier. Each output sums its taps in the
// generic kernel's order, a then b, with fmaf from 0.
template <typename T, int DOWN, int FH, int FW>
__global__ void __launch_bounds__(F4_THREADS) upfirdn2d_fir4_planes_kernel(
    const T* __restrict__ x, T* __restrict__ y, int NC, int H, int W, int OH, int OW, int px0,
    int py0, int rows, int strips, Taps16 taps) {
  constexpr int NR = DOWN * (F4_PR - 1) + FH;   // window rows of the longest strip
  const unsigned t = blockIdx.x * F4_THREADS + threadIdx.x;
  const unsigned per = (unsigned)strips * (unsigned)OW;   // threads a plane
  const unsigned nc = t / per;
  if (nc >= (unsigned)NC) return;
  const int rem = (int)(t - nc * per), s = rem / OW, ox = rem - s * OW, oy0 = s * rows;
  const int ix0 = DOWN * ox - px0, iy0 = DOWN * oy0 - py0, nr = DOWN * (rows - 1) + FH;
  const T* src = x + (long long)nc * H * W;
  bool col_in[FW];
#pragma unroll
  for (int b = 0; b < FW; ++b) col_in[b] = ix0 + b >= 0 && ix0 + b < W;
  float w[NR][FW];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int iy = iy0 + i;
    const bool row_in = i < nr && iy >= 0 && iy < H;
#pragma unroll
    for (int b = 0; b < FW; ++b)
      w[i][b] = row_in && col_in[b] ? to_f(src[(long long)iy * W + ix0 + b]) : 0.f;
  }
  T* dst = y + ((long long)nc * OH + oy0) * OW + ox;
#pragma unroll
  for (int r = 0; r < F4_PR; ++r) {
    if (r < rows && oy0 + r < OH) {
      float acc = 0.f;
#pragma unroll
      for (int a = 0; a < FH; ++a)
#pragma unroll
        for (int b = 0; b < FW; ++b) acc = fmaf(taps.f[a * FW + b], w[DOWN * r + a][b], acc);
      dst[(long long)r * OW] = from_f<T>(acc);
    }
  }
}

// ---- the rows plans: "rows" (16-byte aligned rows) and "rows_scalar" ----

constexpr int FR_R = 8;                                  // output rows a warp: its strip
constexpr int FR_Y = F4_THREADS / 32 / 2 * FR_R;         // output rows a tile: 32

// the window's values a lane reads from one staged row (p: the row at the
// lane's first column): w[b] = input column DOWN * ox + b - px0. At DOWN = 2
// a lane's columns are 2 lx + b: two 8-byte reads (a half-warp reads 128
// contiguous bytes, no bank conflict), or, where the row's first needed
// column is odd in the staged frame (ODD), one 8-byte read between two
// scalar ones. At DOWN = 1 four scalar reads (consecutive lanes,
// consecutive banks).
template <int DOWN, bool ODD, int FW>
__device__ __forceinline__ void fir4_row(const float* p, float w[FW]) {
  static_assert(DOWN == 1 || FW == 4, "down 2 takes 4 taps a row");
  if constexpr (DOWN == 1) {
#pragma unroll
    for (int b = 0; b < FW; ++b) w[b] = p[b];
  } else if constexpr (ODD) {
    const float2 m = *reinterpret_cast<const float2*>(p + 1);
    w[0] = p[0]; w[1] = m.x; w[2] = m.y; w[3] = p[3];
  } else {
    const float2 l = *reinterpret_cast<const float2*>(p);
    const float2 h = *reinterpret_cast<const float2*>(p + 2);
    w[0] = l.x; w[1] = l.y; w[2] = h.x; w[3] = h.y;
  }
}

// A block: an FR_Y x F4_TX output tile of one image. (1) It stages the
// tile's input window, DOWN (FR_Y - 1) + FH rows of DOWN (F4_TX - 1) + FW
// columns, once, as f32 in shared memory, zero outside the image: with
// aligned rows (VEC, the "rows" plan) by 16-byte loads of aligned chunks
// (a chunk lies inside its row or outside it as a whole), all of a
// thread's loads in flight before its 16-byte stores (the staged rows
// start at the chunk holding the first column, `off` columns before it);
// else ("rows_scalar") element by element. (2) Each warp walks down its
// strip of FR_R output rows, a lane an output column, keeping the FH window
// rows of its current output row in registers and reading DOWN new rows a
// step. Each output sums its taps (constant operands) in the generic
// kernel's order, a then b, with fmaf from 0, so it equals the generic
// kernel's output bit for bit. Stores are coalesced (32 consecutive
// outputs a warp).
template <typename T, int DOWN, bool VEC, bool ODD, int FH, int FW>
__global__ void __launch_bounds__(F4_THREADS) upfirdn2d_fir4_kernel(
    const T* __restrict__ x, T* __restrict__ y, int H, int W, int OH, int OW, int px0,
    int py0, Taps16 taps) {
  constexpr int WIN_X = DOWN * (F4_TX - 1) + FW, WIN_Y = DOWN * (FR_Y - 1) + FH;
  constexpr int V = 16 / (int)sizeof(T);                 // elements of a 16-byte chunk
  constexpr int NCH = (WIN_X + 2 * (V - 1)) / V;         // chunks a staged row, at most
  constexpr int SW = VEC ? V * NCH : (WIN_X + 1) & ~1;   // staged row stride, floats (even)
  __shared__ __align__(16) float win[WIN_Y * SW];
  const int tid = threadIdx.x;
  const long long nc = blockIdx.z;
  const int ox0 = blockIdx.x * F4_TX, oy0 = blockIdx.y * FR_Y;
  const int sx = DOWN * ox0 - px0, sy = DOWN * oy0 - py0;   // the window's first input
  const T* src = x + nc * H * W;
  int off = 0;
  if constexpr (VEC) {
    constexpr int ITER = (WIN_Y * NCH + F4_THREADS - 1) / F4_THREADS;
    const int base = sx & ~(V - 1);
    off = sx - base;
    uint4 raw[ITER];
#pragma unroll
    for (int k = 0; k < ITER; ++k) {
      const int i = tid + k * F4_THREADS, r = i / NCH, c = i - r * NCH;
      const int iy = sy + r, g = base + V * c;
      raw[k] = make_uint4(0u, 0u, 0u, 0u);
      if (i < WIN_Y * NCH && iy >= 0 && iy < H && g >= 0 && g < W)
        raw[k] = *reinterpret_cast<const uint4*>(src + (long long)iy * W + g);
    }
#pragma unroll
    for (int k = 0; k < ITER; ++k) {
      const int i = tid + k * F4_THREADS;
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
    for (int i = tid; i < WIN_Y * WIN_X; i += F4_THREADS) {
      const int r = i / WIN_X, c = i - r * WIN_X;
      const int iy = sy + r, ix = sx + c;
      win[r * SW + c] = iy >= 0 && iy < H && ix >= 0 && ix < W
                            ? to_f(src[(long long)iy * W + ix]) : 0.f;
    }
  }
  __syncthreads();

  const int lx = (threadIdx.x >> 5 & 1) * 32 + (threadIdx.x & 31), ox = ox0 + lx;
  const int r0 = (threadIdx.x >> 6) * FR_R;        // the strip's first output row in the tile
  if (oy0 + r0 >= OH) return;                      // uniform across the warp
  const float* col = win + off + DOWN * lx;        // the lane's first window column
  // the strip's outputs in this column: one pointer, moved a row at a time
  T* dst = y + (nc * OH + oy0 + r0) * OW + ox;
  const int rows = ox < OW ? min(FR_R, OH - oy0 - r0) : 0;
  // w[k]: window row DOWN * (row - oy0) + k of the current output row
  float w[FH][FW];
#pragma unroll
  for (int k = 0; k < FH - DOWN; ++k)
    fir4_row<DOWN, ODD, FW>(col + (DOWN * r0 + k) * SW, w[k]);
#pragma unroll
  for (int r = 0; r < FR_R; ++r) {
    const int wr = DOWN * (r0 + r);
#pragma unroll
    for (int k = FH - DOWN; k < FH; ++k) fir4_row<DOWN, ODD, FW>(col + (wr + k) * SW, w[k]);
    float acc = 0.f;
#pragma unroll
    for (int a = 0; a < FH; ++a)
#pragma unroll
      for (int b = 0; b < FW; ++b) acc = fmaf(taps.f[a * FW + b], w[a][b], acc);
    const T v = from_f<T>(acc);
    if (r < rows) *dst = v;
    dst += OW;
#pragma unroll
    for (int k = 0; k < FH - DOWN; ++k)
#pragma unroll
      for (int b = 0; b < FW; ++b) w[k][b] = w[k + DOWN][b];
  }
}

template <typename T, int DOWN, int FH, int FW>
cudaError_t launch_fir4_rows(const T* x, T* y, int NC, int H, int W, int OH, int OW, int px0,
                             int py0, bool vec, const Taps16& taps, cudaStream_t s) {
  dim3 grid((OW + F4_TX - 1) / F4_TX, (OH + FR_Y - 1) / FR_Y, NC);
  if (grid.y > 65535) return cudaErrorInvalidValue;
#define P3D_FIR4(VEC, ODD)                                                          \
  upfirdn2d_fir4_kernel<T, DOWN, VEC, ODD, FH, FW><<<grid, F4_THREADS, 0, s>>>(x, y, H, W, \
                                                                              OH, OW, px0, \
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

// ---- the flat plan: unaligned rows of many tiles ----

// The flat plan's geometry: a TY x F4_TX output tile and its input window
// (WIN_Y x WIN_X), staged as rows of NCH 16-byte chunks (V elements), SW
// elements a row, in the input's dtype
template <typename T, int DOWN, int FH, int FW>
struct F4Geom {
  static constexpr int TY = F4_Y;
  static constexpr int R = TY * F4_WX / (F4_THREADS / 32);   // output rows a warp walks
  static constexpr int WIN_X = DOWN * (F4_TX - 1) + FW, WIN_Y = DOWN * (TY - 1) + FH;
  static constexpr int V = 16 / (int)sizeof(T);
  static constexpr int NCH = (WIN_X + 2 * (V - 1)) / V;
  static constexpr int SW = V * NCH;
  static constexpr int BUF = WIN_Y * SW;                     // elements of the staged window
  static_assert(R >= 1 && R * (F4_THREADS / 32) == TY * F4_WX, "whole strips");
};

// 16 bytes global -> shared by cp.async: the first `bytes` read from src,
// the rest zero-filled (bytes 0: src is not read)
__device__ __forceinline__ void f4_cp_async(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes));
}

struct F4Tile { int nc, oy0, ox0; };

// Stage a flat tile's window (first input (sy, sx) of its plane) into buf:
// the nrows x ncols inputs its valid outputs read, in the input's dtype, by
// cp.async. x is read through xa, the 16-byte boundary at or before it;
// `plane` is the plane's first element counted from xa. So every chunk is
// aligned: window row k holds the 16-byte chunks from the one that holds
// (sy + k, sx), its column j at k SW + off_k + j, off_k = (plane + (sy + k)
// W + sx) mod V, rows of any width alike. A warp stages 32 / NCH rows at
// once, a lane a chunk; a chunk's elements past its row's end, and whole
// chunks outside the row or the image, are zero-filled by the copy; the
// elements before the row's start in the chunk that straddles it are the
// previous row's (or, before the tensor, the same allocation's) until
// f4_fix_left zeroes them.
template <typename T, int DOWN, int FH, int FW>
__device__ __forceinline__ void f4_stage(T* buf, const T* __restrict__ xa, long long plane,
                                         int H, int W, int sy, int sx, int nrows, int ncols) {
  using G = F4Geom<T, DOWN, FH, FW>;
  constexpr int RPW = G::NCH < 32 ? 32 / G::NCH : 1;   // rows a warp stages at once
  const int lane = threadIdx.x & 31, kk = lane / G::NCH, c0 = lane - kk * G::NCH;
  if (kk >= RPW) return;
  for (int k = (threadIdx.x >> 5) * RPW + kk; k < nrows; k += F4_THREADS / 32 * RPW) {
    const int iy = sy + k;
    const long long f = plane + (long long)iy * W + sx;   // (sy + k, sx), counted from xa
    const int off = (int)(f & (G::V - 1));
    const T* src = xa + (f - off);
    const int need = off + ncols, col0 = sx - off;         // col0: the first chunk's column
    const bool row_in = iy >= 0 && iy < H;
    T* drow = buf + k * G::SW;
    for (int c = c0; c * G::V < need; c += 32) {
      const int col = col0 + c * G::V;
      const int in = row_in && col + G::V > 0 ? min(W - col, G::V) : 0;
      const int bytes = in > 0 ? in * (int)sizeof(T) : 0;
      f4_cp_async(drow + c * G::V, bytes ? src + c * G::V : xa, bytes);
    }
  }
}

// zero the staged columns left of the image (j < lo = -sx) of a left-edge
// tile's rows; f0: the low bits of plane + sy W + sx
template <typename T, int DOWN, int FH, int FW>
__device__ __forceinline__ void f4_fix_left(T* buf, unsigned f0, int W, int lo, int nrows) {
  using G = F4Geom<T, DOWN, FH, FW>;
  const int lane = threadIdx.x & 31;
  for (int k = threadIdx.x >> 5; k < nrows; k += F4_THREADS / 32) {
    T* row = buf + k * G::SW + (int)((f0 + (unsigned)k * (unsigned)W) & (G::V - 1));
    for (int j = lane; j < lo; j += 32) row[j] = from_f<T>(0.f);
  }
}

// two adjacent outputs: one 4-byte (bf16x2) or 8-byte (float2) store where
// the pair is aligned (paired), else scalar ones
__device__ __forceinline__ void f4_store2(__nv_bfloat16* p, float a, float b, bool paired,
                                          bool second) {
  if (paired && second) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    p[0] = __float2bfloat16(a);
    if (second) p[1] = __float2bfloat16(b);
  }
}
__device__ __forceinline__ void f4_store2(float* p, float a, float b, bool paired, bool second) {
  if (paired && second) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    p[0] = a;
    if (second) p[1] = b;
  }
}

// A flat tile's outputs from its staged window: a lane owns F4_P adjacent
// output columns and walks down its warp's strip of R rows, keeping the FH
// window rows of its current output row in registers (widened to f32 as
// read) and reading DOWN new rows a step; F4_P = 2: the pair goes out as
// one store. Each output sums its taps in the generic kernel's order, a then b,
// with fmaf from 0, so it equals that kernel's output bit for bit. Lanes
// past the tile's valid outputs read what the buffer holds and store
// nothing.
template <typename T, int DOWN, int FH, int FW>
__device__ __forceinline__ void f4_compute(const T* buf, T* __restrict__ y, int OH, int OW,
                                           int W, F4Tile tl, unsigned f0, const Taps16& taps) {
  using G = F4Geom<T, DOWN, FH, FW>;
  constexpr int NW = DOWN * (F4_P - 1) + FW;   // window columns a lane reads
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lx = (warp % F4_WX) * 32 + lane;    // the lane's column group in the tile
  const int r0 = (warp / F4_WX) * G::R;         // the strip's first output row in the tile
  const int oy = tl.oy0 + r0;
  // uniform across the warp: a strip below the image or right of it
  if (oy >= OH || tl.ox0 + F4_P * (lx - lane) >= OW) return;
  const int ox = tl.ox0 + F4_P * lx;
  const T* col = buf + DOWN * F4_P * lx;
  const unsigned fr = f0 + (unsigned)(DOWN * r0) * (unsigned)W;   // the strip's first row
  auto load = [&](int k, float (&w)[NW]) {      // window row DOWN r0 + k, widened
    const T* p = col + (DOWN * r0 + k) * G::SW +
                 (int)((fr + (unsigned)k * (unsigned)W) & (G::V - 1));
#pragma unroll
    for (int j = 0; j < NW; ++j) w[j] = to_f(p[j]);
  };
  float w[FH][NW];
#pragma unroll
  for (int k = 0; k < FH - DOWN; ++k) load(k, w[k]);
  T* dst = y + ((long long)tl.nc * OH + oy) * OW + ox;
  const int rows = ox < OW ? min(G::R, OH - oy) : 0;
  const bool paired = (OW & 1) == 0, second = ox + 1 < OW;
#pragma unroll
  for (int r = 0; r < G::R; ++r) {
#pragma unroll
    for (int k = FH - DOWN; k < FH; ++k) load(DOWN * r + k, w[k]);
    float o[F4_P];
#pragma unroll
    for (int p = 0; p < F4_P; ++p) {
      float acc = 0.f;
#pragma unroll
      for (int a = 0; a < FH; ++a)
#pragma unroll
        for (int b = 0; b < FW; ++b) acc = fmaf(taps.f[a * FW + b], w[a][DOWN * p + b], acc);
      o[p] = acc;
    }
    if (r < rows) {
      if constexpr (F4_P == 2) f4_store2(dst, o[0], o[1], paired, second);
      else *dst = from_f<T>(o[0]);
    }
    dst += OW;
#pragma unroll
    for (int k = 0; k < FH - DOWN; ++k)
#pragma unroll
      for (int j = 0; j < NW; ++j) w[k][j] = w[k + DOWN][j];
  }
}

// The flat plan: a block a TY x F4_TX output tile, tiles in the order of
// column, row, plane: its window staged in shared memory (f4_stage), the
// columns left of the image zeroed in a left-edge tile (f4_fix_left), then
// its outputs (f4_compute).
template <typename T, int DOWN, int FH, int FW>
__global__ void __launch_bounds__(F4_THREADS, F4_MINB) upfirdn2d_fir4_flat_kernel(
    const T* __restrict__ xa, int e0, T* __restrict__ y, int H, int W, int OH, int OW,
    int px0, int py0, int tiles_x, int tiles_y, Taps16 taps) {
  using G = F4Geom<T, DOWN, FH, FW>;
  extern __shared__ __align__(16) unsigned char f4_smem[];
  T* const buf = reinterpret_cast<T*>(f4_smem);
  const int per = tiles_x * tiles_y, nc = blockIdx.x / per, rem = blockIdx.x - nc * per;
  const int r = rem / tiles_x;
  const F4Tile tl{nc, r * G::TY, (rem - r * tiles_x) * F4_TX};
  // the rows and columns of the tile's window its valid outputs read
  const int nrows = DOWN * (min(G::TY, OH - tl.oy0) - 1) + FH;
  const int ncols = DOWN * (min(F4_TX, OW - tl.ox0) - 1) + FW;
  const int sy = DOWN * tl.oy0 - py0, sx = DOWN * tl.ox0 - px0;
  f4_stage<T, DOWN, FH, FW>(buf, xa, e0 + (long long)nc * H * W, H, W, sy, sx, nrows, ncols);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const unsigned f0 = (unsigned)(e0 + ((long long)nc * H + sy) * W + sx);
  if (sx < 0) {   // uniform across the block
    f4_fix_left<T, DOWN, FH, FW>(buf, f0, W, min(-sx, ncols), nrows);
    __syncthreads();
  }
  f4_compute<T, DOWN, FH, FW>(buf, y, OH, OW, W, tl, f0, taps);
}

template <typename T, int DOWN, int FH, int FW>
cudaError_t launch_fir4_flat(const T* x, T* y, int NC, int H, int W, int OH, int OW, int px0,
                             int py0, const Taps16& taps, cudaStream_t s) {
  using G = F4Geom<T, DOWN, FH, FW>;
  const int tiles_x = (OW + F4_TX - 1) / F4_TX, tiles_y = (OH + G::TY - 1) / G::TY;
  const long long n_tiles = (long long)NC * tiles_x * tiles_y;
  if (n_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x);
  if (addr % sizeof(T) != 0) return cudaErrorMisalignedAddress;
  const int e0 = (int)(addr % 16 / sizeof(T));   // x's elements past a 16-byte boundary
  const auto kernel = upfirdn2d_fir4_flat_kernel<T, DOWN, FH, FW>;
  const size_t smem = (size_t)G::BUF * sizeof(T);
  if (smem > 48 * 1024) {
    // this instantiation's limit, raised at its first launch on each device
    static unsigned raised = 0;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev >= 32 || !(raised >> dev & 1u)) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
      if (dev < 32) raised |= 1u << dev;
    }
  }
  kernel<<<(unsigned)n_tiles, F4_THREADS, smem, s>>>(x - e0, e0, y, H, W, OH, OW, px0, py0,
                                                     tiles_x, tiles_y, taps);
  return cudaGetLastError();
}

// The plan that ops/upfirdn2d.py:fir4_block_plan chose (F4_PLAN_*; `rows`:
// the planes plan's output rows a thread). A plan the call cannot take (the
// rows plan on rows that are not 16-byte aligned, `rows` outside 1..F4_PR)
// is refused, not replaced.
template <typename T, int DOWN, int FH = 4, int FW = 4>
cudaError_t launch_fir4(const void* x, void* y, int NC, int H, int W, int OH, int OW, int px0,
                        int py0, const Taps16& taps, int plan, int rows, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  switch (plan) {
    case F4_PLAN_PLANES: {
      if (rows < 1 || rows > F4_PR) return cudaErrorInvalidValue;
      const int strips = (OH + rows - 1) / rows;
      const long long n = (long long)NC * OW * strips;
      if (n > 0x7fffffffLL) return cudaErrorInvalidValue;
      upfirdn2d_fir4_planes_kernel<T, DOWN, FH, FW>
          <<<(unsigned)((n + F4_THREADS - 1) / F4_THREADS), F4_THREADS, 0, s>>>(
              xt, yt, NC, H, W, OH, OW, px0, py0, rows, strips, taps);
      return cudaGetLastError();
    }
    case F4_PLAN_ROWS:
      if (W % (16 / (int)sizeof(T)) != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0)
        return cudaErrorMisalignedAddress;
      return launch_fir4_rows<T, DOWN, FH, FW>(xt, yt, NC, H, W, OH, OW, px0, py0, true, taps,
                                               s);
    case F4_PLAN_ROWS_SCALAR:
      return launch_fir4_rows<T, DOWN, FH, FW>(xt, yt, NC, H, W, OH, OW, px0, py0, false, taps,
                                               s);
    case F4_PLAN_FLAT:
      return launch_fir4_flat<T, DOWN, FH, FW>(xt, yt, NC, H, W, OH, OW, px0, py0, taps, s);
    default:
      return cudaErrorInvalidValue;
  }
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

// ---- more than MAX_TAPS taps at down 1: the phase-blocked large-filter kernel ----
//
// Output (oy, ox) of phase (py, px) = (oy mod upy, ox mod upx) within the
// block's tile sums the taps f[a0 + upy j][b0 + upx i] of its phase against
// input (iy + j, ix + i), where (iy, ix) steps by one from one output of
// the phase to the next. A lane owns LB_RY x LB_RC outputs of one phase
// (rows and columns of the phase's subgrid), for each of the upx column
// phases in turn. Per window row q it loads its 4 + nI - 1 staged inputs as
// float4s once, and each tap row j = q - r feeds output row r: a tap, read
// as a float4 of 4 with every lane of the warp on the same address, feeds
// LB_RC FMAs, and an input LB_RC x LB_RY.
constexpr int LB_WARPS = 4;                  // warps a block
constexpr int LB_RY = 4, LB_RC = 4;          // a lane's outputs of one phase: rows x columns
constexpr int LB_LY = 4, LB_LX = 8;          // a warp's lanes: rows x columns
constexpr int LB_SUB_H = LB_RY * LB_LY;      // phase rows of a warp's job
constexpr int LB_SUB_W = LB_RC * LB_LX;      // phase columns of a block
constexpr int LB_MAX_UPX = 4, LB_MAX_NI = 16;

// A lane's window of one staged row: 4 NCH + 4 inputs from its first
// column, as float4s (LB_RC + nI - 1 <= 4 NCH + 3 of them are read)
template <int NCH>
__device__ __forceinline__ void load_window(float (&w)[4 * NCH + 4], const float* row) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int k = 0; k <= NCH; ++k) {
    const float4 v = r4[k];
    w[4 * k] = v.x, w[4 * k + 1] = v.y, w[4 * k + 2] = v.z, w[4 * k + 3] = v.w;
  }
}

// One output row of a lane's block against one window row: the tap row tj
// (nI = 4 (NCH - 1) + rem taps), column i feeding the LB_RC outputs from
// window element c + i, in the tap order of the generic kernel
template <int NCH>
__device__ __forceinline__ void fma_row(float (&acc)[LB_RC], const float (&w)[4 * NCH + 4],
                                        const float* tj, int rem) {
  const float4* t4 = reinterpret_cast<const float4*>(tj);
#pragma unroll
  for (int k = 0; k < NCH; ++k) {
    const float4 v = t4[k];
    const float t[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
      if (k < NCH - 1 || ii < rem) {
#pragma unroll
        for (int c = 0; c < LB_RC; ++c) acc[c] = fmaf(t[ii], w[c + 4 * k + ii], acc[c]);
      }
  }
}

// NCH: chunks of 4 taps in a phase's tap row (nI <= 4 NCH; chunks below the
// last are full in every phase). Taps in shared memory, phase-major:
// [upy][upx][nJmax][4 NCH], zero past the filter; the input window staged
// as f32 (zero outside the image) in upx > 1 ? 2 : 1 copies, the second
// shifted by one column so that every phase's window starts 16-byte
// aligned; each warp's outputs of one row phase go through its own rows
// of shared memory to coalesced stores. Every phase has nJ >= LB_RY tap
// rows (large_phase), so window rows LB_RY - 1 .. nJ - 1 feed all of a
// lane's output rows, without a branch. UP1: up 1 on x (one column phase,
// one staged copy); there the 4 outputs of a lane's row are adjacent and,
// where the rows allow it (direct: a multiple of 4 outputs, an aligned y),
// go out as one vector store (a warp's 8 lanes of a row 128 contiguous
// bytes in f32) without the staged rows, and six blocks an SM share its
// registers (the 11x11's small tiles need the blocks; at up 4 EQ-R's
// shared memory holds four, and the registers go to the loop).
template <typename T, int NCH, bool UP1>
__global__ void __launch_bounds__(LB_WARPS * 32, UP1 ? 6 : 4) upfirdn2d_large_phase_kernel(
    const T* __restrict__ x, T* __restrict__ y, int H, int W, int OH, int OW, int upx_,
    int upy, int px0, int py0, int fw, int fh, const float* __restrict__ f, int nbands,
    int direct) {
  const int upx = UP1 ? 1 : upx_;
  constexpr int NIP = 4 * NCH, TWS = LB_SUB_W + 4 * NCH;
  static_assert(TWS <= 64, "a lane stages two columns of a window row");
  extern __shared__ __align__(16) float smem[];
  const int nJmax = (fh + upy - 1) / upy;
  const int PH = LB_SUB_H * nbands, th = PH + nJmax, ncopy = UP1 ? 1 : 2;
  const int SO = LB_SUB_W * upx + 1;         // a staged output row (+1: fewer conflicts)
  float* taps = smem;
  float* tile = taps + upy * upx * nJmax * NIP;
  float* outs = tile + ncopy * th * TWS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long nc = blockIdx.z;
  const int oy0 = blockIdx.y * PH * upy, ox0 = blockIdx.x * LB_SUB_W * upx;
  // the window's first input: the least over the phases, ceil((o0 - p0) / up)
  const int iy0 = -floor_div(py0 - oy0, upy), ix0 = -floor_div(px0 - ox0, upx);

  for (int ph = warp; ph < upy * upx; ph += LB_WARPS) {
    const int py = ph / upx, px = ph - py * upx;
    const int a0 = floor_mod(py0 - py, upy), b0 = floor_mod(px0 - px, upx);
    float* dst = taps + ph * nJmax * NIP;
    for (int e = lane; e < nJmax * NIP; e += 32) {
      const int j = e / NIP, i = e - j * NIP;
      const int a = a0 + upy * j, b = b0 + upx * i;
      dst[e] = a < fh && b < fw ? f[a * fw + b] : 0.f;
    }
  }
  // lane L stages columns L and L + 32 of each row of each copy
  const T* src = x + nc * H * W;
  for (int k = 0; k < ncopy; ++k) {
    const int xa = ix0 + k + lane, xb = xa + 32;
    const bool va = xa >= 0 && xa < W, has_b = lane + 32 < TWS, vb = has_b && xb >= 0 && xb < W;
    for (int row = warp; row < th; row += LB_WARPS) {
      const int iy = iy0 + row;
      const bool in_y = iy >= 0 && iy < H;
      const T* srow = src + (long long)(in_y ? iy : 0) * W;
      float* drow = tile + (k * th + row) * TWS;
      drow[lane] = in_y && va ? to_f(srow[xa]) : 0.f;
      if (has_b) drow[lane + 32] = in_y && vb ? to_f(srow[xb]) : 0.f;
    }
  }
  __syncthreads();

  const int ly = lane / LB_LX, lx = lane % LB_LX;
  float* ow = outs + warp * LB_SUB_H * SO;
  T* dst = y + nc * OH * OW;
  for (int job = warp; job < upy * nbands; job += LB_WARPS) {
    const int py = job % upy, band = job / upy;
    const int a0 = floor_mod(py0 - py, upy);
    const int nJ = (fh - a0 + upy - 1) / upy;
    const int dy = (oy0 + py + a0 - py0) / upy - iy0;   // 0 or 1
    const int row0 = dy + band * LB_SUB_H + ly * LB_RY;
    for (int px = 0; px < upx; ++px) {
      const int b0 = floor_mod(px0 - px, upx);
      const int nI = (fw - b0 + upx - 1) / upx;
      const int rem = nI - 4 * (NCH - 1);                // taps of the last chunk, 0..4
      const int dx = (ox0 + px + b0 - px0) / upx - ix0;  // 0 or 1: the copy
      const float* win = tile + (dx * th + row0) * TWS + LB_RC * lx;
      const float* tp = taps + (py * upx + px) * nJmax * NIP;
      float acc[LB_RY][LB_RC];
#pragma unroll
      for (int r = 0; r < LB_RY; ++r)
#pragma unroll
        for (int c = 0; c < LB_RC; ++c) acc[r][c] = 0.f;
      // window row q feeds output row r with tap row q - r: rows ascending
      // for each output, as the generic kernel sums them
      float w[4 * NCH + 4];
#pragma unroll
      for (int q = 0; q < LB_RY - 1; ++q) {   // output rows 0..q
        load_window<NCH>(w, win + q * TWS);
#pragma unroll
        for (int r = 0; r <= q; ++r) fma_row<NCH>(acc[r], w, tp + (q - r) * NIP, rem);
      }
      for (int q = LB_RY - 1; q < nJ; ++q) {  // every output row
        load_window<NCH>(w, win + q * TWS);
#pragma unroll
        for (int r = 0; r < LB_RY; ++r) fma_row<NCH>(acc[r], w, tp + (q - r) * NIP, rem);
      }
#pragma unroll
      for (int t = 0; t < LB_RY - 1; ++t) {   // output rows t + 1..
        const int q = nJ + t;
        load_window<NCH>(w, win + q * TWS);
#pragma unroll
        for (int r = t + 1; r < LB_RY; ++r) fma_row<NCH>(acc[r], w, tp + (q - r) * NIP, rem);
      }
      if (UP1 && direct) {   // px 0 only
        const int ox = ox0 + LB_RC * lx;
#pragma unroll
        for (int r = 0; r < LB_RY; ++r) {
          const int oy = oy0 + py + upy * (band * LB_SUB_H + ly * LB_RY + r);
          if (oy < OH && ox < OW)
            store4(dst + (long long)oy * OW + ox,
                   make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]));
        }
        continue;
      }
#pragma unroll
      for (int r = 0; r < LB_RY; ++r)
#pragma unroll
        for (int c = 0; c < LB_RC; ++c)
          ow[(ly * LB_RY + r) * SO + px + upx * (LB_RC * lx + c)] = acc[r][c];
    }
    if (UP1 && direct) continue;
    __syncwarp();
    for (int s = 0; s < LB_SUB_H; ++s) {
      const int oy = oy0 + py + upy * (band * LB_SUB_H + s);
      if (oy >= OH) break;
      for (int col = lane; col < LB_SUB_W * upx; col += 32)
        if (ox0 + col < OW) dst[(long long)oy * OW + ox0 + col] = from_f<T>(ow[s * SO + col]);
    }
    __syncwarp();
  }
}

// the phase-blocked kernel's geometry, or false where it does not take the
// call (ops/upfirdn2d.py:large_phase_geometry decides alike)
struct LargePhase { int nch, nbands; size_t smem; };

inline bool large_phase(int upx, int upy, int downx, int downy, int fw, int fh,
                        LargePhase& g) {
  if (downx != 1 || downy != 1 || upx > LB_MAX_UPX) return false;
  const int nImax = (fw + upx - 1) / upx, nJmax = (fh + upy - 1) / upy;
  if (nImax > LB_MAX_NI || fh / upy < LB_RY) return false;   // fh / upy: the least nJ
  g.nch = (nImax + 3) / 4;
  g.nbands = upy >= LB_WARPS ? 1 : (LB_WARPS + upy - 1) / upy;
  const size_t th = (size_t)LB_SUB_H * g.nbands + nJmax, tws = LB_SUB_W + 4 * g.nch;
  g.smem = sizeof(float) * ((size_t)upy * upx * nJmax * 4 * g.nch
                            + (upx > 1 ? 2 : 1) * th * tws
                            + (size_t)LB_WARPS * LB_SUB_H * (LB_SUB_W * upx + 1));
  return g.smem <= 227 * 1024;
}

template <typename T, int NCH>
cudaError_t launch_large_phase_nch(const void* x, void* y, int NC, int H, int W, int OH,
                                   int OW, int upx, int upy, int px0, int py0, int fw, int fh,
                                   const float* f, const LargePhase& g, cudaStream_t s) {
  const auto kernel = upx == 1 ? upfirdn2d_large_phase_kernel<T, NCH, true>
                               : upfirdn2d_large_phase_kernel<T, NCH, false>;
  if (g.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)g.smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((OW + LB_SUB_W * upx - 1) / (LB_SUB_W * upx),
                  (OH + LB_SUB_H * g.nbands * upy - 1) / (LB_SUB_H * g.nbands * upy), NC);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const int direct = upx == 1 && OW % 4 == 0 && aligned4<T>(y);
  kernel<<<grid, LB_WARPS * 32, g.smem, s>>>(static_cast<const T*>(x), static_cast<T*>(y),
                                             H, W, OH, OW, upx, upy, px0, py0, fw, fh, f,
                                             g.nbands, direct);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_large_phase(const void* x, void* y, int NC, int H, int W, int OH, int OW,
                               int upx, int upy, int px0, int py0, int fw, int fh,
                               const float* f, const LargePhase& g, cudaStream_t s) {
#define P3D_LP(N)                                                                          \
  return launch_large_phase_nch<T, N>(x, y, NC, H, W, OH, OW, upx, upy, px0, py0, fw, fh, f, \
                                      g, s)
  switch (g.nch) {
    case 1: P3D_LP(1);
    case 2: P3D_LP(2);
    case 3: P3D_LP(3);
    default: P3D_LP(4);
  }
#undef P3D_LP
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

// ---- a 1-D pass at up = 2 or down = 2 on its axis: the polyphase 1-D forms ----

constexpr int POLY_MAX_TAPS = 16;   // the most taps the 1-D polyphase forms take
constexpr int ROW2_PAIRS = 64;      // output pairs a warp of the up-2 row form, 2 a lane
constexpr int ROW2_RUN = 128;       // outputs a warp of the down-2 row form, 4 a lane
constexpr int ROW2_RPW = 4;         // output rows a warp of the row form

// A 1-D pass's taps by output phase (up 2) or in order (down 2). At up 2,
// output 2m + r of the scaled axis sums f[r * MAX_TAPS / 2 + i] x[m + s_r +
// i], i < n[r], in the order of the generic kernel's taps (b0_r + 2 i
// ascending, b0_r = (p0 - r) mod 2); s_1 = s0 + DS, DS 0 or 1. At down 2,
// output o sums f[b] x[2 o + b - p0], b < n[0].
struct Poly {
  float f[MAX_TAPS];
  int n[2];
  int s0;
};

// the row form: fh == 1, up or down 2 on x. A warp owns a run of ROW2_RPW
// output rows (64 pairs at up 2, 128 outputs at down 2; with one row a warp
// a block lives ~3 us on an H100, and block launches, not bytes, bound the
// form): it stages the rows' input runs (every load of the warp in flight
// before the first store) and each lane computes 4 adjacent outputs of a
// row from one window of the staged run: at up 2 pairs 2 lane and 2 lane +
// 1 (n + DS + 1 inputs, read as float2s), at down 2 outputs 4 lane .. 4
// lane + 3 (n + 6 inputs, read as float4s), the taps by value; the 4
// outputs go out as one vector store where the rows allow it, else as pair
// or scalar stores. K >= the taps (unrolled, the taps past the filter's
// predicated off).
template <typename T, int K, bool UP2, int DS, bool VIN>
__global__ void __launch_bounds__(32 * ROW_WARPS) upfirdn2d_rows2_kernel(
    const T* __restrict__ x, T* __restrict__ y, int H, int W, int OH, int OW, int px0, int py0,
    Poly p) {
  constexpr int NP = K / 2;
  constexpr int MAXLEN = UP2 ? ROW2_PAIRS + NP + 1 : 2 * ROW2_RUN - 2 + K;   // a run's inputs
  // a lane's window: up 2, NP + DS + 1 inputs from 2 lane (float2s); down 2,
  // K + 6 from 8 lane (float4s)
  constexpr int WN = UP2 ? (NP + DS + 2) / 2 * 2 : (K + 6 + 3) / 4 * 4;
  constexpr int SLEN = (MAXLEN + WN + 3) / 4 * 4;   // room past the run for the windows
  __shared__ __align__(16) float stage[ROW_WARPS][ROW2_RPW][SLEN];
  const int lane = threadIdx.x;
  const int oy0 = (blockIdx.y * ROW_WARPS + threadIdx.y) * ROW2_RPW;
  if (oy0 >= OH) return;   // uniform across the warp; the warp syncs only itself
  const long long nc = blockIdx.z;
  const T* img = x + nc * H * W;
  // s[j] = x[oy - py0, start + j], j < len, 0 outside the image
  const int start = UP2 ? blockIdx.x * ROW2_PAIRS + p.s0 : 2 * blockIdx.x * ROW2_RUN - px0;
  const int len = UP2 ? ROW2_PAIRS + max(p.n[0], DS + p.n[1]) : 2 * ROW2_RUN - 2 + p.n[0];
  float(*s)[SLEN] = stage[threadIdx.y];
  if constexpr (VIN) {
    // aligned 4-wide chunks from the one holding `start` (W % 4 == 0: a
    // chunk is inside the row or outside it as a whole)
    constexpr int CPL = (MAXLEN + 6 + 127) / 128;   // chunks a lane
    const int base = start & ~3, chunks = (start + len - base + 3) >> 2;
    float4 q[ROW2_RPW][CPL];
#pragma unroll
    for (int k = 0; k < ROW2_RPW; ++k) {
      const int iy = oy0 + k - py0;
      const bool row_in = oy0 + k < OH && iy >= 0 && iy < H;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int ch = lane + 32 * c, g = base + 4 * ch;
        q[k][c] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row_in && ch < chunks && g >= 0 && g < W) q[k][c] = load4(img + (long long)iy * W + g);
      }
    }
#pragma unroll
    for (int k = 0; k < ROW2_RPW; ++k)
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int ch = lane + 32 * c, g = base + 4 * ch;
        const float e[4] = {q[k][c].x, q[k][c].y, q[k][c].z, q[k][c].w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = g + i - start;
          if (ch < chunks && j >= 0 && j < len) s[k][j] = e[i];
        }
      }
  } else {   // unaligned rows (rare): scalar loads, a row's in flight together
    constexpr int EPL = (MAXLEN + 31) / 32;   // inputs a lane
#pragma unroll
    for (int k = 0; k < ROW2_RPW; ++k) {
      const int iy = oy0 + k - py0;
      const bool row_in = oy0 + k < OH && iy >= 0 && iy < H;
      float v[EPL];
#pragma unroll
      for (int c = 0; c < EPL; ++c) {
        const int j = lane + 32 * c, g = start + j;
        v[c] = row_in && j < len && g >= 0 && g < W ? to_f(img[(long long)iy * W + g]) : 0.f;
      }
#pragma unroll
      for (int c = 0; c < EPL; ++c)
        if (lane + 32 * c < len) s[k][lane + 32 * c] = v[c];
    }
  }
  __syncwarp();
  // the lane's 4 outputs from ox, as one vector store where OW % 4 == 0
  // (the row and the 4 outputs aligned); the window's values past the run
  // are read but meet only predicated-off taps
  const bool vec = (OW & 3) == 0;
  const int ox = UP2 ? 2 * (blockIdx.x * ROW2_PAIRS + 2 * lane) : blockIdx.x * ROW2_RUN + 4 * lane;
#pragma unroll 1
  for (int k = 0; k < ROW2_RPW && oy0 + k < OH; ++k) {
    T* out = y + (nc * OH + oy0 + k) * OW + ox;
    const float* sk = s[k];
    float w[WN];
    float o[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (UP2) {
      // pair h (output 2h + r) of phase r reads w[h + r DS + i], i < n[r]
#pragma unroll
      for (int q = 0; q < WN / 2; ++q) {
        const float2 v = *reinterpret_cast<const float2*>(sk + 2 * lane + 2 * q);
        w[2 * q] = v.x;
        w[2 * q + 1] = v.y;
      }
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        if (i < p.n[0]) {
          o[0] = fmaf(p.f[i], w[i], o[0]);
          o[2] = fmaf(p.f[i], w[1 + i], o[2]);
        }
        if (i < p.n[1]) {
          o[1] = fmaf(p.f[MAX_TAPS / 2 + i], w[DS + i], o[1]);
          o[3] = fmaf(p.f[MAX_TAPS / 2 + i], w[1 + DS + i], o[3]);
        }
      }
    } else {
      // output j reads w[2 j + b], b < n[0]
#pragma unroll
      for (int q = 0; q < WN / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(sk + 8 * lane + 4 * q);
        w[4 * q] = v.x;
        w[4 * q + 1] = v.y;
        w[4 * q + 2] = v.z;
        w[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int b = 0; b < K; ++b)
        if (b < p.n[0]) {
#pragma unroll
          for (int j = 0; j < 4; ++j) o[j] = fmaf(p.f[b], w[2 * j + b], o[j]);
        }
    }
    if (vec && ox + 3 < OW) {
      store4(out, make_float4(o[0], o[1], o[2], o[3]));
    } else if (UP2) {
      const bool paired = (OW & 1) == 0;   // 2m is even: a pair store is aligned
      if (ox < OW) store_pair<T>(out, o[0], o[1], paired, ox + 1 < OW);
      if (ox + 2 < OW) store_pair<T>(out + 2, o[2], o[3], paired, ox + 3 < OW);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (ox + j < OW) out[j] = from_f<T>(o[j]);
    }
  }
}

// the column form: fw == 1, up or down 2 on y. As the 1-D column form: a
// lane owns one output column (or, in f32, 4 adjacent ones as a float4), a
// strip of R output rows; it loads the strip's input rows once into
// registers (coalesced, all in flight together) and each output row sums
// its phase's taps (up 2: R / 2 pairs, their window of n + DS rows; down 2:
// rows 2 r + b) in the generic kernel's order.
template <typename T, int V, int K, int R, bool UP2, int DS>
__global__ void __launch_bounds__(32 * COL_WARPS) upfirdn2d_cols2_kernel(
    const T* __restrict__ x, T* __restrict__ y, int H, int W, int OH, int OW, int px0, int py0,
    Poly p) {
  constexpr int NP = K / 2;
  constexpr int NR = UP2 ? R / 2 + NP + DS : 2 * (R - 1) + K;   // the strip's input rows
  const int oy0 = (blockIdx.y * COL_WARPS + threadIdx.y) * R;
  if (oy0 >= OH) return;   // uniform across the warp
  const long long nc = blockIdx.z;
  const T* src = x + nc * H * W;
  T* dst = y + nc * OH * OW;
  const int ox = (blockIdx.x * 32 + threadIdx.x) * V;
  const int ix = ox - px0;
  const bool col_in = ix >= 0 && ix + V <= W;   // V = 4: W, OW, px0 multiples of 4
  const int iy0 = UP2 ? oy0 / 2 + p.s0 : 2 * oy0 - py0;
  const int need = UP2 ? R / 2 + max(p.n[0], DS + p.n[1]) : 2 * (R - 1) + p.n[0];
  float in[NR][V];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int iy = iy0 + i;
    const bool load = i < need && col_in && iy >= 0 && iy < H;
    if constexpr (V == 4) {
      float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
      if (load) q = load4(src + (long long)iy * W + ix);
      in[i][0] = q.x; in[i][1] = q.y; in[i][2] = q.z; in[i][3] = q.w;
    } else {
      in[i][0] = load ? to_f(src[(long long)iy * W + ix]) : 0.f;
    }
  }
  if (ox >= OW) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.f;
    if constexpr (UP2) {   // output row 2 m + (r & 1); r is unrolled, so the phase is constant
      const int m = r >> 1, ph = r & 1, d = ph ? DS : 0;
#pragma unroll
      for (int i = 0; i < NP; ++i)
        if (i < p.n[ph]) {
#pragma unroll
          for (int v = 0; v < V; ++v)
            acc[v] = fmaf(p.f[ph * (MAX_TAPS / 2) + i], in[m + d + i][v], acc[v]);
        }
    } else {
#pragma unroll
      for (int b = 0; b < K; ++b)
        if (b < p.n[0]) {
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] = fmaf(p.f[b], in[2 * r + b][v], acc[v]);
        }
    }
    const int oy = oy0 + r;
    if (oy < OH) {
      T* o = dst + (long long)oy * OW + ox;
      if constexpr (V == 4) store4(o, make_float4(acc[0], acc[1], acc[2], acc[3]));
      else o[0] = from_f<T>(acc[0]);
    }
  }
}

template <typename T, int K, bool UP2>
cudaError_t launch_rows2(const void* x, void* y, int NC, int H, int W, int OH, int OW, int px0,
                         int py0, const Poly& p, int ds, cudaStream_t s) {
  const bool vin = W % 4 == 0 && aligned4<T>(x);
  const int per = UP2 ? 2 * ROW2_PAIRS : ROW2_RUN;   // outputs of a row a warp
  dim3 grid((OW + per - 1) / per, (OH + ROW_WARPS * ROW2_RPW - 1) / (ROW_WARPS * ROW2_RPW), NC);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const dim3 block(32, ROW_WARPS);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
#define P3D_ROWS2(D, VI)                                                                   \
  upfirdn2d_rows2_kernel<T, K, UP2, D, VI><<<grid, block, 0, s>>>(xt, yt, H, W, OH, OW, px0, \
                                                                  py0, p)
  if constexpr (UP2) {
    if (ds && vin) P3D_ROWS2(1, true);
    else if (ds) P3D_ROWS2(1, false);
    else if (vin) P3D_ROWS2(0, true);
    else P3D_ROWS2(0, false);
  } else {
    if (vin) P3D_ROWS2(0, true);
    else P3D_ROWS2(0, false);
  }
#undef P3D_ROWS2
  return cudaGetLastError();
}

template <typename T, int K, bool UP2>
cudaError_t launch_cols2(const void* x, void* y, int NC, int H, int W, int OH, int OW, int px0,
                         int py0, const Poly& p, int ds, cudaStream_t s) {
  // 4 columns a lane (one float4) in f32 up to 16 taps; the strips' rows:
  // up 2, 16 output rows (8 pairs); down 2, 4 (float4s) or 8 outputs
  constexpr bool wide = sizeof(T) == 4 && K <= 16;
  constexpr int R1 = UP2 ? 16 : 8, R4 = UP2 ? 16 : 4;
  const bool v4 = wide && W % 4 == 0 && OW % 4 == 0 && px0 % 4 == 0 && aligned4<T>(x) &&
                  aligned4<T>(y);
  const int V = v4 ? 4 : 1, R = v4 ? R4 : R1;
  const int strips = (OH + R - 1) / R;
  dim3 grid((OW + 32 * V - 1) / (32 * V), (strips + COL_WARPS - 1) / COL_WARPS, NC);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const dim3 block(32, COL_WARPS);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
#define P3D_COLS2(VV, RR, D)                                                             \
  upfirdn2d_cols2_kernel<T, VV, K, RR, UP2, D><<<grid, block, 0, s>>>(xt, yt, H, W, OH, OW, \
                                                                      px0, py0, p)
  if constexpr (wide) {
    if (v4) {
      if (UP2 && ds) P3D_COLS2(4, R4, UP2 ? 1 : 0);
      else P3D_COLS2(4, R4, 0);
      return cudaGetLastError();
    }
  }
  if (UP2 && ds) P3D_COLS2(1, R1, UP2 ? 1 : 0);
  else P3D_COLS2(1, R1, 0);
#undef P3D_COLS2
  return cudaGetLastError();
}

// whether a call takes a 1-D polyphase form (ops/upfirdn2d.py:_plan decides
// alike): a filter of one row with up or down 2 on x and y unscaled (the
// row form), else of one column with up or down 2 on y and x unscaled (the
// column form), of at most POLY_MAX_TAPS taps
inline bool poly_form(int upx, int upy, int downx, int downy, int fw, int fh, bool& rows,
                      bool& up2) {
  const bool two_x = (upx == 2 && downx == 1) || (upx == 1 && downx == 2);
  const bool two_y = (upy == 2 && downy == 1) || (upy == 1 && downy == 2);
  if (fh == 1 && upy == 1 && downy == 1 && two_x && fw <= POLY_MAX_TAPS) {
    rows = true;
    up2 = upx == 2;
    return true;
  }
  if (fw == 1 && upx == 1 && downx == 1 && two_y && fh <= POLY_MAX_TAPS) {
    rows = false;
    up2 = upy == 2;
    return true;
  }
  return false;
}

// the taps of a 1-D pass at up 2 (by phase, from the scaled axis's leading
// padding p0) or down 2 (in order) -> (Poly, DS)
inline Poly make_poly(const float* f, int n, int p0, bool up2, int& ds) {
  Poly p{};
  ds = 0;
  if (!up2) {
    for (int b = 0; b < n; ++b) p.f[b] = f[b];
    p.n[0] = n;
    return p;
  }
  int s[2];
  for (int r = 0; r < 2; ++r) {
    const int b0 = ((p0 - r) % 2 + 2) % 2;   // the phase's first tap
    p.n[r] = b0 < n ? (n - b0 + 1) / 2 : 0;
    for (int i = 0; i < p.n[r]; ++i) p.f[r * (MAX_TAPS / 2) + i] = f[b0 + 2 * i];
    s[r] = (r + b0 - p0) / 2;                // r + b0 - p0 is even
  }
  p.s0 = s[0];
  ds = s[1] - s[0];                          // 0 (p0 odd) or 1 (p0 even)
  return p;
}

template <typename T>
cudaError_t launch_poly(const void* x, void* y, int NC, int H, int W, int OH, int OW, int px0,
                        int py0, int fw, int fh, const float* f, bool rows, bool up2,
                        cudaStream_t s) {
  const int n = rows ? fw : fh;
  int ds;
  const Poly p = make_poly(f, n, rows ? px0 : py0, up2, ds);
#define P3D_POLY(KK)                                                                         \
  return rows ? (up2 ? launch_rows2<T, KK, true>(x, y, NC, H, W, OH, OW, px0, py0, p, ds, s)  \
                     : launch_rows2<T, KK, false>(x, y, NC, H, W, OH, OW, px0, py0, p, ds, s)) \
              : (up2 ? launch_cols2<T, KK, true>(x, y, NC, H, W, OH, OW, px0, py0, p, ds, s)  \
                     : launch_cols2<T, KK, false>(x, y, NC, H, W, OH, OW, px0, py0, p, ds, s))
  if (n <= 8) P3D_POLY(8);
  if (n <= 12) P3D_POLY(12);   // 12 taps: sym6, the kaiser filters of StyleGAN3's layers
  P3D_POLY(16);
#undef P3D_POLY
}

}  // namespace

// x: [NC, H, W] (f32 or bf16), y: [NC, OH, OW] in the same dtype; f: fh*fw
// host floats (<= 64 taps), already flipped and gained (the kernel
// correlates); a filter of more than 64 taps comes instead as f_dev, fh*fw
// floats on the device (f is then null) and runs the phase-blocked
// large-filter kernel where it takes the call (large_phase), else the tiled
// one. Padding px0/py0 is relative to the zero-inserted image and may be
// negative (a crop); px1/py1 enter only through OH/OW. NC <= 65535.
// phase_taps / phase_src: the polyphase table of an up=2, down=1, 4x4 call
// (ops/upfirdn2d.py:k4_plan): 16 taps [ry][rx][j][i] and the source offsets
// (sy0, sy1, sx0, sx1), whose two phases are equal or one apart for 4 taps.
// Such a call runs the polyphase kernel; a 4x4 filter at up = 1 and down = 2
// (or 1) on both axes the 4x4 form; another 2-D filter of at most 4x4 at up
// = down = 1 the 4x4 form at its size; a filter of one row or one column at
// up = down = 1 the row or the column form, at up or down 2 on its axis
// (the other unscaled, at most 16 taps) the 1-D polyphase row or column
// form; any other call the generic kernel (ops/upfirdn2d.py:k4_plan names
// the same variant). Both tables may be null for a call outside the
// polyphase family. f4_plan / f4_rows: a 4x4-form call's block plan
// (F4_PLAN_*) and the planes plan's output rows a thread, as
// ops/upfirdn2d.py:fir4_block_plan chose them; 0 for another call.
PANIC3D_EXPORT int upfirdn2d(const void* x, void* y, int dtype, int NC, int H, int W,
                             int OH, int OW, int upx, int upy, int downx, int downy,
                             int px0, int py0, const float* f, int fw, int fh,
                             const float* phase_taps, const int* phase_src,
                             const float* f_dev, int f4_plan, int f4_rows, void* stream) {
  if (fw < 1 || fh < 1 || NC < 1 || NC > 65535 || OH < 1 || OW < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fw * fh > MAX_TAPS) {
    if (f_dev == nullptr) return (int)cudaErrorInvalidValue;
    LargePhase g;
    if (large_phase(upx, upy, downx, downy, fw, fh, g)) {
      if (dtype == DT_BF16)
        return (int)launch_large_phase<__nv_bfloat16>(x, y, NC, H, W, OH, OW, upx, upy, px0,
                                                      py0, fw, fh, f_dev, g, s);
      return (int)launch_large_phase<float>(x, y, NC, H, W, OH, OW, upx, upy, px0, py0, fw,
                                            fh, f_dev, g, s);
    }
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
#define P3D_F4(T, D) \
  return (int)launch_fir4<T, D>(x, y, NC, H, W, OH, OW, px0, py0, t16, f4_plan, f4_rows, s)
    if (dtype == DT_BF16) {
      if (downx == 2) P3D_F4(__nv_bfloat16, 2);
      P3D_F4(__nv_bfloat16, 1);
    }
    if (downx == 2) P3D_F4(float, 2);
    P3D_F4(float, 1);
#undef P3D_F4
  }
  const bool unit = upx == 1 && upy == 1 && downx == 1 && downy == 1;
  if (unit && fw >= 2 && fh >= 2 && fw <= 4 && fh <= 4) {   // a small 2-D filter, not 4x4
    Taps16 t16;
    for (int i = 0; i < fw * fh; ++i) t16.f[i] = f[i];
#define P3D_FS(FH, FW)                                                                   \
  if (fh == FH && fw == FW)                                                              \
    return (int)(dtype == DT_BF16                                                        \
                     ? launch_fir4<__nv_bfloat16, 1, FH, FW>(x, y, NC, H, W, OH, OW, px0, \
                                                             py0, t16, f4_plan, f4_rows, s) \
                     : launch_fir4<float, 1, FH, FW>(x, y, NC, H, W, OH, OW, px0, py0, t16,  \
                                                     f4_plan, f4_rows, s))
    P3D_FS(2, 2); P3D_FS(2, 3); P3D_FS(2, 4);
    P3D_FS(3, 2); P3D_FS(3, 3); P3D_FS(3, 4);
    P3D_FS(4, 2); P3D_FS(4, 3);
#undef P3D_FS
  }
  Taps taps;
  for (int i = 0; i < fw * fh; ++i) taps.f[i] = f[i];
  if (unit && (fh == 1 || fw == 1)) {
    if (dtype == DT_BF16)
      return (int)launch_1d<__nv_bfloat16>(x, y, NC, H, W, OH, OW, px0, py0, fw, fh, taps, s);
    return (int)launch_1d<float>(x, y, NC, H, W, OH, OW, px0, py0, fw, fh, taps, s);
  }
  bool rows, poly_up2;
  if (poly_form(upx, upy, downx, downy, fw, fh, rows, poly_up2)) {
    if (dtype == DT_BF16)
      return (int)launch_poly<__nv_bfloat16>(x, y, NC, H, W, OH, OW, px0, py0, fw, fh, f, rows,
                                             poly_up2, s);
    return (int)launch_poly<float>(x, y, NC, H, W, OH, OW, px0, py0, fw, fh, f, rows, poly_up2,
                                   s);
  }
  if (dtype == DT_BF16)
    return (int)launch<__nv_bfloat16>(x, y, NC, H, W, OH, OW, upx, upy, downx, downy, px0,
                                      py0, fw, fh, taps, s);
  return (int)launch<float>(x, y, NC, H, W, OH, OW, upx, upy, downx, downy, px0, py0, fw,
                            fh, taps, s);
}
