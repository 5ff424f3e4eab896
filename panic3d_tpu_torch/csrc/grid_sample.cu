// K14 grid_sample_2d: the bilinear sample of an f32 image batch x [N,C,H,W]
// at a grid [N,Hg,Wg,2] of (x, y) in [-1, 1] -> y [N,C,Hg,Wg], with zeros
// or border padding and either align_corners, and its backward form to the
// image, grid_sample_2d_grad.
//
// Replaces (JAX): panic3d_tpu/ops/grid_sample.py:grid_sample_2d (:256) and
// the grid_sample_2d_points (:42) it reshapes around, an XLA gather + lerp on
// the TPU; its gradient to the image is XLA's autodiff of the same ops. The
// port calls it in ADA's geometric warp (training/augment.py, f32
// [8,6,1560,1560] at [8,1036,1036,2], forward and backward, and R1's second
// order), the equivariance metrics' EQ-R ([4,3,2094,2094] at [4,512,512,2])
// and the training loss mask ([N,2,64,64]).
//
// What bounds it on the H100: bytes. A point reads its two coordinates once
// and, for each channel, four neighbouring texels, and writes one value: a
// few operations a byte. The image's texels count once: neighbouring points
// read the same texels. The backward reads the output's gradient and the
// grid and adds four terms a channel into the image's gradient, which the
// wrapper zeroes (that write is part of its bound: the gradient written
// once). Both kernels stall on memory latency long before the bytes run out,
// so the design is about bytes in flight: resident threads and independent
// loads.
//
// Both kernels: a block takes a tile of 16 x 16 output points of one image
// (blockIdx.z), a thread a point, so that a warp's loads and stores touch
// two 64-byte rows and its corners a compact patch of the image (what the L1
// serves); 32-bit offsets within a plane (the wrapper refuses H W or Hg Wg
// >= 2^31); a point is read once (a float2) and reduced once to its corner
// 00 clamped into the image, the steps to 01 and 10 (0 where the clamp folds
// them), four validity bits and its weights: few registers, so that 6 blocks
// (1,536 threads, 40 registers a thread) stay resident on an SM.
//
// Forward: the corners of CHUNK = 2 channels are loaded (8 independent
// loads) before their lerps and stores. It has one branch: a staged one
// (the tile's source footprint copied into shared memory by cp.async, the
// corners read from there) lost to it at every grid measured (PERF.md):
// the footprint costs ~2 texels a point a channel from the L2 and a
// block barrier a channel, where the L1 serves the gathers of neighbouring
// points from the same lines.
//
// Backward: the block reduces its tile's footprint, the bounding box of its
// points' valid corners (under border padding the clamped corners), its
// x-start rounded down to a multiple of 4 and its width up to one.
// Footprint test: a box of at most STAGE = 1024 texels (4 a point of a full
// tile) takes the staged branch, a larger or empty one the direct branch;
// the choice is the block's, on the device, so the wrapper never reads the
// grid (ops/grid_sample.py:k14_tile_plan is the same test in PyTorch; the
// check entry grid_sample_2d_grad_counted also counts the staged blocks, so
// chip_smoke.py holds the kernel's choice against the model's).
// ADA's warp (about a texel a point, any rotation) stages ~99 % of its tiles
// (median box ~520 texels); EQ-R (points ~4 texels apart on the 4x image:
// ~6,300 texels a tile) goes direct.
// Staged: each point adds its four corner terms with shared-memory atomics
// into zeroed boxes, CB = 3 channels a pass into one of two sets of boxes;
// after the pass's barrier the set is flushed to the image's gradient a
// quad of texels an atomic (red.global.add.v4.f32 where the rows run
// 16-byte aligned: W % 4 == 0 and an aligned gradient; else scalar atomics,
// a row stopped at W), quads that are all zero skipped, and zeroed for the
// pass after next: ~0.5 global atomics a point a channel where the direct
// branch (kept for the tiles that fail the test) makes 4.
//
// The arithmetic is the plain version's (ops/grid_sample.py:
// grid_sample_2d_plain), in its order and with its roundings:
// ((g + 1) W - 1) / 2 or (g + 1) / 2 (W - 1), floor, w = i - floor,
// top = v00 + (v01 - v00) wx, bot likewise, out = top + (bot - top) wy, each
// step by __fadd_rn / __fmul_rn so that nvcc contracts nothing into an FMA:
// the forward is bit-equal to the plain version. The backward's corner
// terms are the plain backward's (g_top = g - g wy, g_bot = g wy, g00 =
// g_top - g_top wx, g01 = g_top wx, ...), equal bit for bit term by term;
// only the order of the sums differs (a box's sums, then the flush), and
// varies from run to run.
//
// Resources (nvcc -Xptxas -v, sm_90a, as chip_smoke.py prints them): the
// forward 40 registers and no shared memory, the backward 40 registers and
// 24,676 bytes of static shared memory (two sets of three 4 KB boxes, the
// footprint's reduction and its box), 256 threads a block, no spills.
//
// K14_BLOCKS, K14_CHUNK and K14_CB may be set with -D to build a variant
// of a design choice (scripts/k14_variants.py times them).
#include "common.cuh"

#include <limits.h>

#ifndef K14_BLOCKS
#define K14_BLOCKS 6
#endif
#ifndef K14_CHUNK
#define K14_CHUNK 2
#endif
#ifndef K14_CB
#define K14_CB 3
#endif

namespace {

constexpr int TILE = 16;               // a block's tile: TILE x TILE output points
constexpr int THREADS = TILE * TILE;   // a thread a point
constexpr int WARPS = THREADS / 32;
constexpr int BLOCKS = K14_BLOCKS;     // resident blocks an SM: at most 40 registers a thread
constexpr int CHUNK = K14_CHUNK;       // the forward's channels a batch of loads
constexpr int STAGE = 1024;            // texels a staged box may hold (4 a point)
constexpr int CB = K14_CB;             // the staged backward's channels a pass

__device__ __forceinline__ float unnormalize(float c, int size, int align) {
  if (align) return __fmul_rn(__fdiv_rn(__fadd_rn(c, 1.f), 2.f), static_cast<float>(size - 1));
  return __fdiv_rn(__fsub_rn(__fmul_rn(__fadd_rn(c, 1.f), static_cast<float>(size)), 1.f), 2.f);
}

// a point: its corner 00 clamped into the image, the steps from it to the
// corners 01 and 10 (0 where the clamp folds them onto 00), which corners
// are valid (bit k: corner k of 00, 01, 10, 11) and its weights
struct Point {
  int x0, y0, dx, dy;
  unsigned ok;
  float wx, wy;
};

__device__ __forceinline__ Point point(float gx, float gy, int H, int W, int border, int align,
                                       bool live) {
  Point t;
  const float ix = unnormalize(gx, W, align), iy = unnormalize(gy, H, align);
  const float fx = floorf(ix), fy = floorf(iy);
  t.wx = __fsub_rn(ix, fx);
  t.wy = __fsub_rn(iy, fy);
  // the floors held within [-2, size + 1]: the tests and clamps below read
  // the same there, and a far coordinate cannot overflow the int
  const int xf = static_cast<int>(fminf(fmaxf(fx, -2.f), static_cast<float>(W) + 1.f));
  const int yf = static_cast<int>(fminf(fmaxf(fy, -2.f), static_cast<float>(H) + 1.f));
  t.x0 = min(max(xf, 0), W - 1);
  t.y0 = min(max(yf, 0), H - 1);
  t.dx = min(max(xf + 1, 0), W - 1) - t.x0;
  t.dy = min(max(yf + 1, 0), H - 1) - t.y0;
  const bool vx0 = xf >= 0 && xf < W, vx1 = xf >= -1 && xf < W - 1;
  const bool vy0 = yf >= 0 && yf < H, vy1 = yf >= -1 && yf < H - 1;
  const unsigned ok = border ? 15u
                             : (vx0 && vy0) | (vx1 && vy0) << 1 | (vx0 && vy1) << 2 |
                                   (vx1 && vy1) << 3;
  t.ok = live ? ok : 0u;
  return t;
}

// the tile's footprint: the bounding box of its points' valid corners, its
// x-start rounded down to a multiple of 4 and its width up to one
struct Box {
  int x, y, w, h;
  bool staged;
};

__device__ __forceinline__ Box footprint(const Point& t, int (*red)[WARPS]) {
  // min x, -max x, min y, -max y over the valid corners
  int v[4] = {INT_MAX, INT_MAX, INT_MAX, INT_MAX};
  if (t.ok) {
    v[0] = t.ok & 5u ? t.x0 : t.x0 + t.dx;
    v[1] = -(t.ok & 10u ? t.x0 + t.dx : t.x0);
    v[2] = t.ok & 3u ? t.y0 : t.y0 + t.dy;
    v[3] = -(t.ok & 12u ? t.y0 + t.dy : t.y0);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[i] = __reduce_min_sync(0xffffffffu, v[i]);
    if (lane == 0) red[i][warp] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[i] = red[i][0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) v[i] = min(v[i], red[i][w]);
  }
  Box b;
  if (v[0] == INT_MAX) {   // no valid corner: nothing to read or to add
    b.x = b.y = b.w = b.h = 0;
    b.staged = false;
    return b;
  }
  b.x = v[0] & ~3;
  b.w = (-v[1] + 1 - b.x + 3) & ~3;
  b.y = v[2];
  b.h = -v[3] + 1 - b.y;
  b.staged = b.w <= STAGE && b.h <= STAGE && b.w * b.h <= STAGE;
  return b;
}

// the bilinear lerp of corners v (00, 01, 10, 11), the valid ones read by
// at(k), the others 0
template <typename At>
__device__ __forceinline__ float bilerp(const Point& t, At at) {
  float v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = t.ok >> k & 1u ? at(k) : 0.f;
  const float top = __fadd_rn(v[0], __fmul_rn(__fsub_rn(v[1], v[0]), t.wx));
  const float bot = __fadd_rn(v[2], __fmul_rn(__fsub_rn(v[3], v[2]), t.wx));
  return __fadd_rn(top, __fmul_rn(__fsub_rn(bot, top), t.wy));
}

// the four corner terms of the output's gradient gv, the plain backward's
__device__ __forceinline__ void corner_terms(float gv, const Point& t, float (&term)[4]) {
  const float gt = __fsub_rn(gv, __fmul_rn(gv, t.wy));
  const float gb = __fmul_rn(gv, t.wy);
  term[0] = __fsub_rn(gt, __fmul_rn(gt, t.wx));
  term[1] = __fmul_rn(gt, t.wx);
  term[2] = __fsub_rn(gb, __fmul_rn(gb, t.wx));
  term[3] = __fmul_rn(gb, t.wx);
}

__global__ void __launch_bounds__(THREADS, BLOCKS) grid_sample_kernel(
    const float* __restrict__ x, const float* __restrict__ grid, float* __restrict__ y, int C,
    int H, int W, int Hg, int Wg, int border, int align) {
  const int n = blockIdx.z;
  const int px = blockIdx.x * TILE + (threadIdx.x % TILE);
  const int py = blockIdx.y * TILE + threadIdx.x / TILE;
  if (px >= Wg || py >= Hg) return;
  const long long P = static_cast<long long>(Hg) * Wg;
  const int p = py * Wg + px;
  const float2 g = __ldg(reinterpret_cast<const float2*>(grid) + n * P + p);
  const Point t = point(g.x, g.y, H, W, border, align, true);
  const int plane = H * W, ody = t.dy * W;
  const float* xp = x + static_cast<long long>(n) * C * plane + t.y0 * W + t.x0;
  float* yp = y + static_cast<long long>(n) * C * P + p;
  for (int c0 = 0; c0 < C; c0 += CHUNK) {
    float v[CHUNK][4];
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      const float* xc = xp + static_cast<long long>(c0 + j) * plane;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v[j][k] = c0 + j < C && t.ok >> k & 1u
                      ? __ldg(xc + (k & 1 ? t.dx : 0) + (k & 2 ? ody : 0)) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < CHUNK; ++j)
      if (c0 + j < C) yp[(c0 + j) * P] = bilerp(t, [&](int k) { return v[j][k]; });
  }
}

// add the boxes of the cn planes of a set (s: the first, STAGE floats
// apart; plane: its gradient plane, hw floats apart) to the image's
// gradient a quad at a time and zero them
__device__ __forceinline__ void flush(float* s, float* plane, int cn, int hw, const Box& b,
                                      int W, bool vec) {
  const int q4 = b.w >> 2, nq = q4 * b.h;
  for (int q = threadIdx.x; q < cn * nq; q += THREADS) {
    const int j = q / nq, qr = q - j * nq, r = qr / q4, c4 = (qr - r * q4) * 4;
    float4* sp = reinterpret_cast<float4*>(s + j * STAGE + r * b.w + c4);
    const float4 v = *sp;
    if (v.x == 0.f && v.y == 0.f && v.z == 0.f && v.w == 0.f) continue;
    *sp = make_float4(0.f, 0.f, 0.f, 0.f);
    float* dst = plane + static_cast<long long>(j) * hw + (b.y + r) * W + b.x + c4;
    if (vec) {
      atomicAdd(reinterpret_cast<float4*>(dst), v);
    } else {
      const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (e[i] != 0.f && b.x + c4 + i < W) atomicAdd(dst + i, e[i]);
    }
  }
}

__global__ void __launch_bounds__(THREADS, BLOCKS) grid_sample_grad_kernel(
    const float* __restrict__ g, const float* __restrict__ grid, float* __restrict__ gx, int C,
    int H, int W, int Hg, int Wg, int border, int align, int vec,
    unsigned long long* staged_blocks) {
  __shared__ __align__(16) float buf[2][CB][STAGE];
  __shared__ int red[4][WARPS];
  __shared__ Box box;   // read again at each flush: fewer live registers
  const int n = blockIdx.z;
  const int px = blockIdx.x * TILE + (threadIdx.x % TILE);
  const int py = blockIdx.y * TILE + threadIdx.x / TILE;
  const bool live = px < Wg && py < Hg;
  const long long P = static_cast<long long>(Hg) * Wg;
  const int p = live ? py * Wg + px : 0;
  const float2 pt = live ? __ldg(reinterpret_cast<const float2*>(grid) + n * P + p)
                         : make_float2(0.f, 0.f);
  const Point t = point(pt.x, pt.y, H, W, border, align, live);
  const Box b = footprint(t, red);
  const int plane = H * W;
  const float* gn = g + static_cast<long long>(n) * C * P + p;
  float* xn = gx + static_cast<long long>(n) * C * plane;
  float term[4];
  if (b.staged) {
    const int s00 = (t.y0 - b.y) * b.w + (t.x0 - b.x), sdy = t.dy * b.w;
    if (threadIdx.x == 0) {
      box = b;
      if (staged_blocks) atomicAdd(staged_blocks, 1ull);
    }
    float4* z = reinterpret_cast<float4*>(&buf[0][0][0]);
    for (int q = threadIdx.x; q < 2 * CB * STAGE / 4; q += THREADS)
      z[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
    // passes of CB channels into the two sets of boxes in turn: a pass's
    // sync orders the other set's flush (the pass before) before the next
    // pass's adds into it
    for (int c0 = 0, set = 0; c0 < C; c0 += CB, set ^= 1) {
      const int cn = min(CB, C - c0);
      float gv[CB];
#pragma unroll
      for (int j = 0; j < CB; ++j) gv[j] = live && j < cn ? __ldg(gn + (c0 + j) * P) : 0.f;
#pragma unroll
      for (int j = 0; j < CB; ++j) {
        if (j >= cn) break;
        float* s = buf[set][j] + s00;
        corner_terms(gv[j], t, term);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (t.ok >> k & 1u) atomicAdd(s + (k & 1 ? t.dx : 0) + (k & 2 ? sdy : 0), term[k]);
      }
      __syncthreads();
      flush(buf[set][0], xn + static_cast<long long>(c0) * plane, cn, plane, box, W, vec);
    }
    return;
  }
  if (!live) return;
  const int off = t.y0 * W + t.x0, ody = t.dy * W;
  for (int c = 0; c < C; ++c) {
    corner_terms(__ldg(gn + c * P), t, term);
    float* xp = xn + static_cast<long long>(c) * plane + off;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (t.ok >> k & 1u) atomicAdd(xp + (k & 1 ? t.dx : 0) + (k & 2 ? ody : 0), term[k]);
  }
}

dim3 tiles(int N, int Hg, int Wg) {
  return dim3((Wg + TILE - 1) / TILE, (Hg + TILE - 1) / TILE, N);
}

bool aligned16(const void* p, int W) {
  return W % 4 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// y [N,C,Hg,Wg] = the sample of x [N,C,H,W] at grid [N,Hg,Wg,2]; border 0
// zeros, 1 border padding; align 0/1 align_corners. The caller keeps N and
// the tiles' rows within the launch's limits and H W, Hg Wg below 2^31.
PANIC3D_EXPORT int grid_sample_2d(const float* x, const float* grid, float* y, int N, int C,
                                  int H, int W, int Hg, int Wg, int border, int align,
                                  cudaStream_t stream) {
  if (static_cast<long long>(N) * Hg * Wg > 0 && C > 0)
    grid_sample_kernel<<<tiles(N, Hg, Wg), THREADS, 0, stream>>>(x, grid, y, C, H, W, Hg, Wg,
                                                                 border, align);
  return static_cast<int>(cudaGetLastError());
}

// gx [N,C,H,W] (zeroed by the caller) += the backward of the sample at grid
// [N,Hg,Wg,2] of the output's gradient g [N,C,Hg,Wg]
PANIC3D_EXPORT int grid_sample_2d_grad(const float* g, const float* grid, float* gx, int N,
                                       int C, int H, int W, int Hg, int Wg, int border,
                                       int align, cudaStream_t stream) {
  if (static_cast<long long>(N) * Hg * Wg > 0 && C > 0)
    grid_sample_grad_kernel<<<tiles(N, Hg, Wg), THREADS, 0, stream>>>(
        g, grid, gx, C, H, W, Hg, Wg, border, align, aligned16(gx, W), nullptr);
  return static_cast<int>(cudaGetLastError());
}

// grid_sample_2d_grad that also adds to *staged_blocks (a device counter)
// the blocks that took the staged branch: a check of the footprint test for
// chip_smoke.py, on no path
PANIC3D_EXPORT int grid_sample_2d_grad_counted(const float* g, const float* grid, float* gx,
                                               int N, int C, int H, int W, int Hg, int Wg,
                                               int border, int align,
                                               unsigned long long* staged_blocks,
                                               cudaStream_t stream) {
  if (static_cast<long long>(N) * Hg * Wg > 0 && C > 0)
    grid_sample_grad_kernel<<<tiles(N, Hg, Wg), THREADS, 0, stream>>>(
        g, grid, gx, C, H, W, Hg, Wg, border, align, aligned16(gx, W), staged_blocks);
  return static_cast<int>(cudaGetLastError());
}
