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
// What bounds it on the H100: bytes. A point reads its two coordinates
// once and, for each channel, four neighbouring texels and writes one
// value: a few operations a byte. The texels a warp reads lie in a few
// rows of the image, which the L1 and the L2 serve; the image's bytes count
// once. The backward reads the output's gradient and adds four terms a
// channel into the zeroed image gradient with atomics (red.global.add.f32,
// resolved in the L2).
//
// Design: one thread a point. It reads the point, computes the two floors
// and weights and the four corners' offsets and validity once, then walks
// the C channel planes of the NCHW image (consecutive threads take
// consecutive points: the output's and the gradient's rows are written and
// read coalesced). The arithmetic is the plain version's
// (ops/grid_sample.py:grid_sample_2d_plain), in its order and with its
// roundings: ((g + 1) W - 1) / 2 or (g + 1) / 2 (W - 1), floor, w = i - floor,
// top = v00 + (v01 - v00) wx, bot likewise, out = top + (bot - top) wy, each
// step by __fadd_rn / __fmul_rn so that nvcc contracts nothing into an FMA:
// the forward is bit-equal to the plain version. The backward's corner terms
// are the plain backward's (g_top = g - g wy, g_bot = g wy, g00 = g_top -
// g_top wx, g01 = g_top wx, ...), equal bit for bit term by term; only the
// order of the atomic sums differs, and varies from run to run.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float unnormalize(float c, int size, int align) {
  if (align) return __fmul_rn(__fdiv_rn(__fadd_rn(c, 1.f), 2.f), static_cast<float>(size - 1));
  return __fdiv_rn(__fsub_rn(__fmul_rn(__fadd_rn(c, 1.f), static_cast<float>(size)), 1.f), 2.f);
}

// a point's four corners (00, 01, 10, 11: x first) in its image plane
struct Corners {
  long long off[4];
  bool ok[4];
  float wx, wy;
};

__device__ __forceinline__ Corners corners(float gx, float gy, int H, int W, int border,
                                           int align) {
  Corners t;
  const float ix = unnormalize(gx, W, align), iy = unnormalize(gy, H, align);
  const float fx = floorf(ix), fy = floorf(iy);
  t.wx = __fsub_rn(ix, fx);
  t.wy = __fsub_rn(iy, fy);
  // the floors held within [-2, size + 1]: the tests and clamps below read
  // the same there, and a far coordinate cannot overflow the int
  const int x0 = static_cast<int>(fminf(fmaxf(fx, -2.f), static_cast<float>(W) + 1.f));
  const int y0 = static_cast<int>(fminf(fmaxf(fy, -2.f), static_cast<float>(H) + 1.f));
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int xs = x0 + (k & 1), ys = y0 + (k >> 1);
    t.ok[k] = border || (xs >= 0 && xs < W && ys >= 0 && ys < H);
    const int xc = min(max(xs, 0), W - 1), yc = min(max(ys, 0), H - 1);
    t.off[k] = static_cast<long long>(yc) * W + xc;
  }
  return t;
}

__global__ void __launch_bounds__(THREADS) grid_sample_kernel(
    const float* __restrict__ x, const float* __restrict__ grid, float* __restrict__ y, int N,
    int C, int H, int W, long long P, int border, int align) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= static_cast<long long>(N) * P) return;
  const long long n = i / P, p = i - n * P;
  const Corners t = corners(__ldg(grid + 2 * i), __ldg(grid + 2 * i + 1), H, W, border, align);
  const long long plane = static_cast<long long>(H) * W;
  const float* xp = x + n * C * plane;
  float* yp = y + n * C * P + p;
  for (int c = 0; c < C; ++c, xp += plane, yp += P) {
    const float v00 = t.ok[0] ? __ldg(xp + t.off[0]) : 0.f;
    const float v01 = t.ok[1] ? __ldg(xp + t.off[1]) : 0.f;
    const float v10 = t.ok[2] ? __ldg(xp + t.off[2]) : 0.f;
    const float v11 = t.ok[3] ? __ldg(xp + t.off[3]) : 0.f;
    const float top = __fadd_rn(v00, __fmul_rn(__fsub_rn(v01, v00), t.wx));
    const float bot = __fadd_rn(v10, __fmul_rn(__fsub_rn(v11, v10), t.wx));
    *yp = __fadd_rn(top, __fmul_rn(__fsub_rn(bot, top), t.wy));
  }
}

__global__ void __launch_bounds__(THREADS) grid_sample_grad_kernel(
    const float* __restrict__ g, const float* __restrict__ grid, float* __restrict__ gx, int N,
    int C, int H, int W, long long P, int border, int align) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= static_cast<long long>(N) * P) return;
  const long long n = i / P, p = i - n * P;
  const Corners t = corners(__ldg(grid + 2 * i), __ldg(grid + 2 * i + 1), H, W, border, align);
  const long long plane = static_cast<long long>(H) * W;
  const float* gp = g + n * C * P + p;
  float* xp = gx + n * C * plane;
  for (int c = 0; c < C; ++c, gp += P, xp += plane) {
    const float gv = __ldg(gp);
    const float gt = __fsub_rn(gv, __fmul_rn(gv, t.wy));
    const float gb = __fmul_rn(gv, t.wy);
    const float term[4] = {__fsub_rn(gt, __fmul_rn(gt, t.wx)), __fmul_rn(gt, t.wx),
                           __fsub_rn(gb, __fmul_rn(gb, t.wx)), __fmul_rn(gb, t.wx)};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (t.ok[k]) atomicAdd(xp + t.off[k], term[k]);
  }
}

unsigned blocks(int N, long long P) {
  return static_cast<unsigned>((static_cast<long long>(N) * P + THREADS - 1) / THREADS);
}

}  // namespace

// y [N,C,P] = the sample of x [N,C,H,W] at grid [N,P,2]; border 0 zeros, 1
// border padding; align 0/1 align_corners
PANIC3D_EXPORT int grid_sample_2d(const float* x, const float* grid, float* y, int N, int C,
                                  int H, int W, long long P, int border, int align,
                                  cudaStream_t stream) {
  if (static_cast<long long>(N) * P > 0 && C > 0)
    grid_sample_kernel<<<blocks(N, P), THREADS, 0, stream>>>(x, grid, y, N, C, H, W, P, border,
                                                             align);
  return static_cast<int>(cudaGetLastError());
}

// gx [N,C,H,W] (zeroed by the caller) += the backward of the sample at grid
// [N,P,2] of the output's gradient g [N,C,P]
PANIC3D_EXPORT int grid_sample_2d_grad(const float* g, const float* grid, float* gx, int N,
                                       int C, int H, int W, long long P, int border, int align,
                                       cudaStream_t stream) {
  if (static_cast<long long>(N) * P > 0 && C > 0)
    grid_sample_grad_kernel<<<blocks(N, P), THREADS, 0, stream>>>(g, grid, gx, N, C, H, W, P,
                                                                  border, align);
  return static_cast<int>(cudaGetLastError());
}
