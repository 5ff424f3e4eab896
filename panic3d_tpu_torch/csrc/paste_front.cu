// K8 paste_front: paste-front's per-pixel masks, front projection and blend
// at the output resolution, in one kernel.
//
// Replaces (JAX): panic3d_tpu/models/triplane.py:paste_front (:730-815) --
// resize_bilinear of the weights, xyz and binary occlusion maps,
// utils/imageops.py:sobel_magnitude and resize_nearest, the four masks and
// their product -- and _sample_orthofront (:626) with
// ops/grid_sample.py:grid_sample_2d_points_packed_border (:217), then the
// blend image + (paste - image) * mask.
//
// What bounds it on the H100: per 512^2 output pixel it reads the SR image
// and the front image (3 channels each, f32) and writes the image, the paste
// and five masks: ~35 MB for bs=2, ~0.01 ms at 3.35 TB/s. The 64^2 maps are
// 0.2 MB and stay in L1/L2. Bytes bound, once each upsampled value is
// computed once.
//
// Design: a block covers a tile of TILE_H x TILE_W output pixels of one
// image n, a thread PX = 4 neighbouring pixels of a row (where the side is
// a multiple of 4, a float4 load of each image channel and a float4 store
// of each of the 11 planes); the grid is (column tiles, row
// tiles, N), so no pixel index needs a division. The block first stages
// the upsampled xyz of its tile plus a one-pixel halo in shared memory
// (reflect padding at the image border), each value computed once instead
// of by the nine pixels whose sobel stencil holds it; each thread then
// reads its pixels' 3 x 6 stencil rows from there. The weights and the
// occlusion map are upsampled once a pixel. The bilinear upsample is
// torch's align_corners=False formula (source index clamped at 0, upper
// neighbour clamped at the edge), the sobel and the projection are
// explicitly rounded operations in the plain version's order, and the
// front image is sampled with border clamping through the
// transposed-image convention of the JAX op. Pixels past the image's edge
// (a partial tile) are computed at a clamped index and not stored; an
// image whose side is not a multiple of 4 is stored pixel by pixel.
//
// A second entry point, paste_front_occ, takes the grid occlusion
// (occ_impl='grid': triplane.py:657 _get_front_occlusion_grid, then
// occ < thresh_occ, and :723 _get_xyz_discrepancy) into the same launch,
// in place of K7b's launch and the ~13 small torch launches around it at
// the render's r^2. Each block first works out the r^2 source pixels its
// tile's bilinear and nearest upsamples read (at 512^2 from 64^2, ~3 x 10)
// and stages, for each, the binary occlusion (K7b's read of the volume,
// front_occlusion.cuh, thresholded) and the binary discrepancy mask (the
// distance of the plane-space surface point from its ray, rounded
// operation by operation); the pixels then upsample those as they would the
// maps. Neighbouring tiles recompute a few of the same points: ~30 points
// a block beside 512 pixels.
//
// K8's backward form (paste_front_grad) serves both entries: their masks
// are the same outputs. It replaces what XLA's autodiff makes of
// paste_front in training (the masks are stop-gradiented there, so only the
// blend and the front projection carry a gradient): to the rendered image
// g (1 - mask), to the paste g mask, and through the projection's bilinear
// sample of the front image (border clamping: no gradient where the clamp
// holds) to channels 0 and 1 of the upsampled xyz, then by the transpose of
// the bilinear upsample to the render's r^2 image_xyz. The front image is
// data and takes none. Two launches, no atomics, so the result is the same
// bits on every run: a thread a pixel writes the image's gradient and the
// two upsampled channels' gradients ([N,2,S,S] f32 scratch); then a thread
// a render texel gathers, for each of the two channels, the pixels whose
// upsample reads it (at S / r = 8, ~16 x 16 of at most 20 x 20
// candidates), a row at a time, in a fixed order. What bounds it: the
// bytes (the mask, the output gradient, the front image and the image's
// gradient at S^2, ~84 MB at training's N = 8, C = 3, 512^2: ~0.025 ms),
// plus the scratch written once and read by the ~4 texels whose footprints
// hold each pixel.
#include <initializer_list>

#include "front_occlusion.cuh"

namespace {

constexpr int PX = 4;                                   // pixels a thread, along a row
constexpr int TILE_W = 64, TILE_H = 8;                  // 16 threads a tile row
constexpr int HALO_W = TILE_W + 2, HALO_H = TILE_H + 2;  // plus the sobel's halo
constexpr int THREADS = TILE_W / PX * TILE_H;

// One output coordinate's bilinear source (align_corners=False), scale =
// r / S: torch's formula, each multiply and add rounded on its own as in the
// plain version (triplane.py:upsample_bilinear)
struct Lerp {
  int i0, i1;
  float l0, l1;
};

__device__ __forceinline__ Lerp lerp_of(int i, int r, float scale) {
  const float s = fmaxf(__fsub_rn(__fmul_rn(__fadd_rn((float)i, 0.5f), scale), 0.5f), 0.f);
  Lerp c;
  c.i0 = (int)s;
  c.i1 = c.i0 < r - 1 ? c.i0 + 1 : c.i0;
  c.l1 = __fsub_rn(s, (float)c.i0);
  c.l0 = __fsub_rn(1.f, c.l1);
  return c;
}

// the upsampled value of map m (row stride ld) whose first row and column
// are source row r0 and column c0
__device__ __forceinline__ float upsample(const float* m, int ld, const Lerp& h, const Lerp& w,
                                          int r0 = 0, int c0 = 0) {
  const float* row0 = m + (h.i0 - r0) * ld - c0;
  const float* row1 = m + (h.i1 - r0) * ld - c0;
  const float top = __fadd_rn(__fmul_rn(row0[w.i0], w.l0), __fmul_rn(row0[w.i1], w.l1));
  const float bot = __fadd_rn(__fmul_rn(row1[w.i0], w.l0), __fmul_rn(row1[w.i1], w.l1));
  return __fadd_rn(__fmul_rn(top, h.l0), __fmul_rn(bot, h.l1));
}

// the grid occlusion's inputs (paste_front_occ): the volume [N,Gx,Gy,Gz]
// (batch stride a_stride, 0 for one portrait's), its zero-feature density,
// K7b's scale (2 / box_warp), half box, offset and segment, the threshold,
// and the force_rays [N,3,r,r] the discrepancy measures against
struct OccArgs {
  const float* A;
  long long a_stride;
  const float* density0;
  int Gx, Gy, Gz;
  const float* ray_o;
  const float* ray_d;
  float scale, half_bw, offset, seg_len, thresh_occ;
};

// the staged source pixels of a tile at r <= S: rows and columns of the
// bilinear and nearest upsamples of TILE_H x TILE_W outputs
constexpr int SRC_H = TILE_H + 2, SRC_W = TILE_W + 2;

// reflect padding by one pixel, clamped into the image for the halo of a
// partial tile (whose pixels are masked)
__device__ __forceinline__ int reflect(int i, int S) {
  i = i < 0 ? -i : (i >= S ? 2 * S - 2 - i : i);
  return min(max(i, 0), S - 1);
}

// kornia's normalised sobel (/8) at one channel of pixel x of a thread's
// 3 x (PX + 2) stencil rows, K_x flipped to a correlation as the JAX op
// does; -> gx^2 + gy^2, each operation rounded
__device__ __forceinline__ float sobel2(const float (&v)[3][PX + 2], int x) {
  const float v00 = v[0][x], v01 = v[0][x + 1], v02 = v[0][x + 2];
  const float v10 = v[1][x], v12 = v[1][x + 2];
  const float v20 = v[2][x], v21 = v[2][x + 1], v22 = v[2][x + 2];
  float gx = __fadd_rn(__fsub_rn(v00, v02), __fmul_rn(2.f, __fsub_rn(v10, v12)));
  gx = __fmul_rn(__fsub_rn(__fadd_rn(gx, v20), v22), 0.125f);
  float gy = __fadd_rn(__fadd_rn(v00, __fmul_rn(2.f, v01)), v02);
  gy = __fmul_rn(__fsub_rn(__fsub_rn(__fsub_rn(gy, v20), __fmul_rn(2.f, v21)), v22), 0.125f);
  return __fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy));
}

// PX values of one plane at offset o: a float4 (VEC), else the first np
template <bool VEC>
__device__ __forceinline__ void store_px(float* p, long long o, const float (&v)[PX], int np) {
  if (VEC) {
    *reinterpret_cast<float4*>(p + o) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int q = 0; q < PX; ++q)
      if (q < np) p[o + q] = v[q];
  }
}

// VEC: the image planes as float4 (a side that is a multiple of PX, so a
// thread's pixels are all inside the image and 16-byte aligned). OCC: the
// grid occlusion from the volume (paste_front_occ; occ_bin and dxyz are
// then unused), else the binary occlusion and discrepancy maps given
template <bool VEC, bool OCC>
__global__ void __launch_bounds__(THREADS, 6) paste_front_kernel(
    const float* __restrict__ image, const float* __restrict__ front, int C, int Hf, int Wf,
    const float* __restrict__ weights, const float* __restrict__ xyz,
    const float* __restrict__ occ_bin, const float* __restrict__ dxyz,
    const float* __restrict__ fwmask, float* __restrict__ out_image, float* __restrict__ paste,
    float* __restrict__ mask, float* __restrict__ wmask, float* __restrict__ smask,
    float* __restrict__ fmask, float* __restrict__ dmask, int S, int r, float half_bw,
    float inv_bw, float thresh_weight, float thresh_edges, float thresh_dxyz, float scale,
    float near, OccArgs occ) {
  __shared__ float up[3][HALO_H][HALO_W];
  __shared__ float occ_s[OCC ? SRC_H : 1][OCC ? SRC_W : 1];
  __shared__ float dxyz_s[OCC ? SRC_H : 1][OCC ? SRC_W : 1];
  const int n = blockIdx.z, tx = threadIdx.x % (TILE_W / PX), ty = threadIdx.x / (TILE_W / PX);
  const int i0 = blockIdx.y * TILE_H, j0 = blockIdx.x * TILE_W;
  const int rr = r * r;
  const float* xyz_n = xyz + (long long)n * 3 * rr;
  // the source pixels the tile's upsamples read: the first and last row
  // (column) of each, whose indices grow with the output's
  int r0 = 0, c0 = 0;
  if (OCC) {
    const int il = min(i0 + TILE_H, S) - 1, jl = min(j0 + TILE_W, S) - 1;
    r0 = min(lerp_of(i0, r, scale).i0, (int)floorf((float)i0 * near));
    c0 = min(lerp_of(j0, r, scale).i0, (int)floorf((float)j0 * near));
    const int nr = max(lerp_of(il, r, scale).i1, (int)floorf((float)il * near)) - r0 + 1;
    const int nc = max(lerp_of(jl, r, scale).i1, (int)floorf((float)jl * near)) - c0 + 1;
    const float d0 = occ.density0[0];
    const float* vol = occ.A + n * occ.a_stride;
    const float* ro = occ.ray_o + (long long)n * 3 * rr;
    const float* rd = occ.ray_d + (long long)n * 3 * rr;
    for (int q = threadIdx.x; q < nr * nc; q += THREADS) {
      const int y = q / nc, x = q - y * nc;
      const int p = (r0 + y) * r + c0 + x;
      // the plane-space surface point: image_xyz x (-1, 1, -1), exact
      const float qx = -xyz_n[p], qy = xyz_n[rr + p], qz = -xyz_n[2 * rr + p];
      const float o = front_occlusion_at(vol, occ.Gx, occ.Gy, occ.Gz, d0, qx, qy, qz,
                                         occ.scale, occ.half_bw, occ.offset, occ.seg_len);
      occ_s[y][x] = o < occ.thresh_occ ? 1.f : 0.f;
      // its distance from its ray: |(p - a) - ((p - a) . n) n|
      const float e0 = __fsub_rn(qx, ro[p]), e1 = __fsub_rn(qy, ro[rr + p]);
      const float e2 = __fsub_rn(qz, ro[2 * rr + p]);
      const float n0 = rd[p], n1 = rd[rr + p], n2 = rd[2 * rr + p];
      const float dot =
          __fadd_rn(__fadd_rn(__fmul_rn(e0, n0), __fmul_rn(e1, n1)), __fmul_rn(e2, n2));
      const float f0 = __fsub_rn(e0, __fmul_rn(dot, n0)), f1 = __fsub_rn(e1, __fmul_rn(dot, n1));
      const float f2 = __fsub_rn(e2, __fmul_rn(dot, n2));
      const float d = __fsqrt_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(f0, f0), __fmul_rn(f1, f1)), __fmul_rn(f2, f2)));
      dxyz_s[y][x] = d < thresh_dxyz ? 1.f : 0.f;
    }
  }

  // the upsampled xyz of the tile and its halo, each value once
#pragma unroll
  for (int t = 0; t < (HALO_H * HALO_W + THREADS - 1) / THREADS; ++t) {
    const int q = t * THREADS + threadIdx.x;
    if (q >= HALO_H * HALO_W) break;
    const int y = q / HALO_W, x = q % HALO_W;
    const Lerp h = lerp_of(reflect(i0 + y - 1, S), r, scale);
    const Lerp w = lerp_of(reflect(j0 + x - 1, S), r, scale);
#pragma unroll
    for (int c = 0; c < 3; ++c) up[c][y][x] = upsample(xyz_n + c * rr, r, h, w);
  }
  __syncthreads();
  const int i = i0 + ty, jb = j0 + tx * PX;   // the thread's first pixel
  if (i >= S || jb >= S) return;
  const int np = min(PX, S - jb);
  const long long plane = (long long)S * S;
  const long long row = n * plane + (long long)i * S + jb;   // in a one-plane tensor

  float mag2[PX] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float v[3][PX + 2];
#pragma unroll
    for (int y = 0; y < 3; ++y)
#pragma unroll
      for (int x = 0; x < PX + 2; ++x) v[y][x] = up[c][ty + y][tx * PX + x];
#pragma unroll
    for (int q = 0; q < PX; ++q) mag2[q] = __fadd_rn(mag2[q], sobel2(v, q));
  }

  const Lerp h = lerp_of(i, r, scale);
  const int ni = (int)floorf((float)i * near);
  const float* w_n = weights + (long long)n * rr;
  const float* o_n = OCC ? nullptr : occ_bin + (long long)n * rr;
  const float* d_n = OCC ? nullptr : dxyz + (long long)n * rr + ni * r;
  float m[PX], wm[PX], sm[PX], fm[PX], dm[PX];
#pragma unroll
  for (int q = 0; q < PX; ++q) {
    const int j = min(jb + q, S - 1);
    const Lerp w = lerp_of(j, r, scale);
    wm[q] = upsample(w_n, r, h, w) > thresh_weight ? 1.f : 0.f;
    sm[q] = __fsqrt_rn(__fadd_rn(mag2[q], 1e-12f)) < thresh_edges ? 1.f : 0.f;
    const int nj = (int)floorf((float)j * near);
    if (OCC) {
      fm[q] = upsample(&occ_s[0][0], SRC_W, h, w, r0, c0);
      dm[q] = dxyz_s[ni - r0][nj - c0];
    } else {
      fm[q] = upsample(o_n, r, h, w);
      dm[q] = d_n[nj] < thresh_dxyz ? 1.f : 0.f;
    }
    const float fw = fwmask ? fwmask[row - jb + j] : 1.f;
    m[q] = (((wm[q] * sm[q]) * fm[q]) * dm[q]) * fw;
  }
  store_px<VEC>(mask, row, m, np);
  store_px<VEC>(wmask, row, wm, np);
  store_px<VEC>(smask, row, sm, np);
  store_px<VEC>(fmask, row, fm, np);
  store_px<VEC>(dmask, row, dm, np);

  // the front image's uv: uv = 1 - (xyz[[1, 0]] + bw/2) / bw, sampled from
  // the transposed image (x indexes the front's rows, y its columns); the
  // division by bw is a multiply by its f32 reciprocal, as torch's division
  // of a CUDA tensor by a Python number is, and a division by 2 a multiply
  // by 0.5 (the same value). Kept a pixel: its texel (x0, y0), whether x1
  // and y1 step past it (bits 0, 1), and the weights
  int t00[PX], step[PX];
  float wx[PX], wy[PX];
#pragma unroll
  for (int q = 0; q < PX; ++q) {
    const float cx = up[1][ty + 1][tx * PX + q + 1], cy = up[0][ty + 1][tx * PX + q + 1];
    const float u = __fsub_rn(
        __fmul_rn(__fsub_rn(1.f, __fmul_rn(__fadd_rn(cx, half_bw), inv_bw)), 2.f), 1.f);
    const float v = __fsub_rn(
        __fmul_rn(__fsub_rn(1.f, __fmul_rn(__fadd_rn(cy, half_bw), inv_bw)), 2.f), 1.f);
    const float ix = __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(u, 1.f), (float)Hf), 1.f), 0.5f);
    const float iy = __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(v, 1.f), (float)Wf), 1.f), 0.5f);
    const float fx = floorf(ix), fy = floorf(iy);
    wx[q] = __fsub_rn(ix, fx);
    wy[q] = __fsub_rn(iy, fy);
    const int x0 = min(max((int)fx, 0), Hf - 1), x1 = min(max((int)fx + 1, 0), Hf - 1);
    const int y0 = min(max((int)fy, 0), Wf - 1), y1 = min(max((int)fy + 1, 0), Wf - 1);
    t00[q] = x0 * Wf + y0;
    step[q] = (x1 - x0) | ((y1 - y0) << 1);
  }
  for (int c = 0; c < C; ++c) {
    const float* f = front + ((long long)n * C + c) * Hf * Wf;
    const long long o = row + ((long long)n * (C - 1) + c) * plane;   // pixel jb, channel c
    float im[PX], p[PX];
    if (VEC) {
      const float4 a = *reinterpret_cast<const float4*>(image + o);
      im[0] = a.x, im[1] = a.y, im[2] = a.z, im[3] = a.w;
    } else {
#pragma unroll
      for (int q = 0; q < PX; ++q) im[q] = q < np ? image[o + q] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < PX; ++q) {
      const float* t = f + t00[q];
      const int dx = (step[q] & 1) * Wf, dy = step[q] >> 1;
      const float v00 = t[0], v01 = t[dx], v10 = t[dy], v11 = t[dx + dy];
      const float top = __fadd_rn(v00, __fmul_rn(__fsub_rn(v01, v00), wx[q]));
      const float bot = __fadd_rn(v10, __fmul_rn(__fsub_rn(v11, v10), wx[q]));
      p[q] = __fadd_rn(top, __fmul_rn(__fsub_rn(bot, top), wy[q]));
    }
    store_px<VEC>(paste, o, p, np);
#pragma unroll
    for (int q = 0; q < PX; ++q)   // the blend, in place of the image
      im[q] = __fadd_rn(im[q], __fmul_rn(__fsub_rn(p[q], im[q]), m[q]));
    store_px<VEC>(out_image, o, im, np);
  }
}

template <bool OCC>
int launch_paste(const float* image, const float* front, int C, int Hf, int Wf,
                 const float* weights, const float* xyz, const float* occ_bin, const float* dxyz,
                 const float* fwmask, float* out_image, float* paste, float* mask, float* wmask,
                 float* smask, float* fmask, float* dmask, int N, int S, int r, float bw,
                 float thresh_weight, float thresh_edges, float thresh_dxyz, float near_h,
                 float near_w, const OccArgs& occ, void* stream) {
  if (near_h != near_w) return (int)cudaErrorInvalidValue;
  const dim3 grid((S + TILE_W - 1) / TILE_W, (S + TILE_H - 1) / TILE_H, N);
  const float inv_bw = 1.f / bw;   // f32, as torch takes a CUDA tensor's divisor's reciprocal
  // float4 image planes: a side that is a multiple of PX (a thread's pixels
  // all inside the image, each row 16-byte aligned) and 16-byte aligned bases
  bool vec = S % PX == 0;
  for (const float* p : {image, (const float*)out_image, (const float*)paste,
                         (const float*)mask, (const float*)wmask, (const float*)smask,
                         (const float*)fmask, (const float*)dmask})
    vec = vec && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  auto kernel = vec ? paste_front_kernel<true, OCC> : paste_front_kernel<false, OCC>;
  kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      image, front, C, Hf, Wf, weights, xyz, occ_bin, dxyz, fwmask, out_image, paste, mask,
      wmask, smask, fmask, dmask, S, r, bw * 0.5f, inv_bw, thresh_weight, thresh_edges,
      thresh_dxyz, (float)r / (float)S, near_h, occ);
  return (int)cudaGetLastError();
}

// K8's backward form, first launch: a thread a pixel of [N,S,S]. The image
// takes g - g mask (autograd's sum for image + (paste - image) mask), the
// paste g mask (+ g_paste, the paste output's own gradient, where given);
// the projection's uv is the forward's (the same upsampled xyz and rounded
// operations, so the same texels and weights), and dL/d(wx, wy) of the
// bilinear sample, times d(ix, iy)/d(xyz1, xyz0) = -(Hf, Wf) / bw, gives
// the upsampled xyz's channels 1 and 0 their gradients in g_up [N,2,S,S].
constexpr int GRAD_THREADS = 256;

__global__ void __launch_bounds__(GRAD_THREADS) paste_grad_pixels_kernel(
    const float* __restrict__ mask, const float* __restrict__ g_out,
    const float* __restrict__ g_paste, const float* __restrict__ front, int C, int Hf, int Wf,
    const float* __restrict__ xyz, float* __restrict__ g_image, float* __restrict__ g_up, int N,
    int S, int r, float half_bw, float inv_bw, float scale) {
  const long long plane = (long long)S * S;
  const long long idx = (long long)blockIdx.x * GRAD_THREADS + threadIdx.x;
  if (idx >= N * plane) return;
  const int n = (int)(idx / plane);
  const long long pix = idx - n * plane;
  const int i = (int)(pix / S), j = (int)(pix - (long long)i * S);
  const int rr = r * r;
  const float* xyz_n = xyz + (long long)n * 3 * rr;
  const Lerp h = lerp_of(i, r, scale), w = lerp_of(j, r, scale);
  const float cx = upsample(xyz_n + rr, r, h, w), cy = upsample(xyz_n, r, h, w);
  const float u = __fsub_rn(
      __fmul_rn(__fsub_rn(1.f, __fmul_rn(__fadd_rn(cx, half_bw), inv_bw)), 2.f), 1.f);
  const float v = __fsub_rn(
      __fmul_rn(__fsub_rn(1.f, __fmul_rn(__fadd_rn(cy, half_bw), inv_bw)), 2.f), 1.f);
  const float ix = __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(u, 1.f), (float)Hf), 1.f), 0.5f);
  const float iy = __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(v, 1.f), (float)Wf), 1.f), 0.5f);
  const float fx = floorf(ix), fy = floorf(iy);
  const float wx = __fsub_rn(ix, fx), wy = __fsub_rn(iy, fy);
  const int x0 = min(max((int)fx, 0), Hf - 1), x1 = min(max((int)fx + 1, 0), Hf - 1);
  const int y0 = min(max((int)fy, 0), Wf - 1), y1 = min(max((int)fy + 1, 0), Wf - 1);
  const float m = mask[idx];
  float gwx = 0.f, gwy = 0.f;
  for (int c = 0; c < C; ++c) {
    const long long o = ((long long)n * C + c) * plane + pix;
    const float g = g_out[o];
    g_image[o] = g - g * m;
    const float gp = g * m + (g_paste ? g_paste[o] : 0.f);
    const float* f = front + ((long long)n * C + c) * Hf * Wf;
    const float v00 = f[x0 * Wf + y0], v01 = f[x1 * Wf + y0];
    const float v10 = f[x0 * Wf + y1], v11 = f[x1 * Wf + y1];
    const float top = v00 + (v01 - v00) * wx, bot = v10 + (v11 - v10) * wx;
    gwx += gp * ((v01 - v00) * (1.f - wy) + (v11 - v10) * wy);
    gwy += gp * (bot - top);
  }
  g_up[(2LL * n) * plane + pix] = -gwy * (float)Wf * inv_bw;
  g_up[(2LL * n + 1) * plane + pix] = -gwx * (float)Hf * inv_bw;
}

// an output row's (column's) weight on source row a of the bilinear
// upsample: l0 where it reads a as its lower neighbour, l1 as its upper
__device__ __forceinline__ float upsample_weight(int i, int a, int r, float scale) {
  const Lerp l = lerp_of(i, r, scale);
  return (l.i0 == a ? l.l0 : 0.f) + (l.i1 == a ? l.l1 : 0.f);
}

// K8's backward form, second launch: a thread a render texel (n, a, b) of
// [N,r,r]; the transpose of the upsample, gathered: for channels 0 and 1,
// the sum over the output rows i and columns j that read the texel of
// w_row(i) (sum_j w_col(j) g_up[i][j]), rows and columns in order; channel
// 2 takes no gradient
__global__ void __launch_bounds__(GRAD_THREADS) paste_grad_texels_kernel(
    const float* __restrict__ g_up, float* __restrict__ g_xyz, int N, int S, int r,
    float scale) {
  const int rr = r * r;
  const long long idx = (long long)blockIdx.x * GRAD_THREADS + threadIdx.x;
  if (idx >= (long long)N * rr) return;
  const int n = (int)(idx / rr), t = (int)(idx - (long long)n * rr), a = t / r, b = t - a * r;
  // the output rows (columns) whose lower or upper neighbour is a (b), and
  // a margin of one: src(i) = (i + 0.5) r / S - 0.5 lies in [a - 1, a + 1)
  const float inv = (float)S / (float)r;
  const int ilo = max((int)floorf((a - 0.5f) * inv - 0.5f) - 1, 0);
  const int ihi = min((int)ceilf((a + 1.5f) * inv - 0.5f) + 1, S - 1);
  const int jlo = max((int)floorf((b - 0.5f) * inv - 0.5f) - 1, 0);
  const int jhi = min((int)ceilf((b + 1.5f) * inv - 0.5f) + 1, S - 1);
  const long long plane = (long long)S * S;
  float acc[2] = {0.f, 0.f};
  for (int i = ilo; i <= ihi; ++i) {
    const float wr = upsample_weight(i, a, r, scale);
    if (wr == 0.f) continue;
    float rs[2] = {0.f, 0.f};
    for (int j = jlo; j <= jhi; ++j) {
      const float wc = upsample_weight(j, b, r, scale);
      if (wc == 0.f) continue;
#pragma unroll
      for (int c = 0; c < 2; ++c) rs[c] += wc * g_up[(2LL * n + c) * plane + (long long)i * S + j];
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) acc[c] += wr * rs[c];
  }
  float* out = g_xyz + (long long)n * 3 * rr + t;
  out[0] = acc[0];
  out[rr] = acc[1];
  out[2 * rr] = 0.f;
}

}  // namespace

// image [N,C,S,S] f32 (the SR image), front [N,C,Hf,Wf] f32 (the image to
// paste); weights, occ_bin, dxyz [N,1,r,r] and xyz [N,3,r,r] f32;
// fwmask [N,1,S,S] f32 or null (all ones); outputs [N,C,S,S] image and
// paste, [N,1,S,S] mask and its four factors. near_h/near_w are the
// nearest-resize steps r/S (equal: the images are square).
PANIC3D_EXPORT int paste_front(const float* image, const float* front, int C, int Hf, int Wf,
                               const float* weights, const float* xyz, const float* occ_bin,
                               const float* dxyz, const float* fwmask, float* out_image,
                               float* paste, float* mask, float* wmask, float* smask,
                               float* fmask, float* dmask, int N, int S, int r, float bw,
                               float thresh_weight, float thresh_edges, float thresh_dxyz,
                               float near_h, float near_w, void* stream) {
  return launch_paste<false>(image, front, C, Hf, Wf, weights, xyz, occ_bin, dxyz, fwmask,
                             out_image, paste, mask, wmask, smask, fmask, dmask, N, S, r, bw,
                             thresh_weight, thresh_edges, thresh_dxyz, near_h, near_w,
                             OccArgs{}, stream);
}

// paste_front with the grid occlusion in the same launch: in place of
// occ_bin and dxyz, the occlusion volume A [N,Gx,Gy,Gz] f32 (batch stride
// a_stride, 0: one volume for every view), density0 one f32, K7b's scale
// (2 / box_warp), half box, offset and segment length, thresh_occ, and the
// force_rays origins and directions [N,3,r,r] f32. r <= S.
PANIC3D_EXPORT int paste_front_occ(const float* image, const float* front, int C, int Hf,
                                   int Wf, const float* weights, const float* xyz,
                                   const float* A, long long a_stride, const float* density0,
                                   int Gx, int Gy, int Gz, const float* ray_o,
                                   const float* ray_d, const float* fwmask, float* out_image,
                                   float* paste, float* mask, float* wmask, float* smask,
                                   float* fmask, float* dmask, int N, int S, int r, float bw,
                                   float thresh_weight, float thresh_edges, float thresh_dxyz,
                                   float near_h, float near_w, float occ_scale,
                                   float occ_half_bw, float offset, float seg_len,
                                   float thresh_occ, void* stream) {
  if (r > S) return (int)cudaErrorInvalidValue;
  const OccArgs occ{A, a_stride, density0, Gx, Gy, Gz, ray_o, ray_d,
                    occ_scale, occ_half_bw, offset, seg_len, thresh_occ};
  return launch_paste<true>(image, front, C, Hf, Wf, weights, xyz, nullptr, nullptr, fwmask,
                            out_image, paste, mask, wmask, smask, fmask, dmask, N, S, r, bw,
                            thresh_weight, thresh_edges, thresh_dxyz, near_h, near_w, occ,
                            stream);
}

// K8's backward form: mask [N,1,S,S] f32 (the forward's), g_out [N,C,S,S]
// f32 (the blended image's gradient), g_paste [N,C,S,S] f32 or null (the
// paste output's), front [N,C,Hf,Wf] f32 (the image pasted), xyz [N,3,r,r]
// f32 (the render's image_xyz); writes g_image [N,C,S,S] (the rendered
// image's gradient) and g_xyz [N,3,r,r] (channel 2 zero) through g_up
// [N,2,S,S] f32 scratch. bw: the box warp.
PANIC3D_EXPORT int paste_front_grad(const float* mask, const float* g_out, const float* g_paste,
                                    const float* front, int C, int Hf, int Wf, const float* xyz,
                                    float* g_image, float* g_up, float* g_xyz, int N, int S,
                                    int r, float bw, void* stream) {
  if (N < 1 || S < 1 || r < 1 || C < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale = (float)r / (float)S;
  const long long pixels = (long long)N * S * S, texels = (long long)N * r * r;
  paste_grad_pixels_kernel<<<(unsigned)((pixels + GRAD_THREADS - 1) / GRAD_THREADS),
                             GRAD_THREADS, 0, st>>>(mask, g_out, g_paste, front, C, Hf, Wf, xyz,
                                                    g_image, g_up, N, S, r, bw * 0.5f, 1.f / bw,
                                                    scale);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  paste_grad_texels_kernel<<<(unsigned)((texels + GRAD_THREADS - 1) / GRAD_THREADS),
                             GRAD_THREADS, 0, st>>>(g_up, g_xyz, N, S, r, scale);
  return (int)cudaGetLastError();
}
