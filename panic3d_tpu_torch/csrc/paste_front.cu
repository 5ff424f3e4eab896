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
#include <initializer_list>

#include "common.cuh"

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

__device__ __forceinline__ float upsample(const float* m, int r, const Lerp& h, const Lerp& w) {
  const float* row0 = m + h.i0 * r;
  const float* row1 = m + h.i1 * r;
  const float top = __fadd_rn(__fmul_rn(row0[w.i0], w.l0), __fmul_rn(row0[w.i1], w.l1));
  const float bot = __fadd_rn(__fmul_rn(row1[w.i0], w.l0), __fmul_rn(row1[w.i1], w.l1));
  return __fadd_rn(__fmul_rn(top, h.l0), __fmul_rn(bot, h.l1));
}

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
// thread's pixels are all inside the image and 16-byte aligned)
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 6) paste_front_kernel(
    const float* __restrict__ image, const float* __restrict__ front, int C, int Hf, int Wf,
    const float* __restrict__ weights, const float* __restrict__ xyz,
    const float* __restrict__ occ_bin, const float* __restrict__ dxyz,
    const float* __restrict__ fwmask, float* __restrict__ out_image, float* __restrict__ paste,
    float* __restrict__ mask, float* __restrict__ wmask, float* __restrict__ smask,
    float* __restrict__ fmask, float* __restrict__ dmask, int S, int r, float half_bw,
    float inv_bw, float thresh_weight, float thresh_edges, float thresh_dxyz, float scale,
    float near) {
  __shared__ float up[3][HALO_H][HALO_W];
  const int n = blockIdx.z, tx = threadIdx.x % (TILE_W / PX), ty = threadIdx.x / (TILE_W / PX);
  const int i0 = blockIdx.y * TILE_H, j0 = blockIdx.x * TILE_W;
  const int rr = r * r;
  const float* xyz_n = xyz + (long long)n * 3 * rr;

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
  const float* o_n = occ_bin + (long long)n * rr;
  const float* d_n = dxyz + (long long)n * rr + ni * r;
  float m[PX], wm[PX], sm[PX], fm[PX], dm[PX];
#pragma unroll
  for (int q = 0; q < PX; ++q) {
    const int j = min(jb + q, S - 1);
    const Lerp w = lerp_of(j, r, scale);
    wm[q] = upsample(w_n, r, h, w) > thresh_weight ? 1.f : 0.f;
    sm[q] = __fsqrt_rn(__fadd_rn(mag2[q], 1e-12f)) < thresh_edges ? 1.f : 0.f;
    fm[q] = upsample(o_n, r, h, w);
    dm[q] = d_n[(int)floorf((float)j * near)] < thresh_dxyz ? 1.f : 0.f;
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
  auto kernel = vec ? paste_front_kernel<true> : paste_front_kernel<false>;
  kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      image, front, C, Hf, Wf, weights, xyz, occ_bin, dxyz, fwmask, out_image, paste, mask,
      wmask, smask, fmask, dmask, S, r, bw * 0.5f, inv_bw, thresh_weight, thresh_edges,
      thresh_dxyz, (float)r / (float)S, near_h);
  return (int)cudaGetLastError();
}
