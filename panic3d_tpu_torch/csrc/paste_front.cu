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
// 0.2 MB and stay in L1/L2. Each pixel does ~30 bilinear evaluations (the
// 3x3 sobel stencil of the upsampled xyz is recomputed in place), a few
// hundred flops: bytes bound.
//
// Design: one thread per output pixel. The upsampled xyz never reaches
// device memory: the sobel neighbours' values are recomputed from the 64^2
// map (reflect padding at the output border), the bilinear upsample is
// torch's align_corners=False formula (source index clamped at 0, upper
// neighbour clamped at the edge), and the front image is sampled with
// border clamping through the transposed-image convention of the JAX op.
#include "common.cuh"

namespace {

// Bilinear upsample (align_corners=False) of an r x r map at output pixel
// (i, j), scale = r / S: torch's formula, each multiply and add rounded
// on its own as in the plain version (triplane.py:upsample_bilinear)
__device__ __forceinline__ float upsample(const float* m, int r, float scale, int i, int j) {
  const float sh = fmaxf(__fsub_rn(__fmul_rn(__fadd_rn((float)i, 0.5f), scale), 0.5f), 0.f);
  const float sw = fmaxf(__fsub_rn(__fmul_rn(__fadd_rn((float)j, 0.5f), scale), 0.5f), 0.f);
  const int h0 = (int)sh, w0 = (int)sw;
  const int hp = h0 < r - 1 ? 1 : 0, wp = w0 < r - 1 ? 1 : 0;
  const float lh1 = __fsub_rn(sh, (float)h0), lw1 = __fsub_rn(sw, (float)w0);
  const float lh0 = __fsub_rn(1.f, lh1), lw0 = __fsub_rn(1.f, lw1);
  const float* row0 = m + h0 * r;
  const float* row1 = m + (h0 + hp) * r;
  const float top = __fadd_rn(__fmul_rn(row0[w0], lw0), __fmul_rn(row0[w0 + wp], lw1));
  const float bot = __fadd_rn(__fmul_rn(row1[w0], lw0), __fmul_rn(row1[w0 + wp], lw1));
  return __fadd_rn(__fmul_rn(top, lh0), __fmul_rn(bot, lh1));
}

__device__ __forceinline__ int reflect(int i, int S) {
  return i < 0 ? -i : (i >= S ? 2 * S - 2 - i : i);
}

__global__ void paste_front_kernel(
    const float* __restrict__ image, const float* __restrict__ front, int C, int Hf, int Wf,
    const float* __restrict__ weights, const float* __restrict__ xyz,
    const float* __restrict__ occ_bin, const float* __restrict__ dxyz,
    const float* __restrict__ fwmask, float* __restrict__ out_image, float* __restrict__ paste,
    float* __restrict__ mask, float* __restrict__ wmask, float* __restrict__ smask,
    float* __restrict__ fmask, float* __restrict__ dmask, int N, int S, int r, float bw,
    float thresh_weight, float thresh_edges, float thresh_dxyz, float near_h, float near_w) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long plane = (long long)S * S;
  if (idx >= N * plane) return;
  const int n = (int)(idx / plane), i = (int)((idx / S) % S), j = (int)(idx % S);
  const long long pix = (long long)i * S + j;
  const float scale = (float)r / (float)S;
  const int rr = r * r;

  const float wm = upsample(weights + (long long)n * rr, r, scale, i, j) > thresh_weight ? 1.f : 0.f;

  // sobel of the upsampled xyz (kornia-normalised /8, reflect padding):
  // gx = sum K_x * x, K_x flipped to a correlation, as the JAX op does
  const float* xyz_n = xyz + (long long)n * 3 * rr;
  float mag2 = 0.f, centre[3];
  const int ii[3] = {reflect(i - 1, S), i, reflect(i + 1, S)};
  const int jj[3] = {reflect(j - 1, S), j, reflect(j + 1, S)};
  for (int c = 0; c < 3; ++c) {
    float v[3][3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b) v[a][b] = upsample(xyz_n + c * rr, r, scale, ii[a], jj[b]);
    centre[c] = v[1][1];
    const float gx = (v[0][0] - v[0][2] + 2.f * (v[1][0] - v[1][2]) + v[2][0] - v[2][2]) / 8.f;
    const float gy = (v[0][0] + 2.f * v[0][1] + v[0][2] - v[2][0] - 2.f * v[2][1] - v[2][2]) / 8.f;
    mag2 += gx * gx + gy * gy;
  }
  const float sm = sqrtf(mag2 + 1e-12f) < thresh_edges ? 1.f : 0.f;
  const float fm = upsample(occ_bin + (long long)n * rr, r, scale, i, j);
  const int ni = (int)floorf((float)i * near_h), nj = (int)floorf((float)j * near_w);
  const float dm = dxyz[(long long)n * rr + ni * r + nj] < thresh_dxyz ? 1.f : 0.f;
  const float fw = fwmask ? fwmask[(long long)n * plane + pix] : 1.f;
  const float m = (((wm * sm) * fm) * dm) * fw;

  // the front image's uv: uv = 1 - (xyz[[1, 0]] + bw/2) / bw, sampled from
  // the transposed image (x indexes the front's rows, y its columns); the
  // division by bw is a multiply by its f32 reciprocal, as torch's division
  // of a CUDA tensor by a Python number is
  const float half_bw = bw * 0.5f, inv_bw = __fdiv_rn(1.f, bw);
  const float u = __fsub_rn(__fmul_rn(__fsub_rn(1.f, __fmul_rn(__fadd_rn(centre[1], half_bw), inv_bw)), 2.f), 1.f);
  const float v = __fsub_rn(__fmul_rn(__fsub_rn(1.f, __fmul_rn(__fadd_rn(centre[0], half_bw), inv_bw)), 2.f), 1.f);
  const float ix = __fdiv_rn(__fsub_rn(__fmul_rn(__fadd_rn(u, 1.f), (float)Hf), 1.f), 2.f);
  const float iy = __fdiv_rn(__fsub_rn(__fmul_rn(__fadd_rn(v, 1.f), (float)Wf), 1.f), 2.f);
  const float fx = floorf(ix), fy = floorf(iy);
  const float wx = __fsub_rn(ix, fx), wy = __fsub_rn(iy, fy);
  const int x0 = min(max((int)fx, 0), Hf - 1), x1 = min(max((int)fx + 1, 0), Hf - 1);
  const int y0 = min(max((int)fy, 0), Wf - 1), y1 = min(max((int)fy + 1, 0), Wf - 1);
  for (int c = 0; c < C; ++c) {
    const float* f = front + ((long long)n * C + c) * Hf * Wf;
    const float v00 = f[x0 * Wf + y0], v01 = f[x1 * Wf + y0];
    const float v10 = f[x0 * Wf + y1], v11 = f[x1 * Wf + y1];
    const float top = __fadd_rn(v00, __fmul_rn(__fsub_rn(v01, v00), wx));
    const float bot = __fadd_rn(v10, __fmul_rn(__fsub_rn(v11, v10), wx));
    const float p = __fadd_rn(top, __fmul_rn(__fsub_rn(bot, top), wy));
    const long long o = ((long long)n * C + c) * plane + pix;
    paste[o] = p;
    const float im = image[o];
    out_image[o] = __fadd_rn(im, __fmul_rn(__fsub_rn(p, im), m));
  }
  const long long o1 = (long long)n * plane + pix;
  mask[o1] = m;
  wmask[o1] = wm;
  smask[o1] = sm;
  fmask[o1] = fm;
  dmask[o1] = dm;
}

}  // namespace

// image [N,C,S,S] f32 (the SR image), front [N,C,Hf,Wf] f32 (the image to
// paste); weights, occ_bin, dxyz [N,1,r,r] and xyz [N,3,r,r] f32;
// fwmask [N,1,S,S] f32 or null (all ones); outputs [N,C,S,S] image and
// paste, [N,1,S,S] mask and its four factors. near_h/near_w are the
// nearest-resize steps r/S.
PANIC3D_EXPORT int paste_front(const float* image, const float* front, int C, int Hf, int Wf,
                               const float* weights, const float* xyz, const float* occ_bin,
                               const float* dxyz, const float* fwmask, float* out_image,
                               float* paste, float* mask, float* wmask, float* smask,
                               float* fmask, float* dmask, int N, int S, int r, float bw,
                               float thresh_weight, float thresh_edges, float thresh_dxyz,
                               float near_h, float near_w, void* stream) {
  const int threads = 256;
  const long long total = (long long)N * S * S;
  paste_front_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      image, front, C, Hf, Wf, weights, xyz, occ_bin, dxyz, fwmask, out_image, paste, mask,
      wmask, smask, fmask, dmask, N, S, r, bw, thresh_weight, thresh_edges, thresh_dxyz,
      near_h, near_w);
  return (int)cudaGetLastError();
}
