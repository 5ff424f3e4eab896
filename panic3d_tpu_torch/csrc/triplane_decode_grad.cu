// K1's backward form (triplane_decode_grad): the gradient of K1's decode
// (triplane bilinear sample -> plane mean -> OSGDecoder MLP -> density
// filters) to the channels-last planes and, through the products it leaves
// behind, to the decoder's weights and biases.
//
// Replaces (JAX): what XLA's autodiff makes of
// panic3d_tpu/models/volumetric/renderer.py:run_model (:778) in training:
// sample_from_planes' bilinear gather (its transpose, a scatter-add into the
// plane gradient), the plane mean and OSGDecoder (models/triplane.py:63).
// The render's coarse and fine passes and sample_mixed (the density
// regulariser's points) run it; the sample coordinates take no gradient on
// that path (the depths are stop-gradiented, the regulariser's points are
// drawn), so the kernel gives none.
//
// What bounds it on the H100: per point it reads the 12 corner rows of the
// forward (768 B at C = 32 in bf16, L2 hits) and its output gradients,
// redoes the MLP (4,160 multiply-adds) and runs it backward (another
// 4,160 + 2,112), writes the four per-point blocks the weight gradients are
// taken from (f [C], h [64], dL/dpre [64], dL/dout [33]: 772 B in f32) and
// adds 3 x 4 x C f32 values into the plane gradient. The bytes (~1.5 KB a
// point) bound it, with the atomics' own rate next.
//
// Design (a first form): one thread per point, 64 a block; the decoder's
// gained weights and biases sit in shared memory (f32), and so do each
// thread's 64 hidden values and 33 output gradients ([unit][thread]), so
// that the loops over them stay rolled (a build of seconds, not minutes,
// and no 255-register threads); the gather, the mean and the MLP are
// recomputed in f32, not kept from the forward (64 hidden values a point
// would cost 400 MB a pass); the rgb slope is the
// sigmoid's s (1 - s) times the MipNeRF scale, sigma's gradient is zero
// where a density filter replaced it. The corner contributions go into the
// f32 plane gradient [N,3,H,W,C] as 16-byte vector atomics (red.v4.f32,
// sm_90). The weight gradients are the products h^T dL/dout and
// f^T dL/dpre over the points, left to torch.matmul as the JAX package
// leaves them to XLA's dots (ops in renderer.py:triplane_decode_grad_kernel).
#include "common.cuh"

namespace {

constexpr int TPB = 64;
constexpr int HID = 64;
constexpr int NOUT = 33;

struct Proj {
  float m[3][3][2];   // [plane][xyz][uv]: the inverse plane axes' first two columns
};

__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }

// plane p's 4 bilinear corners of a point (grid_sample, align_corners=False,
// zeros padding): the texel row index [N,3,H,W] (-1 outside) and the weight
__device__ __forceinline__ void corners(const Proj& pr, int p, float px, float py, float pz,
                                        float scale, long long n, int H, int W,
                                        long long (&corner)[4], float (&cw)[4]) {
  const float u = (px * scale) * pr.m[p][0][0] + (py * scale) * pr.m[p][1][0] +
                  (pz * scale) * pr.m[p][2][0];
  const float v = (px * scale) * pr.m[p][0][1] + (py * scale) * pr.m[p][1][1] +
                  (pz * scale) * pr.m[p][2][1];
  const float ix = ((u + 1.f) * W - 1.f) / 2.f, iy = ((v + 1.f) * H - 1.f) / 2.f;
  const float fx = floorf(ix), fy = floorf(iy);
  const float wx = ix - fx, wy = iy - fy;
  const int x0 = (int)fx, y0 = (int)fy;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int xx = x0 + (k & 1), yy = y0 + (k >> 1);
    cw[k] = ((k & 1) ? wx : 1.f - wx) * ((k >> 1) ? wy : 1.f - wy);
    const bool in = xx >= 0 && xx < W && yy >= 0 && yy < H;
    corner[k] = in ? ((n * 3 + p) * H + yy) * (long long)W + xx : -1;
  }
}

// a thread's hidden values and output gradients live in shared memory,
// [unit][thread] (conflict-free: a unit's 64 threads read 64 words), so the
// loops over the 64 hidden units and 33 outputs need not unroll
template <typename T, int C>
__global__ void __launch_bounds__(TPB) triplane_decode_grad_kernel(
    const T* __restrict__ planes, const float* __restrict__ coords,
    const float* __restrict__ w0, const float* __restrict__ b0, const float* __restrict__ w1,
    const float* __restrict__ b1, const T* __restrict__ g_rgb,
    const float* __restrict__ g_sigma, float* __restrict__ g_planes,
    float* __restrict__ feats, float* __restrict__ hid, float* __restrict__ g_pre,
    float* __restrict__ g_out, int N, int M, int H, int W, Proj pr, float scale, float gain0,
    float gain1, float lr_mul, float rgb_scale, int use_crop, float crop_lim, int cull_mode,
    float cull_thresh) {
  __shared__ float sw0[HID * C];
  __shared__ float sw1[NOUT * HID];
  __shared__ float sb0[HID];
  __shared__ float sb1[NOUT];
  __shared__ float sh[HID][TPB];
  __shared__ float sgo[NOUT][TPB];
  for (int i = threadIdx.x; i < HID * C; i += TPB) sw0[i] = w0[i] * gain0;
  for (int i = threadIdx.x; i < NOUT * HID; i += TPB) sw1[i] = w1[i] * gain1;
  for (int i = threadIdx.x; i < HID; i += TPB) sb0[i] = b0[i] * lr_mul;
  for (int i = threadIdx.x; i < NOUT; i += TPB) sb1[i] = b1[i] * lr_mul;
  __syncthreads();
  const long long P = (long long)N * M;
  const long long idx = blockIdx.x * (long long)TPB + threadIdx.x;
  if (idx >= P) return;
  const int t = threadIdx.x;
  const long long n = idx / M;
  const float px = coords[idx * 3], py = coords[idx * 3 + 1], pz = coords[idx * 3 + 2];

  // the gather, the plane mean and the first layer: h = softplus(W0 f + b0)
  {
    float f[C];
#pragma unroll
    for (int c = 0; c < C; ++c) f[c] = 0.f;
#pragma unroll 1
    for (int p = 0; p < 3; ++p) {
      long long corner[4];
      float cw[4];
      corners(pr, p, px, py, pz, scale, n, H, W, corner, cw);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (corner[k] < 0) continue;
        const T* row = planes + corner[k] * C;
#pragma unroll
        for (int c = 0; c < C; ++c) f[c] = fmaf(cw[k], to_f(row[c]), f[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      f[c] /= 3.f;
      feats[idx * C + c] = f[c];
    }
#pragma unroll 1
    for (int j = 0; j < HID; ++j) {
      float a = sb0[j];
#pragma unroll
      for (int c = 0; c < C; ++c) a = fmaf(sw0[j * C + c], f[c], a);
      const float hj = softplus_f(a);
      sh[j][t] = hj;
      hid[idx * HID + j] = hj;
    }
  }

  // the second layer and the outputs' slopes: dL/dout
#pragma unroll 1
  for (int k = 0; k < NOUT; ++k) {
    float o = sb1[k];
#pragma unroll 8
    for (int j = 0; j < HID; ++j) o = fmaf(sw1[k * HID + j], sh[j][t], o);
    float go;
    if (k == 0) {
      bool pass = !(use_crop && (fabsf(px) > crop_lim || fabsf(pz) > crop_lim));
      if (cull_mode == 2) pass = false;
      if (cull_mode == 1 && pass && 1.f - expf(-softplus_f(o - 1.f)) < cull_thresh)
        pass = false;
      go = pass ? g_sigma[idx] : 0.f;
    } else {
      const float s = sigmoid_f(o);
      go = to_f(g_rgb[idx * 32 + (k - 1)]) * (s * (1.f - s)) * rgb_scale;
    }
    sgo[k][t] = go;
    g_out[idx * NOUT + k] = go;
  }

  // backward through the MLP: dL/dh, dL/dpre (softplus' = sigmoid(pre) =
  // 1 - e^-h), dL/df
  float gf[C];
#pragma unroll
  for (int c = 0; c < C; ++c) gf[c] = 0.f;
#pragma unroll 1
  for (int j = 0; j < HID; ++j) {
    float gh = 0.f;
#pragma unroll 11
    for (int k = 0; k < NOUT; ++k) gh = fmaf(sw1[k * HID + j], sgo[k][t], gh);
    const float gp = gh * -expm1f(-sh[j][t]);
#pragma unroll
    for (int c = 0; c < C; ++c) gf[c] = fmaf(sw0[j * C + c], gp, gf[c]);
    g_pre[idx * HID + j] = gp;
  }

  // the scatter: d(mean)/d(plane sample) = 1/3, times each corner's weight
#pragma unroll 1
  for (int p = 0; p < 3; ++p) {
    long long corner[4];
    float cw[4];
    corners(pr, p, px, py, pz, scale, n, H, W, corner, cw);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (corner[k] < 0) continue;
      const float wgt = cw[k] / 3.f;
      float4* dst = reinterpret_cast<float4*>(g_planes + corner[k] * C);
#pragma unroll
      for (int c = 0; c < C; c += 4)
        atomicAdd(dst + c / 4,
                  make_float4(gf[c] * wgt, gf[c + 1] * wgt, gf[c + 2] * wgt, gf[c + 3] * wgt));
    }
  }
}

template <typename T, int C>
cudaError_t launch(const void* planes, const float* coords, const float* w0, const float* b0,
                   const float* w1, const float* b1, const void* g_rgb, const float* g_sigma,
                   float* g_planes, float* feats, float* hid, float* g_pre, float* g_out,
                   int N, int M, int H, int W, const Proj& pr, float scale, float gain0,
                   float gain1, float lr_mul, float rgb_scale, int use_crop, float crop_lim,
                   int cull_mode, float cull_thresh, cudaStream_t stream) {
  const long long P = (long long)N * M;
  const unsigned blocks = (unsigned)((P + TPB - 1) / TPB);
  triplane_decode_grad_kernel<T, C><<<blocks, TPB, 0, stream>>>(
      static_cast<const T*>(planes), coords, w0, b0, w1, b1, static_cast<const T*>(g_rgb),
      g_sigma, g_planes, feats, hid, g_pre, g_out, N, M, H, W, pr, scale, gain0, gain1, lr_mul,
      rgb_scale, use_crop, crop_lim, cull_mode, cull_thresh);
  return cudaGetLastError();
}

}  // namespace

// planes [N,3,H,W,C] channels-last (f32 or bf16), coords [N,M,3] f32, the
// decoder's raw weights w0 [64,C], b0 [64], w1 [33,64], b1 [33] (f32; the
// gains are applied here), g_rgb [N,M,32] in the planes' dtype and g_sigma
// [N,M] f32: the gradients of K1's outputs. Writes (adds into) g_planes
// [N,3,H,W,C] f32, zeroed by the caller, and writes feats [N*M,C], hid
// [N*M,64], g_pre [N*M,64], g_out [N*M,33] (f32), from which the caller
// takes the weight gradients. proj: the inverse plane axes [3][3][2]; the
// filter arguments are K1's.
PANIC3D_EXPORT int triplane_decode_grad(
    const void* planes, int dtype, const float* coords, const float* w0, const float* b0,
    const float* w1, const float* b1, const void* g_rgb, const float* g_sigma,
    float* g_planes, float* feats, float* hid, float* g_pre, float* g_out, int N, int M,
    int H, int W, int C, const float* proj, float scale, float gain0, float gain1,
    float lr_mul, int force_sigmoid, int use_crop, float crop_lim, int cull_mode,
    float cull_thresh, void* stream) {
  if (N < 1 || M < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  Proj pr;
  for (int i = 0; i < 18; ++i) (&pr.m[0][0][0])[i] = proj[i];
  const float rgb_scale = force_sigmoid ? 1.f : 1.f + 2.f * 0.001f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define P3D_K1G(T, CC)                                                                       \
  return (int)launch<T, CC>(planes, coords, w0, b0, w1, b1, g_rgb, g_sigma, g_planes, feats, \
                            hid, g_pre, g_out, N, M, H, W, pr, scale, gain0, gain1, lr_mul,  \
                            rgb_scale, use_crop, crop_lim, cull_mode, cull_thresh, s)
  if (dtype == DT_BF16) {
    if (C == 32) P3D_K1G(__nv_bfloat16, 32);
    if (C == 16) P3D_K1G(__nv_bfloat16, 16);
    if (C == 8) P3D_K1G(__nv_bfloat16, 8);
  } else {
    if (C == 32) P3D_K1G(float, 32);
    if (C == 16) P3D_K1G(float, 16);
    if (C == 8) P3D_K1G(float, 8);
  }
#undef P3D_K1G
  return (int)cudaErrorInvalidValue;
}
