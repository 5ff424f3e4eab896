// K1 triplane_decode: triplane bilinear sample -> plane mean -> OSGDecoder MLP
// -> triplane-crop / cull-clouds density filters, fused in one kernel; and
// K1v volume_density, its volume form for the mesh path.
//
// K1 replaces (JAX): panic3d_tpu/models/volumetric/renderer.py:run_model
// (:778) -> sample_from_planes (:68) -> ops/grid_sample.py:grid_sample_2d_points
// (:42), models/triplane.py:OSGDecoder.__call__ (:63), and
// renderer.py:_apply_density_filters (:246). Its ancestor on the TPU is the
// retired Pallas probe scripts/bench_pallas_gather.py:pallas_fused (row
// gather + first-layer dot).
//
// K1v replaces panic3d_tpu/eval/volume.py:extract_mesh's density_grid
// (:285): the sheared 256^3 lattice of create_samples_device (:39), the
// sigma-only decode (decode_sigma, :142), sigma2density (:35), the crop and
// the cloud cull applied to the density (:294-296), and the fp16 cast, with
// the grid written already flipped on axis 0 (:307).
//
// What bounds K1 on the H100: the random 4-corner reads. Per point it reads
// 3 planes x 4 corners x C channels (768 B in bf16 at C=32) and does
// C*64 + 64*33 multiply-adds (4,160 at C=32), about 5 FLOP per byte read, so
// at 96+96 samples x 64^2 rays x 2 views it is bound by cache bandwidth,
// not by arithmetic. Both portraits' bf16 planes (2 x 12.6 MB) fit in the
// 50 MB L2, so the corner reads are L2 hits after first touch.
// K1v reads nothing per point but the planes (one portrait's f32 planes,
// 25 MB, stay in L2) and writes 2 bytes, so it is bound by operations:
// ~4.7 kFLOP per point (the lerps, the 32x64 layer and 64 softplus, two
// more softplus and exp) x 16.8 M points.
//
// Design: one thread per sample point; planes are channels-last
// [N,3,H,W,C], so each corner is one contiguous C-vector read as 16-byte
// loads. The decoder weights (scaled by their equalized-lr gains) sit in
// shared memory and are read as broadcasts. The [M,3,C] feature block and
// the 64-wide hidden layer never leave registers; only rgb [N,M,32] (in the
// planes' dtype) and the filtered sigma [N,M] (f32) are written. All
// arithmetic is f32; bf16 planes are upcast as they are loaded. A grid-stride
// loop over a bounded grid amortizes the per-block weight load. K1v makes
// each point's coordinate from its flat index with the JAX package's f32
// divisions and fmod, explicitly rounded (IEEE division, no contracted
// multiply-add), so the lattice is bit-identical to its plain version's;
// it decodes net2's sigma row alone and stores the density in the flipped
// layout marching tetrahedra reads.
#include <cuda_fp16.h>

#include "common.cuh"
#include "lattice_decode.cuh"

namespace {

constexpr int HIDDEN = 64;
constexpr int OUT = 33;     // sigma + 32 feature channels
constexpr int THREADS = 128;

struct Proj { float a[3][3][2]; };   // plane p: uv[d] = sum_c xyz[c] * a[p][c][d]

__device__ __forceinline__ void load8(const float* p, float* v) {
  float4 a = reinterpret_cast<const float4*>(p)[0];
  float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// grid_sample (align_corners=False, zeros padding) of the three planes of
// one portrait [3,H,W,C] at plane-space point (sx, sy, sz), summed over the
// planes and divided by 3: the plane mean
template <typename T, int C>
__device__ __forceinline__ void sample_planes(const T* __restrict__ planes, int H, int W,
                                              const Proj& pj, float sx, float sy, float sz,
                                              float feat[C]) {
#pragma unroll
  for (int c = 0; c < C; ++c) feat[c] = 0.f;
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const float gx = sx * pj.a[p][0][0] + sy * pj.a[p][1][0] + sz * pj.a[p][2][0];
    const float gy = sx * pj.a[p][0][1] + sy * pj.a[p][1][1] + sz * pj.a[p][2][1];
    // grid_sample, align_corners=False
    const float ix = ((gx + 1.f) * (float)W - 1.f) / 2.f;
    const float iy = ((gy + 1.f) * (float)H - 1.f) / 2.f;
    const float fx0 = floorf(ix), fy0 = floorf(iy);
    const float wx = ix - fx0, wy = iy - fy0;
    const int x0 = (int)fx0, y0 = (int)fy0;
    const bool vx0 = x0 >= 0 && x0 < W, vx1 = x0 + 1 >= 0 && x0 + 1 < W;
    const bool vy0 = y0 >= 0 && y0 < H, vy1 = y0 + 1 >= 0 && y0 + 1 < H;
    const T* base = planes + (size_t)p * H * W * C;
    const T* r00 = base + ((long long)y0 * W + x0) * C;
#pragma unroll
    for (int c0 = 0; c0 < C; c0 += 8) {
      float v00[8] = {0}, v01[8] = {0}, v10[8] = {0}, v11[8] = {0};
      if (vy0 && vx0) load8(r00 + c0, v00);
      if (vy0 && vx1) load8(r00 + C + c0, v01);
      if (vy1 && vx0) load8(r00 + (long long)W * C + c0, v10);
      if (vy1 && vx1) load8(r00 + (long long)W * C + C + c0, v11);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float top = v00[k] + (v01[k] - v00[k]) * wx;
        const float bot = v10[k] + (v11[k] - v10[k]) * wx;
        feat[c0 + k] += top + (bot - top) * wy;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) feat[c] = feat[c] / 3.f;
}

template <typename T, int C>
__global__ void __launch_bounds__(THREADS) triplane_decode_kernel(
    const T* __restrict__ planes, const float* __restrict__ coords,
    const float* __restrict__ w0, const float* __restrict__ b0,
    const float* __restrict__ w1, const float* __restrict__ b1,
    T* __restrict__ rgb, float* __restrict__ sigma_out,
    int N, int M, int H, int W, Proj pj, float coord_scale, float g0, float g1,
    float bias_scale, int force_sigmoid, int use_crop, float crop_lim,
    int cull_mode, float cull_thresh) {
  __shared__ float sw0[HIDDEN * C];
  __shared__ float sb0[HIDDEN];
  __shared__ float sw1[OUT * HIDDEN];
  __shared__ float sb1[OUT];
  for (int i = threadIdx.x; i < HIDDEN * C; i += blockDim.x) sw0[i] = w0[i] * g0;
  for (int i = threadIdx.x; i < OUT * HIDDEN; i += blockDim.x) sw1[i] = w1[i] * g1;
  for (int i = threadIdx.x; i < HIDDEN; i += blockDim.x) sb0[i] = b0[i] * bias_scale;
  for (int i = threadIdx.x; i < OUT; i += blockDim.x) sb1[i] = b1[i] * bias_scale;
  __syncthreads();

  const long long total = (long long)N * M;
  for (long long pt = blockIdx.x * (long long)blockDim.x + threadIdx.x; pt < total;
       pt += (long long)gridDim.x * blockDim.x) {
    const int n = (int)(pt / M);
    const float x = coords[pt * 3 + 0], y = coords[pt * 3 + 1], z = coords[pt * 3 + 2];
    const float sx = coord_scale * x, sy = coord_scale * y, sz = coord_scale * z;

    float feat[C];
    sample_planes<T, C>(planes + (size_t)n * 3 * H * W * C, H, W, pj, sx, sy, sz, feat);
    // FC(C->64) -> softplus -> FC(64->33), f32 accumulation
    float out[OUT];
#pragma unroll
    for (int k = 0; k < OUT; ++k) out[k] = 0.f;
#pragma unroll 4
    for (int j = 0; j < HIDDEN; ++j) {
      float h = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) h = fmaf(sw0[j * C + c], feat[c], h);
      h = softplus_f(h + sb0[j]);
#pragma unroll
      for (int k = 0; k < OUT; ++k) out[k] = fmaf(sw1[k * HIDDEN + j], h, out[k]);
    }

    float sigma = out[0] + sb1[0];
    if (use_crop && !(fabsf(x) <= crop_lim && fabsf(z) <= crop_lim)) sigma = -1e3f;
    if (cull_mode != 0) {
      const float alpha = 1.f - expf(-softplus_f(sigma - 1.f));
      if (cull_mode == 2) sigma = alpha < cull_thresh ? -1e3f : 1e3f;   // binarize
      else if (alpha < cull_thresh) sigma = -1e3f;                       // cull
    }
    sigma_out[pt] = sigma;

    __align__(16) T o[OUT - 1];
#pragma unroll
    for (int k = 1; k < OUT; ++k) {
      const float s = 1.f / (1.f + expf(-(out[k] + sb1[k])));
      o[k - 1] = from_f<T>(force_sigmoid ? s : s * 1.002f - 0.001f);
    }
    uint4* dst = reinterpret_cast<uint4*>(rgb + pt * (OUT - 1));
#pragma unroll
    for (int i = 0; i < (int)(sizeof(o) / sizeof(uint4)); ++i)
      dst[i] = reinterpret_cast<const uint4*>(o)[i];
  }
}

template <typename T, int C>
cudaError_t launch(const void* planes, const float* coords, const float* w0,
                   const float* b0, const float* w1, const float* b1, void* rgb,
                   float* sigma, int N, int M, int H, int W, const Proj& pj,
                   float coord_scale, float g0, float g1, float bias_scale,
                   int force_sigmoid, int use_crop, float crop_lim, int cull_mode,
                   float cull_thresh, cudaStream_t stream) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long total = (long long)N * M;
  long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 16LL * sms) blocks = 16LL * sms;
  if (blocks < 1) blocks = 1;
  triplane_decode_kernel<T, C><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(planes), coords, w0, b0, w1, b1, static_cast<T*>(rgb),
      sigma, N, M, H, W, pj, coord_scale, g0, g1, bias_scale, force_sigmoid,
      use_crop, crop_lim, cull_mode, cull_thresh);
  return cudaGetLastError();
}

// the point of flat index i of the N^3 lattice (create_samples_device): f32
// divisions of the flat index (the sheared lattice the reference meshes
// bake in), then * voxel + origin
__device__ __forceinline__ void lattice_point(long long i, int N, float voxel, float origin,
                                              float& x, float& y, float& z) {
  const float fi = (float)i, fN = (float)N;
  const float s1 = fmodf(__fdiv_rn(fi, fN), fN);
  const float s0 = fmodf(__fdiv_rn(__fdiv_rn(fi, fN), fN), fN);
  const float s2 = (float)(i % N);
  x = __fadd_rn(__fmul_rn(s0, voxel), origin);
  y = __fadd_rn(__fmul_rn(s1, voxel), origin);
  z = __fadd_rn(__fmul_rn(s2, voxel), origin);
}

// K1v: one thread per point of the N^3 lattice (flat index i, x slowest),
// written to out[(N-1-i/N^2)*N^2 + i%N^2] (axis 0 flipped)
template <int C>
__global__ void __launch_bounds__(THREADS) volume_density_kernel(
    const float* __restrict__ planes, const float* __restrict__ w0,
    const float* __restrict__ b0, const float* __restrict__ w1,
    const float* __restrict__ b1, void* __restrict__ out, int out_f16, int N, int H, int W,
    Proj pj, float coord_scale, float g0, float g1, float bias_scale, float voxel,
    float origin, int use_crop, float crop_lim, int use_cull, float cull_thresh) {
  __shared__ SigmaMLP<C> m;
  load_sigma_mlp<C>(m, w0, b0, w1, b1, g0, g1, bias_scale);
  __syncthreads();

  const long long NN = (long long)N * N, total = NN * N;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    float x, y, z;
    lattice_point(i, N, voxel, origin, x, y, z);
    float feat[C];
    sample_planes<float, C>(planes, H, W, pj, coord_scale * x, coord_scale * y,
                            coord_scale * z, feat);
    const float sigma = sigma_decode<C>(m, feat);
    // sigma2density, then the crop, then the cloud cull on the density
    float d = __fsub_rn(1.f, expf(-softplus_f(__fsub_rn(sigma, 1.f))));
    if (use_crop && !(fabsf(x) <= crop_lim && fabsf(z) <= crop_lim)) d = -1e3f;
    if (use_cull && __fsub_rn(1.f, expf(-softplus_f(__fsub_rn(d, 1.f)))) < cull_thresh)
      d = -1e3f;
    const long long a = i / NN;
    const long long o = (N - 1 - a) * NN + (i - a * NN);
    if (out_f16) static_cast<__half*>(out)[o] = __float2half_rn(d);
    else static_cast<float*>(out)[o] = d;
  }
}

// the lattice alone, coords [N^3,3] in flat order, for checking K1v's points
__global__ void __launch_bounds__(THREADS) volume_lattice_kernel(
    float* __restrict__ coords, int N, float voxel, float origin) {
  const long long total = (long long)N * N * N;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x)
    lattice_point(i, N, voxel, origin, coords[i * 3], coords[i * 3 + 1], coords[i * 3 + 2]);
}

long long volume_blocks(int N) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long total = (long long)N * N * N;
  long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 16LL * sms) blocks = 16LL * sms;
  return blocks < 1 ? 1 : blocks;
}

template <int C>
cudaError_t launch_volume(const float* planes, const float* w0, const float* b0,
                          const float* w1, const float* b1, void* out, int out_f16, int N,
                          int H, int W, const Proj& pj, float coord_scale, float g0, float g1,
                          float bias_scale, float voxel, float origin, int use_crop,
                          float crop_lim, int use_cull, float cull_thresh,
                          cudaStream_t stream) {
  volume_density_kernel<C><<<(unsigned)volume_blocks(N), THREADS, 0, stream>>>(
      planes, w0, b0, w1, b1, out, out_f16, N, H, W, pj, coord_scale, g0, g1, bias_scale,
      voxel, origin, use_crop, crop_lim, use_cull, cull_thresh);
  return cudaGetLastError();
}

}  // namespace

// planes: [N,3,H,W,C] channels-last, dtype f32 or bf16; coords [N,M,3] f32;
// w0 [64,C], b0 [64], w1 [33,64], b1 [33] raw f32 parameters (gains applied
// here); rgb [N,M,32] in the planes' dtype; sigma [N,M] f32.
// proj: 18 floats, [plane][xyz][uv]. cull_mode: 0 off, 1 cull, 2 binarize.
// A channel count outside {8, 16, 32} returns cudaErrorInvalidValue.
PANIC3D_EXPORT int triplane_decode(
    const void* planes, int dtype, const float* coords, const float* w0,
    const float* b0, const float* w1, const float* b1, void* rgb, float* sigma,
    int N, int M, int H, int W, int C, const float* proj, float coord_scale,
    float g0, float g1, float bias_scale, int force_sigmoid, int use_crop,
    float crop_lim, int cull_mode, float cull_thresh, void* stream) {
  Proj pj;
  for (int i = 0; i < 18; ++i) (&pj.a[0][0][0])[i] = proj[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define P3D_K1(T, CC)                                                              \
  return (int)launch<T, CC>(planes, coords, w0, b0, w1, b1, rgb, sigma, N, M, H, W, \
                            pj, coord_scale, g0, g1, bias_scale, force_sigmoid,     \
                            use_crop, crop_lim, cull_mode, cull_thresh, s)
  if (dtype == DT_BF16) {
    if (C == 32) P3D_K1(__nv_bfloat16, 32);
    if (C == 16) P3D_K1(__nv_bfloat16, 16);
    if (C == 8) P3D_K1(__nv_bfloat16, 8);
  } else {
    if (C == 32) P3D_K1(float, 32);
    if (C == 16) P3D_K1(float, 16);
    if (C == 8) P3D_K1(float, 8);
  }
#undef P3D_K1
  return (int)cudaErrorInvalidValue;
}

// K1v. planes: one portrait's [3,H,W,C] channels-last f32; w0..b1 as K1;
// out [N,N,N] f16 (out_f16) or f32, axis 0 flipped. use_cull applies the
// cloud cull to the density. N must be at most 256 (the flat index is exact
// in f32).
PANIC3D_EXPORT int volume_density(
    const float* planes, const float* w0, const float* b0, const float* w1,
    const float* b1, void* out, int out_f16, int N, int H, int W, int C, const float* proj,
    float coord_scale, float g0, float g1, float bias_scale, float voxel, float origin,
    int use_crop, float crop_lim, int use_cull, float cull_thresh, void* stream) {
  if (N < 2 || N > 256) return (int)cudaErrorInvalidValue;
  Proj pj;
  for (int i = 0; i < 18; ++i) (&pj.a[0][0][0])[i] = proj[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define P3D_K1V(CC)                                                                  \
  return (int)launch_volume<CC>(planes, w0, b0, w1, b1, out, out_f16, N, H, W, pj,    \
                                coord_scale, g0, g1, bias_scale, voxel, origin,       \
                                use_crop, crop_lim, use_cull, cull_thresh, s)
  if (C == 32) P3D_K1V(32);
  if (C == 16) P3D_K1V(16);
  if (C == 8) P3D_K1V(8);
#undef P3D_K1V
  return (int)cudaErrorInvalidValue;
}

// The points K1v decodes, coords [N^3,3] f32 in flat order, made by the same
// device function: a check of the lattice, not a kernel of any path.
PANIC3D_EXPORT int volume_lattice(float* coords, int N, float voxel, float origin,
                                  void* stream) {
  if (N < 2 || N > 256) return (int)cudaErrorInvalidValue;
  volume_lattice_kernel<<<(unsigned)volume_blocks(N), THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(coords, N, voxel, origin);
  return (int)cudaGetLastError();
}
