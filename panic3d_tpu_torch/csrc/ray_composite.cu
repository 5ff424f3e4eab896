// K2 ray_composite: merge the coarse and fine samples of each ray in stable
// depth order and composite them with the midpoint quadrature.
//
// Replaces (JAX): panic3d_tpu/models/volumetric/renderer.py:unify_samples
// (:567) + ray_march (:188); the JAX eval path runs the re-associated
// merge_composite (:605), which computes the same function.
//
// What bounds it on the H100: per ray it reads S = S1 + S2 samples of
// (depth, sigma, C colors, xyz) -- 192 x (8 + 2*32 + 12) bytes = 16 KB with
// bf16 colors at the flagship slice -- and writes C + 5 floats. The sort is
// O(S^2) compares in shared memory and the two scans are sequential, so at
// 2 x 64^2 rays it is bound by per-ray latency more than by the ~134 MB it
// streams.
//
// Design: one block per ray. The block stages the ray's samples in shared
// memory as f32 (coalesced: each half of a ray is one contiguous run), ranks
// every sample by counting smaller depths (ties go to the lower index, i.e.
// coarse first: the order of a stable argsort), and computes the alphas in
// the sorted domain in parallel. Thread 0 runs the transmittance cumprod and
// the weight total; then one thread per output channel accumulates
// sum_j w_j (c_j + c_j+1) / 2 over the sorted samples. The composite depth
// is clipped to the global [min, max] of all depths (as the reference's
// jnp.clip(depth, min(depths), max(depths)) does): each block folds its
// ray's depth range into a global pair by float atomics, and a second
// launch applies the clip once every block is done.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;

__global__ void init_minmax(float* minmax) {
  minmax[0] = INFINITY;
  minmax[1] = -INFINITY;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) ray_composite_kernel(
    const float* __restrict__ d1, const T* __restrict__ c1, const float* __restrict__ s1,
    const float* __restrict__ x1, const float* __restrict__ d2, const T* __restrict__ c2,
    const float* __restrict__ s2, const float* __restrict__ x2, float* __restrict__ comp,
    float* __restrict__ depth_out, float* __restrict__ wsum_out, float* minmax,
    int S1, int S2, int C, int white_back) {
  extern __shared__ float sm[];
  const int S = S1 + S2, Cc = C + 3, tid = threadIdx.x;
  float* d = sm;                                  // [S] depths
  float* sg = d + S;                              // [S] sigmas
  float* w = sg + S;                              // [S-1] alpha, then weights
  int* order = reinterpret_cast<int*>(w + S);     // [S] sorted slot -> sample
  float* col = reinterpret_cast<float*>(order + S);   // [S, C+3] colors | xyz
  __shared__ float red[2][THREADS / 32];
  __shared__ float s_wsum;
  const long long r = blockIdx.x;

  for (int i = tid; i < S; i += blockDim.x) {
    d[i] = i < S1 ? d1[r * S1 + i] : d2[r * S2 + (i - S1)];
    sg[i] = i < S1 ? s1[r * S1 + i] : s2[r * S2 + (i - S1)];
  }
  for (int e = tid; e < S1 * C; e += blockDim.x) col[(e / C) * Cc + e % C] = to_f(c1[r * S1 * C + e]);
  for (int e = tid; e < S2 * C; e += blockDim.x) col[(S1 + e / C) * Cc + e % C] = to_f(c2[r * S2 * C + e]);
  for (int e = tid; e < S1 * 3; e += blockDim.x) col[(e / 3) * Cc + C + e % 3] = x1[r * S1 * 3 + e];
  for (int e = tid; e < S2 * 3; e += blockDim.x) col[(S1 + e / 3) * Cc + C + e % 3] = x2[r * S2 * 3 + e];
  __syncthreads();

  // stable rank of every sample; the ray's depth range on the side
  float lo = INFINITY, hi = -INFINITY;
  for (int i = tid; i < S; i += blockDim.x) {
    const float di = d[i];
    int rank = 0;
    for (int j = 0; j < S; ++j) {
      const float dj = d[j];
      rank += (dj < di) || (dj == di && j < i);
    }
    order[rank] = i;
    lo = fminf(lo, di);
    hi = fmaxf(hi, di);
  }
  for (int off = 16; off > 0; off >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  if (tid % 32 == 0) {
    red[0][tid / 32] = lo;
    red[1][tid / 32] = hi;
  }
  __syncthreads();
  if (tid == 0) {
    for (int k = 1; k < THREADS / 32; ++k) {
      lo = fminf(lo, red[0][k]);
      hi = fmaxf(hi, red[1][k]);
    }
    atomic_min_f(&minmax[0], lo);
    atomic_max_f(&minmax[1], hi);
  }

  // alpha per sorted interval
  for (int j = tid; j < S - 1; j += blockDim.x) {
    const int a = order[j], b = order[j + 1];
    const float delta = d[b] - d[a];
    const float dens = softplus_f((sg[a] + sg[b]) / 2.f - 1.f);
    w[j] = 1.f - expf(-(dens * delta));
  }
  __syncthreads();
  if (tid == 0) {   // weights = alpha * exclusive cumprod(1 - alpha + 1e-10)
    float T = 1.f, total = 0.f;
    for (int j = 0; j < S - 1; ++j) {
      const float wj = w[j] * T;
      T *= (1.f - w[j] + 1e-10f);
      w[j] = wj;
      total += wj;
    }
    s_wsum = total;
  }
  __syncthreads();

  const float wsum = s_wsum;
  for (int t = tid; t <= Cc; t += blockDim.x) {
    float acc = 0.f;
    if (t < Cc) {
      for (int j = 0; j < S - 1; ++j)
        acc += w[j] * ((col[order[j] * Cc + t] + col[order[j + 1] * Cc + t]) / 2.f);
      if (white_back) acc = acc + 1.f - wsum;
      comp[r * Cc + t] = acc * 2.f - 1.f;
    } else {
      for (int j = 0; j < S - 1; ++j) acc += w[j] * ((d[order[j]] + d[order[j + 1]]) / 2.f);
      float dep = acc / wsum;
      if (isnan(dep)) dep = INFINITY;
      depth_out[r] = dep;   // clipped by clip_depth once all rays are done
      wsum_out[r] = wsum;
    }
  }
}

__global__ void clip_depth(float* depth, const float* minmax, long long rays) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < rays) depth[i] = fminf(fmaxf(depth[i], minmax[0]), minmax[1]);
}

template <typename T>
cudaError_t launch(const float* d1, const void* c1, const float* s1, const float* x1,
                   const float* d2, const void* c2, const float* s2, const float* x2,
                   float* comp, float* depth, float* wsum, float* minmax, int rays,
                   int S1, int S2, int C, int white_back, cudaStream_t stream) {
  const int S = S1 + S2;
  const size_t smem = (size_t)S * 4 * sizeof(float) + (size_t)S * (C + 3) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(ray_composite_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  init_minmax<<<1, 1, 0, stream>>>(minmax);
  ray_composite_kernel<T><<<rays, THREADS, smem, stream>>>(
      d1, static_cast<const T*>(c1), s1, x1, d2, static_cast<const T*>(c2), s2, x2,
      comp, depth, wsum, minmax, S1, S2, C, white_back);
  clip_depth<<<(unsigned)((rays + 255) / 256), 256, 0, stream>>>(depth, minmax, rays);
  return cudaGetLastError();
}

}  // namespace

// Per ray r: d*[r, S*] depths, s*[r, S*] sigmas, x*[r, S*, 3] xyz (f32),
// c*[r, S*, C] colors (f32 or bf16). S2 may be 0 (no importance pass).
// Outputs: comp [rays, C+3] (composited colors | xyz after white_back and
// *2-1), depth [rays], wsum [rays], all f32; minmax: 2 f32 of scratch.
PANIC3D_EXPORT int ray_composite(const float* d1, const void* c1, const float* s1,
                                 const float* x1, const float* d2, const void* c2,
                                 const float* s2, const float* x2, int dtype,
                                 float* comp, float* depth, float* wsum, float* minmax,
                                 int rays, int S1, int S2, int C, int white_back,
                                 void* stream) {
  if (rays < 1 || S1 + S2 < 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16)
    return (int)launch<__nv_bfloat16>(d1, c1, s1, x1, d2, c2, s2, x2, comp, depth, wsum,
                                      minmax, rays, S1, S2, C, white_back, s);
  return (int)launch<float>(d1, c1, s1, x1, d2, c2, s2, x2, comp, depth, wsum, minmax,
                            rays, S1, S2, C, white_back, s);
}
