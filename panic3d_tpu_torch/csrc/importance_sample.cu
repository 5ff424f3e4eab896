// K3 importance_sample: coarse ray-march weights -> max-pool/avg-pool
// smoothing -> pdf/cdf -> inverse-CDF sampling at u = linspace(0, 1, K).
//
// Replaces (JAX): panic3d_tpu/models/volumetric/renderer.py:1052-1056, i.e.
// ray_march (:188, weights only) -> sample_importance (:548) -> sample_pdf
// (:496) -> _searchsorted_right (:486), on the deterministic eval path
// (key=None).
//
// What bounds it on the H100: per ray it reads S depths and S sigmas (2 x 96
// f32) and writes K depths; the arithmetic is O(S*K) compares for the
// searchsorted. At 2 x 64^2 rays it moves about 9 MB, so it is bound by
// latency and launch, not by bandwidth or FLOPs.
//
// Design: one warp per ray, the ray's S samples staged in shared memory.
// Elementwise steps (alpha, smoothing, pdf) are spread over the 32 lanes;
// the two scans (transmittance cumprod, cdf cumsum) run sequentially on lane
// 0 in the reference's order; each lane then resolves K/32 of the u values
// by counting cdf entries <= u (searchsorted-right) and lerps the bracketing
// mid-depths. Nothing but the K output depths goes back to device memory.
#include "common.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int MAX_S = 256;

__global__ void __launch_bounds__(WARPS * 32) importance_sample_kernel(
    const float* __restrict__ depths, const float* __restrict__ sigmas,
    float* __restrict__ out, int rays, int S, int K) {
  __shared__ float s_z[WARPS][MAX_S];
  __shared__ float s_a[WARPS][MAX_S];    // alpha, then the pdf weights
  __shared__ float s_cdf[WARPS][MAX_S];
  __shared__ float s_w[WARPS][MAX_S];    // ray-march weights
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long r = (long long)blockIdx.x * WARPS + warp;
  if (r >= rays) return;
  float* z = s_z[warp];
  float* a = s_a[warp];
  float* cdf = s_cdf[warp];
  float* w = s_w[warp];
  const float* zr = depths + r * S;
  const float* sr = sigmas + r * S;

  // ray_march: midpoint density, alpha = 1 - exp(-softplus(sigma_mid - 1) * delta)
  for (int i = lane; i < S; i += 32) z[i] = zr[i];
  __syncwarp();
  for (int i = lane; i < S - 1; i += 32) {
    const float delta = z[i + 1] - z[i];
    const float dens = softplus_f((sr[i] + sr[i + 1]) / 2.f - 1.f);
    a[i] = 1.f - expf(-(dens * delta));
  }
  __syncwarp();
  if (lane == 0) {   // transmittance: exclusive cumprod of (1 - alpha + 1e-10)
    float T = 1.f;
    for (int i = 0; i < S - 1; ++i) {
      w[i] = a[i] * T;
      T *= (1.f - a[i] + 1e-10f);
    }
  }
  __syncwarp();

  // smoothing: max_pool1d(k2,s1,p1) then avg_pool1d(k2,s1), + 0.01; the
  // pdf uses the interior S-3 entries (+ eps)
  const int Sw = S - 3;
  const float eps = 1e-5f;
  for (int k = lane; k < Sw; k += 32) {
    const float m0 = fmaxf(w[k], w[k + 1]);
    const float m1 = fmaxf(w[k + 1], w[k + 2]);
    a[k] = ((m0 + m1) / 2.f + 0.01f) + eps;
  }
  __syncwarp();
  if (lane == 0) {
    float sum = 0.f;
    for (int k = 0; k < Sw; ++k) sum += a[k];
    float c = 0.f;
    cdf[0] = 0.f;
    for (int k = 0; k < Sw; ++k) {
      c += a[k] / sum;
      cdf[k + 1] = c;
    }
  }
  __syncwarp();

  // u = linspace(0, 1, K) in torch.linspace's symmetric form
  const float step = K > 1 ? 1.f / (float)(K - 1) : 0.f;
  for (int k = lane; k < K; k += 32) {
    const float u = (k < K / 2) ? step * (float)k : 1.f - step * (float)(K - 1 - k);
    int inds = 0;
    for (int j = 0; j <= Sw; ++j) inds += (cdf[j] <= u);
    const int below = max(inds - 1, 0);
    const int above = min(inds, Sw);
    const float c_lo = cdf[below], c_hi = cdf[above];
    const float b_lo = 0.5f * (z[below] + z[below + 1]);
    const float b_hi = 0.5f * (z[above] + z[above + 1]);
    float denom = c_hi - c_lo;
    if (denom < eps) denom = 1.f;
    out[r * K + k] = b_lo + (u - c_lo) / denom * (b_hi - b_lo);
  }
}

}  // namespace

// depths, sigmas: [rays, S] f32 (coarse samples, sorted by depth);
// out: [rays, K] f32. Requires 4 <= S <= 256.
PANIC3D_EXPORT int importance_sample(const float* depths, const float* sigmas,
                                     float* out, int rays, int S, int K,
                                     void* stream) {
  if (S < 4 || S > MAX_S || K < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = ((long long)rays + WARPS - 1) / WARPS;
  importance_sample_kernel<<<(unsigned)blocks, WARPS * 32, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      depths, sigmas, out, rays, S, K);
  return (int)cudaGetLastError();
}
