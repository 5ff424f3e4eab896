// K3 importance_sample: coarse ray-march weights -> max-pool/avg-pool
// smoothing -> pdf/cdf -> inverse-CDF sampling at u = linspace(0, 1, K), or,
// in the keyed form, at u [rays, K] read from memory.
//
// Replaces (JAX): panic3d_tpu/models/volumetric/renderer.py:1052-1056, i.e.
// ray_march (:188, weights only) -> sample_importance (:548) -> sample_pdf
// (:496) -> _searchsorted_right (:486): on the deterministic eval path
// (key=None) and, with u the draw jax.random.uniform(k_imp, (R, K)) of
// sample_pdf (:516-519), on the keyed path of training.
//
// What bounds it on the H100: per ray it reads S depths and S sigmas (2 x 96
// f32) and writes K depths, ~9 MB at 8,192 rays of 96+96: bytes bound it at
// ~3 us, so in practice each warp's chain of dependent steps and the launch
// do.
//
// Design: a warp, or a half warp, per ray, and no step of the ray on one
// lane alone.
// - Each of a ray's L lanes holds NPL consecutive samples in registers
//   (lane l: l NPL .. l NPL + NPL - 1; lanes past S hold nothing): at S = 96
//   L = 32 and NPL = 3; at S = 48 two rays share a warp, L = 16 and NPL = 3
//   (no lane idle, half the warps of one ray a warp); otherwise L = 32 and
//   NPL = ceil(S / 32) <= 8. The next lane's first depth and sigma, and its
//   first two weights, come by __shfl_down within the ray's lanes.
// - The transmittance (exclusive cumprod of 1 - alpha + 1e-10), the pdf's
//   sum and the cdf (cumsum of pdf) are scans over the ray's lanes: each
//   lane's product or sum of its own terms, log2 L __shfl_up steps
//   (Kogge-Stone) for the lanes before it (__shfl_xor for the sum), then
//   the lane's terms in order from that prefix.
// - The cdf and the bin midpoints go to a per-ray shared array of L NPL
//   floats each; each lane resolves its K / L values u = k / (K - 1) by a
//   binary search of fixed steps for the number of cdf entries <= u
//   (searchsorted right); the keyed form reads its u's, one coalesced load
//   per lane and step, in place of computing them, and nothing else
//   changes (its fine depths are then in no order along the ray: K2 takes
//   its rank-count branch). The cdf rises by at least
//   0.01 / (1.01 (S - 3)) >= 3.9e-5 an entry (the smoothed weights are >=
//   0.01, the weights are <= 1 on sorted depths), and a prefix in the scan's
//   order is within ~13 roundings (< 4e-7) of the sequential one, so it
//   rises strictly and the search finds exactly the index that counting
//   cdf[j] <= u finds.
// The scans' order rounds differently from torch.cumprod / torch.cumsum;
// renderer.py:importance_sample_warp_order repeats it in PyTorch for the
// CPU tests (tests/test_torch_importance_scan.py).
#include "common.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int MAX_S = 256;
constexpr unsigned FULL = 0xffffffffu;

// per-lane inclusive scan of v over the ray's L lanes (Kogge-Stone); MUL:
// product, else sum
template <int L, bool MUL>
__device__ __forceinline__ float scan_inclusive(float v, int lane) {
#pragma unroll
  for (int d = 1; d < L; d <<= 1) {
    const float o = __shfl_up_sync(FULL, v, d, L);
    if (lane >= d) v = MUL ? v * o : v + o;
  }
  return v;
}

// L lanes a ray, NPL samples a lane; FIXED_S: the kernel's S (0: any S up
// to L NPL, read from the argument)
template <int NPL, int L, int FIXED_S>
__global__ void __launch_bounds__(WARPS * 32) importance_sample_kernel(
    const float* __restrict__ depths, const float* __restrict__ sigmas,
    const float* __restrict__ u_in, float* __restrict__ out, int rays, int S_arg, int K) {
  constexpr int RPW = 32 / L;       // rays a warp
  constexpr int W = L * NPL;        // samples a ray can hold
  __shared__ float s_cdf[WARPS * RPW][W];
  __shared__ float s_bin[WARPS * RPW][W];
  const int S = FIXED_S ? FIXED_S : S_arg;
  const int npl = FIXED_S ? NPL : (S + L - 1) / L;
  const int slot = threadIdx.x / L, lane = threadIdx.x % L;
  const long long r_slot = (long long)blockIdx.x * WARPS * RPW + slot;
  if (r_slot - slot % RPW >= rays) return;   // a whole warp leaves together
  const bool live = r_slot < rays;           // a half warp past the last ray
  const long long r = live ? r_slot : rays - 1;
  float* cdf = s_cdf[slot];
  float* bin = s_bin[slot];
  const float* zr = depths + r * S;
  const float* sr = sigmas + r * S;
  const int i0 = lane * npl;

  float z[NPL], sg[NPL];
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    const bool ok = j < npl && i0 + j < S;
    z[j] = ok ? zr[i0 + j] : 0.f;
    sg[j] = ok ? sr[i0 + j] : 0.f;
  }
  const float z_next = __shfl_down_sync(FULL, z[0], 1, L);
  const float s_next = __shfl_down_sync(FULL, sg[0], 1, L);

  // ray_march: alpha = 1 - exp(-softplus(sigma_mid - 1) * delta) for
  // i < S - 1, its factor (1 - alpha) + 1e-10 of the transmittance, and the
  // bin midpoints
  float alpha[NPL], f[NPL];
  float prod = 1.f;
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    const int i = i0 + j;
    const bool last = j + 1 == npl;
    const float z1 = last ? z_next : z[j + 1 < NPL ? j + 1 : j];
    const float s1 = last ? s_next : sg[j + 1 < NPL ? j + 1 : j];
    alpha[j] = 0.f;
    f[j] = 1.f;
    if (j < npl && i < S - 1) {
      const float delta = z1 - z[j];
      const float dens = softplus_f((sg[j] + s1) / 2.f - 1.f);
      alpha[j] = 1.f - expf(-(dens * delta));
      f[j] = 1.f - alpha[j] + 1e-10f;
      bin[i] = 0.5f * (z[j] + z1);
      prod *= f[j];
    }
  }
  // transmittance from the lanes before (exclusive), then the lane's own in order
  float T = __shfl_up_sync(FULL, scan_inclusive<L, true>(prod, lane), 1, L);
  if (lane == 0) T = 1.f;
  float w[NPL];
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    w[j] = alpha[j] * T;
    T *= f[j];
  }

  // smoothing: max_pool1d(k2,s1,p1) then avg_pool1d(k2,s1), + 0.01; the pdf
  // takes the interior S - 3 entries (+ eps): entry m from w[m..m+2]
  const int Sw = S - 3;
  const float eps = 1e-5f;
  const float w_n0 = __shfl_down_sync(FULL, w[0], 1, L);
  const float w_n1 = npl >= 2 ? __shfl_down_sync(FULL, w[NPL >= 2 ? 1 : 0], 1, L)
                              : __shfl_down_sync(FULL, w[0], 2, L);
  float p[NPL];
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    // w[i0 + j + 1] and w[i0 + j + 2] from this lane or the next
    const float wa = w[j];
    const float wb = j + 1 < npl ? w[j + 1 < NPL ? j + 1 : j] : (j + 1 == npl ? w_n0 : w_n1);
    const float wc = j + 2 < npl ? w[j + 2 < NPL ? j + 2 : j]
                                 : (j + 2 == npl ? w_n0 : w_n1);
    p[j] = 0.f;
    if (j < npl && i0 + j < Sw) {
      const float m0 = fmaxf(wa, wb), m1 = fmaxf(wb, wc);
      p[j] = ((m0 + m1) / 2.f + 0.01f) + eps;
      sum += p[j];
    }
  }
#pragma unroll
  for (int m = L / 2; m > 0; m >>= 1) sum += __shfl_xor_sync(FULL, sum, m, L);

  // cdf = [0, cumsum(p / sum)]
  float q[NPL];
  float lane_sum = 0.f;
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    q[j] = p[j] / sum;
    lane_sum += q[j];
  }
  float c = __shfl_up_sync(FULL, scan_inclusive<L, false>(lane_sum, lane), 1, L);
  if (lane == 0) {
    c = 0.f;
    cdf[0] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    c += q[j];
    if (j < npl && i0 + j < Sw) cdf[i0 + j + 1] = c;
  }
  __syncwarp();
  if (!live) return;

  // u = linspace(0, 1, K) in torch.linspace's symmetric form ([0] for K = 1),
  // or u_in's row of the ray
  const float step = K > 1 ? 1.f / (float)(K - 1) : 0.f;
  int top = 1;                      // the largest power of 2 <= Sw + 1
  while (top * 2 <= Sw + 1) top *= 2;
  const float* ur = u_in ? u_in + r * K : nullptr;
  for (int k = lane; k < K; k += L) {
    const float u = ur ? ur[k]
                       : (k < K / 2 || K == 1) ? step * (float)k
                                               : 1.f - step * (float)(K - 1 - k);
    int n = 0;                      // cdf[0..n-1] <= u < cdf[n]: the count
    for (int h = top; h > 0; h >>= 1)
      if (n + h <= Sw + 1 && cdf[n + h - 1] <= u) n += h;
    const int below = max(n - 1, 0);
    const int above = min(n, Sw);
    const float c_lo = cdf[below], c_hi = cdf[above];
    const float b_lo = bin[below], b_hi = bin[above];
    float denom = c_hi - c_lo;
    if (denom < eps) denom = 1.f;
    out[r * K + k] = b_lo + (u - c_lo) / denom * (b_hi - b_lo);
  }
}

template <int NPL, int L, int FIXED_S>
int launch(const float* depths, const float* sigmas, const float* u, float* out, int rays,
           int S, int K, cudaStream_t stream) {
  const long long per_block = WARPS * 32 / L;
  const long long blocks = ((long long)rays + per_block - 1) / per_block;
  importance_sample_kernel<NPL, L, FIXED_S><<<(unsigned)blocks, WARPS * 32, 0, stream>>>(
      depths, sigmas, u, out, rays, S, K);
  return (int)cudaGetLastError();
}

}  // namespace

// depths, sigmas: [rays, S] f32 (coarse samples, sorted by depth); u:
// [rays, K] f32 in [0, 1), or null for linspace(0, 1, K); out: [rays, K]
// f32. Requires 4 <= S <= 256.
PANIC3D_EXPORT int importance_sample(const float* depths, const float* sigmas,
                                     const float* u, float* out, int rays, int S, int K,
                                     void* stream) {
  if (S < 4 || S > MAX_S || K < 1 || rays < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S == 48) return launch<3, 16, 48>(depths, sigmas, u, out, rays, S, K, st);
  if (S == 96) return launch<3, 32, 96>(depths, sigmas, u, out, rays, S, K, st);
  return launch<MAX_S / 32, 32, 0>(depths, sigmas, u, out, rays, S, K, st);
}
