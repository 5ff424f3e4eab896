// K2 ray_composite: merge the coarse and fine samples of each ray in stable
// depth order and composite them with the midpoint quadrature.
//
// Replaces (JAX): panic3d_tpu/models/volumetric/renderer.py:unify_samples
// (:567) + ray_march (:188); the JAX eval path runs the re-associated
// merge_composite (:605), which computes the same function.
//
// What bounds it on the H100: per ray it reads S = S1 + S2 samples of
// (depth, sigma, C colors, xyz) -- 192 x (8 + 2*32 + 12) bytes = 16 KB with
// bf16 colors at the flagship slice -- and writes C + 5 floats: ~134 MB for
// 2 x 64^2 rays, ~0.04 ms of memory traffic. The work per sample is a few
// operations, so the kernel is bound by bytes once the per-ray steps are
// parallel.
//
// Design: one warp per ray, several rays per block. The warp stages the
// ray's depths and sigmas in shared memory and votes whether each half is
// non-decreasing (on every eval path it is: midpoint linspace coarse
// samples, inverse-CDF fine samples at a linspace u). If so, coarse sample i
// goes to slot i + #{fine < d_i} and fine sample j to j + #{coarse <= d_j},
// both by binary search: the stable argsort's order with ties coarse first
// (merge_composite's gathers_only merge). A ray that is not sorted takes the
// full stable rank count. The alphas run lane-parallel over the sorted
// intervals; the transmittance cumprod(1 - alpha + 1e-10) is a warp prefix
// product by shuffles, carried from one 32-interval chunk to the next; the
// weight total and the depth sum are warp reductions. The colors are not
// gathered: sample i at sorted slot s(i) gets the coefficient
// v_i = (w_{s(i)-1} + w_{s(i)}) / 2 (w_{-1} = w_{S-1} = 0), and the
// composite is sum_i v_i c_i in stored order: each lane reads 16 bytes of a
// sample's color row, so a warp reads several whole rows per load, and the
// partial sums meet by shuffles at the end. xyz goes the same way as a flat
// run of 3 S floats. The composite depth is clipped to the global [min, max]
// of all depths (the reference's jnp.clip(depth, min(depths), max(depths))):
// each block folds its rays' depth range into a global pair by float
// atomics, and the last block to finish (a counter after __threadfence)
// clips every ray's depth and resets the pair and the counter for the next
// call. One launch.
//
// Its backward form (ray_composite_grad) replaces what XLA's autodiff makes
// of the same merge and ray_march in training: the gradient to the colours
// and the sigmas of both halves (the sample depths are stop-gradiented,
// renderer.py:563; the sample xyz carry none, being points on camera rays).
// Same layout, one warp per ray: the warp redoes the merge (the same slots,
// so ties between the halves route exactly as the stable argsort does), the
// alphas and the weights in the forward's order; the colours' gradient is
// 2 v_i g_c (each lane writes 16-byte chunks of the rows in stored order),
// and the coefficients' gradient g_v_i = 2 (g_c . c_i + g_xyz . x_i) goes
// to the weights as g_w_k = (g_v[k] + g_v[k+1]) / 2 in sorted order, plus
// the weight total's (white_back's -2 sum g_c included) and the depth's,
// (dmid_k - depth) / wsum where the depth was not clipped. The alphas'
// gradient is T_k (g_w_k - R_k) with the reverse recurrence
// R_{k-1} = g_w_k alpha_k + (1 - alpha_k + 1e-10) R_k, R_{S-2} = 0 (no
// division by the transmittance): one lane walks it over the ray's
// intervals in shared memory. Then dalpha/ddens = delta e^(-dens delta),
// softplus' = sigmoid, and each interval's gradient splits half to each of
// its two sorted samples, scattered back to stored order by the slots.
// Bound: bytes (the colours read once and their gradient written once).
#include "common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int ARRAYS = 6;   // per warp: d, sg | v, sorted d, sorted sg, w, slot

// 16 bytes of a color row as floats
__device__ __forceinline__ void load16(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&o)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    o[2 * k] = f.x;
    o[2 * k + 1] = f.y;
  }
}

// #{k < n: a[k] < x} (strict) or #{k < n: a[k] <= x}, a non-decreasing
template <bool STRICT>
__device__ __forceinline__ int count_below(const float* a, int n, float x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (STRICT ? a[mid] < x : a[mid] <= x) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

__device__ __forceinline__ float finish(float acc, float wsum, int white_back) {
  if (white_back) acc = (acc + 1.f) - wsum;
  return acc * 2.f - 1.f;
}

template <typename T>
__global__ void ray_composite_kernel(
    const float* __restrict__ d1, const T* __restrict__ c1, const float* __restrict__ s1,
    const float* __restrict__ x1, const float* __restrict__ d2, const T* __restrict__ c2,
    const float* __restrict__ s2, const float* __restrict__ x2, float* __restrict__ comp,
    float* __restrict__ depth_out, float* __restrict__ wsum_out, float* scratch, int rays,
    int S1, int S2, int C, int white_back) {
  extern __shared__ float sm[];
  __shared__ float red[2][32];
  __shared__ bool s_last;
  constexpr int VEC = 16 / sizeof(T);
  const int S = S1 + S2, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5, Cc = C + 3;
  float* d = sm + (size_t)warp * ARRAYS * S;
  float* sg = d + S;          // sigmas in stored order, then the coefficients v
  float* ds = sg + S;         // depths by sorted slot
  float* ss = ds + S;         // sigmas by sorted slot
  float* w = ss + S;          // weights by sorted slot, w[S-1] = 0
  int* slot = reinterpret_cast<int*>(w + S);   // sorted slot of each sample
  const long long r = (long long)blockIdx.x * n_warps + warp;

  float lo = INFINITY, hi = -INFINITY;
  if (r < rays) {
    for (int i = lane; i < S; i += 32) {
      const float di = i < S1 ? d1[r * S1 + i] : d2[r * S2 + (i - S1)];
      d[i] = di;
      sg[i] = i < S1 ? s1[r * S1 + i] : s2[r * S2 + (i - S1)];
      lo = fminf(lo, di);
      hi = fmaxf(hi, di);
    }
    __syncwarp();
    bool sorted = true;
    for (int i = lane; i < S - 1; i += 32)
      if (i != S1 - 1) sorted &= d[i] <= d[i + 1];
    sorted = __all_sync(FULL, sorted);
    for (int i = lane; i < S; i += 32) {
      const float di = d[i];
      int k = 0;
      if (sorted) {
        k = i < S1 ? i + count_below<true>(d + S1, S2, di)
                   : (i - S1) + count_below<false>(d, S1, di);
      } else {   // the stable rank: smaller depths, then equal ones stored before
        for (int j = 0; j < S; ++j) {
          const float dj = d[j];
          k += (dj < di) || (dj == di && j < i);
        }
      }
      slot[i] = k;
      ds[k] = di;
      ss[k] = sg[i];
    }
    __syncwarp();

    // weights = alpha * exclusive cumprod(1 - alpha + 1e-10), by chunks of 32
    float carry = 1.f, wsum = 0.f, dsum = 0.f;
    for (int base = 0; base < S - 1; base += 32) {
      const int k = base + lane;
      float alpha = 0.f, f = 1.f;
      if (k < S - 1) {
        const float delta = ds[k + 1] - ds[k];
        const float dens = softplus_f((ss[k] + ss[k + 1]) / 2.f - 1.f);
        alpha = 1.f - expf(-(dens * delta));
        f = (1.f - alpha) + 1e-10f;
      }
      float p = f;   // inclusive prefix product within the chunk
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(FULL, p, off);
        if (lane >= off) p *= o;
      }
      float excl = __shfl_up_sync(FULL, p, 1);
      if (lane == 0) excl = 1.f;
      if (k < S - 1) {
        const float wk = alpha * (carry * excl);
        w[k] = wk;
        wsum += wk;
        dsum += wk * ((ds[k] + ds[k + 1]) / 2.f);
      }
      carry *= __shfl_sync(FULL, p, 31);
    }
    if (lane == 0) w[S - 1] = 0.f;
    wsum = warp_sum(wsum);
    dsum = warp_sum(dsum);
    __syncwarp();
    float* v = sg;
    for (int i = lane; i < S; i += 32) {
      const int k = slot[i];
      v[i] = ((k > 0 ? w[k - 1] : 0.f) + w[k]) / 2.f;
    }
    __syncwarp();

    // colors: G lanes cover a sample's row, 32 / G samples a step
    const int G = C / VEC, q = lane % G, g = lane / G, step = 32 / G;
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
#pragma unroll 4
    for (int i = g; i < S1; i += step) {
      float c[VEC];
      load16(c1 + (r * S1 + i) * C + q * VEC, c);
      const float vi = v[i];
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] = fmaf(vi, c[k], acc[k]);
    }
#pragma unroll 4
    for (int i = g; i < S2; i += step) {
      float c[VEC];
      load16(c2 + (r * S2 + i) * C + q * VEC, c);
      const float vi = v[S1 + i];
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] = fmaf(vi, c[k], acc[k]);
    }
    for (int off = G; off < 32; off <<= 1) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] += __shfl_xor_sync(FULL, acc[k], off);
    }
    if (lane < G) {
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        comp[r * Cc + q * VEC + k] = finish(acc[k], wsum, white_back);
    }

    // xyz as a flat run of 3 S floats per half
    float xa[3] = {0.f, 0.f, 0.f};
    for (int e = lane; e < 3 * S1; e += 32) {
      const int i = e / 3, k = e - 3 * i;
      const float val = v[i] * x1[r * S1 * 3 + e];
      if (k == 0) xa[0] += val;
      else if (k == 1) xa[1] += val;
      else xa[2] += val;
    }
    for (int e = lane; e < 3 * S2; e += 32) {
      const int i = e / 3, k = e - 3 * i;
      const float val = v[S1 + i] * x2[r * S2 * 3 + e];
      if (k == 0) xa[0] += val;
      else if (k == 1) xa[1] += val;
      else xa[2] += val;
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) xa[k] = warp_sum(xa[k]);
    if (lane < 3)
      comp[r * Cc + C + lane] = finish(lane == 0 ? xa[0] : lane == 1 ? xa[1] : xa[2], wsum,
                                       white_back);
    if (lane == 0) {
      float dep = dsum / wsum;
      if (isnan(dep)) dep = INFINITY;
      depth_out[r] = dep;   // clipped by the last block
      wsum_out[r] = wsum;
    }
  }

  // the depth range: warp, block, then the global pair
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(FULL, lo, off));
    hi = fmaxf(hi, __shfl_xor_sync(FULL, hi, off));
  }
  if (lane == 0) {
    red[0][warp] = lo;
    red[1][warp] = hi;
  }
  __threadfence();   // this block's depths, before its ticket
  __syncthreads();
  unsigned int* done = reinterpret_cast<unsigned int*>(scratch + 2);
  if (threadIdx.x == 0) {
    for (int k = 1; k < n_warps; ++k) {
      lo = fminf(lo, red[0][k]);
      hi = fmaxf(hi, red[1][k]);
    }
    atomic_min_f(&scratch[0], lo);
    atomic_max_f(&scratch[1], hi);
    __threadfence();
    s_last = atomicAdd(done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const float lo_g = __ldcg(&scratch[0]), hi_g = __ldcg(&scratch[1]);
  for (long long i = threadIdx.x; i < rays; i += blockDim.x)
    depth_out[i] = fminf(fmaxf(__ldcg(depth_out + i), lo_g), hi_g);
  if (threadIdx.x == 0) {   // ready for the next call
    scratch[0] = INFINITY;
    scratch[1] = -INFINITY;
    *done = 0u;
  }
}

// the stored (d, sigma) of a ray into d / sg, its sorted slots into slot and
// the sorted copies into ds / ss (the forward's merge, the same order)
__device__ __forceinline__ void merge_ray(const float* d1, const float* s1, const float* d2,
                                          const float* s2, long long r, int S1, int S2,
                                          float* d, float* sg, float* ds, float* ss, int* slot,
                                          int lane) {
  const int S = S1 + S2;
  for (int i = lane; i < S; i += 32) {
    d[i] = i < S1 ? d1[r * S1 + i] : d2[r * S2 + (i - S1)];
    sg[i] = i < S1 ? s1[r * S1 + i] : s2[r * S2 + (i - S1)];
  }
  __syncwarp();
  bool sorted = true;
  for (int i = lane; i < S - 1; i += 32)
    if (i != S1 - 1) sorted &= d[i] <= d[i + 1];
  sorted = __all_sync(FULL, sorted);
  for (int i = lane; i < S; i += 32) {
    const float di = d[i];
    int k = 0;
    if (sorted) {
      k = i < S1 ? i + count_below<true>(d + S1, S2, di)
                 : (i - S1) + count_below<false>(d, S1, di);
    } else {
      for (int j = 0; j < S; ++j) {
        const float dj = d[j];
        k += (dj < di) || (dj == di && j < i);
      }
    }
    slot[i] = k;
    ds[k] = di;
    ss[k] = sg[i];
  }
  __syncwarp();
}

constexpr int GRAD_ARRAYS = 10;   // per warp: d, sg, ds, ss, slot, alpha, T, w, gv, g

template <typename T>
__global__ void ray_composite_grad_kernel(
    const float* __restrict__ d1, const T* __restrict__ c1, const float* __restrict__ s1,
    const float* __restrict__ x1, const float* __restrict__ d2, const T* __restrict__ c2,
    const float* __restrict__ s2, const float* __restrict__ x2,
    const float* __restrict__ depth_out, const float* __restrict__ g_comp,
    const float* __restrict__ g_depth, const float* __restrict__ g_wsum,
    T* __restrict__ g_c1, float* __restrict__ g_s1, T* __restrict__ g_c2,
    float* __restrict__ g_s2, int rays, int S1, int S2, int C, int white_back) {
  extern __shared__ float sm[];
  constexpr int VEC = 16 / sizeof(T);
  const int S = S1 + S2, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5, Cc = C + 3;
  const long long r = (long long)blockIdx.x * n_warps + warp;
  if (r >= rays) return;
  float* d = sm + (size_t)warp * GRAD_ARRAYS * S;
  float* sg = d + S;
  float* ds = sg + S;
  float* ss = ds + S;
  int* slot = reinterpret_cast<int*>(ss + S);
  float* alpha = ss + 2 * S;
  float* tr = alpha + S;    // the transmittance T_k
  float* w = tr + S;        // weights by sorted slot, w[S-1] = 0
  float* gv = w + S;        // g_v by stored sample, then g_w by sorted slot
  float* g = gv + S;        // v by stored sample, then the intervals' g_arg
  merge_ray(d1, s1, d2, s2, r, S1, S2, d, sg, ds, ss, slot, lane);

  // the forward's weights, alphas and transmittances, in its order
  float carry = 1.f, wsum = 0.f, dsum = 0.f;
  for (int base = 0; base < S - 1; base += 32) {
    const int k = base + lane;
    float a = 0.f, f = 1.f;
    if (k < S - 1) {
      const float delta = ds[k + 1] - ds[k];
      const float dens = softplus_f((ss[k] + ss[k + 1]) / 2.f - 1.f);
      a = 1.f - expf(-(dens * delta));
      f = (1.f - a) + 1e-10f;
    }
    float p = f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(FULL, p, off);
      if (lane >= off) p *= o;
    }
    float excl = __shfl_up_sync(FULL, p, 1);
    if (lane == 0) excl = 1.f;
    if (k < S - 1) {
      const float t = carry * excl;
      const float wk = a * t;
      alpha[k] = a;
      tr[k] = t;
      w[k] = wk;
      wsum += wk;
      dsum += wk * ((ds[k] + ds[k + 1]) / 2.f);
    }
    carry *= __shfl_sync(FULL, p, 31);
  }
  if (lane == 0) w[S - 1] = 0.f;
  wsum = warp_sum(wsum);
  dsum = warp_sum(dsum);
  __syncwarp();
  for (int i = lane; i < S; i += 32) {
    const int k = slot[i];
    g[i] = ((k > 0 ? w[k - 1] : 0.f) + w[k]) / 2.f;   // v_i
  }
  __syncwarp();

  // colours: g_c_i = 2 v_i g_comp, and g_v_i = 2 g_comp . c_i (G lanes a row)
  const float* gc = g_comp + r * Cc;
  const int G = C / VEC, q = lane % G, grp = lane / G, step = 32 / G;
  float gq[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) gq[k] = gc[q * VEC + k];
  for (int base = 0; base < S; base += step) {
    const int i = base + grp;
    float part = 0.f;
    if (i < S) {
      const T* row = i < S1 ? c1 + (r * S1 + i) * C : c2 + (r * S2 + (i - S1)) * C;
      T* grow = i < S1 ? g_c1 + (r * S1 + i) * C : g_c2 + (r * S2 + (i - S1)) * C;
      float c[VEC];
      load16(row + q * VEC, c);
      const float vi2 = 2.f * g[i];
      __align__(16) T out[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        part = fmaf(gq[k], c[k], part);
        out[k] = from_f<T>(vi2 * gq[k]);
      }
      *reinterpret_cast<uint4*>(grow + q * VEC) = *reinterpret_cast<const uint4*>(out);
    }
    for (int off = 1; off < G; off <<= 1) part += __shfl_xor_sync(FULL, part, off);
    if (i < S && q == 0) gv[i] = 2.f * part;
  }
  __syncwarp();
  const float gx0 = gc[C], gx1 = gc[C + 1], gx2 = gc[C + 2];
  for (int i = lane; i < S; i += 32) {
    const float* xi = i < S1 ? x1 + (r * S1 + i) * 3 : x2 + (r * S2 + (i - S1)) * 3;
    gv[i] += 2.f * (gx0 * xi[0] + gx1 * xi[1] + gx2 * xi[2]);
  }
  // the weight total's gradient: its own, and white_back's -2 sum g_comp
  float gsum = 0.f;
  for (int k = lane; k < Cc; k += 32) gsum += gc[k];
  gsum = warp_sum(gsum);
  const float g_tot = g_wsum[r] - (white_back ? 2.f * gsum : 0.f);
  // the depth's, where dsum / wsum was not clipped
  const float dep = dsum / wsum;
  const float g_dep = (!isnan(dep) && dep == depth_out[r]) ? g_depth[r] / wsum : 0.f;
  __syncwarp();
  // g_v to sorted order (into g), then g_w_k = (g_v[k] + g_v[k+1]) / 2 + ...
  for (int i = lane; i < S; i += 32) g[slot[i]] = gv[i];
  __syncwarp();
  for (int k = lane; k < S - 1; k += 32) {
    float gw = (g[k] + g[k + 1]) / 2.f + g_tot;
    if (g_dep != 0.f) gw += g_dep * ((ds[k] + ds[k + 1]) / 2.f - dep);
    gv[k] = gw;
  }
  __syncwarp();
  // the alphas: T_k (g_w_k - R_k), R walked back from the last interval
  if (lane == 0) {
    float R = 0.f;
    for (int k = S - 2; k >= 0; --k) {
      const float a = alpha[k], gw = gv[k];
      g[k] = tr[k] * (gw - R);   // g_alpha_k
      R = gw * a + ((1.f - a) + 1e-10f) * R;
    }
  }
  __syncwarp();
  for (int k = lane; k < S - 1; k += 32) {
    const float delta = ds[k + 1] - ds[k];
    const float arg = (ss[k] + ss[k + 1]) / 2.f - 1.f;
    const float dens = softplus_f(arg);
    const float ddens = g[k] * delta * expf(-(dens * delta));
    g[k] = ddens / (1.f + expf(-arg));   // g_arg, softplus' = sigmoid
  }
  __syncwarp();
  for (int i = lane; i < S; i += 32) {
    const int k = slot[i];
    const float gs = 0.5f * ((k > 0 ? g[k - 1] : 0.f) + (k < S - 1 ? g[k] : 0.f));
    if (i < S1) g_s1[r * S1 + i] = gs;
    else g_s2[r * S2 + (i - S1)] = gs;
  }
}

template <typename T>
cudaError_t launch_grad(const float* d1, const void* c1, const float* s1, const float* x1,
                        const float* d2, const void* c2, const float* s2, const float* x2,
                        const float* depth_out, const float* g_comp, const float* g_depth,
                        const float* g_wsum, void* g_c1, float* g_s1, void* g_c2,
                        float* g_s2, int rays, int S1, int S2, int C, int white_back,
                        cudaStream_t stream) {
  const int S = S1 + S2;
  const size_t per_warp = (size_t)GRAD_ARRAYS * S * sizeof(float);
  int n_warps = (int)((96 * 1024) / per_warp);
  n_warps = n_warps < 1 ? 1 : (n_warps > 8 ? 8 : n_warps);
  const size_t smem = per_warp * n_warps;
  cudaError_t e = cudaFuncSetAttribute(ray_composite_grad_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const unsigned blocks = (unsigned)((rays + n_warps - 1) / n_warps);
  ray_composite_grad_kernel<T><<<blocks, 32 * n_warps, smem, stream>>>(
      d1, static_cast<const T*>(c1), s1, x1, d2, static_cast<const T*>(c2), s2, x2,
      depth_out, g_comp, g_depth, g_wsum, static_cast<T*>(g_c1), g_s1, static_cast<T*>(g_c2),
      g_s2, rays, S1, S2, C, white_back);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const float* d1, const void* c1, const float* s1, const float* x1,
                   const float* d2, const void* c2, const float* s2, const float* x2,
                   float* comp, float* depth, float* wsum, float* scratch, int rays,
                   int S1, int S2, int C, int white_back, cudaStream_t stream) {
  const int S = S1 + S2;
  const size_t per_warp = (size_t)ARRAYS * S * sizeof(float);
  int n_warps = (int)((96 * 1024) / per_warp);
  n_warps = n_warps < 1 ? 1 : (n_warps > 8 ? 8 : n_warps);
  const size_t smem = per_warp * n_warps;
  cudaError_t e = cudaFuncSetAttribute(ray_composite_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const unsigned blocks = (unsigned)((rays + n_warps - 1) / n_warps);
  ray_composite_kernel<T><<<blocks, 32 * n_warps, smem, stream>>>(
      d1, static_cast<const T*>(c1), s1, x1, d2, static_cast<const T*>(c2), s2, x2,
      comp, depth, wsum, scratch, rays, S1, S2, C, white_back);
  return cudaGetLastError();
}

}  // namespace

// Per ray r: d*[r, S*] depths, s*[r, S*] sigmas, x*[r, S*, 3] xyz (f32),
// c*[r, S*, C] colors (f32 or bf16, 16-byte aligned; C * itemsize / 16 lanes
// per row, a power of two up to 32). S2 may be 0 (no importance pass).
// Outputs: comp [rays, C+3] (composited colors | xyz after white_back and
// *2-1), depth [rays], wsum [rays], all f32. scratch: 2 f32 (+inf, -inf)
// and a u32 counter (0), as every call leaves them.
PANIC3D_EXPORT int ray_composite(const float* d1, const void* c1, const float* s1,
                                 const float* x1, const float* d2, const void* c2,
                                 const float* s2, const float* x2, int dtype,
                                 float* comp, float* depth, float* wsum, float* scratch,
                                 int rays, int S1, int S2, int C, int white_back,
                                 void* stream) {
  const int vec = dtype == DT_BF16 ? 8 : 4, G = C / vec;
  if (rays < 1 || S1 < 1 || S1 + S2 < 2 || S1 + S2 > 1024 || C % vec != 0 || G < 1 || G > 32
      || (G & (G - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16)
    return (int)launch<__nv_bfloat16>(d1, c1, s1, x1, d2, c2, s2, x2, comp, depth, wsum,
                                      scratch, rays, S1, S2, C, white_back, s);
  return (int)launch<float>(d1, c1, s1, x1, d2, c2, s2, x2, comp, depth, wsum, scratch,
                            rays, S1, S2, C, white_back, s);
}

// The backward form. The forward's inputs (S2 >= 1 here), its clipped
// depth output depth_out [rays], and the gradients of its outputs: g_comp
// [rays, C+3] (colours | xyz), g_depth [rays], g_wsum [rays], all f32
// (zeros where an output has none). Writes g_c1 [rays, S1, C] and g_c2
// [rays, S2, C] in the colours' dtype and g_s1 [rays, S1], g_s2 [rays, S2]
// in f32.
PANIC3D_EXPORT int ray_composite_grad(const float* d1, const void* c1, const float* s1,
                                      const float* x1, const float* d2, const void* c2,
                                      const float* s2, const float* x2, int dtype,
                                      const float* depth_out, const float* g_comp,
                                      const float* g_depth, const float* g_wsum, void* g_c1,
                                      float* g_s1, void* g_c2, float* g_s2, int rays, int S1,
                                      int S2, int C, int white_back, void* stream) {
  const int vec = dtype == DT_BF16 ? 8 : 4, G = C / vec;
  if (rays < 1 || S1 < 1 || S2 < 1 || S1 + S2 > 1024 || C % vec != 0 || G < 1 || G > 32 ||
      (G & (G - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16)
    return (int)launch_grad<__nv_bfloat16>(d1, c1, s1, x1, d2, c2, s2, x2, depth_out, g_comp,
                                           g_depth, g_wsum, g_c1, g_s1, g_c2, g_s2, rays, S1,
                                           S2, C, white_back, s);
  return (int)launch_grad<float>(d1, c1, s1, x1, d2, c2, s2, x2, depth_out, g_comp, g_depth,
                                 g_wsum, g_c1, g_s1, g_c2, g_s2, rays, S1, S2, C, white_back,
                                 s);
}
