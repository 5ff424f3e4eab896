// K6 ess: the empty-space-skipping occupancy grid and the per-ray interval
// narrowing, two entry points.
//
// Replaces (JAX): panic3d_tpu/models/volumetric/renderer.py:ess_occupancy
// (:303) with lattice.py:decode_lattice (:136, plane_reduce='mean') and the
// sigma-only OSGDecoder (triplane.py:63, sigma_only=True); and
// renderer.py:ess_narrow_intervals (:378) with the per-ray
// sample_stratified (:479-488): over fixed bounds or per-ray ones
// (ray_start = ray_end = 'auto', get_ray_limits_box), at jitter 0.5 (eval)
// or at a drawn jitter (the keyed render of training, :485-487).
//
// What bounds it on the H100: the occupancy decodes (G*ss)^3 lattice points
// per portrait -- 64^3 = 262,144 at the flagship (grid 32, supersample 2) --
// each with 64 softplus of its hidden layer, two SFU operations each (ex2,
// lg2): at N = 2, 67 M SFU operations, ~0.016 ms at 16 a clock per SM, of
// which the triplane crop (crop 0.1: |x|, |z| <= 0.25 of 0.35) leaves 52 %
// to decode. Its inputs (three [N,64,64,32] f32 terms, 3 MB) stay in L2.
// The narrowing is 2 x 4096 rays x 64 taps of index arithmetic and one
// L2-resident read each, bound by latency.
//
// Design, occupancy: two launches (three where a cropped point counts as
// occupied). (1) The factored first layer
// (lattice_decode.cuh:factor_terms_kernel, shared with K7a): P_t =
// g0 W0 F_t / 3 once per term row, b0 on the (x, y) term's rows, into a
// [3,N,Gs,Gs,64] f32 scratch (6 MB at N = 2), so a point's hidden layer is
// (P_xy + P_a) + P_b: two adds a unit in place of C FMAs. (2) The decode: a
// block owns a tile of 8 x by 16 y by 8 z fine points (a warp 2 x-columns by
// 16 y-columns, a lane one (x, y) column walking the tile's 8 z). The two
// z-dependent terms' rows of the tile go to shared memory by cp.async (the
// tile's z halves as two groups, so the first half is decoded while the
// second loads), in rows of 68 floats: the 16 y-rows a warp reads are
// conflict-free float4 reads, the 2 x-rows broadcasts. Each lane keeps its
// column's P_xy row in registers. The hidden softplus runs on the SFU
// (softplus_fast); net2's sigma row sums in four partial sums (j mod 4);
// the density filters and the threshold keep the libm forms, once per
// point. Points the triplane crop removes are not decoded (their sigma is
// -1e3 whatever the decoder gives, so their occupancy is one constant), and
// the grid holds only the tiles that meet the crop's box on x and z. The
// 2^3 max-pool: the z pair in the lane, then the y pair (lane xor 1) and
// the x pair (lane xor 16) by shuffles; one lane writes the cell. The 3^3
// dilation (the SAME padding adds 0, which never wins over the centre):
// where a cropped point is empty (any threshold >= 0), that lane marks an
// occupied cell and its neighbours with plain stores of 1 in the grid the
// factor launch cleared (no atomics: every store writes the same value);
// else (3) a launch dilates the pooled grid, the cells outside the decoded
// tiles read as the cropped constant.
// Design, narrowing: one warp per ray (8,192 rays are 8,192 warps, one wave
// on 132 SMs at 32 registers a thread). The 32 lanes share the ray's K
// taps, ceil(K/32) a lane, each lane's hits a bit mask; each chunk of 32
// taps is then one ballot, and the first and last occupied taps are the
// lowest and highest set bits of the first and last non-zero ballots.
// The lanes then write [t0, t1] (lane 0) and the S stratified depths of the
// narrowed interval together (lane l: depths l, l + 32, ...), so the stores
// coalesce and the coarse sampling costs no launch of its own. Per-ray
// bounds are one load each by every lane of the ray (a broadcast); a
// jitter is one coalesced load a depth. With fixed bounds and no jitter
// the arithmetic is the same as without those forms. The tap,
// grid-index and depth arithmetic uses explicitly rounded operations in
// the JAX package's order, so a grid index or depth never differs from the
// plain version by a contracted multiply-add.
#include "lattice_decode.cuh"

namespace {

constexpr int THREADS = 256;

// the occupancy decode's tile of fine points: 4 warps, each 2 x-columns by
// 16 y-columns, walking OZ z
constexpr int OX = 8, OY = 16, OZ = 8;
constexpr int OCC_THREADS = 128;
constexpr int ORS = LAT_HIDDEN + 4;   // staged row stride (+ 4: conflict-free float4 reads)
constexpr unsigned FULL = 0xffffffffu;

// sigma of the factored hidden layer: sum_j w1_j softplus((pc_j + u_j) + v_j)
// in four partial sums (j mod 4), then b1
__device__ __forceinline__ float factored_sigma(const float (&pc)[LAT_HIDDEN],
                                                const float* __restrict__ u,
                                                const float* __restrict__ v,
                                                const float* __restrict__ w1, float b1) {
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j4 = 0; j4 < LAT_HIDDEN / 4; ++j4) {
    const float4 uu = *reinterpret_cast<const float4*>(u + 4 * j4);
    const float4 vv = *reinterpret_cast<const float4*>(v + 4 * j4);
    const float4 ww = *reinterpret_cast<const float4*>(w1 + 4 * j4);
    const float uj[4] = {uu.x, uu.y, uu.z, uu.w}, vj[4] = {vv.x, vv.y, vv.z, vv.w};
    const float wj[4] = {ww.x, ww.y, ww.z, ww.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      s[k] = fmaf(wj[k], softplus_fast((pc[4 * j4 + k] + uj[k]) + vj[k]), s[k]);
  }
  return ((s[0] + s[1]) + (s[2] + s[3])) + b1;
}

// the occupancy of a point the triplane crop removes: sigma -1e3, then the
// cull, then the threshold (exact values: 0 or 1e3 -> 0 or 1)
inline float cropped_occupancy(float thresh, int cull_mode, float cull_thresh) {
  return softplus_f(density_filters(-1e3f, 0.f, 0.f, 0, 0.f, cull_mode, cull_thresh) - 1.f) >
                 thresh ? 1.f : 0.f;
}

// Cell (n, cx, cy, cz)'s pooled occupancy v: into the pooled grid, which
// a later launch dilates; or, with ``marks`` (every cell outside the
// decoded tiles is empty), as its 3^3 dilation directly: an occupied cell
// sets itself and its neighbours to 1 in the grid the factor launch cleared.
__device__ __forceinline__ void put_cell(float* __restrict__ pooled, float* __restrict__ occ,
                                         bool marks, int n, int G, int cx, int cy, int cz,
                                         float v) {
  if (!marks) {
    pooled[((n * G + cx) * G + cy) * G + cz] = v;
    return;
  }
  if (v == 0.f) return;
  for (int x = max(cx - 1, 0); x <= min(cx + 1, G - 1); ++x)
    for (int y = max(cy - 1, 0); y <= min(cy + 1, G - 1); ++y)
      for (int z = max(cz - 1, 0); z <= min(cz + 1, G - 1); ++z)
        occ[((n * G + x) * G + y) * G + z] = 1.f;
}

// 4 blocks an SM (at most 128 registers a thread, 52 KB of staged rows each).
// The grid covers the tiles (xt0.., zt0..) x every y tile that hold the
// crop's kept points; the cells outside them are cropped_occupancy.
template <int SS>
__global__ void __launch_bounds__(OCC_THREADS, 4) ess_occupancy_kernel(
    FactoredTerms ft, const float* __restrict__ w1, const float* __restrict__ b1,
    float* __restrict__ pooled, float* __restrict__ occ, int marks, int G, int xt0,
    int xtiles, int zt0, int ztiles, double bw, float thresh, float g1, float bias_scale,
    int use_crop, float crop_lim, int cull_mode, float cull_thresh, float occ_crop) {
  extern __shared__ __align__(16) float sm[];
  __shared__ __align__(16) float s_w1[LAT_HIDDEN];
  __shared__ float s_b1;
  const int Gs = G * SS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int xl = 2 * warp + (lane >> 4), yl = lane & 15;
  const int ytiles = (Gs + OY - 1) / OY;
  const int zt = zt0 + blockIdx.x % ztiles, yt = (blockIdx.x / ztiles) % ytiles,
            xt = xt0 + (blockIdx.x / ztiles / ytiles) % xtiles;
  const int n = blockIdx.x / ztiles / ytiles / xtiles;
  const int x0 = xt * OX, y0 = yt * OY, z0 = zt * OZ;
  const int x = x0 + xl, y = y0 + yl;
  const bool valid = x < Gs && y < Gs;
  auto kept = [&](int g) { return !use_crop || fabsf(cell_center(g, Gs, bw)) <= crop_lim; };
  const bool x_kept = valid && kept(x);
  unsigned z_kept = 0;   // bit zz: the crop keeps z0 + zz
  for (int zz = 0; zz < OZ && z0 + zz < Gs; ++zz) z_kept |= (unsigned)kept(z0 + zz) << zz;
  // uniform over the block: whether any of its points is decoded
  const bool decode = __syncthreads_or(x_kept) && z_kept;

  for (int j = threadIdx.x; j < LAT_HIDDEN; j += blockDim.x)
    s_w1[j] = w1[j] * g1;   // net2's row 0
  if (threadIdx.x == 0) s_b1 = b1[0] * bias_scale;
  // the two z-dependent terms' rows of the tile, [OZ][E_k][ORS] (E_k the
  // tile's extent on the term's other axis), a z half a cp.async group
  const int e0 = ft.axis[0] ? OY : OX, e1 = ft.axis[1] ? OY : OX;
  float* const st[2] = {sm, sm + OZ * e0 * ORS};
  if (decode) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int E = k ? e1 : e0, t0 = ft.axis[k] ? y0 : x0;
        const float* src = ft.slab[k] + (long long)n * Gs * Gs * LAT_HIDDEN;
        for (int i = threadIdx.x; i < OZ / 2 * E * (LAT_HIDDEN / 4); i += OCC_THREADS) {
          const int j4 = i % (LAT_HIDDEN / 4), r = i / (LAT_HIDDEN / 4) % E;
          const int zz = half * (OZ / 2) + i / (LAT_HIDDEN / 4) / E;
          const bool ok = t0 + r < Gs && z0 + zz < Gs;
          cp_async16_zfill(st[k] + (zz * E + r) * ORS + 4 * j4,
                           ok ? src + ((long long)(t0 + r) * Gs + z0 + zz) * LAT_HIDDEN + 4 * j4
                              : src, ok);
        }
      }
      cp_async_commit();
    }
  }
  float pc[LAT_HIDDEN];
  if (decode && x_kept) {
    const float4* row = reinterpret_cast<const float4*>(
        ft.col + (((long long)n * Gs + x) * Gs + y) * LAT_HIDDEN);
#pragma unroll
    for (int j4 = 0; j4 < LAT_HIDDEN / 4; ++j4) {
      const float4 v = row[j4];
      pc[4 * j4] = v.x; pc[4 * j4 + 1] = v.y; pc[4 * j4 + 2] = v.z; pc[4 * j4 + 3] = v.w;
    }
  }
  const float* q0 = st[0] + (ft.axis[0] ? yl : xl) * ORS;
  const float* q1 = st[1] + (ft.axis[1] ? yl : xl) * ORS;
  float m = 0.f;   // the z pair's max (SS = 2)
  for (int zz = 0; zz < OZ; ++zz) {
    const int z = z0 + zz;
    if (z >= Gs) break;   // uniform
    if (zz % (OZ / 2) == 0) {
      if (decode) {
        if (zz == 0) cp_async_wait<1>();
        else cp_async_wait<0>();
      }
      __syncthreads();   // this z half's rows (and net2's row) are in
    }
    float o = occ_crop;
    if (x_kept && (z_kept >> zz & 1)) {
      const float sigma = factored_sigma(pc, q0 + zz * e0 * ORS, q1 + zz * e1 * ORS, s_w1, s_b1);
      // the crop holds here; the cull (or binarize) on sigma, the threshold
      o = softplus_f(density_filters(sigma, 0.f, 0.f, 0, 0.f, cull_mode, cull_thresh) - 1.f) >
                  thresh ? 1.f : 0.f;
    }
    if constexpr (SS == 1) {
      if (valid) put_cell(pooled, occ, marks, n, G, x, y, z, o);
    } else {
      m = fmaxf(m, o);
      if (zz & 1) {   // the cell's 8 points: this z pair, the y pair, the x pair
        m = fmaxf(m, __shfl_xor_sync(FULL, m, 1));
        m = fmaxf(m, __shfl_xor_sync(FULL, m, 16));
        if (valid && (lane & 17) == 0) put_cell(pooled, occ, marks, n, G, x / 2, y / 2, z / 2, m);
        m = 0.f;
      }
    }
  }
  if (decode) cp_async_wait<0>();   // no copy outlives the block (a tile past Gs)
}

// the 3^3 max of the pooled grid, a thread a cell; cells outside [cx0, cx1)
// on x or [cz0, cz1) on z (the decoded tiles) are the cropped occupancy
__global__ void __launch_bounds__(THREADS) dilate3_kernel(
    const float* __restrict__ pooled, float* __restrict__ occ, int N, int G, int cx0, int cx1,
    int cz0, int cz1, float occ_crop) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N * G * G * G) return;
  const int z = i % G, y = i / G % G, x = i / (G * G) % G;
  const float* grid = pooled + (i - (x * G + y) * G - z);   // batch n's grid
  float m = 0.f;
#pragma unroll
  for (int dx = -1; dx <= 1; ++dx)
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
      for (int dz = -1; dz <= 1; ++dz) {
        const int xx = x + dx, yy = y + dy, zz = z + dz;
        if (xx < 0 || xx >= G || yy < 0 || yy >= G || zz < 0 || zz >= G) continue;
        const bool decoded = xx >= cx0 && xx < cx1 && zz >= cz0 && zz < cz1;
        m = fmaxf(m, decoded ? grid[(xx * G + yy) * G + zz] : occ_crop);
      }
  occ[i] = m;
}

constexpr int NARROW_WARPS = 8;   // rays a block: one warp each
constexpr int MAX_TAPS = 32 * 32; // a lane's hits are one 32-bit mask

// Whether tap k of the ray (o, d) lands in an occupied cell (or, outside
// the grid, whether occ_outside is set): the JAX package's operations in
// its order, each rounded on its own, so no tap can land in another cell
__device__ __forceinline__ bool tap_hit(const float* __restrict__ grid, bool outside,
                                        const float (&o)[3], const float (&d)[3], float rs,
                                        float L, int k, int K, float bw, int G) {
  const float frac = __fdiv_rn(__fadd_rn((float)k, 0.5f), (float)K);
  const float tk = __fadd_rn(rs, __fmul_rn(frac, L));
  bool inside = true;
  int gi[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float p = __fadd_rn(o[a], __fmul_rn(tk, d[a]));
    const float q = floorf(__fmul_rn(__fadd_rn(__fdiv_rn(p, bw), 0.5f), (float)G));
    inside = inside && q >= 0.f && q < (float)G;
    gi[a] = (int)fminf(fmaxf(q, 0.f), (float)(G - 1));
  }
  return inside ? grid[(gi[0] * G + gi[1]) * G + gi[2]] > 0.f : outside;
}

// 8 blocks of 8 warps an SM (at most 32 registers a thread): 8,192 rays
// are 8,192 warps, one wave on 132 SMs. The keyed forms (PER_RAY: the
// bounds read a ray, JITTER: a jitter read a depth) are instantiations of
// their own, 6 blocks an SM (at most 40 registers), so the eval form's code
// and registers stay as they were
template <bool PER_RAY, bool JITTER>
__global__ void __launch_bounds__(NARROW_WARPS * 32, (PER_RAY || JITTER) ? 6 : 8)
ess_narrow_kernel(
    const float* __restrict__ occ, const float* __restrict__ occ_outside,
    const float* __restrict__ ro, const float* __restrict__ rd, float* __restrict__ t0_out,
    float* __restrict__ t1_out, float* __restrict__ depths, int n_rays, int R, int G, int K,
    long long occ_stride, float ray_start, float ray_end, float bw, float margin, int S,
    const float* __restrict__ rs_ray, const float* __restrict__ re_ray,
    const float* __restrict__ jitter) {
  const int lane = threadIdx.x & 31;
  const int ray = blockIdx.x * NARROW_WARPS + (threadIdx.x >> 5);
  if (ray >= n_rays) return;             // the whole warp: one ray a warp
  const float* grid = occ + (long long)(ray / R) * occ_stride;
  const bool outside = occ_outside[0] > 0.f;
  const float o[3] = {ro[ray * 3], ro[ray * 3 + 1], ro[ray * 3 + 2]};
  const float d[3] = {rd[ray * 3], rd[ray * 3 + 1], rd[ray * 3 + 2]};
  float rs = ray_start, re = ray_end;
  if constexpr (PER_RAY) {
    rs = rs_ray[ray];
    re = re_ray[ray];
  }
  const float L = __fsub_rn(re, rs);
  // lane l holds taps l, l + 32, ...: its hits first, as bit c of one mask
  // (no exchange between the taps, so their loads are in flight together),
  // then chunk c's hits are one ballot, and the first and last occupied
  // taps are the lowest and highest set bits of the first and last
  // non-zero ballots
  const int chunks = (K + 31) >> 5;
  unsigned mine = 0;
#pragma unroll 2
  for (int c = 0; c < chunks; ++c) {
    const int k = c * 32 + lane;
    if (k < K && tap_hit(grid, outside, o, d, rs, L, k, K, bw, G)) mine |= 1u << c;
  }
  int first = -1, last = -1;
  for (int c = 0; c < chunks; ++c) {
    const unsigned bits = __ballot_sync(0xffffffffu, (mine >> c) & 1u);
    if (bits) {
      if (first < 0) first = c * 32 + __ffs(bits) - 1;
      last = c * 32 + 31 - __clz(bits);
    }
  }
  float t0 = rs, t1 = re;
  if (first >= 0) {
    const float step = __fdiv_rn(L, (float)K);
    t0 = __fadd_rn(rs, __fmul_rn(fmaxf(__fsub_rn((float)first, margin), 0.f), step));
    t1 = __fadd_rn(rs, __fmul_rn(fminf(__fadd_rn(__fadd_rn((float)last, 1.f), margin), (float)K),
                                 step));
  }
  if (lane == 0) {
    t0_out[ray] = t0;
    t1_out[ray] = t1;
  }
  // batched_linspace(t0, t1, S) + jitter * (t1 - t0) / (S - 1), jitter 0.5
  // when none is given; lane l writes depths l, l + 32, ...: a warp's stores
  // are one contiguous run
  const float diff = __fsub_rn(t1, t0);
  const float delta = __fdiv_rn(diff, (float)(S - 1));
  float* out = depths + (long long)ray * S;
  const float* jit = JITTER ? jitter + (long long)ray * S : nullptr;
#pragma unroll 1
  for (int s = lane; s < S; s += 32) {
    const float step = __fdiv_rn((float)s, (float)(S - 1));
    const float off = __fmul_rn(JITTER ? jit[s] : 0.5f, delta);
    out[s] = __fadd_rn(__fadd_rn(t0, __fmul_rn(step, diff)), off);
  }
}

}  // namespace

// terms: three (F [N,Gs,Gs,C] f32 with its channels contiguous and its
// rows 16-byte aligned, axis_a, axis_b, F's strides in elements over n, the
// a index and the b index), one of the first two on axes (x, y) and the
// others on (x or y, z); decoder raw f32 parameters (w1 is [33,64]: its row
// 0 is read); pooled and P are scratch ([N,G,G,G] and [3,N,Gs,Gs,64] f32)
// and occ the output ([N,G,G,G] f32). A channel count outside {8,16,32}, a
// supersample outside {1,2} or other term axes return
// cudaErrorInvalidValue. Launches: the factored first layer, the decode
// with the max-pool and (where a cropped point is empty) the dilation;
// else a third, the dilation.
PANIC3D_EXPORT int ess_occupancy(
    const float* F0, int a0, int b0_, long long n0, long long s0a, long long s0b, const float* F1,
    int a1, int b1_, long long n1, long long s1a, long long s1b, const float* F2, int a2, int b2_,
    long long n2, long long s2a, long long s2b, const float* w0, const float* b0,
    const float* w1, const float* b1, float* pooled, float* occ, float* P, int N, int G, int ss,
    int C, double bw, float thresh, float g0, float g1, float bias_scale, int use_crop,
    float crop_lim, int cull_mode, float cull_thresh, void* stream) {
  if ((ss != 1 && ss != 2) || (long long)N * G * G * G * ss * ss * ss > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  LatticeTerms terms{{{F0, a0, b0_, n0, s0a, s0b, 0, 0}, {F1, a1, b1_, n1, s1a, s1b, 0, 0},
                      {F2, a2, b2_, n2, s2a, s2b, 0, 0}}};
  const int Gs = G * ss;
  const int size[3] = {Gs, Gs, Gs};
  FactoredTerms ft;
  FactorLayout lay;
  if (!factored_layout(terms, size, N, P, ft, lay)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // a cropped point's occupancy: 0 unless thresh < 0 or binarize keeps -1e3;
  // where it is 0 the decode marks the dilated grid directly (cleared by
  // the factor launch), else the pooled grid goes through the dilation
  const float occ_crop = cropped_occupancy(thresh, cull_mode, cull_thresh);
  const bool marks = occ_crop == 0.f;
  cudaError_t err = launch_factor_terms(terms, lay, C, w0, b0, g0, bias_scale, P, s,
                                        marks ? occ : nullptr, marks ? N * G * G * G : 0);
  if (err != cudaSuccess) return (int)err;

  // the fine range the crop keeps on x and on z (the lattice is a cube),
  // and the decode's tiles over it (none: every cell is cropped)
  int lo = 0, hi = Gs - 1;
  if (use_crop) {
    lo = Gs, hi = -1;
    for (int g = 0; g < Gs; ++g)
      if (fabsf(cell_center(g, Gs, bw)) <= crop_lim) lo = lo < g ? lo : g, hi = g;
  }
  const int xt0 = lo / OX, xtiles = hi < lo ? 0 : hi / OX - xt0 + 1;
  const int zt0 = lo / OZ, ztiles = hi < lo ? 0 : hi / OZ - zt0 + 1;
  const size_t smem = sizeof(float) * OZ * ORS *
                      (size_t)((ft.axis[0] ? OY : OX) + (ft.axis[1] ? OY : OX));
  const long long blocks = (long long)N * xtiles * ((Gs + OY - 1) / OY) * ztiles;
  if (blocks > 0) {
    auto* kernel = ss == 2 ? ess_occupancy_kernel<2> : ess_occupancy_kernel<1>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(unsigned)blocks, OCC_THREADS, smem, s>>>(
        ft, w1, b1, pooled, occ, marks, G, xt0, xtiles, zt0, ztiles, bw, thresh, g1,
        bias_scale, use_crop, crop_lim, cull_mode, cull_thresh, occ_crop);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (marks) return (int)cudaSuccess;
  // the decoded cells on x and z: the tiles' fine ranges, in cells
  const int cx0 = xt0 * OX / ss, cz0 = zt0 * OZ / ss;
  const int fx1 = (xt0 + xtiles) * OX, fz1 = (zt0 + ztiles) * OZ;
  const int cx1 = blocks > 0 ? (fx1 < Gs ? fx1 : Gs) / ss : cx0;
  const int cz1 = blocks > 0 ? (fz1 < Gs ? fz1 : Gs) / ss : cz0;
  const int cells = N * G * G * G;
  dilate3_kernel<<<(cells + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      pooled, occ, N, G, cx0, cx1, cz0, cz1, occ_crop);
  return (int)cudaGetLastError();
}

// occ [N,G,G,G] f32 with batch stride occ_stride (0: one grid for every
// view); occ_outside one f32; rays [n_rays,3] f32 (R rays per batch
// element); the bounds ray_start / ray_end, or per ray rs_ray / re_ray
// [n_rays] f32 where those are not null; jitter [n_rays,S] f32 in [0, 1),
// or null for 0.5; t0/t1 [n_rays] and depths [n_rays,S] f32 out. K taps in
// 1..1024 and S >= 2, else cudaErrorInvalidValue.
PANIC3D_EXPORT int ess_narrow(const float* occ, const float* occ_outside, const float* ro,
                              const float* rd, float* t0, float* t1, float* depths, int n_rays,
                              int R, int G, int K, long long occ_stride, float ray_start,
                              float ray_end, float bw, float margin, int S, const float* rs_ray,
                              const float* re_ray, const float* jitter, void* stream) {
  if (K < 1 || K > MAX_TAPS || S < 2) return (int)cudaErrorInvalidValue;
  if ((rs_ray == nullptr) != (re_ray == nullptr)) return (int)cudaErrorInvalidValue;
  const int blocks = (n_rays + NARROW_WARPS - 1) / NARROW_WARPS;
  auto* kernel = rs_ray ? (jitter ? ess_narrow_kernel<true, true> : ess_narrow_kernel<true, false>)
                        : (jitter ? ess_narrow_kernel<false, true>
                                  : ess_narrow_kernel<false, false>);
  kernel<<<blocks, NARROW_WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      occ, occ_outside, ro, rd, t0, t1, depths, n_rays, R, G, K, occ_stride, ray_start, ray_end,
      bw, margin, S, rs_ray, re_ray, jitter);
  return (int)cudaGetLastError();
}
