// K6 ess: the empty-space-skipping occupancy grid and the per-ray interval
// narrowing, two entry points.
//
// Replaces (JAX): panic3d_tpu/models/volumetric/renderer.py:ess_occupancy
// (:303) with lattice.py:decode_lattice (:136, plane_reduce='mean') and the
// sigma-only OSGDecoder (triplane.py:63, sigma_only=True); and
// renderer.py:ess_narrow_intervals (:378) with the per-ray
// sample_stratified (:479-483).
//
// What bounds it on the H100: the occupancy decodes (G*ss)^3 lattice points
// per portrait -- 64^3 = 262,144 at the flagship (grid 32, supersample 2)
// -- at about 2.1k multiply-adds each (32x64 + 64), ~2.2 GFLOP for bs=2:
// arithmetic, ~0.03 ms at 67 TFLOP/s f32. Its inputs (three [N,64,64,32]
// f32 terms, 3 MB) stay in L2. The narrowing is 2 x 4096 rays x 64 taps
// of index arithmetic and one L2-resident read each, bound by latency.
//
// Design, occupancy: one thread per supersampled lattice point; the eight
// sub-points of one coarse cell are eight neighbouring lanes of a warp, so
// the 2^3 max-pool is three xor-shuffles and the cell is written once, with
// no atomics and no zeroed output. The decoder weights sit in shared
// memory; the [M,32] feature block never leaves registers. A second launch
// dilates the pooled grid by one cell (3^3 max; the SAME padding adds 0,
// which never wins over the centre).
// Design, narrowing: one warp per ray (8,192 rays are 8,192 warps, one wave
// on 132 SMs at 32 registers a thread). The 32 lanes share the ray's K
// taps, ceil(K/32) a lane, each lane's hits a bit mask; each chunk of 32
// taps is then one ballot, and the first and last occupied taps are the
// lowest and highest set bits of the first and last non-zero ballots.
// The lanes then write [t0, t1] (lane 0) and the S stratified depths of the
// narrowed interval together (lane l: depths l, l + 32, ...), so the stores
// coalesce and the coarse sampling costs no launch of its own. The tap,
// grid-index and depth arithmetic uses explicitly rounded operations in
// the JAX package's order, so a grid index or depth never differs from the
// plain version by a contracted multiply-add.
#include "lattice_decode.cuh"

namespace {

constexpr int THREADS = 256;

template <int C>
__global__ void __launch_bounds__(THREADS) ess_occupancy_kernel(
    LatticeTerms terms, const float* __restrict__ w0, const float* __restrict__ b0,
    const float* __restrict__ w1, const float* __restrict__ b1, float* __restrict__ pooled,
    int N, int G, int ss, double bw, float thresh, float g0, float g1, float bias_scale,
    int use_crop, float crop_lim, int cull_mode, float cull_thresh) {
  __shared__ SigmaMLP<C> mlp;
  load_sigma_mlp<C>(mlp, w0, b0, w1, b1, g0, g1, bias_scale);
  __syncthreads();

  const int group = ss * ss * ss;           // lanes per coarse cell: 1 or 8
  const int Gs = G * ss;
  const long long total = (long long)N * G * G * G * group;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = t < total;
  const long long cell = t / group;          // (n, cx, cy, cz)
  const int sub = (int)(t % group);
  float occ = 0.f;
  if (valid) {
    const int cz = (int)(cell % G), cy = (int)((cell / G) % G), cx = (int)((cell / G / G) % G);
    const int n = (int)(cell / ((long long)G * G * G));
    const int idx[3] = {cx * ss + ((sub >> 2) & 1) * (ss > 1),
                        cy * ss + ((sub >> 1) & 1) * (ss > 1),
                        cz * ss + (sub & 1) * (ss > 1)};
    const int size[3] = {Gs, Gs, Gs};
    float feat[C];
    lattice_feature<C>(terms, n, idx, size, feat);
    float sigma = sigma_decode<C>(mlp, feat);
    sigma = density_filters(sigma, cell_center(idx[0], Gs, bw), cell_center(idx[2], Gs, bw),
                            use_crop, crop_lim, cull_mode, cull_thresh);
    occ = softplus_f(sigma - 1.f) > thresh ? 1.f : 0.f;
  }
  // max over the cell's sub-points (neighbouring lanes)
  for (int off = 1; off < group; off <<= 1)
    occ = fmaxf(occ, __shfl_xor_sync(0xffffffffu, occ, off));
  if (valid && sub == 0) pooled[cell] = occ;
}

__global__ void dilate3_kernel(const float* __restrict__ pooled, float* __restrict__ occ, int N,
                               int G) {
  const long long total = (long long)N * G * G * G;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int z = (int)(i % G), y = (int)((i / G) % G), x = (int)((i / G / G) % G);
    const long long base = i - ((long long)x * G + y) * G - z;   // start of batch n
    float m = 0.f;
    for (int dx = -1; dx <= 1; ++dx)
      for (int dy = -1; dy <= 1; ++dy)
        for (int dz = -1; dz <= 1; ++dz) {
          const int xx = x + dx, yy = y + dy, zz = z + dz;
          if (xx < 0 || xx >= G || yy < 0 || yy >= G || zz < 0 || zz >= G) continue;
          m = fmaxf(m, pooled[base + ((long long)xx * G + yy) * G + zz]);
        }
    occ[i] = m;
  }
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
// are 8,192 warps, one wave on 132 SMs
__global__ void __launch_bounds__(NARROW_WARPS * 32, 8) ess_narrow_kernel(
    const float* __restrict__ occ, const float* __restrict__ occ_outside,
    const float* __restrict__ ro, const float* __restrict__ rd, float* __restrict__ t0_out,
    float* __restrict__ t1_out, float* __restrict__ depths, int n_rays, int R, int G, int K,
    long long occ_stride, float ray_start, float ray_end, float bw, float margin, int S) {
  const int lane = threadIdx.x & 31;
  const int ray = blockIdx.x * NARROW_WARPS + (threadIdx.x >> 5);
  if (ray >= n_rays) return;             // the whole warp: one ray a warp
  const float* grid = occ + (long long)(ray / R) * occ_stride;
  const bool outside = occ_outside[0] > 0.f;
  const float o[3] = {ro[ray * 3], ro[ray * 3 + 1], ro[ray * 3 + 2]};
  const float d[3] = {rd[ray * 3], rd[ray * 3 + 1], rd[ray * 3 + 2]};
  const float rs = ray_start, L = __fsub_rn(ray_end, ray_start);
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
  float t0 = rs, t1 = ray_end;
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
  // batched_linspace(t0, t1, S) + 0.5 * (t1 - t0) / (S - 1); lane l writes
  // depths l, l + 32, ...: a warp's stores are one contiguous run
  const float diff = __fsub_rn(t1, t0);
  const float half_delta = __fmul_rn(0.5f, __fdiv_rn(diff, (float)(S - 1)));
  float* out = depths + (long long)ray * S;
#pragma unroll 1
  for (int s = lane; s < S; s += 32) {
    const float step = __fdiv_rn((float)s, (float)(S - 1));
    out[s] = __fadd_rn(__fadd_rn(t0, __fmul_rn(step, diff)), half_delta);
  }
}

}  // namespace

// terms: three (F [N,Gs,Gs,C] f32, axis_a, axis_b); decoder raw f32
// parameters (w1 is [33,64]: its row 0 is read); pooled is scratch and occ
// the output, both [N,G,G,G] f32. A channel count outside {8,16,32} or a
// supersample outside {1,2} returns cudaErrorInvalidValue.
PANIC3D_EXPORT int ess_occupancy(
    const float* F0, int a0, int b0_, const float* F1, int a1, int b1_, const float* F2, int a2,
    int b2_, const float* w0, const float* b0, const float* w1, const float* b1, float* pooled,
    float* occ, int N, int G, int ss, int C, double bw, float thresh, float g0, float g1,
    float bias_scale, int use_crop, float crop_lim, int cull_mode, float cull_thresh,
    void* stream) {
  if (ss != 1 && ss != 2) return (int)cudaErrorInvalidValue;
  LatticeTerms terms{{{F0, a0, b0_}, {F1, a1, b1_}, {F2, a2, b2_}}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = (long long)N * G * G * G * ss * ss * ss;
  const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
#define P3D_K6(CC)                                                                          \
  ess_occupancy_kernel<CC><<<blocks, THREADS, 0, s>>>(terms, w0, b0, w1, b1, pooled, N, G, \
                                                      ss, bw, thresh, g0, g1, bias_scale,  \
                                                      use_crop, crop_lim, cull_mode,       \
                                                      cull_thresh)
  if (C == 32) P3D_K6(32);
  else if (C == 16) P3D_K6(16);
  else if (C == 8) P3D_K6(8);
  else return (int)cudaErrorInvalidValue;
#undef P3D_K6
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long cells = (long long)N * G * G * G;
  long long dblocks = (cells + THREADS - 1) / THREADS;
  if (dblocks > 4096) dblocks = 4096;
  dilate3_kernel<<<(unsigned)dblocks, THREADS, 0, s>>>(pooled, occ, N, G);
  return (int)cudaGetLastError();
}

// occ [N,G,G,G] f32 with batch stride occ_stride (0: one grid for every
// view); occ_outside one f32; rays [n_rays,3] f32 (R rays per batch
// element); t0/t1 [n_rays] and depths [n_rays,S] f32 out. K taps in
// 1..1024 and S >= 2, else cudaErrorInvalidValue.
PANIC3D_EXPORT int ess_narrow(const float* occ, const float* occ_outside, const float* ro,
                              const float* rd, float* t0, float* t1, float* depths, int n_rays,
                              int R, int G, int K, long long occ_stride, float ray_start,
                              float ray_end, float bw, float margin, int S, void* stream) {
  if (K < 1 || K > MAX_TAPS || S < 2) return (int)cudaErrorInvalidValue;
  const int blocks = (n_rays + NARROW_WARPS - 1) / NARROW_WARPS;
  ess_narrow_kernel<<<blocks, NARROW_WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      occ, occ_outside, ro, rd, t0, t1, depths, n_rays, R, G, K, occ_stride, ray_start, ray_end,
      bw, margin, S);
  return (int)cudaGetLastError();
}
