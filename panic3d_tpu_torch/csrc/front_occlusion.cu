// K7 front_occlusion: paste-front's per-portrait +z opacity volume and its
// per-pixel sampler, two entry points.
//
// Replaces (JAX): panic3d_tpu/models/volumetric/lattice.py:
// front_occlusion_volume (:239, decode_lattice with plane_reduce='mean', the
// density filters, softplus, and the flip-cumsum-flip suffix integral) and
// sample_front_occlusion (:303, grid_sample_3d_points with border padding
// plus the out-of-box zero-feature terms; its per-point arithmetic is
// front_occlusion.cuh's, which K8's grid-occlusion entry also runs).
//
// K7a, the volume. What bounds it on the H100: 128 x 128 x 256 lattice
// points per portrait, 8.4 M for bs=2, of which the triplane crop keeps
// 51 % (|x|, |z| <= 0.25 at crop 0.1, box 0.7). Each kept point needs 64
// softplus of its hidden layer, two SFU operations each (ex2, lg2): ~0.55 G
// SFU operations at 16 a clock per SM, ~0.13 ms, above the f32 work
// (~0.03 ms) and the 33.5 MB of A (~0.01 ms).
//
// Design. The first layer is linear and a lattice point's feature is the
// broadcast sum ((F_0 + F_1) + F_2) / 3 of three planar terms, so
// W0 feat = ((W0 F_0 + W0 F_1) + W0 F_2) / 3. A first launch
// (lattice_decode.cuh:factor_terms_kernel, shared with K6a) computes
// P_t = g0 W0 F_t / 3 for the three terms ([N,G_a,G_b,64] f32, one row per
// term cell: 0.67 GFLOP at N=2), with the bias b0 added to the (x, y)
// term's rows. The volume launch then needs two adds per hidden unit, not
// 32 FMAs. A block owns 4 x-columns (one warp each) by 32 y-columns (one
// lane each) and walks z from the top of the box down in slabs of 4 cells:
// the two z-dependent terms' rows of a slab (P_xz at its 4 x, P_yz at its
// 32 y) go to shared memory by cp.async, one slab ahead into the other of
// two buffers, and every column of the tile reads them there. Each thread
// keeps its column's P_xy row in registers and carries the suffix sum from
// cell to cell (a sequential sum from the top, the order of a CPU cumsum of
// the flipped column). Cells the crop removes are not decoded: their sigma
// is -1e3 whatever the decoder gives, so their density is the constant the
// cull makes of -1e3 (0), the value the plain version computes. The hidden
// softplus runs on the SFU (softplus_fast); the density and the cull keep
// the libm forms, once per point. A slab's A values go through a
// per-thread row of shared memory into one 16-byte store.
#include "front_occlusion.cuh"
#include "lattice_decode.cuh"

namespace {

constexpr int TZ = 4;        // z cells per slab
constexpr int TX = 4;        // x-columns per block (one warp each)
constexpr int RS = LAT_HIDDEN + 4;   // staged row stride (+ 4: conflict-free float4 reads)

__global__ void __launch_bounds__(TX * 32) occlusion_volume_kernel(
    FactoredTerms ft, const float* __restrict__ w1, const float* __restrict__ b1,
    float* __restrict__ A, int Gx, int Gy, int Gz, double bw,
    float dz, float g1, float bias_scale, int use_crop, float crop_lim, int cull_mode,
    float cull_thresh) {
  extern __shared__ __align__(16) float sm[];
  __shared__ __align__(16) float s_w1[LAT_HIDDEN];
  __shared__ float s_b1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // per z-dependent term k: its staged rows (TX x-rows or 32 y-rows of TZ
  // cells), the lattice size and tile origin on its axis, this thread's row
  const int ax0 = ft.axis[0], ax1 = ft.axis[1];
  // two buffers of each term's rows, one slab apart
  const int stage_floats = ((ax0 ? 32 : TX) + (ax1 ? 32 : TX)) * TZ * RS;
  float* const stage0 = sm;
  float* const stage1 = sm + (ax0 ? 32 : TX) * TZ * RS;
  float* const a_row = sm + 2 * stage_floats + threadIdx.x * (TZ + 1);

  const int ytiles = (Gy + 31) / 32, xtiles = (Gx + TX - 1) / TX;
  const int yt = blockIdx.x % ytiles, xt = (blockIdx.x / ytiles) % xtiles;
  const int n = blockIdx.x / ytiles / xtiles;
  const int x = xt * TX + warp, y = yt * 32 + lane;
  const bool valid = x < Gx && y < Gy;
  const bool x_kept = valid && (!use_crop || fabsf(cell_center(x, Gx, bw)) <= crop_lim);
  const bool any_kept = __syncthreads_or(x_kept);

  for (int j = threadIdx.x; j < LAT_HIDDEN; j += blockDim.x) s_w1[j] = w1[j] * g1;   // net2's row 0
  if (threadIdx.x == 0) s_b1 = b1[0] * bias_scale;
  // a cropped cell: sigma -1e3, then the cull, then softplus(sigma - 1)
  const float d_crop = softplus_f(density_filters(-1e3f, 0.f, 0.f, 0, 0.f, cull_mode,
                                                  cull_thresh) - 1.f);
  float pc[LAT_HIDDEN];
  if (x_kept) {
    const float4* row = reinterpret_cast<const float4*>(
        ft.col + (((long long)n * Gx + x) * Gy + y) * LAT_HIDDEN);
#pragma unroll
    for (int j4 = 0; j4 < LAT_HIDDEN / 4; ++j4) {
      const float4 v = row[j4];
      pc[4 * j4] = v.x; pc[4 * j4 + 1] = v.y; pc[4 * j4 + 2] = v.z; pc[4 * j4 + 3] = v.w;
    }
  }
  const float* q0 = stage0 + (ax0 ? lane : warp) * TZ * RS;
  const float* q1 = stage1 + (ax1 ? lane : warp) * TZ * RS;
  float* out = A + (((long long)n * Gx + x) * Gy + y) * Gz;

  // slab s covers z in [Gz - TZ (s + 1), Gz - TZ s); its rows go to buffer
  // s % 2 by cp.async, issued one slab ahead
  const int n_slabs = Gz / TZ;
  auto decode_slab = [&](int sl) {
    if (!any_kept || sl >= n_slabs) return false;
    bool kept = !use_crop;
    for (int zz = 0; zz < TZ; ++zz)
      kept |= fabsf(cell_center(Gz - TZ * (sl + 1) + zz, Gz, bw)) <= crop_lim;
    return kept;   // uniform over the block
  };
  auto stage_slab = [&](int sl) {
    const int z0 = Gz - TZ * (sl + 1);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int a = k ? ax1 : ax0, e = a ? 32 : TX, G = a ? Gy : Gx;
      const int t0 = a ? yt * 32 : xt * TX, lim = G - t0;
      float* const dst = (k ? stage1 : stage0) + (sl & 1) * stage_floats;
      const float* src = ft.slab[k] + ((long long)n * G + t0) * Gz * LAT_HIDDEN;
      for (int i = threadIdx.x; i < e * TZ * (LAT_HIDDEN / 4); i += blockDim.x) {
        const int r = i / (TZ * LAT_HIDDEN / 4), rem = i % (TZ * LAT_HIDDEN / 4);
        const int zz = rem / (LAT_HIDDEN / 4), j4 = rem % (LAT_HIDDEN / 4);
        float* d = dst + (r * TZ + zz) * RS + 4 * j4;
        if (r < lim)
          cp_async16(d, src + ((long long)r * Gz + z0 + zz) * LAT_HIDDEN + 4 * j4);
        else
          *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    cp_async_commit();
  };

  float run = 0.f;
  bool decode = decode_slab(0);
  if (decode) stage_slab(0);
  for (int sl = 0; sl < n_slabs; ++sl) {
    const int z0 = Gz - TZ * (sl + 1);
    const bool decode_next = decode_slab(sl + 1);
    if (decode_next) stage_slab(sl + 1);
    if (decode) {
      if (decode_next) cp_async_wait<1>();
      else cp_async_wait<0>();
      __syncthreads();   // slab sl's rows are in
    }
    const float* q0s = q0 + (sl & 1) * stage_floats;
    const float* q1s = q1 + (sl & 1) * stage_floats;
#pragma unroll 1
    for (int zz = TZ - 1; zz >= 0; --zz) {
      const int z = z0 + zz;
      const float zc = cell_center(z, Gz, bw);
      float dens = d_crop;
      if (decode && x_kept && (!use_crop || fabsf(zc) <= crop_lim)) {
        const float* u = q0s + zz * RS;
        const float* v = q1s + zz * RS;
        float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j4 = 0; j4 < LAT_HIDDEN / 4; ++j4) {
          const float4 uu = *reinterpret_cast<const float4*>(u + 4 * j4);
          const float4 vv = *reinterpret_cast<const float4*>(v + 4 * j4);
          const float4 ww = *reinterpret_cast<const float4*>(s_w1 + 4 * j4);
          const float uj[4] = {uu.x, uu.y, uu.z, uu.w}, vj[4] = {vv.x, vv.y, vv.z, vv.w};
          const float wj[4] = {ww.x, ww.y, ww.z, ww.w};
#pragma unroll
          for (int k = 0; k < 4; ++k)
            s[k] = fmaf(wj[k], softplus_fast((pc[4 * j4 + k] + uj[k]) + vj[k]), s[k]);
        }
        const float sigma = ((s[0] + s[1]) + (s[2] + s[3])) + s_b1;
        // the crop holds here; the cull (or binarize) on sigma
        dens = softplus_f(density_filters(sigma, 0.f, 0.f, 0, 0.f, cull_mode, cull_thresh)
                          - 1.f);
      }
      run += dens;
      a_row[zz] = (run - 0.5f * dens) * dz;
    }
    if (valid) {
      float4* dst = reinterpret_cast<float4*>(out + z0);
#pragma unroll
      for (int h = 0; h < TZ / 4; ++h)
        dst[h] = make_float4(a_row[4 * h], a_row[4 * h + 1], a_row[4 * h + 2], a_row[4 * h + 3]);
    }
    if (decode) __syncthreads();   // buffer sl % 2 is refilled for slab sl + 2
    decode = decode_next;
  }
}

__global__ void occlusion_sample_kernel(const float* __restrict__ A,
                                        const float* __restrict__ density0,
                                        const float* __restrict__ points, float* __restrict__ out,
                                        int N, int M, int Gx, int Gy, int Gz,
                                        long long a_stride, float scale, float half_bw,
                                        float offset, float seg_len) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)N * M) return;
  out[i] = front_occlusion_at(A + (i / M) * a_stride, Gx, Gy, Gz, density0[0], points[i * 3],
                              points[i * 3 + 1], points[i * 3 + 2], scale, half_bw, offset,
                              seg_len);
}

}  // namespace

// terms: three (F [N,G_a,G_b,C] f32 with its channels contiguous and its
// rows 16-byte aligned, axis_a, axis_b, F's strides in elements over n, the
// a index and the b index) on the lattice
// (Gx, Gy, Gz), one of them on axes (x, y) and among the first two, the
// others on (x or y, z); decoder raw f32 parameters (w0 [64,C], w1 [33,64]:
// row 0 is read); P scratch of sum_t N G_a G_b 64 f32; A [N,Gx,Gy,Gz] f32
// out. Gz must be a multiple of 4 and C one of {8,16,32}, else
// cudaErrorInvalidValue. Two launches: the factored first layer, the volume.
PANIC3D_EXPORT int occlusion_volume(
    const float* F0, int a0, int b0_, long long n0, long long s0a, long long s0b, const float* F1,
    int a1, int b1_, long long n1, long long s1a, long long s1b, const float* F2, int a2, int b2_,
    long long n2, long long s2a, long long s2b, const float* w0, const float* b0,
    const float* w1, const float* b1, float* P, float* A, int N, int Gx, int Gy, int Gz, int C,
    double bw, float dz, float g0, float g1, float bias_scale, int use_crop, float crop_lim,
    int cull_mode, float cull_thresh, void* stream) {
  if (Gz % TZ != 0 || (C != 8 && C != 16 && C != 32)) return (int)cudaErrorInvalidValue;
  LatticeTerms terms{{{F0, a0, b0_, n0, s0a, s0b, 0, 0}, {F1, a1, b1_, n1, s1a, s1b, 0, 0},
                      {F2, a2, b2_, n2, s2a, s2b, 0, 0}}};
  const int size[3] = {Gx, Gy, Gz};
  FactoredTerms ft;
  FactorLayout lay;
  if (!factored_layout(terms, size, N, P, ft, lay)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = launch_factor_terms(terms, lay, C, w0, b0, g0, bias_scale, P, s);
  if (e != cudaSuccess) return (int)e;

  const size_t smem = sizeof(float) * (2 * (size_t)((ft.axis[0] ? 32 : TX) + (ft.axis[1] ? 32 : TX))
                                       * TZ * RS
                                       + (size_t)TX * 32 * (TZ + 1));
  e = cudaFuncSetAttribute(occlusion_volume_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (long long)N * ((Gx + TX - 1) / TX) * ((Gy + 31) / 32);
  occlusion_volume_kernel<<<(unsigned)blocks, TX * 32, smem, s>>>(
      ft, w1, b1, A, Gx, Gy, Gz, bw, dz, g1, bias_scale, use_crop, crop_lim, cull_mode,
      cull_thresh);
  return (int)cudaGetLastError();
}

// A [N,Gx,Gy,Gz] f32 with batch stride a_stride (0: one volume for every
// view); density0 one f32; points [N,M,3] f32; out [N,M] f32.
PANIC3D_EXPORT int occlusion_sample(const float* A, const float* density0, const float* points,
                                    float* out, int N, int M, int Gx, int Gy, int Gz,
                                    long long a_stride, float scale, float half_bw, float offset,
                                    float seg_len, void* stream) {
  const int threads = 256;
  const long long total = (long long)N * M;
  occlusion_sample_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      A, density0, points, out, N, M, Gx, Gy, Gz, a_stride, scale, half_bw, offset, seg_len);
  return (int)cudaGetLastError();
}
