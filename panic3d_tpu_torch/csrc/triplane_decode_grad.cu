// K1's backward form (triplane_decode_grad): the gradient of K1's decode
// (triplane bilinear sample -> plane mean -> OSGDecoder MLP -> density
// filters) to the channels-last planes and to the decoder's weights and
// biases.
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
// What bounds it on the H100: per point it reads its coordinates and output
// gradients (80 B) and the 12 corner rows of the forward (768 B at C = 32 in
// bf16, L2 hits), redoes the MLP and runs it backward: five products of
// 2 (C x 64 or 64 x 33) flops each, 24,960 flops a point at C = 32, on the
// tensor cores in 3xTF32 (three TF32 products each); and it adds 3 x 4 x C
// f32 values into the plane gradient. The tensor cores' TF32 rate bounds
// it (0.238 ms at a training pass of 1,572,864 points), its bytes next
// (0.098 ms: the inputs once, the bf16 plane gradient written once; the f32
// scratch the atomics need, zeroed and cast back, is this design's cost).
//
// Design (an earlier form ran a point a thread in f32 and wrote four
// per-point blocks, 772 B a point, for torch.matmul to form the weight
// gradients):
// - A warp decodes a tile of 16 points (the mma's M), K1's forward layout:
//   the gather (C / 8 lanes a point, one 16-byte chunk of each corner, the
//   lerps and the plane mean in f32, K1's order) into the warp's features
//   f; layer 1 on the tensor cores (mma.sync m16n8k8 TF32, 3xTF32 split,
//   tf32_mma.cuh), softplus and sigmoid(pre) on its accumulators (libm's
//   expf and log1pf, as the plain version; not the SFU's forms); layer 2;
//   dL/dout from the accumulators (rgb: g s (1 - s) x the MipNeRF scale,
//   sigma: its gradient where no density filter replaced it); then the
//   backward on the tensor cores too: dL/dh = dL/dout W1, dL/dpre = dL/dh
//   sigmoid(pre), and after the round's weight products dL/df = dL/dpre
//   W0. h, sigmoid(pre), dL/dpre, dL/dout and dL/df live in the warp's
//   slot of shared memory between the products (the A operands), never in
//   device memory.
// - The weight gradients inside the kernel: a persistent grid of one CTA
//   an SM, 3 quads of 4 warps each (2 on f32 planes). A quad's round is one
//   tile a warp; after it (a named barrier, the quad's alone) the quad's
//   warps each take one 16-row
//   m-tile of dW0 += dL/dpre^T f and dW1^T += h^T dL/dout over the round's
//   64 points (the same 3xTF32 mma; db0 and db1 as sums of the operands
//   the lane loads), kept in registers across the rounds. Each quad writes
//   one partial; a second launch sums the partials in a fixed order (f64)
//   and applies the gains, so the weight gradients come out the same from
//   run to run.
// - The scatter (scatter_tile): a point's cell on each plane, its 4
//   corners' weights; a run of consecutive points in one cell (a ray's
//   samples: on the ortho front view every sample of a ray hits the same
//   xy cell) is summed first (weights x dL/df / 3, from the warp's slot)
//   and each of its corners added once; C / 4 lanes a corner row, one
//   16-byte red.global.add.f32 each, so a warp instruction adds 128 / C
//   whole rows. The plane gradient stays f32. A card run with the atomics
//   replaced by plain stores took as long: the scatter's instructions, not
//   the L2's atomics, bound it, so a lane reads a point's dL/df chunk once
//   for its 4 corners (TMA bulk reductions of whole rows were slower).
// What holds a warp back is latency: its tile is one long dependent chain
// (the gather's L2 reads, five products, libm's expf and log1pf, the
// scatter's atomics), its instructions a quarter of the SM's issue slots
// or less (counted from the code), so the design buys warps. The CTA holds
// the decoder's gained weights once an SM, split into TF32 (hi, lo) pairs
// as they are loaded,
// w0 [64][C] and w1 [40][64] in one orientation each: a B fragment is two
// 8-byte loads, with no split, in either orientation (layer 1 and dL/df
// read w0 as it is and transposed, layer 2 and dL/dh w1), conflict-free at
// a row stride of 4 mod 16 pairs. (A layout of whole fragments, 16 bytes a
// lane, needs both orientations: 72 KB, which leaves room for 10 warps.) A
// warp's slot holds f, h, sigmoid(pre) and dL/dout for the round's
// products; dL/df then takes f's place and the scatter's items dL/dout's,
// 13.5 KB a warp at C = 32. The weights (40 KB) and 12 slots take ~202
// KB: 12 warps an SM.
//
// K10's backward form (triplane_decode_deep_grad) is the same kernel on the
// deep planes (triplane_depth D > 1), templated on DEEP. It replaces what
// XLA's autodiff makes of panic3d_tpu/ops/grid_sample.py:
// grid_sample_3d_points (:266) where sample_from_planes runs it at depth
// (renderer.py:86-92), with the plane mean, OSGDecoder and the filters. The
// gather reads K10's channels-last volumes [N*3, D, H, W, C]: a plane's
// point has a third projected coordinate that indexes D, and its 8 corners
// (zeros outside the volume) are lerped as K10's forward lerps them
// (csrc/triplane_decode.cu:deep_plane_sample). The scatter's runs are runs
// of points in one 3-D cell; a (plane, point)'s 8 corner weights are formed
// once, as K1's 4 are, and a run's item adds each of the cell's 8 corners
// inside the volume once. The MLP, its backward and the weight gradients
// are K1's. Per point it reads twice K1's corner rows (1,536 B at C = 32 in
// bf16, L2 hits) and adds 3 x 8 x C f32 values; the TF32 products are K1's.
// On the H100 the scatter takes a third of its time, the gather a quarter
// (chip_smoke.py --k1-grad-parts), neither held by device memory.
#include "common.cuh"
#include "tf32_mma.cuh"

// A diagnostic build (chip_smoke.py --k1-grad-parts) leaves parts out with
// -DK1G_PARTS: bit 0 the gather, bit 1 the scatter, bit 2 the weight
// products, bit 3 the scatter's atomics (else plain stores, wrong values:
// for timing only). The kernel's own build has all four.
#ifndef K1G_PARTS
#define K1G_PARTS 15
#endif

namespace {

constexpr int HID = 64;
constexpr int NOUT = 33;
constexpr int N2 = 40;          // the outputs padded to 5 n-tiles of 8
constexpr int SIGMA_COL = 32;   // net2's sigma row sits after its 32 rgb rows
constexpr int PTS = 16;         // points a warp tile: the mma's M
constexpr int GW = 4;           // warps a quad; a round is one tile a warp
constexpr int CTAS_PER_SM = 1;  // one CTA an SM (renderer.py: K1G_WARPS, K1G_QUADS,
                                // K1G_CTAS_PER_SM)

// quads a CTA: 3 (12 warps an SM) on bf16 planes; 2 on f32 ones, whose
// gather holds more registers than 384 threads an SM leave a thread. The
// host sizes the grid and the partials by the same count
// (renderer.py:k1_grad_quads) and passes it; the entry points refuse
// another.
template <typename T>
__host__ __device__ constexpr int quads_of() { return sizeof(T) == 2 ? 3 : 2; }
constexpr int HS = HID + 4;     // hidden rows' stride (+ 4: conflict-free A reads)
constexpr int OS = N2 + 4;      // output rows' stride

// the stride of a (hi, lo) weight array: n rounded up to 4 mod 16 pairs, so
// a B fragment's 16 lanes of 8-byte loads meet no bank conflict in either
// orientation (row g, column t: 4g + t; row t, column g: 4t + g)
__host__ __device__ constexpr int hl_stride(int n) { return n + ((4 - n % 16) + 16) % 16; }
constexpr unsigned FULL = 0xffffffffu;

struct Proj {
  float m[3][3][3];   // [plane][xyz][uvw]: the inverse plane axes (w, the depth: DEEP only)
};

// net2's row in padded output column c: rgb channel c (row c + 1) for
// c < 32, sigma (row 0) in column SIGMA_COL, -1 (zero) in the padding
__device__ __forceinline__ int net2_row(int c) {
  return c < SIGMA_COL ? c + 1 : c == SIGMA_COL ? 0 : -1;
}

// a warp's tile: what the products read as A operands, and the scatter's
// scratch. A round's first phase fills f, h, p and o; its weight products
// read them; then dL/df takes f's place and the scatter's items o's.
template <int C>
struct Slot {
  float f[PTS][C + 4];    // the plane-mean features, then dL/df
  float h[PTS][HS];       // softplus(pre)
  float p[PTS][HS];       // sigmoid(pre), then dL/dpre in its place
  union {
    float o[PTS][OS];     // dL/dout, net2's padded order
    struct {
      float4 w4[2][48];   // the scatter: a (plane, point)'s corner weights / 3 (corners
                          // 0-3; DEEP's 4-7 in w4[1])
      int items[48];      // its runs: first | end << 8 | the corners inside << 16
      int irow[48];       // the run's cell: corner (y0, x0)'s texel row
    } sc;
  };
};

// a CTA's shared memory: the weights, then a slot a warp
template <int C>
struct __align__(16) GradSmem {
  uint2 w0[HID][hl_stride(C)];   // w0[j][c] (gained) as TF32 (hi, lo): layer 1's and dL/df's B
  uint2 w1[N2][hl_stride(HID)];  // w1[o'][j] (gained, padded order) as (hi, lo): layer 2's and
                                 // dL/dh's B
  float b0[HID];
  float b1[N2];
};

template <typename T, int C>
constexpr size_t smem_bytes() {
  return sizeof(GradSmem<C>) + sizeof(Slot<C>) * GW * quads_of<T>();
}

// a B fragment of the 8x8 block (ks, nt) of B[k][n] = m[n][k], m a (hi, lo)
// array with row stride `stride`: b0 = B[t][g], b1 = B[t + 4][g], as
// split_pair gives it (b0 hi, b1 hi, b0 lo, b1 lo)
__device__ __forceinline__ uint4 load_b(const uint2* m, int stride, int nt, int ks, int g,
                                        int t) {
  const uint2* r = m + (nt * 8 + g) * stride + ks * 8 + t;
  const uint2 b0 = r[0], b1 = r[4];
  return make_uint4(b0.x, b1.x, b0.y, b1.y);
}

// the same of B[k][n] = m[k][n] (the transposed product): b0 = m[8 ks + t][8
// nt + g], b1 = m[8 ks + t + 4][8 nt + g]
__device__ __forceinline__ uint4 load_bt(const uint2* m, int stride, int nt, int ks, int g,
                                         int t) {
  const uint2* r = m + (ks * 8 + t) * stride + nt * 8 + g;
  const uint2 b0 = r[0], b1 = r[4 * stride];
  return make_uint4(b0.x, b1.x, b0.y, b1.y);
}

// a quad's barrier: its 4 warps, named barrier 1 + quad (0 is __syncthreads)
__device__ __forceinline__ void quad_sync(int quad) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + quad), "r"(32 * GW) : "memory");
}

__device__ __forceinline__ void split4(const float (&a)[4], uint32_t hi[4], uint32_t lo[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(a[i], hi[i], lo[i]);
}

// plane p's bilinear geometry of a (scaled) point, as K1's gather computes
// it (grid_sample, align_corners=False): the lower corner and the weights.
// The corner is clamped before the conversion (a clamped corner is outside
// the plane either way), so far-out points convert safely.
__device__ __forceinline__ void plane_geom(const Proj& pr, int p, float sx, float sy, float sz,
                                           int H, int W, int& x0, int& y0, float& wx,
                                           float& wy) {
  const float gx = sx * pr.m[p][0][0] + sy * pr.m[p][1][0] + sz * pr.m[p][2][0];
  const float gy = sx * pr.m[p][0][1] + sy * pr.m[p][1][1] + sz * pr.m[p][2][1];
  const float ix = ((gx + 1.f) * (float)W - 1.f) / 2.f;
  const float iy = ((gy + 1.f) * (float)H - 1.f) / 2.f;
  const float fx = floorf(ix), fy = floorf(iy);
  wx = ix - fx;
  wy = iy - fy;
  x0 = (int)fminf(fmaxf(fx, -2.f), (float)W);
  y0 = (int)fminf(fmaxf(fy, -2.f), (float)H);
}

// a deep plane's third coordinate (the volume's depth, D slices) of a
// (scaled) point, as K10's gather computes it: the lower slice and its weight
__device__ __forceinline__ void depth_geom(const Proj& pr, int p, float sx, float sy, float sz,
                                           int D, int& z0, float& wz) {
  const float gz = sx * pr.m[p][0][2] + sy * pr.m[p][1][2] + sz * pr.m[p][2][2];
  const float iz = ((gz + 1.f) * (float)D - 1.f) / 2.f;
  const float fz = floorf(iz);
  wz = iz - fz;
  z0 = (int)fminf(fmaxf(fz, -2.f), (float)D);
}

__device__ __forceinline__ void unpack8(const uint4& r, float* v, const float*) {
  v[0] = __uint_as_float(r.x); v[1] = __uint_as_float(r.y);
  v[2] = __uint_as_float(r.z); v[3] = __uint_as_float(r.w);
}

__device__ __forceinline__ void unpack8(const uint4& r, float* v, const __nv_bfloat16*) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {   // a bf16 is the top half of its f32
    const uint32_t u = (&r.x)[i];
    v[2 * i] = __uint_as_float(u << 16);
    v[2 * i + 1] = __uint_as_float(u & 0xffff0000u);
  }
}

// one deep plane's trilinear sample of a lane's CH channels at c0, added to
// feat: K10's forward order (csrc/triplane_decode.cu:deep_plane_sample), per
// z slice the xy lerps, then 0 + s(z0) (1 - wz) + s(z1) wz
template <typename T, int C>
__device__ __forceinline__ void deep_sample(const T* __restrict__ vols, int n, int p, int D,
                                            int H, int W, const Proj& pr, float sx, float sy,
                                            float sz, int c0, float* feat) {
  constexpr int CH = 16 / (int)sizeof(T);
  int x0, y0, z0;
  float wx, wy, wz;
  plane_geom(pr, p, sx, sy, sz, H, W, x0, y0, wx, wy);
  depth_geom(pr, p, sx, sy, sz, D, z0, wz);
  const bool vx0 = x0 >= 0 && x0 < W, vx1 = x0 + 1 >= 0 && x0 + 1 < W;
  const bool vy0 = y0 >= 0 && y0 < H, vy1 = y0 + 1 >= 0 && y0 + 1 < H;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint4 r[2][4];
#pragma unroll
  for (int dz = 0; dz < 2; ++dz) {
    const int z = z0 + dz;
    const bool vz = z >= 0 && z < D;
    const long long row = (((long long)(n * 3 + p) * D + z) * H + y0) * W + x0;
    const T* r00 = vols + row * C + c0;
    const T* r10 = r00 + (long long)W * C;
    r[dz][0] = vz && vy0 && vx0 ? __ldg(reinterpret_cast<const uint4*>(r00)) : zero;
    r[dz][1] = vz && vy0 && vx1 ? __ldg(reinterpret_cast<const uint4*>(r00 + C)) : zero;
    r[dz][2] = vz && vy1 && vx0 ? __ldg(reinterpret_cast<const uint4*>(r10)) : zero;
    r[dz][3] = vz && vy1 && vx1 ? __ldg(reinterpret_cast<const uint4*>(r10 + C)) : zero;
  }
  float v[CH];
#pragma unroll
  for (int k = 0; k < CH; ++k) v[k] = 0.f;
#pragma unroll
  for (int dz = 0; dz < 2; ++dz) {
    const float wzz = dz ? wz : 1.f - wz;
    float v00[CH], v01[CH], v10[CH], v11[CH];
    unpack8(r[dz][0], v00, vols);
    unpack8(r[dz][1], v01, vols);
    unpack8(r[dz][2], v10, vols);
    unpack8(r[dz][3], v11, vols);
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      const float top = v00[k] + (v01[k] - v00[k]) * wx;
      const float bot = v10[k] + (v11[k] - v10[k]) * wx;
      v[k] += (top + (bot - top) * wy) * wzz;
    }
  }
#pragma unroll
  for (int k = 0; k < CH; ++k) feat[k] += v[k];
}

// the plane-mean features of the tile's 16 points into f[point][C + 4]
// (zeros past the end): C / CH neighbouring lanes a point, one 16-byte
// chunk of CH channels of every corner each; the lerps and the mean in
// K1's order (ops/grid_sample.py:grid_sample_2d_points), or with DEEP
// K10's (deep_sample)
template <typename T, int C, bool DEEP>
__device__ __forceinline__ void gather_tile(const T* __restrict__ planes,
                                            const float* __restrict__ coords, long long t0,
                                            long long total, int M, int D, int H, int W,
                                            const Proj& pr, float scale, int lane, float* f) {
  constexpr int CH = 16 / (int)sizeof(T), TPP = C / CH, PPP = 32 / TPP;
  constexpr int PASSES = (PTS + PPP - 1) / PPP, FS = C + 4;
  const int cc = lane % TPP;
#pragma unroll 1
  for (int pass = 0; pass < PASSES; ++pass) {
    const int lp = pass * PPP + lane / TPP;
    if (lp >= PTS) continue;
    const long long pt = t0 + lp;
    float feat[CH];
#pragma unroll
    for (int c = 0; c < CH; ++c) feat[c] = 0.f;
    if (pt < total) {
      const int n = (int)(pt / M);
      const float sx = scale * coords[pt * 3], sy = scale * coords[pt * 3 + 1];
      const float sz = scale * coords[pt * 3 + 2];
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        if constexpr (DEEP) {
          deep_sample<T, C>(planes, n, p, D, H, W, pr, sx, sy, sz, cc * CH, feat);
        } else {
          int x0, y0;
          float wx, wy;
          plane_geom(pr, p, sx, sy, sz, H, W, x0, y0, wx, wy);
          const T* r00 = planes + ((long long)(n * 3 + p) * H * W + (long long)y0 * W + x0) * C +
                         cc * CH;
          uint4 v[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int xx = x0 + (k & 1), yy = y0 + (k >> 1);
            v[k] = make_uint4(0u, 0u, 0u, 0u);
            if (xx >= 0 && xx < W && yy >= 0 && yy < H)
              v[k] = __ldg(reinterpret_cast<const uint4*>(r00 + ((k >> 1) * W + (k & 1)) * C));
          }
          float v00[CH], v01[CH], v10[CH], v11[CH];
          unpack8(v[0], v00, planes);
          unpack8(v[1], v01, planes);
          unpack8(v[2], v10, planes);
          unpack8(v[3], v11, planes);
#pragma unroll
          for (int k = 0; k < CH; ++k) {
            const float top = v00[k] + (v01[k] - v00[k]) * wx;
            const float bot = v10[k] + (v11[k] - v10[k]) * wx;
            feat[k] += top + (bot - top) * wy;
          }
        }
      }
#pragma unroll
      for (int c = 0; c < CH; ++c) feat[c] = feat[c] / 3.f;
    }
    float4* dst = reinterpret_cast<float4*>(f + lp * FS + cc * CH);
#pragma unroll
    for (int q = 0; q < CH / 4; ++q)
      dst[q] = make_float4(feat[4 * q], feat[4 * q + 1], feat[4 * q + 2], feat[4 * q + 3]);
  }
}

// softplus(x) in jax.nn.softplus's overflow-safe form (softplus_f) and its
// slope sigmoid(x), from one e^-|x| with libm's expf and log1pf: within f32
// rounding of the plain version's. With the SFU's forms (~2e-7 off) one f32
// training step's update of G came 8.1e-3 (relative L2) from the plain
// ops', against a tolerance of 1e-2; with these 1.4e-3 (an H100).
__device__ __forceinline__ void softplus_sigmoid(float x, float& sp, float& sg) {
  const float e = expf(-fabsf(x));
  sp = fmaxf(x, 0.f) + log1pf(e);
  sg = (x >= 0.f ? 1.f : e) / (1.f + e);
}

__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// sigma's gradient passes where no density filter replaced sigma
// (renderer.py:_apply_density_filters): outside the crop, binarized, or
// culled, its slope is 0
__device__ __forceinline__ bool sigma_passes(float sigma, float x, float z, int use_crop,
                                             float crop_lim, int cull_mode, float cull_thresh) {
  if (use_crop && !(fabsf(x) <= crop_lim && fabsf(z) <= crop_lim)) return false;
  if (cull_mode == 2) return false;
  if (cull_mode == 1 && 1.f - expf(-softplus_f(sigma - 1.f)) < cull_thresh) return false;
  return true;
}

// one tile: the decode again and its backward up to dL/dpre. The slot
// holds f, h, dL/dpre and dL/dout for the round's weight products.
template <typename T, int C, bool DEEP>
__device__ __forceinline__ void tile_grad(
    GradSmem<C>& sm, Slot<C>& s, const T* __restrict__ planes, const float* __restrict__ coords,
    const T* __restrict__ g_rgb, const float* __restrict__ g_sigma, long long t0,
    long long total, int M, int D, int H, int W, const Proj& pr, float scale, float rgb_scale,
    int use_crop, float crop_lim, int cull_mode, float cull_thresh, int lane) {
  constexpr int FS = C + 4;
  const int g = lane >> 2, t = lane & 3;
  // the point of lane & 15: its world x and z (the crop)
  const long long pl = t0 + (lane & 15);
  float cx = 0.f, cz = 0.f;
  if (pl < total) {
    cx = coords[pl * 3];
    cz = coords[pl * 3 + 2];
  }
  if (K1G_PARTS & 1)
    gather_tile<T, C, DEEP>(planes, coords, t0, total, M, D, H, W, pr, scale, lane, &s.f[0][0]);
  __syncwarp();

  // layer 1: pre = W0 f + b0 -> h = softplus(pre), sigmoid(pre)
  {
    float acc[HID / 8][4];
#pragma unroll
    for (int nt = 0; nt < HID / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < C / 8; ++ks) {
      uint32_t hi[4], lo[4];
      load_a(&s.f[0][0] + ks * 8 + t, g, FS, hi, lo);
#pragma unroll
      for (int nt = 0; nt < HID / 8; ++nt)
        mma_3xtf32(acc[nt], hi, lo, load_b(&sm.w0[0][0], hl_stride(C), nt, ks, g, t));
    }
#pragma unroll
    for (int nt = 0; nt < HID / 8; ++nt) {
      const int col = nt * 8 + 2 * t;
      const float2 bb = load_pair(&sm.b0[col]);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = g + 8 * half;
        float h0, h1, s0, s1;
        softplus_sigmoid(acc[nt][2 * half] + bb.x, h0, s0);
        softplus_sigmoid(acc[nt][2 * half + 1] + bb.y, h1, s1);
        store2(&s.h[row][col], h0, h1);
        store2(&s.p[row][col], s0, s1);
      }
    }
  }
  __syncwarp();

  // layer 2, then dL/dout from its accumulators
  {
    float o[N2 / 8][4];
#pragma unroll
    for (int nt = 0; nt < N2 / 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < HID / 8; ++ks) {
      uint32_t hi[4], lo[4];
      load_a(&s.h[0][0] + ks * 8 + t, g, HS, hi, lo);
#pragma unroll
      for (int nt = 0; nt < N2 / 8; ++nt)
        mma_3xtf32(o[nt], hi, lo, load_b(&sm.w1[0][0], hl_stride(HID), nt, ks, g, t));
    }
    // rows g and g + 8: their world x and z from lanes g and g + 8 (the crop)
    const float xr[2] = {__shfl_sync(FULL, cx, g), __shfl_sync(FULL, cx, g + 8)};
    const float zr[2] = {__shfl_sync(FULL, cz, g), __shfl_sync(FULL, cz, g + 8)};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = g + 8 * half;
      const long long pt = t0 + row;
      const bool valid = pt < total;
#pragma unroll
      for (int nt = 0; nt < N2 / 8 - 1; ++nt) {   // rgb channels 8 nt + 2 t, + 1
        const int col = nt * 8 + 2 * t;
        const float2 gr = valid ? load_pair(g_rgb + pt * 32 + col) : make_float2(0.f, 0.f);
        const float sa = sigmoid_f(o[nt][2 * half] + sm.b1[col]);
        const float sb = sigmoid_f(o[nt][2 * half + 1] + sm.b1[col + 1]);
        store2(&s.o[row][col], gr.x * (sa * (1.f - sa)) * rgb_scale,
               gr.y * (sb * (1.f - sb)) * rgb_scale);
      }
      float d = 0.f;   // sigma in column 32 (t == 0); zeros in the padding 33..39
      if (t == 0 && valid &&
          sigma_passes(o[N2 / 8 - 1][2 * half] + sm.b1[SIGMA_COL], xr[half], zr[half], use_crop,
                       crop_lim, cull_mode, cull_thresh))
        d = g_sigma[pt];
      store2(&s.o[row][SIGMA_COL + 2 * t], d, 0.f);
    }
  }
  __syncwarp();

  // dL/dh = dL/dout W1 (K = 40: the padding is zero), dL/dpre = dL/dh
  // sigmoid(pre), in place of sigmoid(pre)
  {
    float dh[HID / 8][4];
#pragma unroll
    for (int nt = 0; nt < HID / 8; ++nt) dh[nt][0] = dh[nt][1] = dh[nt][2] = dh[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < N2 / 8; ++ks) {
      uint32_t hi[4], lo[4];
      load_a(&s.o[0][0] + ks * 8 + t, g, OS, hi, lo);
#pragma unroll
      for (int nt = 0; nt < HID / 8; ++nt)
        mma_3xtf32(dh[nt], hi, lo, load_bt(&sm.w1[0][0], hl_stride(HID), nt, ks, g, t));
    }
#pragma unroll
    for (int nt = 0; nt < HID / 8; ++nt) {
      const int col = nt * 8 + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float* q = &s.p[g + 8 * half][col];
        const float2 sg = load_pair(q);
        store2(q, dh[nt][2 * half] * sg.x, dh[nt][2 * half + 1] * sg.y);
      }
    }
  }
  __syncwarp();
}

// after the round's weight products: dL/df = dL/dpre W0 into the slot, in
// the features' place
template <int C>
__device__ __forceinline__ void tile_df(const GradSmem<C>& sm, Slot<C>& s, int lane) {
  constexpr int NTC = C / 8;
  const int g = lane >> 2, t = lane & 3;
  {
    float df[NTC][4];
#pragma unroll
    for (int nt = 0; nt < NTC; ++nt) df[nt][0] = df[nt][1] = df[nt][2] = df[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < HID / 8; ++ks) {
      uint32_t hi[4], lo[4];
      load_a(&s.p[0][0] + ks * 8 + t, g, HS, hi, lo);
#pragma unroll
      for (int nt = 0; nt < NTC; ++nt)
        mma_3xtf32(df[nt], hi, lo, load_bt(&sm.w0[0][0], hl_stride(C), nt, ks, g, t));
    }
#pragma unroll
    for (int nt = 0; nt < NTC; ++nt) {
      const int col = nt * 8 + 2 * t;
      store2(&s.f[g][col], df[nt][0], df[nt][1]);
      store2(&s.f[g + 8][col], df[nt][2], df[nt][3]);
    }
  }
  __syncwarp();
}

// the scatter of a tile's dL/df into the plane gradient. (1) Each lane
// takes its point (lane & 15) on plane lane / 16, and lanes < 16 also on
// plane 2: the point's cell (the bilinear corner (y0, x0)), its 4 corners'
// weights / 3 (the plane mean; 0 outside the plane) into the slot, the
// corners inside the plane as a mask. (2) A run of consecutive points in
// one cell (a ray's samples on the ortho front view's xy plane) starts
// where the cell changes (or the plane does); each run is an item. (3) C /
// 4 lanes an item: each sums weight x dL/df over the run's points (in point
// order) for the 4 corners from one read of each point's dL/df chunk, and
// adds each corner inside the plane once, a 16-byte red.global.add.f32, so
// a warp instruction adds 128 / C whole corner rows. With DEEP a cell is
// 3-D: step (1) forms the point's 8 corner weights / 3 (bit k of the
// item's mask: x + (k & 1), y + (k >> 1 & 1), z + (k >> 2)) once, so the
// item's lanes read them as K1's read its 4, and a run's 8 sums are formed
// from one read of each point's dL/df chunk.
template <int C, bool DEEP>
__device__ __forceinline__ void scatter_tile(Slot<C>& s, float* __restrict__ g_planes,
                                             const float* __restrict__ coords, long long t0,
                                             long long total, int M, int D, int H, int W,
                                             const Proj& pr, float scale, int lane) {
  constexpr int LPR = C / 4, RPI = 32 / LPR;   // lanes an item, items an instruction
  constexpr int NK = DEEP ? 8 : 4;             // corners a cell
  const long long pl = t0 + (lane & 15);
  const bool lv = pl < total;
  float sx = 0.f, sy = 0.f, sz = 0.f;
  int ln = 0;
  if (lv) {
    sx = scale * coords[pl * 3];
    sy = scale * coords[pl * 3 + 1];
    sz = scale * coords[pl * 3 + 2];
    ln = (int)(pl / M);
  }
  int n_items = 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {   // h = 0: planes 0 and 1 (lanes 0-15, 16-31); h = 1: plane 2
    const int e = lane + 32 * h, p = h ? 2 : lane >> 4;
    const bool on = h == 0 || lane < 16;
    int key = -1, row = 0, mask = 0;
    if (on && lv) {
      int x0, y0;
      float wx, wy;
      plane_geom(pr, p, sx, sy, sz, H, W, x0, y0, wx, wy);
      if constexpr (DEEP) {
        int z0;
        float wz;
        depth_geom(pr, p, sx, sy, sz, D, z0, wz);
        // a corner is inside the volume
        if (x0 >= -1 && x0 < W && y0 >= -1 && y0 < H && z0 >= -1 && z0 < D) {
          key = (((ln * 3 + p) * (D + 2) + z0 + 1) * (H + 2) + y0 + 1) * (W + 2) + x0 + 1;
          row = (((ln * 3 + p) * D + z0) * H + y0) * W + x0;
          const bool in_x[2] = {x0 >= 0, x0 + 1 < W}, in_y[2] = {y0 >= 0, y0 + 1 < H};
          const bool in_z[2] = {z0 >= 0, z0 + 1 < D};
          const float fx[2] = {1.f - wx, wx}, fy[2] = {1.f - wy, wy};
          const float fz[2] = {(1.f - wz) / 3.f, wz / 3.f};
          float wk[8];
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            mask |= (in_x[k & 1] && in_y[k >> 1 & 1] && in_z[k >> 2]) << k;
            wk[k] = fx[k & 1] * fy[k >> 1 & 1] * fz[k >> 2];
          }
          s.sc.w4[0][e] = make_float4(wk[0], wk[1], wk[2], wk[3]);
          s.sc.w4[1][e] = make_float4(wk[4], wk[5], wk[6], wk[7]);
        }
      } else if (x0 >= -1 && x0 < W && y0 >= -1 && y0 < H) {   // a corner is inside the plane
        key = ((ln * 3 + p) * (H + 2) + y0 + 1) * (W + 2) + x0 + 1;
        row = ((ln * 3 + p) * H + y0) * W + x0;
        const bool in_x0 = x0 >= 0, in_x1 = x0 + 1 < W, in_y0 = y0 >= 0, in_y1 = y0 + 1 < H;
        mask = (in_y0 && in_x0) | (in_y0 && in_x1) << 1 | (in_y1 && in_x0) << 2 |
               (in_y1 && in_x1) << 3;
        s.sc.w4[0][e] = make_float4((1.f - wx) * (1.f - wy) / 3.f, wx * (1.f - wy) / 3.f,
                                    (1.f - wx) * wy / 3.f, wx * wy / 3.f);
      }
    }
    const int prev = __shfl_up_sync(FULL, key, 1);
    const int seg = h ? 0 : 16 * (lane >> 4);   // the first lane of this plane's 16
    const bool start = on && (lane == seg || key != prev);
    const unsigned starts = __ballot_sync(FULL, start);
    const unsigned heads = __ballot_sync(FULL, start && key >= 0);
    const unsigned later = lane == 31 ? 0u : starts >> (lane + 1) << (lane + 1);
    const int seg_end = h ? 16 : seg + 16;
    const int end = later ? min(__ffs(later) - 1, seg_end) : seg_end;
    if (start && key >= 0) {
      const int idx = n_items + __popc(heads & ((1u << lane) - 1u));
      s.sc.items[idx] = e | (end + 32 * h) << 8 | mask << 16;
      s.sc.irow[idx] = row;
    }
    n_items += __popc(heads);
  }
  __syncwarp();
  const int c4 = 4 * (lane % LPR);
  for (int it = lane / LPR; it < n_items; it += RPI) {
    const int item = s.sc.items[it], e0 = item & 255, e1 = (item >> 8) & 255, mask = item >> 16;
    float4 a[NK];
#pragma unroll
    for (int k = 0; k < NK; ++k) a[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int e = e0; e < e1; ++e) {
      const float4 d = *reinterpret_cast<const float4*>(&s.f[e & 15][c4]);
      float wk[NK];
#pragma unroll
      for (int q = 0; q < NK / 4; ++q) {
        const float4 w = s.sc.w4[q][e];
        wk[4 * q] = w.x;
        wk[4 * q + 1] = w.y;
        wk[4 * q + 2] = w.z;
        wk[4 * q + 3] = w.w;
      }
#pragma unroll
      for (int k = 0; k < NK; ++k) {
        a[k].x = fmaf(wk[k], d.x, a[k].x);
        a[k].y = fmaf(wk[k], d.y, a[k].y);
        a[k].z = fmaf(wk[k], d.z, a[k].z);
        a[k].w = fmaf(wk[k], d.w, a[k].w);
      }
    }
    const long long r0 = s.sc.irow[it];
#pragma unroll
    for (int k = 0; k < NK; ++k)
      if (mask >> k & 1) {
        const long long off = ((long long)(k >> 2) * H + (k >> 1 & 1)) * W + (k & 1);
        float4* dst = reinterpret_cast<float4*>(g_planes + (r0 + off) * C + c4);
        if (K1G_PARTS & 8)
          atomicAdd(dst, a[k]);
        else
          *dst = a[k];
      }
  }
  __syncwarp();   // the slot's scratch is the next tile's
}

// the round's weight products: the quad's warp w's m-tile (hidden units 16
// w + g, + 8) of dW0 (columns: the features) and of dW1^T (columns: the
// padded outputs) over the round's 4 x 16 points (the quad's slots), 8 a
// k-step; the biases' sums from the same operands (db1: warp 0)
template <int C>
__device__ __forceinline__ void weight_products(const Slot<C>* slots, int warp, int lane,
                                                float (&aw0)[C / 8][4], float (&aw1)[N2 / 8][4],
                                                float (&ab0)[2], float (&ab1)[N2 / 8]) {
  const int g = lane >> 2, t = lane & 3, j0 = 16 * warp + g;
#pragma unroll 1
  for (int ks = 0; ks < 2 * GW; ++ks) {
    const Slot<C>& sl = slots[ks >> 1];
    const int r = ((ks & 1) << 3) + t;   // the point row of a0 (a2: r + 4)
    uint32_t hi[4], lo[4];
    {   // A[j][p] = dL/dpre[p][j], B[p][c] = f[p][c]
      const float a[4] = {sl.p[r][j0], sl.p[r][j0 + 8], sl.p[r + 4][j0], sl.p[r + 4][j0 + 8]};
      ab0[0] += a[0];
      ab0[0] += a[2];
      ab0[1] += a[1];
      ab0[1] += a[3];
      split4(a, hi, lo);
#pragma unroll
      for (int nt = 0; nt < C / 8; ++nt)
        mma_3xtf32(aw0[nt], hi, lo, split_pair(sl.f[r][nt * 8 + g], sl.f[r + 4][nt * 8 + g]));
    }
    {   // A[j][p] = h[p][j], B[p][o'] = dL/dout[p][o']
      const float a[4] = {sl.h[r][j0], sl.h[r][j0 + 8], sl.h[r + 4][j0], sl.h[r + 4][j0 + 8]};
      split4(a, hi, lo);
#pragma unroll
      for (int nt = 0; nt < N2 / 8; ++nt) {
        const float b0 = sl.o[r][nt * 8 + g], b1 = sl.o[r + 4][nt * 8 + g];
        if (warp == 0) {
          ab1[nt] += b0;
          ab1[nt] += b1;
        }
        mma_3xtf32(aw1[nt], hi, lo, split_pair(b0, b1));
      }
    }
  }
}

// the sum of the t lanes (lanes 4g .. 4g + 3) in a fixed order
__device__ __forceinline__ float sum_over_t(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  return v + __shfl_xor_sync(FULL, v, 2);
}

template <typename T, int C, bool DEEP>
__global__ void __launch_bounds__(32 * GW * quads_of<T>(), CTAS_PER_SM)
triplane_decode_grad_kernel(
    const T* __restrict__ planes, const float* __restrict__ coords,
    const float* __restrict__ w0, const float* __restrict__ b0, const float* __restrict__ w1,
    const float* __restrict__ b1, const T* __restrict__ g_rgb,
    const float* __restrict__ g_sigma, float* __restrict__ g_planes,
    float* __restrict__ partials, int N, int M, int D, int H, int W, Proj pr, float scale,
    float gain0, float gain1, float lr_mul, float rgb_scale, int use_crop, float crop_lim,
    int cull_mode, float cull_thresh) {
  extern __shared__ uint4 smem_raw[];
  constexpr int QUADS = quads_of<T>();
  GradSmem<C>& sm = *reinterpret_cast<GradSmem<C>*>(smem_raw);
  const int tid = threadIdx.x;
  // the gained weights once a CTA, split into TF32 (hi, lo) as the products read them
  for (int i = tid; i < HID * C; i += blockDim.x) {
    const int j = i / C, c = i - j * C;
    uint32_t hi, lo;
    split_tf32(w0[i] * gain0, hi, lo);
    sm.w0[j][c] = make_uint2(hi, lo);
  }
  for (int i = tid; i < N2 * HID; i += blockDim.x) {
    const int oc = i / HID, j = i - oc * HID, o = net2_row(oc);
    uint32_t hi, lo;
    split_tf32(o >= 0 ? w1[o * HID + j] * gain1 : 0.f, hi, lo);
    sm.w1[oc][j] = make_uint2(hi, lo);
  }
  for (int i = tid; i < HID; i += blockDim.x) sm.b0[i] = b0[i] * lr_mul;
  for (int i = tid; i < N2; i += blockDim.x)
    sm.b1[i] = net2_row(i) >= 0 ? b1[net2_row(i)] * lr_mul : 0.f;
  __syncthreads();

  // each quad of 4 warps runs rounds of its own (a tile a warp), with its
  // own barrier and its own partial of the weight gradients
  const int quad = tid >> 7, warp = (tid >> 5) & (GW - 1), lane = tid & 31;
  const int qg = blockIdx.x * QUADS + quad;
  Slot<C>* slots = reinterpret_cast<Slot<C>*>(&sm + 1) + quad * GW;
  Slot<C>& mine = slots[warp];
  const long long total = (long long)N * M, tiles = (total + PTS - 1) / PTS;
  float aw0[C / 8][4], aw1[N2 / 8][4], ab0[2] = {0.f, 0.f}, ab1[N2 / 8];
#pragma unroll
  for (int nt = 0; nt < C / 8; ++nt) aw0[nt][0] = aw0[nt][1] = aw0[nt][2] = aw0[nt][3] = 0.f;
#pragma unroll
  for (int nt = 0; nt < N2 / 8; ++nt) {
    aw1[nt][0] = aw1[nt][1] = aw1[nt][2] = aw1[nt][3] = 0.f;
    ab1[nt] = 0.f;
  }
  // round r: tiles GW r .. GW r + GW - 1 (past the end: zero features and
  // zero output gradients, so they add nothing)
  for (long long round = qg; round * GW < tiles; round += (long long)gridDim.x * QUADS) {
    const long long t0 = (round * GW + warp) * PTS;
    tile_grad<T, C, DEEP>(sm, mine, planes, coords, g_rgb, g_sigma, t0, total, M, D, H, W, pr,
                          scale, rgb_scale, use_crop, crop_lim, cull_mode, cull_thresh, lane);
    quad_sync(quad);
    if (K1G_PARTS & 4) weight_products<C>(slots, warp, lane, aw0, aw1, ab0, ab1);
    quad_sync(quad);
    tile_df<C>(sm, mine, lane);
    if (K1G_PARTS & 2)
      scatter_tile<C, DEEP>(mine, g_planes, coords, t0, total, M, D, H, W, pr, scale, lane);
  }

  // this quad's partial: dW0 [64][C], dW1 [33][64], db0 [64], db1 [33] (no gains)
  const int g = lane >> 2, t = lane & 3, j0 = 16 * warp + g;
  float* part = partials + (long long)qg * (HID * C + NOUT * HID + HID + NOUT);
#pragma unroll
  for (int nt = 0; nt < C / 8; ++nt) {
    const int c = nt * 8 + 2 * t;
    part[j0 * C + c] = aw0[nt][0];
    part[j0 * C + c + 1] = aw0[nt][1];
    part[(j0 + 8) * C + c] = aw0[nt][2];
    part[(j0 + 8) * C + c + 1] = aw0[nt][3];
  }
  float* pw1 = part + HID * C;
#pragma unroll
  for (int nt = 0; nt < N2 / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int o = net2_row(nt * 8 + 2 * t + e);
      if (o >= 0) {
        pw1[o * HID + j0] = aw1[nt][e];
        pw1[o * HID + j0 + 8] = aw1[nt][2 + e];
      }
    }
  float* pb0 = pw1 + NOUT * HID;
  float* pb1 = pb0 + HID;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float v = sum_over_t(ab0[e]);
    if (t == 0) pb0[j0 + 8 * e] = v;
  }
  if (warp == 0) {
#pragma unroll
    for (int nt = 0; nt < N2 / 8; ++nt) {
      const float v = sum_over_t(ab1[nt]);
      const int o = net2_row(nt * 8 + g);
      if (t == 0 && o >= 0) pb1[o] = v;
    }
  }
}

// the weight gradients: the CTAs' partials summed in order (f64), times
// their gains (nw0 values of dW0, nw1 of dW1, then the biases')
__global__ void triplane_decode_grad_finish(const float* __restrict__ partials, int ctas, int nw,
                                            int nw0, int nw1, float gain0, float gain1,
                                            float lr_mul, float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= nw) return;
  double sum = 0.0;
  for (int b = 0; b < ctas; ++b) sum += partials[(long long)b * nw + e];
  const double gain = e < nw0 ? gain0 : e < nw0 + nw1 ? gain1 : lr_mul;
  out[e] = (float)(sum * gain);
}

template <typename T, int C, bool DEEP>
cudaError_t launch(const void* planes, const float* coords, const float* w0, const float* b0,
                   const float* w1, const float* b1, const void* g_rgb, const float* g_sigma,
                   float* g_planes, float* partials, float* g_weights, int ctas, int N, int M,
                   int D, int H, int W, const Proj& pr, float scale, float gain0, float gain1,
                   float lr_mul, float rgb_scale, int use_crop, float crop_lim, int cull_mode,
                   float cull_thresh, cudaStream_t stream) {
  // above 48 KB of shared memory a block must ask for it, and the CTA's
  // ~206 KB (C = 32) needs the largest shared-memory carveout (once per kernel)
  static const cudaError_t attr = [] {
    const cudaError_t e = cudaFuncSetAttribute(triplane_decode_grad_kernel<T, C, DEEP>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem_bytes<T, C>());
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(triplane_decode_grad_kernel<T, C, DEEP>,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                (int)cudaSharedmemCarveoutMaxShared);
  }();
  if (attr != cudaSuccess) return attr;
  triplane_decode_grad_kernel<T, C, DEEP>
      <<<ctas, 32 * GW * quads_of<T>(), smem_bytes<T, C>(), stream>>>(
      static_cast<const T*>(planes), coords, w0, b0, w1, b1, static_cast<const T*>(g_rgb),
      g_sigma, g_planes, partials, N, M, D, H, W, pr, scale, gain0, gain1, lr_mul, rgb_scale,
      use_crop, crop_lim, cull_mode, cull_thresh);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int nw = HID * C + NOUT * HID + HID + NOUT;
  triplane_decode_grad_finish<<<(nw + 255) / 256, 256, 0, stream>>>(
      partials, ctas * quads_of<T>(), nw, HID * C, NOUT * HID, gain0, gain1, lr_mul,
      g_weights);
  return cudaGetLastError();
}

}  // namespace

// planes [N,3,H,W,C] channels-last (f32 or bf16, 16-byte aligned; N 3 (H +
// 2) (W + 2) < 2^31: the scatter's cells are 32-bit keys), coords [N,M,3]
// f32, the decoder's raw weights w0 [64,C], b0 [64], w1 [33,64], b1 [33]
// (f32; the gains are applied here), g_rgb [N,M,32] in the planes' dtype
// and g_sigma [N,M] f32: the gradients of K1's outputs. Adds into g_planes
// [N,3,H,W,C] f32, zeroed by the caller; writes g_weights [64 C + 33 * 64 +
// 64 + 33] f32 (dW0, dW1, db0, db1, the gains applied), through partials
// [ctas x quads, the same] f32 scratch (a partial a quad). ctas: the
// persistent grid, at most CTAS_PER_SM x the SMs and at least 1; quads:
// the quads a CTA its wrapper sized the grid and the partials by, which
// must be this dtype's (quads_of: 3 on bf16 planes, 2 on f32 ones). proj:
// the inverse plane axes [3][3][2]; the filter arguments are K1's.
PANIC3D_EXPORT int triplane_decode_grad(
    const void* planes, int dtype, const float* coords, const float* w0, const float* b0,
    const float* w1, const float* b1, const void* g_rgb, const float* g_sigma,
    float* g_planes, float* partials, float* g_weights, int ctas, int quads, int N, int M,
    int H, int W, int C, const float* proj, float scale, float gain0, float gain1, float lr_mul,
    int force_sigmoid, int use_crop, float crop_lim, int cull_mode, float cull_thresh,
    void* stream) {
  if (N < 1 || M < 1 || H < 1 || W < 1 || ctas < 1 ||
      (long long)N * 3 * (H + 2) * (W + 2) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  Proj pr{};
  for (int p = 0; p < 3; ++p)
    for (int c = 0; c < 3; ++c)
      for (int d = 0; d < 2; ++d) pr.m[p][c][d] = proj[(p * 3 + c) * 2 + d];
  const float rgb_scale = force_sigmoid ? 1.f : 1.f + 2.f * 0.001f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define P3D_K1G(T, CC)                                                                      \
  return quads != quads_of<T>()                                                             \
             ? (int)cudaErrorInvalidValue                                                   \
             : (int)launch<T, CC, false>(planes, coords, w0, b0, w1, b1, g_rgb, g_sigma,    \
                                         g_planes, partials, g_weights, ctas, N, M, 1, H, W, \
                                         pr, scale, gain0, gain1, lr_mul, rgb_scale,         \
                                         use_crop, crop_lim, cull_mode, cull_thresh, s)
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

// K10's backward form: vols [N*3,D,H,W,C] channels-last (K10's deep
// volumes, f32 or bf16, 16-byte aligned; N 3 (D + 2) (H + 2) (W + 2) <
// 2^31), proj: the inverse plane axes [3][3][3] (w indexes D); adds into
// g_vols [N*3,D,H,W,C] f32, zeroed by the caller; the rest as
// triplane_decode_grad.
PANIC3D_EXPORT int triplane_decode_deep_grad(
    const void* vols, int dtype, const float* coords, const float* w0, const float* b0,
    const float* w1, const float* b1, const void* g_rgb, const float* g_sigma,
    float* g_vols, float* partials, float* g_weights, int ctas, int quads, int N, int M, int D,
    int H, int W, int C, const float* proj, float scale, float gain0, float gain1, float lr_mul,
    int force_sigmoid, int use_crop, float crop_lim, int cull_mode, float cull_thresh,
    void* stream) {
  if (N < 1 || M < 1 || D < 1 || H < 1 || W < 1 || ctas < 1 ||
      (long long)N * 3 * (D + 2) * (H + 2) * (W + 2) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  Proj pr{};
  for (int i = 0; i < 27; ++i) (&pr.m[0][0][0])[i] = proj[i];
  const float rgb_scale = force_sigmoid ? 1.f : 1.f + 2.f * 0.001f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define P3D_K10G(T, CC)                                                                    \
  return quads != quads_of<T>()                                                            \
             ? (int)cudaErrorInvalidValue                                                  \
             : (int)launch<T, CC, true>(vols, coords, w0, b0, w1, b1, g_rgb, g_sigma,      \
                                        g_vols, partials, g_weights, ctas, N, M, D, H, W,  \
                                        pr, scale, gain0, gain1, lr_mul, rgb_scale,        \
                                        use_crop, crop_lim, cull_mode, cull_thresh, s)
  if (dtype == DT_BF16) {
    if (C == 32) P3D_K10G(__nv_bfloat16, 32);
    if (C == 16) P3D_K10G(__nv_bfloat16, 16);
    if (C == 8) P3D_K10G(__nv_bfloat16, 8);
  } else {
    if (C == 32) P3D_K10G(float, 32);
    if (C == 16) P3D_K10G(float, 16);
    if (C == 8) P3D_K10G(float, 8);
  }
#undef P3D_K10G
  return (int)cudaErrorInvalidValue;
}
