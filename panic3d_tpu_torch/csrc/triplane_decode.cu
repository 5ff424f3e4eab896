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
// What bounds K1 on the H100: with the MLP on the CUDA cores, operations
// (C*64 + 64*33 = 4,160 multiply-adds per point at C = 32, ~90 % of them the
// two layers' matrix products); with the MLP on the tensor cores, the
// instructions per point (the gather's address and lerp arithmetic, 64
// softplus and 32 sigmoids) and the latency of the random 4-corner reads
// (3 planes x 4 corners x C channels: 768 B per point in bf16 at C = 32),
// not the tensor cores or shared memory (PERF.md). Both portraits' bf16 planes
// (2 x 12.6 MB) fit in the 50 MB L2, so the corner reads are L2 hits after
// first touch. K1v reads nothing per point but the planes (one portrait's
// f32 planes, 25 MB, stay in L2) and writes 2 bytes; with the crop skip and
// the MLP on the tensor cores, its per-point work is the gather's lerps, the
// 64 hidden softplus on the SFU and the tail's libm exp and log1p.
//
// K1's design: each warp decodes tiles of 16 points (the mma's M) in a
// grid-stride loop, 8 warps a block, 2 blocks an SM (128 registers a
// thread); planes are channels-last [N,3,H,W,C]. (1) Gather: C/8 (bf16) or
// C/4 (f32) neighbouring lanes share a point, each reading one 16-byte
// channel chunk of every corner, so a corner is one coalesced request; the
// next plane's chunks are in flight while a plane's lerps run; the lerps and
// the plane mean are f32 and land in the warp's shared tile. (2) The MLP on
// the tensor cores: mma.sync m16n8k8 in TF32 with the 3xTF32 split (v = hi +
// lo, hi = cvt.rna(v)), a_lo*w_hi + a_hi*w_lo + a_hi*w_hi with f32
// accumulation, which keeps the result within f32 rounding of the plain
// version. The weights (gained) sit in shared memory already split, in
// fragment order, one 16-byte read per fragment; the bias and softplus run
// on layer 1's accumulators, and the hidden layer goes back to the warp's
// tile as layer 2's A operand (N padded from 33 to 40, sigma's row moved
// after the 32 rgb rows so that rgb channels pair up). softplus and the
// sigmoid use the SFU (ex2/lg2.approx, ~2e-7). (3) The epilogue keeps the
// density filters and the sigmoid / MipNeRF clamp; rgb is staged in the
// warp's tile in output order and leaves as contiguous 16-byte stores. bf16
// planes are upcast as they are read; all arithmetic is f32, SFU f32 or
// 3xTF32. K1v is described at its kernel (volume_density_kernel): bricks of
// 4 x 8 columns of 16 lattice points, their plane windows staged in shared
// memory, the crop skipped per brick and per column, and K1's layer 1 and
// SFU softplus with net2's sigma row as a reduction of the hidden fragments;
// it makes each point's coordinate from its flat index with the JAX
// package's f32 divisions and fmod, explicitly rounded, so the lattice is
// bit-identical to its plain version's, and stores the density in the
// flipped layout marching tetrahedra reads.
//
// K10's trilinear K1 form (triplane_decode_deep, volume_density_deep)
// replaces panic3d_tpu/ops/grid_sample.py:grid_sample_3d_points (:266) where
// the JAX package's deep-plane decode runs it (triplane_depth D > 1:
// renderer.py:run_model -> sample_from_planes' 3-D branch, :86-92, then
// OSGDecoder and the filters; eval/volume.py's density grid likewise). It
// is K1's kernel with a trilinear gather: the planes come as N*3
// channels-last volumes [N*3, D, H, W, C], each plane's point has a third
// projected coordinate that indexes D, and a lane reads its 16-byte chunk
// of the 8 corners (zeros outside the volume), lerps each z slice in x and
// y, then blends the slices, 0 + s(z0) * (1 - wz) + s(z1) * wz, in f32, as
// grid_sample_3d_points orders it. The plane mean, the 3xTF32 MLP and the
// filters are K1's, so the [N*3, M, C] feature block never reaches device
// memory. triplane_decode_deep has K1's contract (rgb and filtered sigma
// at given points). volume_density_deep, K10's lattice form, is K1v's brick
// kernel on the deep volumes: each plane's window in shared memory holds
// the depth slices its brick's corners touch (two at most at D = 2: with
// align_corners=False a lattice point's z0 lies in {-1, 0, 1}), the lerps
// read the window in grid_sample_3d_points' order, and the rest (the crop
// skip, layer 1 in 3xTF32 with the mean's 1/3 folded in, the SFU
// softplus, net2's sigma row as a reduction of the hidden fragments,
// sigma2density, the crop and the cull, the flipped grid) is K1v's. Its
// bricks are K1v's 4 x 8 columns, one block of 16 warps an SM: the
// windows' slices take twice K1v's shared memory.
#include <climits>

#include <cuda_fp16.h>

#include "common.cuh"
#include "lattice_decode.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int HIDDEN = 64;
constexpr int OUT = 33;     // sigma + 32 feature channels
constexpr int THREADS = 128;

// plane p: uv[d] = sum_c xyz[c] * a[p][c][d]; the deep planes' third
// coordinate (the volume's depth) w = sum_c xyz[c] * z[p][c]
struct Proj {
  float a[3][3][2];
  float z[3][3];
};

// proj: 18 floats [plane][xyz][uv], or with deep 27 floats [plane][xyz][uvw]
Proj make_proj(const float* proj, bool deep) {
  Proj pj{};
  const int k = deep ? 3 : 2;
  for (int p = 0; p < 3; ++p)
    for (int c = 0; c < 3; ++c) {
      for (int d = 0; d < 2; ++d) pj.a[p][c][d] = proj[(p * 3 + c) * k + d];
      if (deep) pj.z[p][c] = proj[(p * 3 + c) * k + 2];
    }
  return pj;
}

// the forms of K1's kernel: K1 (bilinear planes [N,3,H,W,C] at given
// points) and K10's trilinear form on deep volumes [N*3,D,H,W,C] at given
// points (TRILINEAR; its lattice form is the brick kernel's, below)
enum Form { BILINEAR = 0, TRILINEAR = 1 };

// ---- K1: gather, then the MLP on the tensor cores ----

constexpr int K1_WARPS = 8;     // warps per block; each warp runs its own tiles
constexpr int K1_BLOCKS = 2;    // resident blocks per SM: 128 registers a thread
constexpr int PTS = 16;         // points per warp tile: the mma's M
constexpr int N2 = 40;          // net2's 33 outputs padded to 5 n-tiles of 8
constexpr int SIGMA_COL = 32;   // net2's sigma row sits after its 32 rgb rows
constexpr int HS = HIDDEN + 4;  // hidden row stride (+ 4: conflict-free A reads)
constexpr int RS_BYTES = 32 * 4 + 32;   // staged rgb row stride, f32 (+ 32 B: fewer conflicts)
// a warp's floats: its features [PTS][C + 4], in their place its hidden
// layer [PTS][HS], in its place its staged rgb; then the sigmas
constexpr int REGION = PTS * HS + PTS;

// the sigmoid on the SFU (ex2.approx and a fast divide), as softplus_fast
__device__ __forceinline__ float sigmoid_fast(float x) {
  return __fdividef(1.f, 1.f + __expf(-x));
}

// net2's row in padded output column c: rgb channel c (row c + 1) for
// c < 32, sigma (row 0) in column SIGMA_COL, -1 (zero) in the padding
__device__ __forceinline__ int net2_row(int c) {
  return c < SIGMA_COL ? c + 1 : c == SIGMA_COL ? 0 : -1;
}

// layer 1's B fragments (gains applied, split) into w0f: fragment
// [k-step][n-tile][lane] holds, for lane = 4g + t, B[t][g] and B[t+4][g] of
// the 8x8 block, B[k][n] = w0[8nt+n][8ks+k]; the block's threads share the
// work (K1 and K1v)
template <int C>
__device__ __forceinline__ void load_w0_fragments(uint4 (*w0f)[HIDDEN / 8][32],
                                                  const float* __restrict__ w0, float g0) {
  constexpr int KS1 = C / 8, NT1 = HIDDEN / 8;
  for (int i = threadIdx.x; i < KS1 * NT1 * 32; i += blockDim.x) {
    const int lane = i & 31, nt = (i >> 5) % NT1, ks = i / (32 * NT1);
    const float* row = w0 + (nt * 8 + (lane >> 2)) * C + ks * 8 + (lane & 3);
    w0f[ks][nt][lane] = split_pair(row[0] * g0, row[4] * g0);
  }
}

// FC(C->64) of a warp's 16 points, features tile[point][FS], in 3xTF32:
// h[nt] holds rows g, g+8 and columns 8nt+2t, 8nt+2t+1 (K1 and K1v)
template <int C, int FS>
__device__ __forceinline__ void layer1(const float* tile, const uint4 (*w0f)[HIDDEN / 8][32],
                                       int lane, float h[HIDDEN / 8][4]) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < HIDDEN / 8; ++nt) h[nt][0] = h[nt][1] = h[nt][2] = h[nt][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < C / 8; ++ks) {
    uint32_t hi[4], lo[4];
    load_a(tile + ks * 8 + t, g, FS, hi, lo);
#pragma unroll
    for (int nt = 0; nt < HIDDEN / 8; ++nt) mma_3xtf32(h[nt], hi, lo, w0f[ks][nt][lane]);
  }
}

// two neighbouring channels, rounded to T, as one store
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// the decoder in shared memory as mma B fragments (gains applied, split).
// Fragment [k-step][n-tile][lane] holds, for lane = 4g + t, B[t][g] and
// B[t+4][g] of the 8x8 block: B[k][n] = w0[8nt+n][8ks+k] (layer 1) and
// w1[net2_row(8nt+n)][8ks+k] (layer 2).
template <int C>
struct K1Smem {
  uint4 w0f[C / 8][HIDDEN / 8][32];
  uint4 w1f[HIDDEN / 8][N2 / 8][32];
  float b0[HIDDEN];
  float b1[N2];
  float tile[K1_WARPS][REGION];
};

__device__ __forceinline__ void unpack(const uint4& r, float* v, const float*) {
  v[0] = __uint_as_float(r.x); v[1] = __uint_as_float(r.y);
  v[2] = __uint_as_float(r.z); v[3] = __uint_as_float(r.w);
}

__device__ __forceinline__ void unpack(const uint4& r, float* v, const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// one plane's bilinear corners for a point: the 16-byte chunk at channel c0
// of each corner (zeros outside the plane) and the lerp weights
struct Corners {
  uint4 v[4];   // (y0, x0), (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 + 1)
  float wx, wy;
};

template <typename T, int C>
__device__ __forceinline__ Corners plane_corners(const T* __restrict__ planes, int n, int p,
                                                 int H, int W, const Proj& pj, float sx,
                                                 float sy, float sz, int c0) {
  Corners k;
  const float gx = sx * pj.a[p][0][0] + sy * pj.a[p][1][0] + sz * pj.a[p][2][0];
  const float gy = sx * pj.a[p][0][1] + sy * pj.a[p][1][1] + sz * pj.a[p][2][1];
  const float ix = ((gx + 1.f) * (float)W - 1.f) / 2.f;
  const float iy = ((gy + 1.f) * (float)H - 1.f) / 2.f;
  const float fx0 = floorf(ix), fy0 = floorf(iy);
  k.wx = ix - fx0;
  k.wy = iy - fy0;
  const int x0 = (int)fx0, y0 = (int)fy0;
  const bool vx0 = x0 >= 0 && x0 < W, vx1 = x0 + 1 >= 0 && x0 + 1 < W;
  const bool vy0 = y0 >= 0 && y0 < H, vy1 = y0 + 1 >= 0 && y0 + 1 < H;
  const T* r00 = planes + ((long long)(n * 3 + p) * H * W + (long long)y0 * W + x0) * C + c0;
  const T* r10 = r00 + (long long)W * C;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  k.v[0] = vy0 && vx0 ? __ldg(reinterpret_cast<const uint4*>(r00)) : zero;
  k.v[1] = vy0 && vx1 ? __ldg(reinterpret_cast<const uint4*>(r00 + C)) : zero;
  k.v[2] = vy1 && vx0 ? __ldg(reinterpret_cast<const uint4*>(r10)) : zero;
  k.v[3] = vy1 && vx1 ? __ldg(reinterpret_cast<const uint4*>(r10 + C)) : zero;
  return k;
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

// one deep plane's trilinear sample for a point, added to feat: the CH
// channels at c0 of plane p's volume [D,H,W,C] (zeros padding). The order is
// ops/grid_sample.py:grid_sample_3d_points': per z slice the xy lerps of
// grid_sample_2d_points, then 0 + s(z0) * (1 - wz) + s(z1) * wz.
template <typename T, int C>
__device__ __forceinline__ void deep_plane_sample(const T* __restrict__ vols, int n, int p,
                                                  int D, int H, int W, const Proj& pj,
                                                  float sx, float sy, float sz, int c0,
                                                  float* feat) {
  constexpr int CH = 16 / (int)sizeof(T);
  const float gx = sx * pj.a[p][0][0] + sy * pj.a[p][1][0] + sz * pj.a[p][2][0];
  const float gy = sx * pj.a[p][0][1] + sy * pj.a[p][1][1] + sz * pj.a[p][2][1];
  const float gz = sx * pj.z[p][0] + sy * pj.z[p][1] + sz * pj.z[p][2];
  const float ix = ((gx + 1.f) * (float)W - 1.f) / 2.f;
  const float iy = ((gy + 1.f) * (float)H - 1.f) / 2.f;
  const float iz = ((gz + 1.f) * (float)D - 1.f) / 2.f;
  const float fx0 = floorf(ix), fy0 = floorf(iy), fz0 = floorf(iz);
  const float wx = ix - fx0, wy = iy - fy0, wz = iz - fz0;
  // clamped before the conversion, so that far-out points convert safely
  // (a lower corner below -1 or past the last texel is outside either way)
  const int x0 = (int)fminf(fmaxf(fx0, -2.f), (float)W);
  const int y0 = (int)fminf(fmaxf(fy0, -2.f), (float)H);
  const int z0 = (int)fminf(fmaxf(fz0, -2.f), (float)D);
  const bool vx0 = x0 >= 0 && x0 < W, vx1 = x0 + 1 >= 0 && x0 + 1 < W;
  const bool vy0 = y0 >= 0 && y0 < H, vy1 = y0 + 1 >= 0 && y0 + 1 < H;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint4 r[2][4];
#pragma unroll
  for (int dz = 0; dz < 2; ++dz) {
    const int z = z0 + dz;
    const bool vz = z >= 0 && z < D;
    const T* r00 = vols + ((((long long)(n * 3 + p) * D + z) * H + y0) * W + x0) * C + c0;
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
    unpack(r[dz][0], v00, vols);
    unpack(r[dz][1], v01, vols);
    unpack(r[dz][2], v10, vols);
    unpack(r[dz][3], v11, vols);
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

// the plane-mean features of the warp's PTS points [t0, t0 + PTS) into
// tile[point][C + 4] (zeros past the end). A point is served by C / CH
// neighbouring lanes, each reading one 16-byte chunk of CH channels of every
// corner, so a corner's C channels are one coalesced request; the next
// plane's four chunks are in flight while a plane's lerps run. The lerps and
// their order are ops/grid_sample.py:grid_sample_2d_points' (align_corners=
// False, zeros padding), then the plane mean, ((p0 + p1) + p2) / 3. The
// trilinear form reads the deep volumes instead (deep_plane_sample, one
// plane at a time: its 8 chunks are in flight together).
template <typename T, int C, int FORM>
__device__ __forceinline__ void gather_tile(const T* __restrict__ planes,
                                            const float* __restrict__ coords, long long t0,
                                            long long total, int M, int D, int H, int W,
                                            const Proj& pj,
                                            float coord_scale, int lane, float* tile) {
  constexpr int CH = 16 / (int)sizeof(T);    // channels per chunk
  constexpr int TPP = C / CH;                // lanes per point
  constexpr int PPP = 32 / TPP;              // points per pass
  constexpr int PASSES = (PTS + PPP - 1) / PPP;
  constexpr int FS = C + 4;
  const int cc = lane % TPP;
#pragma unroll 1   // one point per lane at a time: registers stay <= 128
  for (int pass = 0; pass < PASSES; ++pass) {
    const int lp = pass * PPP + lane / TPP;
    if (lp >= PTS) continue;
    const long long pt = t0 + lp;
    float feat[CH];
#pragma unroll
    for (int c = 0; c < CH; ++c) feat[c] = 0.f;
    if constexpr (FORM == TRILINEAR) {
      if (pt < total) {
        const int n = (int)(pt / M);
        const float x = coords[pt * 3 + 0], y = coords[pt * 3 + 1], z = coords[pt * 3 + 2];
#pragma unroll
        for (int p = 0; p < 3; ++p)
          deep_plane_sample<T, C>(planes, n, p, D, H, W, pj, coord_scale * x,
                                  coord_scale * y, coord_scale * z, cc * CH, feat);
#pragma unroll
        for (int c = 0; c < CH; ++c) feat[c] = feat[c] / 3.f;
      }
    } else if (pt < total) {
      const int n = (int)(pt / M);
      const float sx = coord_scale * coords[pt * 3 + 0];
      const float sy = coord_scale * coords[pt * 3 + 1];
      const float sz = coord_scale * coords[pt * 3 + 2];
      Corners cur = plane_corners<T, C>(planes, n, 0, H, W, pj, sx, sy, sz, cc * CH);
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        Corners nxt;
        if (p < 2) nxt = plane_corners<T, C>(planes, n, p + 1, H, W, pj, sx, sy, sz, cc * CH);
        float v00[CH], v01[CH], v10[CH], v11[CH];
        unpack(cur.v[0], v00, planes);
        unpack(cur.v[1], v01, planes);
        unpack(cur.v[2], v10, planes);
        unpack(cur.v[3], v11, planes);
#pragma unroll
        for (int k = 0; k < CH; ++k) {
          const float top = v00[k] + (v01[k] - v00[k]) * cur.wx;
          const float bot = v10[k] + (v11[k] - v10[k]) * cur.wx;
          feat[k] += top + (bot - top) * cur.wy;
        }
        if (p < 2) cur = nxt;
      }
#pragma unroll
      for (int c = 0; c < CH; ++c) feat[c] = feat[c] / 3.f;
    }
    float4* dst = reinterpret_cast<float4*>(tile + lp * FS + cc * CH);
#pragma unroll
    for (int q = 0; q < CH / 4; ++q)
      dst[q] = make_float4(feat[4 * q], feat[4 * q + 1], feat[4 * q + 2], feat[4 * q + 3]);
  }
}

template <typename T, int C, int FORM>
__global__ void __launch_bounds__(32 * K1_WARPS, K1_BLOCKS) triplane_decode_kernel(
    const T* __restrict__ planes, const float* __restrict__ coords,
    const float* __restrict__ w0, const float* __restrict__ b0,
    const float* __restrict__ w1, const float* __restrict__ b1,
    T* __restrict__ rgb, float* __restrict__ sigma_out,
    int N, int M, int H, int W, Proj pj, float coord_scale, float g0, float g1,
    float bias_scale, int force_sigmoid, int use_crop, float crop_lim,
    int cull_mode, float cull_thresh, int D) {
  constexpr int FS = C + 4;
  constexpr int NT1 = HIDDEN / 8, KS2 = HIDDEN / 8, NT2 = N2 / 8;
  extern __shared__ uint4 smem_raw[];
  K1Smem<C>& s = *reinterpret_cast<K1Smem<C>*>(smem_raw);
  load_w0_fragments<C>(s.w0f, w0, g0);
  for (int i = threadIdx.x; i < KS2 * NT2 * 32; i += blockDim.x) {
    const int lane = i & 31, nt = (i >> 5) % NT2, ks = i / (32 * NT2);
    const int o = net2_row(nt * 8 + (lane >> 2));
    const float* row = w1 + o * HIDDEN + ks * 8 + (lane & 3);
    s.w1f[ks][nt][lane] = o >= 0 ? split_pair(row[0] * g1, row[4] * g1)
                                 : make_uint4(0u, 0u, 0u, 0u);
  }
  for (int i = threadIdx.x; i < HIDDEN; i += blockDim.x) s.b0[i] = b0[i] * bias_scale;
  for (int i = threadIdx.x; i < N2; i += blockDim.x)
    s.b1[i] = net2_row(i) >= 0 ? b1[net2_row(i)] * bias_scale : 0.f;
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float* tile = s.tile[warp];
  const long long total = (long long)N * M;
  for (long long t0 = ((long long)blockIdx.x * K1_WARPS + warp) * PTS; t0 < total;
       t0 += (long long)gridDim.x * K1_WARPS * PTS) {
    gather_tile<T, C, FORM>(planes, coords, t0, total, M, D, H, W, pj, coord_scale, lane,
                            tile);
    __syncwarp();

    // FC(C->64): hidden [16 x 64] in 8 n-tiles; the lane holds rows g, g+8
    // and columns 8nt+2t, 8nt+2t+1
    {
      float h[NT1][4];
      layer1<C, FS>(tile, s.w0f, lane, h);
      __syncwarp();   // the features are read: the hidden layer takes their place
      // bias and softplus, then the hidden layer to the warp's region as
      // layer 2's A operand
#pragma unroll
      for (int nt = 0; nt < NT1; ++nt) {
        const float2 bb = *reinterpret_cast<const float2*>(&s.b0[nt * 8 + 2 * t]);
        float* r = tile + g * HS + nt * 8 + 2 * t;
        *reinterpret_cast<float2*>(r) =
            make_float2(softplus_fast(h[nt][0] + bb.x), softplus_fast(h[nt][1] + bb.y));
        *reinterpret_cast<float2*>(r + 8 * HS) =
            make_float2(softplus_fast(h[nt][2] + bb.x), softplus_fast(h[nt][3] + bb.y));
      }
    }
    __syncwarp();

    // FC(64->33, padded to 40; rgb in columns 0-31, sigma in column 32)
    float o[NT2][4];
#pragma unroll
    for (int nt = 0; nt < NT2; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS2; ++ks) {
      uint32_t hi[4], lo[4];
      load_a(tile + ks * 8 + t, g, HS, hi, lo);
#pragma unroll
      for (int nt = 0; nt < NT2; ++nt) mma_3xtf32(o[nt], hi, lo, s.w1f[ks][nt][lane]);
    }
    __syncwarp();   // the hidden layer is read: the region takes the outputs next

    // epilogue: rgb's sigmoid (or the MipNeRF clamp), staged in the points'
    // order as pairs of channels, then written as 16-byte stores; sigma's
    // filters
    char* rgb_s = reinterpret_cast<char*>(tile);
    constexpr int RS = RS_BYTES / 4 * (int)sizeof(T);   // staged row stride, bytes
    float* sig_s = tile + PTS * HS;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = g + 8 * half;
#pragma unroll
      for (int nt = 0; nt < NT2 - 1; ++nt) {
        const int col = nt * 8 + 2 * t;
        float a = sigmoid_fast(o[nt][2 * half] + s.b1[col]);
        float b = sigmoid_fast(o[nt][2 * half + 1] + s.b1[col + 1]);
        if (!force_sigmoid) {
          a = a * 1.002f - 0.001f;
          b = b * 1.002f - 0.001f;
        }
        store2(reinterpret_cast<T*>(rgb_s + row * RS) + col, a, b);
      }
      const long long pt = t0 + row;
      if (t == 0 && pt < total)
        sig_s[row] = density_filters(o[NT2 - 1][2 * half] + s.b1[SIGMA_COL], coords[pt * 3],
                                     coords[pt * 3 + 2], use_crop, crop_lim, cull_mode,
                                     cull_thresh);
    }
    __syncwarp();
    const int valid = (int)min((long long)PTS, total - t0);
    constexpr int U = (OUT - 1) * (int)sizeof(T) / 16;   // 16-byte chunks per point
    uint4* dst = reinterpret_cast<uint4*>(rgb + t0 * (OUT - 1));
    for (int i = lane; i < valid * U; i += 32)
      dst[i] = reinterpret_cast<const uint4*>(rgb_s + (i / U) * RS)[i % U];
    if (lane < valid) sigma_out[t0 + lane] = sig_s[lane];
    __syncwarp();   // the outputs are read before the next tile's features land
  }
}

template <typename T, int C, int FORM = BILINEAR>
cudaError_t launch(const void* planes, const float* coords, const float* w0,
                   const float* b0, const float* w1, const float* b1, void* rgb,
                   float* sigma, int N, int M, int H, int W, const Proj& pj,
                   float coord_scale, float g0, float g1, float bias_scale,
                   int force_sigmoid, int use_crop, float crop_lim, int cull_mode,
                   float cull_thresh, cudaStream_t stream, int D = 1) {
  // above 48 KB of shared memory a block must ask for it (once per kernel)
  static const cudaError_t attr = cudaFuncSetAttribute(
      triplane_decode_kernel<T, C, FORM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(K1Smem<C>));
  if (attr != cudaSuccess) return attr;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long total = (long long)N * M;
  const long long tiles = (total + PTS - 1) / PTS;
  long long blocks = (tiles + K1_WARPS - 1) / K1_WARPS;
  if (blocks > (long long)K1_BLOCKS * sms) blocks = (long long)K1_BLOCKS * sms;
  if (blocks < 1) blocks = 1;
  triplane_decode_kernel<T, C, FORM>
      <<<(unsigned)blocks, 32 * K1_WARPS, sizeof(K1Smem<C>), stream>>>(
          static_cast<const T*>(planes), coords, w0, b0, w1, b1, static_cast<T*>(rgb),
          sigma, N, M, H, W, pj, coord_scale, g0, g1, bias_scale, force_sigmoid,
          use_crop, crop_lim, cull_mode, cull_thresh, D);
  return cudaGetLastError();
}

// ---- K1v and K10's lattice form: bricks of the lattice, plane windows in shared memory ----

constexpr int V_BZ = 16;   // z points of a column: one warp tile (PTS)
constexpr int V_BX = 4;    // columns of a brick in x

// A brick: V_BX x V_BY columns of V_BZ points. K1v's (DEEP false) has 8
// warps, two blocks an SM, and its three plane windows take at most POOL
// texels together (6 x 10 + 6 x 18 + 10 x 18 = 348 at N = H = W = 256).
// K10's lattice form (DEEP) stages each window's depth slices too, up to
// twice the texels at D = 2 ((6 x 10 + 6 x 18 + 10 x 18) x 2 = 696 texel
// slices at most): one block of 16 warps fills an SM. Bricks of 4 x 4
// columns (504 texel slices, two blocks of 8 warps an SM) read 10-20 %
// slower on an H100 (PERF.md): half the points share each brick's fixed
// work (the corners, the windows' bounds, the staging, three barriers).
constexpr int V_BY = 8;    // columns of a brick in y
template <bool DEEP>
struct Brick {
  static constexpr int POINTS = V_BZ * V_BY * V_BX;        // points of a brick
  static constexpr int POOL = DEEP ? 768 : 384;           // texels (x slices)
  static constexpr int BLOCKS = DEEP ? 1 : 2;              // resident blocks per SM
  static constexpr int WARPS = 16 / BLOCKS;                // 16 warps an SM
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int COLS = V_BX * V_BY / WARPS;         // columns a warp, two at a time
  static_assert(COLS % 2 == 0, "a warp decodes its columns in pairs");
};

// align_corners=False texel coordinate of plane coordinate g on an axis of
// `size` texels, rounded op by op as the plain version computes it (the
// halving as a multiply by 0.5: the same correctly rounded value as / 2)
__device__ __forceinline__ float texel_coord(float g, int size) {
  return __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(g, 1.f), (float)size), 1.f), 0.5f);
}

// one channel's bilinear lerp, in gather_tile's order
__device__ __forceinline__ float bilerp(float v00, float v01, float v10, float v11, float wx,
                                        float wy) {
  const float top = v00 + (v01 - v00) * wx;
  const float bot = v10 + (v11 - v10) * wx;
  return top + (bot - top) * wy;
}

// a deep corner (x0, y0, z0), each in [-2, 1021], as one int
__device__ __forceinline__ int pack_corner(int x0, int y0, int z0) {
  return (x0 + 2) | (y0 + 2) << 10 | (z0 + 2) << 20;
}

template <int C, bool DEEP>
struct VolSmem {
  uint4 w0f[C / 8][HIDDEN / 8][32];   // layer 1, gains and the plane mean's 1/3 applied
  float b0[HIDDEN];
  float w1[HIDDEN];        // net2's sigma row, gained
  float b1;
  // per plane over the brick: min x0, y0 (and z0 at depth), then from [4]
  // the max of each
  int win[3][8];
  int woff[3];             // per plane: its window's first texel in the pool, -1 if not staged
  int zs[3];               // DEEP: per plane, its window's first depth slice
  // per plane and point: x0, y0 and the bits of wx, wy; DEEP: pack_corner
  // (x0, y0, z0) and the bits of wx, wy, wz
  int4 info[3][Brick<DEEP>::POINTS];
  unsigned char flags[Brick<DEEP>::POINTS];   // bit 0: in the lattice; bit 1: kept by the crop
  alignas(16) float tile[Brick<DEEP>::WARPS][PTS * (C + 4)];
  float sigma[Brick<DEEP>::WARPS][2 * V_BZ];   // a warp's sigmas of two columns
  // then the plane windows, Brick::POOL texels (texel slices) of C floats
};

// the plane sums of one column's 16 points (brick points base .. base + 15)
// into tile[point][C + 4], zeros for points outside the lattice; the
// corners come from the plane windows in the pool (window p's texel (y, x)
// at woff[p] + (y - y_lo) * width + x - x_lo), or from the planes for a
// plane whose window was not staged. The mapping, the lerps and their
// order are K1's gather_tile; the mean's 1/3 is in layer 1's weights.
template <int C>
__device__ __forceinline__ void gather_column(const VolSmem<C, false>& s,
                                              const float* pool,
                                              const float* __restrict__ planes, int H, int W,
                                              int base, int lane, float* tile) {
  constexpr int TPP = C / 4;          // lanes per point, one 16-byte chunk each
  constexpr int PPP = 32 / TPP;       // points per pass
  constexpr int FS = C + 4;
  const int cc = lane % TPP;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  // each window's width, and the pool offset of the texel (0, 0) in its
  // frame (-1 width: read from the planes)
  int ww[3], org[3];
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    ww[p] = s.woff[p] >= 0 ? s.win[p][4] - s.win[p][0] + 2 : -1;
    org[p] = (s.woff[p] - s.win[p][1] * ww[p] - s.win[p][0]) * C + cc * 4;
  }
  // plane 0 (x, y) barely moves along a column (the lattice's shear): a
  // lane keeps its last four plane-0 corners and reads them again only
  // where the corner changes
  int k0x = INT_MIN, k0y = INT_MIN;
  float4 k00 = zero, k01 = zero, k10 = zero, k11 = zero;
#pragma unroll 1
  for (int pass = 0; pass < PTS / PPP; ++pass) {
    const int lp = pass * PPP + lane / TPP;
    const int pt = base + lp;
    float4 feat = zero;
    if (s.flags[pt] & 1) {
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        const int4 in = s.info[p][pt];
        const float wx = __int_as_float(in.z), wy = __int_as_float(in.w);
        float4 v00, v01, v10, v11;
        if (p == 0 && in.x == k0x && in.y == k0y) {
          v00 = k00;
          v01 = k01;
          v10 = k10;
          v11 = k11;
        } else if (ww[p] > 0) {
          const float* r = pool + org[p] + (in.y * ww[p] + in.x) * C;
          v00 = *reinterpret_cast<const float4*>(r);
          v01 = *reinterpret_cast<const float4*>(r + C);
          v10 = *reinterpret_cast<const float4*>(r + ww[p] * C);
          v11 = *reinterpret_cast<const float4*>(r + ww[p] * C + C);
        } else {
          const bool vx0 = in.x >= 0 && in.x < W, vx1 = in.x + 1 >= 0 && in.x + 1 < W;
          const bool vy0 = in.y >= 0 && in.y < H, vy1 = in.y + 1 >= 0 && in.y + 1 < H;
          const float* r00 = planes + (((long long)p * H + in.y) * W + in.x) * C + cc * 4;
          const float* r10 = r00 + (long long)W * C;
          v00 = vy0 && vx0 ? __ldg(reinterpret_cast<const float4*>(r00)) : zero;
          v01 = vy0 && vx1 ? __ldg(reinterpret_cast<const float4*>(r00 + C)) : zero;
          v10 = vy1 && vx0 ? __ldg(reinterpret_cast<const float4*>(r10)) : zero;
          v11 = vy1 && vx1 ? __ldg(reinterpret_cast<const float4*>(r10 + C)) : zero;
        }
        if (p == 0) {
          k0x = in.x;
          k0y = in.y;
          k00 = v00;
          k01 = v01;
          k10 = v10;
          k11 = v11;
        }
        feat.x += bilerp(v00.x, v01.x, v10.x, v11.x, wx, wy);
        feat.y += bilerp(v00.y, v01.y, v10.y, v11.y, wx, wy);
        feat.z += bilerp(v00.z, v01.z, v10.z, v11.z, wx, wy);
        feat.w += bilerp(v00.w, v01.w, v10.w, v11.w, wx, wy);
      }
    }
    *reinterpret_cast<float4*>(tile + lp * FS + cc * 4) = feat;
  }
}

// one deep plane's 8 corner chunks for a point (in: its info): from the
// plane's window (rs, ss: its row and slice strides in floats, 0 when the
// window was not staged; org: the pool offset of the texel (0, 0, 0) in its
// frame, this lane's chunk included) or else from the volume; a slice
// outside the volume reads zeros (the zeros padding)
template <int C>
__device__ __forceinline__ void deep_corners(const float* pool,
                                             const float* __restrict__ vols, int D, int H,
                                             int W, int p, int cc, int rs, int ss, int org,
                                             int corner, float4 v[2][4]) {
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const int x0 = (corner & 1023) - 2, y0 = (corner >> 10 & 1023) - 2, z0 = (corner >> 20) - 2;
#pragma unroll
  for (int dz = 0; dz < 2; ++dz) {
    const int z = z0 + dz;
    if (z < 0 || z >= D) {
#pragma unroll
      for (int c = 0; c < 4; ++c) v[dz][c] = zero;
    } else if (rs) {
      const float* r = pool + org + z * ss + y0 * rs + x0 * C;
      v[dz][0] = *reinterpret_cast<const float4*>(r);
      v[dz][1] = *reinterpret_cast<const float4*>(r + C);
      v[dz][2] = *reinterpret_cast<const float4*>(r + rs);
      v[dz][3] = *reinterpret_cast<const float4*>(r + rs + C);
    } else {
      const bool vx0 = x0 >= 0 && x0 < W, vx1 = x0 + 1 >= 0 && x0 + 1 < W;
      const bool vy0 = y0 >= 0 && y0 < H, vy1 = y0 + 1 >= 0 && y0 + 1 < H;
      const float* r00 = vols + ((((long long)p * D + z) * H + y0) * W + x0) * C + cc * 4;
      const float* r10 = r00 + (long long)W * C;
      v[dz][0] = vy0 && vx0 ? __ldg(reinterpret_cast<const float4*>(r00)) : zero;
      v[dz][1] = vy0 && vx1 ? __ldg(reinterpret_cast<const float4*>(r00 + C)) : zero;
      v[dz][2] = vy1 && vx0 ? __ldg(reinterpret_cast<const float4*>(r10)) : zero;
      v[dz][3] = vy1 && vx1 ? __ldg(reinterpret_cast<const float4*>(r10 + C)) : zero;
    }
  }
}

// one deep plane's sample of a lane's 4 channels from its corners, added to
// feat: per slice the xy lerps, then 0 + s(z0) (1 - wz) + s(z1) wz
__device__ __forceinline__ void deep_lerp(const float4 v[2][4], float wx, float wy, float wz,
                                          float4& feat) {
  float4 smp = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int dz = 0; dz < 2; ++dz) {
    const float wzz = dz ? wz : 1.f - wz;
    smp.x += bilerp(v[dz][0].x, v[dz][1].x, v[dz][2].x, v[dz][3].x, wx, wy) * wzz;
    smp.y += bilerp(v[dz][0].y, v[dz][1].y, v[dz][2].y, v[dz][3].y, wx, wy) * wzz;
    smp.z += bilerp(v[dz][0].z, v[dz][1].z, v[dz][2].z, v[dz][3].z, wx, wy) * wzz;
    smp.w += bilerp(v[dz][0].w, v[dz][1].w, v[dz][2].w, v[dz][3].w, wx, wy) * wzz;
  }
  feat.x += smp.x;
  feat.y += smp.y;
  feat.z += smp.z;
  feat.w += smp.w;
}

// K10's form of gather_column: each plane's trilinear sample from its
// window of depth slices (window p's texel (z, y, x) at woff[p] + ((z -
// zs[p]) * height + y - y_lo) * width + x - x_lo), or from the volumes
// [3,D,H,W,C] for a window that was not staged. The order is
// deep_plane_sample's (grid_sample_3d_points'): per slice the xy lerps,
// then 0 + s(z0) (1 - wz) + s(z1) wz; the plane sums, then the mean's 1/3
// in layer 1's weights. Plane 0's (x0, y0) barely moves along a column and
// its z0 changes at most once in 16 points: a lane keeps its last 8
// plane-0 corners.
template <int C>
__device__ __forceinline__ void gather_column_deep(const VolSmem<C, true>& s,
                                                   const float* pool,
                                                   const float* __restrict__ vols, int D,
                                                   int H, int W, int base, int lane,
                                                   float* tile) {
  constexpr int TPP = C / 4, PPP = 32 / TPP, FS = C + 4;
  const int cc = lane % TPP;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  int rs[3], ss[3], org[3];
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const int ww = s.win[p][4] - s.win[p][0] + 2, wh = s.win[p][5] - s.win[p][1] + 2;
    rs[p] = s.woff[p] >= 0 ? ww * C : 0;
    ss[p] = rs[p] * wh;
    org[p] = s.woff[p] * C - s.zs[p] * ss[p] - s.win[p][1] * rs[p] - s.win[p][0] * C + cc * 4;
  }
  int key0 = INT_MIN;
  float4 k[2][4];
#pragma unroll
  for (int dz = 0; dz < 2; ++dz)
#pragma unroll
    for (int c = 0; c < 4; ++c) k[dz][c] = zero;
#pragma unroll 1
  for (int pass = 0; pass < PTS / PPP; ++pass) {
    const int lp = pass * PPP + lane / TPP;
    const int pt = base + lp;
    float4 feat = zero;
    if (s.flags[pt] & 1) {
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        const int4 in = s.info[p][pt];
        float4 v[2][4];
        if (p == 0 && in.x == key0) {
#pragma unroll
          for (int dz = 0; dz < 2; ++dz)
#pragma unroll
            for (int c = 0; c < 4; ++c) v[dz][c] = k[dz][c];
        } else {
          deep_corners<C>(pool, vols, D, H, W, p, cc, rs[p], ss[p], org[p], in.x, v);
          if (p == 0) {
            key0 = in.x;
#pragma unroll
            for (int dz = 0; dz < 2; ++dz)
#pragma unroll
              for (int c = 0; c < 4; ++c) k[dz][c] = v[dz][c];
          }
        }
        deep_lerp(v, __int_as_float(in.y), __int_as_float(in.z), __int_as_float(in.w), feat);
      }
    }
    *reinterpret_cast<float4*>(tile + lp * FS + cc * 4) = feat;
  }
}

// K1v, and with DEEP K10's lattice form. A block walks bricks of V_BX x V_BY
// columns of 16 z-points (the flat index's fastest axis). Per brick: (1)
// the threads make each point's lattice point (lattice_point, bit for bit),
// its crop decision and, per plane, its corner (x0, y0; at depth z0 too)
// and weights, into shared memory; the block reduces the corners to each
// plane's window, [min x0, max x0 + 1] x [min y0, max y0 + 1] (at depth
// times the slices of [min z0, max z0 + 1] inside the volume). (2) A brick
// with no point kept by the crop writes -1e3 and decodes nothing. (3) The
// windows go to shared memory by cp.async (zeros outside the plane: the
// zeros padding), into one pool; a window that no longer fits is read from
// the planes. (4) Each warp decodes its columns as K1 does (a column with
// no kept point is skipped): the gather of the plane sums from the windows
// (gather_column, gather_column_deep), layer 1 in 3xTF32 on the tensor
// cores with the mean's 1/3 folded into its weights, softplus on the SFU on
// the accumulators, and net2's sigma row as a 64-wide dot of the hidden
// fragments reduced across each quad; then, for two columns at once, a
// lane a point, sigma2density and the cull (libm: the cull decides on the
// last ulps of expf) and the store into the flipped grid. The cropped
// points are written -1e3 in (1), as the crop would leave them. planes:
// [3,H,W,C], or at depth the volumes [3,D,H,W,C]. stats (may be null):
// bricks skipped by the crop, columns skipped in the bricks decoded, planes
// of decoded bricks read from the planes because their window did not fit.
template <int C, bool DEEP>
__global__ void __launch_bounds__((Brick<DEEP>::THREADS), (Brick<DEEP>::BLOCKS))
volume_density_kernel(
    const float* __restrict__ planes, const float* __restrict__ w0,
    const float* __restrict__ b0, const float* __restrict__ w1,
    const float* __restrict__ b1, void* __restrict__ out, int out_f16, int N, int D, int H,
    int W, Proj pj, float coord_scale, float g0, float g1, float bias_scale, float voxel,
    float origin, int use_crop, float crop_lim, int use_cull, float cull_thresh,
    int* __restrict__ stats) {
  using B = Brick<DEEP>;
  constexpr int FS = C + 4;
  constexpr int NT1 = HIDDEN / 8;
  constexpr int NA = DEEP ? 3 : 2;   // corner axes: x0, y0 (and z0)
  extern __shared__ uint4 smem_raw[];
  VolSmem<C, DEEP>& s = *reinterpret_cast<VolSmem<C, DEEP>*>(smem_raw);
  float* pool =
      reinterpret_cast<float*>(reinterpret_cast<char*>(smem_raw) + sizeof(VolSmem<C, DEEP>));
  load_w0_fragments<C>(s.w0f, w0, g0 / 3.f);
  for (int i = threadIdx.x; i < HIDDEN; i += blockDim.x) {
    s.b0[i] = b0[i] * bias_scale;
    s.w1[i] = w1[i] * g1;
  }
  if (threadIdx.x == 0) s.b1 = b1[0] * bias_scale;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int nbz = (N + V_BZ - 1) / V_BZ, nby = (N + V_BY - 1) / V_BY;
  const int nbx = (N + V_BX - 1) / V_BX;
  const long long NN = (long long)N * N, bricks = (long long)nbz * nby * nbx;
  for (long long brick = blockIdx.x; brick < bricks; brick += gridDim.x) {
    const int bz = (int)(brick % nbz), by = (int)(brick / nbz % nby);
    const int bx = (int)(brick / ((long long)nbz * nby));
    __syncthreads();   // the previous brick is decoded (its windows and bounds read)
    if (tid < 24) s.win[tid >> 3][tid & 7] = (tid & 4) ? INT_MIN : INT_MAX;
    __syncthreads();   // the bounds are reset

    // (1) the brick's points, B::POINTS / B::THREADS a thread
    int lo[3][NA], hi[3][NA];
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int a = 0; a < NA; ++a) lo[p][a] = INT_MAX, hi[p][a] = INT_MIN;
    bool any_kept = false;
#pragma unroll 1
    for (int pt = tid; pt < B::POINTS; pt += B::THREADS) {
      const int xi = bx * V_BX + pt / (V_BZ * V_BY), yi = by * V_BY + pt / V_BZ % V_BY;
      const int zi = bz * V_BZ + pt % V_BZ;
      const bool valid = xi < N && yi < N && zi < N;
      bool kept = false;
      if (valid) {
        float x, y, z;
        lattice_point(((long long)xi * N + yi) * N + zi, N, voxel, origin, x, y, z);
        kept = !use_crop || (fabsf(x) <= crop_lim && fabsf(z) <= crop_lim);
        const float sx = coord_scale * x, sy = coord_scale * y, sz = coord_scale * z;
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          const float gx = sx * pj.a[p][0][0] + sy * pj.a[p][1][0] + sz * pj.a[p][2][0];
          const float gy = sx * pj.a[p][0][1] + sy * pj.a[p][1][1] + sz * pj.a[p][2][1];
          const float ix = texel_coord(gx, W), iy = texel_coord(gy, H);
          const float fx0 = floorf(ix), fy0 = floorf(iy);
          int c[NA];
          if constexpr (DEEP) {
            const float gz = sx * pj.z[p][0] + sy * pj.z[p][1] + sz * pj.z[p][2];
            const float iz = texel_coord(gz, D);
            const float fz0 = floorf(iz);
            // clamped before the conversion: a corner below -1 or past the
            // last texel is outside either way
            c[0] = (int)fminf(fmaxf(fx0, -2.f), (float)W);
            c[1] = (int)fminf(fmaxf(fy0, -2.f), (float)H);
            c[2] = (int)fminf(fmaxf(fz0, -2.f), (float)D);
            s.info[p][pt] = make_int4(pack_corner(c[0], c[1], c[2]), __float_as_int(ix - fx0),
                                      __float_as_int(iy - fy0), __float_as_int(iz - fz0));
          } else {
            c[0] = (int)fx0;
            c[1] = (int)fy0;
            s.info[p][pt] = make_int4(c[0], c[1], __float_as_int(ix - fx0),
                                      __float_as_int(iy - fy0));
          }
#pragma unroll
          for (int a = 0; a < NA; ++a) {
            lo[p][a] = min(lo[p][a], c[a]);
            hi[p][a] = max(hi[p][a], c[a]);
          }
        }
        if (!kept) {
          const long long o = (long long)(N - 1 - xi) * NN + (long long)yi * N + zi;
          if (out_f16) static_cast<__half*>(out)[o] = __float2half_rn(-1e3f);
          else static_cast<float*>(out)[o] = -1e3f;
        }
      }
      s.flags[pt] = (unsigned char)(valid | (kept << 1));
      any_kept |= kept;
    }
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        const int l = __reduce_min_sync(0xffffffffu, lo[p][a]);
        const int h = __reduce_max_sync(0xffffffffu, hi[p][a]);
        if (lane == 0) {
          atomicMin(&s.win[p][a], l);
          atomicMax(&s.win[p][4 + a], h);
        }
      }

    // (2) the crop skip: every point of the brick is cropped (and written)
    if (!__syncthreads_or(any_kept)) {
      if (stats && tid == 0) atomicAdd(&stats[0], 1);
      continue;
    }

    // (3) the plane windows into the pool, one after another; a window
    // that does not fit in what is left is not staged, and the gather
    // reads that plane from memory. At depth a window holds the slices
    // [zs, ze] of its corners' z0 .. z0 + 1 that lie inside the volume.
    int off = 0;
#pragma unroll 1
    for (int p = 0; p < 3; ++p) {
      const int lx = s.win[p][0], ly = s.win[p][1];
      const int ww = s.win[p][4] - lx + 2, wh = s.win[p][5] - ly + 2;
      int zs = 0, nz = 1;
      if constexpr (DEEP) {
        zs = max(s.win[p][2], 0);
        nz = max(min(s.win[p][6] + 1, D - 1) - zs + 1, 0);
      }
      const int texels = ww * wh * nz;
      const bool fits = off + texels <= B::POOL;
      if (tid == 0) {
        s.woff[p] = fits ? off : -1;
        s.zs[p] = zs;
        if (stats && !fits) atomicAdd(&stats[2], 1);
      }
      if (!fits) continue;
      for (int q = tid; q < texels * (C / 4); q += B::THREADS) {
        const int texel = q / (C / 4), c4 = q % (C / 4);
        int z = 0, r = texel;
        if constexpr (DEEP) {
          z = zs + texel / (ww * wh);
          r = texel % (ww * wh);
        }
        const int ty = ly + r / ww, tx = lx + r % ww;
        const bool inside = tx >= 0 && tx < W && ty >= 0 && ty < H;
        const float* src =
            inside ? planes + ((((long long)p * D + z) * H + ty) * W + tx) * C + c4 * 4 : planes;
        cp_async16_zfill(pool + (off + texel) * C + c4 * 4, src, inside);
      }
      off += texels;
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // (4) B::COLS columns a warp, two at a time: the decode of each, then
    // the tails of both, a lane a point
    float* tile = s.tile[warp];
#pragma unroll 1
    for (int cw = 0; cw < B::COLS; cw += 2) {
#pragma unroll 1
      for (int half = 0; half < 2; ++half) {
        const int base = (warp * B::COLS + cw + half) * V_BZ;
        const unsigned fl = lane < V_BZ ? s.flags[base + lane] : 0u;
        if (!__ballot_sync(0xffffffffu, fl & 2u)) {   // every point cropped (and written)
          if (stats && lane == 0) atomicAdd(&stats[1], 1);
          continue;
        }
        if constexpr (DEEP)
          gather_column_deep<C>(s, pool, planes, D, H, W, base, lane, tile);
        else gather_column<C>(s, pool, planes, H, W, base, lane, tile);
        __syncwarp();
        float h[NT1][4];
        layer1<C, FS>(tile, s.w0f, lane, h);
        // net2's sigma row: rows g (lo) and g + 8 (hi), this lane's 16
        // columns, then the sum over the quad's four lanes
        float s_lo = 0.f, s_hi = 0.f;
#pragma unroll
        for (int nt = 0; nt < NT1; ++nt) {
          const float2 bb = *reinterpret_cast<const float2*>(&s.b0[nt * 8 + 2 * t]);
          const float2 wv = *reinterpret_cast<const float2*>(&s.w1[nt * 8 + 2 * t]);
          s_lo = fmaf(softplus_fast(h[nt][0] + bb.x), wv.x, s_lo);
          s_lo = fmaf(softplus_fast(h[nt][1] + bb.y), wv.y, s_lo);
          s_hi = fmaf(softplus_fast(h[nt][2] + bb.x), wv.x, s_hi);
          s_hi = fmaf(softplus_fast(h[nt][3] + bb.y), wv.y, s_hi);
        }
        s_lo += __shfl_xor_sync(0xffffffffu, s_lo, 1);
        s_hi += __shfl_xor_sync(0xffffffffu, s_hi, 1);
        s_lo += __shfl_xor_sync(0xffffffffu, s_lo, 2);
        s_hi += __shfl_xor_sync(0xffffffffu, s_hi, 2);
        if (t < 2) s.sigma[warp][half * V_BZ + g + 8 * t] = (t == 0 ? s_lo : s_hi) + s.b1;
        __syncwarp();   // the tile is read before the next column's features land
      }
      // the tails of the kept points (the cropped ones were written in (1))
      const int base = (warp * B::COLS + cw + (lane >> 4)) * V_BZ, row = lane & 15;
      if ((s.flags[base + row] & 3u) == 3u) {
        const float sigma = s.sigma[warp][lane];
        // sigma2density, then the cloud cull on the density
        float d = __fsub_rn(1.f, expf(-softplus_f(__fsub_rn(sigma, 1.f))));
        if (use_cull && __fsub_rn(1.f, expf(-softplus_f(__fsub_rn(d, 1.f)))) < cull_thresh)
          d = -1e3f;
        const int col_x = bx * V_BX + base / (V_BZ * V_BY);
        const int col_y = by * V_BY + base / V_BZ % V_BY;
        const long long o = (long long)(N - 1 - col_x) * NN + (long long)col_y * N +
                            bz * V_BZ + row;
        if (out_f16) static_cast<__half*>(out)[o] = __float2half_rn(d);
        else static_cast<float*>(out)[o] = d;
      }
      __syncwarp();   // the sigmas are read before the next pair's land
    }
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

template <int C, bool DEEP>
cudaError_t launch_volume(const float* planes, const float* w0, const float* b0,
                          const float* w1, const float* b1, void* out, int out_f16, int N,
                          int D, int H, int W, const Proj& pj, float coord_scale, float g0,
                          float g1, float bias_scale, float voxel, float origin, int use_crop,
                          float crop_lim, int use_cull, float cull_thresh, int* stats,
                          cudaStream_t stream) {
  using B = Brick<DEEP>;
  const int smem = (int)sizeof(VolSmem<C, DEEP>) + B::POOL * C * (int)sizeof(float);
  static const cudaError_t attr = cudaFuncSetAttribute(
      volume_density_kernel<C, DEEP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long bricks = (long long)((N + V_BZ - 1) / V_BZ) * ((N + V_BY - 1) / V_BY) *
                           ((N + V_BX - 1) / V_BX);
  const long long blocks = bricks < (long long)B::BLOCKS * sms ? bricks : (long long)B::BLOCKS * sms;
  volume_density_kernel<C, DEEP><<<(unsigned)blocks, B::THREADS, smem, stream>>>(
      planes, w0, b0, w1, b1, out, out_f16, N, D, H, W, pj, coord_scale, g0, g1, bias_scale,
      voxel, origin, use_crop, crop_lim, use_cull, cull_thresh, stats);
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
  const Proj pj = make_proj(proj, false);
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

// K10's trilinear K1 form. vols: the deep planes as N*3 volumes
// [N*3,D,H,W,C] channels-last, f32 or bf16, 16-byte aligned; proj: 27
// floats, [plane][xyz][uvw] (w indexes D); the rest as K1.
PANIC3D_EXPORT int triplane_decode_deep(
    const void* vols, int dtype, const float* coords, const float* w0,
    const float* b0, const float* w1, const float* b1, void* rgb, float* sigma,
    int N, int M, int D, int H, int W, int C, const float* proj, float coord_scale,
    float g0, float g1, float bias_scale, int force_sigmoid, int use_crop,
    float crop_lim, int cull_mode, float cull_thresh, void* stream) {
  if (D < 1) return (int)cudaErrorInvalidValue;
  const Proj pj = make_proj(proj, true);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define P3D_K10(T, CC)                                                                 \
  return (int)launch<T, CC, TRILINEAR>(vols, coords, w0, b0, w1, b1, rgb, sigma, N, M, \
                                       H, W, pj, coord_scale, g0, g1, bias_scale,      \
                                       force_sigmoid, use_crop, crop_lim, cull_mode,   \
                                       cull_thresh, s, D)
  if (dtype == DT_BF16) {
    if (C == 32) P3D_K10(__nv_bfloat16, 32);
    if (C == 16) P3D_K10(__nv_bfloat16, 16);
    if (C == 8) P3D_K10(__nv_bfloat16, 8);
  } else {
    if (C == 32) P3D_K10(float, 32);
    if (C == 16) P3D_K10(float, 16);
    if (C == 8) P3D_K10(float, 8);
  }
#undef P3D_K10
  return (int)cudaErrorInvalidValue;
}

// K10's lattice form: K1v's brick kernel on the deep planes. vols: one
// portrait's deep planes as [3,D,H,W,C] channels-last f32, 16-byte aligned;
// proj as triplane_decode_deep; out [N,N,N] f16 (out_f16) or f32, axis 0
// flipped, K1v's densities (sigma2density, the crop on the lattice point,
// the cull on the density when use_cull); N at most 256 (the flat index is
// exact in f32), H, W and D at most 1000; stats as volume_density's.
PANIC3D_EXPORT int volume_density_deep(
    const float* vols, const float* w0, const float* b0, const float* w1,
    const float* b1, void* out, int out_f16, int N, int D, int H, int W, int C,
    const float* proj, float coord_scale, float g0, float g1, float bias_scale,
    float voxel, float origin, int use_crop, float crop_lim, int use_cull,
    float cull_thresh, int* stats, void* stream) {
  if (N < 2 || N > 256 || D < 1 || D > 1000 || H > 1000 || W > 1000)
    return (int)cudaErrorInvalidValue;
  const Proj pj = make_proj(proj, true);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define P3D_K10V(CC)                                                                      \
  return (int)launch_volume<CC, true>(vols, w0, b0, w1, b1, out, out_f16, N, D, H, W, pj, \
                                      coord_scale, g0, g1, bias_scale, voxel, origin,     \
                                      use_crop, crop_lim, use_cull, cull_thresh, stats, s)
  if (C == 32) P3D_K10V(32);
  if (C == 16) P3D_K10V(16);
  if (C == 8) P3D_K10V(8);
#undef P3D_K10V
  return (int)cudaErrorInvalidValue;
}

// K1v. planes: one portrait's [3,H,W,C] channels-last f32, 16-byte aligned;
// w0..b1 as K1; out [N,N,N] f16 (out_f16) or f32, axis 0 flipped. use_cull
// applies the cloud cull to the density. N must be at most 256 (the flat
// index is exact in f32). stats: null, or 3 ints the kernel adds to (bricks
// skipped by the crop, columns skipped, planes read outside a window).
PANIC3D_EXPORT int volume_density(
    const float* planes, const float* w0, const float* b0, const float* w1,
    const float* b1, void* out, int out_f16, int N, int H, int W, int C, const float* proj,
    float coord_scale, float g0, float g1, float bias_scale, float voxel, float origin,
    int use_crop, float crop_lim, int use_cull, float cull_thresh, int* stats, void* stream) {
  if (N < 2 || N > 256) return (int)cudaErrorInvalidValue;
  const Proj pj = make_proj(proj, false);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define P3D_K1V(CC)                                                                  \
  return (int)launch_volume<CC, false>(planes, w0, b0, w1, b1, out, out_f16, N, 1, \
                                               H, W, pj, coord_scale, g0, g1, bias_scale,  \
                                               voxel, origin, use_crop, crop_lim,          \
                                               use_cull, cull_thresh, stats, s)
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
