// K7 front_occlusion: paste-front's per-portrait +z opacity volume and its
// per-pixel sampler, two entry points.
//
// Replaces (JAX): panic3d_tpu/models/volumetric/lattice.py:
// front_occlusion_volume (:239, decode_lattice with plane_reduce='mean', the
// density filters, softplus, and the flip-cumsum-flip suffix integral) and
// sample_front_occlusion (:303, grid_sample_3d_points with border padding
// plus the out-of-box zero-feature terms).
//
// What bounds it on the H100: the volume decodes 128 x 128 x 256 lattice
// points per portrait -- 8.4 M for bs=2 -- at about 2.1k multiply-adds
// each, ~35 GFLOP: arithmetic, ~0.5 ms at 67 TFLOP/s f32. Its output A
// ([2,128,128,256] f32) is 33.5 MB, ~0.01 ms of writes. The sampler reads
// 8 values of A per surface point for 2 x 4096 points: latency.
//
// Design, volume: one block per (n, x, y) column of Gz cells (a grid-stride
// loop over columns, so the decoder weights are loaded into shared memory
// once per block); thread z decodes sigma at (x, y, z) from
// F_xy[x,y] + F_xz[x,z] + F_yz[y,z] -- the [M,32] feature block never
// reaches device memory, where the JAX package writes it chunk by chunk --
// applies the filters at the cell centre and takes density =
// softplus(sigma - 1). The block then forms the reverse inclusive sum along
// z (warp shuffles, then the warp totals through shared memory) and writes
// A = (suffix - density / 2) * dz. The scan adds in another order than
// torch.cumsum's sequential sum, so A agrees to ~1e-5 of its maximum.
// Design, sampler: one thread per point; the border-clamped trilinear read
// of A at (z0, y, x) in the JAX op's association, then the below- and
// above-box lengths at the zero-feature density and 1 - exp(-A_total).
#include "lattice_decode.cuh"

namespace {

template <int C>
__global__ void occlusion_volume_kernel(LatticeTerms terms, const float* __restrict__ w0,
                                        const float* __restrict__ b0,
                                        const float* __restrict__ w1,
                                        const float* __restrict__ b1, float* __restrict__ A,
                                        int N, int Gx, int Gy, int Gz, double bw, float dz,
                                        float g0, float g1, float bias_scale, int use_crop,
                                        float crop_lim, int cull_mode, float cull_thresh) {
  __shared__ SigmaMLP<C> mlp;
  __shared__ float warp_sum[32];
  load_sigma_mlp<C>(mlp, w0, b0, w1, b1, g0, g1, bias_scale);
  __syncthreads();

  const int z = threadIdx.x, lane = z & 31, warp = z >> 5, n_warps = Gz >> 5;
  const int size[3] = {Gx, Gy, Gz};
  const float zc = cell_center(z, Gz, bw);
  const long long columns = (long long)N * Gx * Gy;
  for (long long col = blockIdx.x; col < columns; col += gridDim.x) {
    const int y = (int)(col % Gy), x = (int)((col / Gy) % Gx), n = (int)(col / Gy / Gx);
    const int idx[3] = {x, y, z};
    float feat[C];
    lattice_feature<C>(terms, n, idx, size, feat);
    float sigma = sigma_decode<C>(mlp, feat);
    sigma = density_filters(sigma, cell_center(x, Gx, bw), zc, use_crop, crop_lim, cull_mode,
                            cull_thresh);
    const float density = softplus_f(sigma - 1.f);

    // suffix (z' >= z) sum: within the warp, then over the later warps
    float v = density;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_down_sync(0xffffffffu, v, off);
      if (lane + off < 32) v += o;
    }
    if (lane == 0) warp_sum[warp] = v;
    __syncthreads();
    float later = 0.f;
    for (int w = n_warps - 1; w > warp; --w) later += warp_sum[w];
    const float suffix = v + later;
    A[col * Gz + z] = (suffix - 0.5f * density) * dz;
    __syncthreads();   // warp_sum is rewritten by the next column
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
  const float* vol = A + (i / M) * a_stride;      // [D=Gx, H=Gy, W=Gz]
  const float px = points[i * 3], py = points[i * 3 + 1], pz = points[i * 3 + 2];
  const float z0 = __fadd_rn(pz, offset);
  // grid_sample_3d_points(A[:, None], (z0, y, x) * 2/bw, border): the
  // query's x indexes W = Gz, y indexes H = Gy, z indexes D = Gx
  const float q[3] = {__fmul_rn(z0, scale), __fmul_rn(py, scale), __fmul_rn(px, scale)};
  const int sz[3] = {Gz, Gy, Gx};
  int i0[3];
  float w1[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float u = __fdiv_rn(__fsub_rn(__fmul_rn(__fadd_rn(q[a], 1.f), (float)sz[a]), 1.f), 2.f);
    const float f = floorf(u);
    i0[a] = (int)f;
    w1[a] = __fsub_rn(u, f);
  }
  auto at = [&](int d, int h, int w) {
    d = min(max(d, 0), Gx - 1);
    h = min(max(h, 0), Gy - 1);
    w = min(max(w, 0), Gz - 1);
    return vol[((long long)d * Gy + h) * Gz + w];
  };
  float acc = 0.f;
#pragma unroll
  for (int dd = 0; dd < 2; ++dd) {
    const float wz = dd == 0 ? __fsub_rn(1.f, w1[2]) : w1[2];
    const int d = i0[2] + dd;
    const float v00 = at(d, i0[1], i0[0]), v01 = at(d, i0[1], i0[0] + 1);
    const float v10 = at(d, i0[1] + 1, i0[0]), v11 = at(d, i0[1] + 1, i0[0] + 1);
    const float top = __fadd_rn(v00, __fmul_rn(__fsub_rn(v01, v00), w1[0]));
    const float bot = __fadd_rn(v10, __fmul_rn(__fsub_rn(v11, v10), w1[0]));
    acc = __fadd_rn(acc, __fmul_rn(__fadd_rn(top, __fmul_rn(__fsub_rn(bot, top), w1[1])), wz));
  }
  const float d0 = density0[0];
  const bool inside_xy = fabsf(px) <= half_bw && fabsf(py) <= half_bw;
  const float len_below = fminf(fmaxf(__fsub_rn(-half_bw, z0), 0.f), seg_len);
  const float len_above = fminf(fmaxf(__fsub_rn(__fadd_rn(z0, seg_len), half_bw), 0.f), seg_len);
  const float a_total = inside_xy ? __fadd_rn(acc, __fmul_rn(d0, __fadd_rn(len_below, len_above)))
                                  : __fmul_rn(d0, seg_len);
  out[i] = 1.f - expf(-a_total);
}

}  // namespace

// terms: three (F [N,G_a,G_b,C] f32, axis_a, axis_b) on the lattice
// (Gx, Gy, Gz); decoder raw f32 parameters (w1 is [33,64]: row 0 is read);
// A [N,Gx,Gy,Gz] f32 out. Gz must be a multiple of 32 up to 1024 (one
// thread per z cell) and C one of {8,16,32}, else cudaErrorInvalidValue.
PANIC3D_EXPORT int occlusion_volume(
    const float* F0, int a0, int b0_, const float* F1, int a1, int b1_, const float* F2, int a2,
    int b2_, const float* w0, const float* b0, const float* w1, const float* b1, float* A, int N,
    int Gx, int Gy, int Gz, int C, double bw, float dz, float g0, float g1, float bias_scale,
    int use_crop, float crop_lim, int cull_mode, float cull_thresh, void* stream) {
  if (Gz % 32 != 0 || Gz > 1024) return (int)cudaErrorInvalidValue;
  LatticeTerms terms{{{F0, a0, b0_}, {F1, a1, b1_}, {F2, a2, b2_}}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = (long long)N * Gx * Gy;
  const long long cap = (long long)sms * (2048 / Gz);
  if (blocks > cap) blocks = cap;
#define P3D_K7(CC)                                                                           \
  occlusion_volume_kernel<CC><<<(unsigned)blocks, Gz, 0, s>>>(                               \
      terms, w0, b0, w1, b1, A, N, Gx, Gy, Gz, bw, dz, g0, g1, bias_scale, use_crop, crop_lim, \
      cull_mode, cull_thresh)
  if (C == 32) P3D_K7(32);
  else if (C == 16) P3D_K7(16);
  else if (C == 8) P3D_K7(8);
  else return (int)cudaErrorInvalidValue;
#undef P3D_K7
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
