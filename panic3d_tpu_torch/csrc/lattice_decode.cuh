// The sigma-only OSGDecoder on factorised lattice features, shared by K6a
// (ess.cu) and K7a (front_occlusion.cu): the three factorised terms F_p
// [N, G_a, G_b, C] (lattice.py lattice_features), the factored first layer,
// the density filters and the lattice's cell centres.
//
// A lattice point (i0, i1, i2) on world axes (x, y, z) reads each term at
// its two axes; its feature is the plane mean ((F_0 + F_1) + F_2) / 3 and
// its sigma FC(C->64) -> softplus -> net2's sigma row. FC(C->64) is
// linear, so W0 feat = ((W0 F_0 + W0 F_1) + W0 F_2) / 3, and
// factor_terms_kernel computes P_t = g0 W0 F_t / 3 once per term row, b0
// added to the (x, y) term's rows; a lattice point's hidden layer is then
// (P_xy + P_a) + P_b (P_a, P_b the two z-dependent terms in plane order):
// two adds a hidden unit in place of C FMAs.
#pragma once

#include "common.cuh"

constexpr int LAT_HIDDEN = 64;

struct LatticeTerm {
  const float* F;            // [N, G_a, G_b, C] f32, the channels contiguous
  int a, b;                  // the two world axes (a < b)
  long long sn, sa, sb;      // strides (elements) over n, the a index and the b index
  int ga, gb;                // the lattice's sizes on a and b (factored_layout)
};

// the channels of term row r = (n, i_a, i_b), in (n, i_a, i_b) order (r <
// 2^31: at most N G_a G_b rows)
__device__ __forceinline__ const float* term_row(const LatticeTerm& t, long long r) {
  const int q = (int)r;
  return t.F + (q / (t.ga * t.gb)) * t.sn + (q / t.gb % t.ga) * t.sa + (q % t.gb) * t.sb;
}

struct LatticeTerms {
  LatticeTerm t[3];
};

// _apply_density_filters at world point (x, z): triplane crop, then cull
// (mode 1) or binarize (mode 2) clouds.
__host__ __device__ __forceinline__ float density_filters(float sigma, float x, float z,
                                                          int use_crop, float crop_lim,
                                                          int cull_mode, float cull_thresh) {
  if (use_crop && !(fabsf(x) <= crop_lim && fabsf(z) <= crop_lim)) sigma = -1e3f;
  if (cull_mode != 0) {
    const float alpha = 1.f - expf(-softplus_f(sigma - 1.f));
    if (cull_mode == 2) sigma = alpha < cull_thresh ? -1e3f : 1e3f;
    else if (alpha < cull_thresh) sigma = -1e3f;
  }
  return sigma;
}

// lattice_axis_coords: cell g of G on a box of side bw, computed in double
// and rounded once, as the numpy helper does
__host__ __device__ __forceinline__ float cell_center(int g, int G, double bw) {
  return (float)(((double)g + 0.5) / G * bw - bw / 2);
}

// ---- the factored first layer ----

// the factored terms: P of the (x, y) term, and of the two z-dependent
// terms (axes (axis[k], z)) in plane order
struct FactoredTerms {
  const float* col;
  const float* slab[2];
  int axis[2];
};

// where each term's rows lie in P (term t's after term t - 1's), and which
// term is the (x, y) one
struct FactorLayout {
  int col;
  long long end[3];   // the row after term t's last
};

// The factored terms of ``terms`` on a lattice of per-axis sizes ``size``,
// batch N, in the scratch P (sum_t N G_a G_b 64 f32); sets each term's
// sizes. False unless one of the first two terms is on axes (x, y) and the
// other two on (x or y, z).
inline bool factored_layout(LatticeTerms& terms, const int size[3], int N, float* P,
                            FactoredTerms& ft, FactorLayout& lay) {
  ft = FactoredTerms{};
  lay.col = -1;
  long long rows = 0;
  int n_slab = 0;
  for (int t = 0; t < 3; ++t) {
    LatticeTerm& tm = terms.t[t];
    tm.ga = size[tm.a];
    tm.gb = size[tm.b];
    const float* Pt = P + rows * LAT_HIDDEN;
    rows += (long long)N * size[tm.a] * size[tm.b];
    lay.end[t] = rows;
    if (tm.a == 0 && tm.b == 1 && t < 2 && lay.col < 0) {
      ft.col = Pt;
      lay.col = t;
    } else if ((tm.a == 0 || tm.a == 1) && tm.b == 2 && n_slab < 2) {
      ft.slab[n_slab] = Pt;
      ft.axis[n_slab++] = tm.a;
    } else {
      return false;
    }
  }
  return true;
}

namespace {

constexpr float THIRD = 1.f / 3.f;

// P_t = g0 W0 F_t / 3 for every row of the three terms, one after another
// in P, plus the bias b0 on the rows of the (x, y) term (col): a lattice
// point's hidden layer is then (P_col + P_a) + P_b. A block stages 64 rows
// of F in shared memory (all of their loads in flight at once, a term's rows
// read through its strides); thread j of a row keeps W0's row j in
// registers and computes hidden unit j of 16 rows.
constexpr int FROWS = 64;

// It also sets clear[0, n_clear) to 0 (K6a's occupancy grid, which the
// decode launch then marks; K7a passes none).
template <int C>
__global__ void __launch_bounds__(256) factor_terms_kernel(
    LatticeTerms terms, int col, long long end0, long long end1, long long rows,
    const float* __restrict__ w0, const float* __restrict__ b0, float g0, float bias_scale,
    float* __restrict__ P, float* __restrict__ clear, int n_clear) {
  __shared__ __align__(16) float f[FROWS * C];
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_clear; i += gridDim.x * blockDim.x)
    clear[i] = 0.f;
  __shared__ float ws[LAT_HIDDEN * (C + 1)];   // W0, rows padded: conflict-free reads
  for (int i = threadIdx.x; i < LAT_HIDDEN * C; i += blockDim.x)
    ws[(i / C) * (C + 1) + i % C] = w0[i] * g0;
  __syncthreads();
  const int j = threadIdx.x % LAT_HIDDEN, group = threadIdx.x / LAT_HIDDEN;
  float w[C];
#pragma unroll
  for (int c = 0; c < C; ++c) w[c] = ws[j * (C + 1) + c];
  const float bias = b0[j] * bias_scale;
  for (long long r0 = (long long)blockIdx.x * FROWS; r0 < rows;
       r0 += (long long)gridDim.x * FROWS) {
    __syncthreads();   // the previous rows are read
    for (int i = threadIdx.x; i < FROWS * C / 4; i += blockDim.x) {
      const long long row = r0 + i / (C / 4);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < rows) {
        const float* F = row < end0 ? term_row(terms.t[0], row)
                       : row < end1 ? term_row(terms.t[1], row - end0)
                                    : term_row(terms.t[2], row - end1);
        v = __ldg(reinterpret_cast<const float4*>(F) + i % (C / 4));
      }
      reinterpret_cast<float4*>(f)[i] = v;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < FROWS / 4; ++k) {
      const int rl = group * (FROWS / 4) + k;
      const long long row = r0 + rl;
      if (row >= rows) break;
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) acc = fmaf(w[c], f[rl * C + c], acc);
      const int t = row < end0 ? 0 : row < end1 ? 1 : 2;
      P[row * LAT_HIDDEN + j] = fmaf(acc, THIRD, t == col ? bias : 0.f);
    }
  }
}

// The factor launch of a layout (C in {8, 16, 32}): at most 8 blocks an SM,
// each walking its share of the rows; it clears clear[0, n_clear).
inline cudaError_t launch_factor_terms(const LatticeTerms& terms, const FactorLayout& lay,
                                       int C, const float* w0, const float* b0, float g0,
                                       float bias_scale, float* P, cudaStream_t s,
                                       float* clear = nullptr, int n_clear = 0) {
  const long long rows = lay.end[2];
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long fblocks = (rows + FROWS - 1) / FROWS;
  if (fblocks > 8LL * sms) fblocks = 8LL * sms;
#define P3D_FACTOR(CC)                                                                     \
  factor_terms_kernel<CC><<<(unsigned)fblocks, 256, 0, s>>>(terms, lay.col, lay.end[0],     \
                                                            lay.end[1], rows, w0, b0, g0,  \
                                                            bias_scale, P, clear, n_clear)
  if (C == 32) P3D_FACTOR(32);
  else if (C == 16) P3D_FACTOR(16);
  else if (C == 8) P3D_FACTOR(8);
  else return cudaErrorInvalidValue;
#undef P3D_FACTOR
  return cudaGetLastError();
}

}  // namespace
