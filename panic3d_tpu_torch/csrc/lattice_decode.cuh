// Sigma-only OSGDecoder on factorised lattice features, shared by K6
// (ess.cu) and K7 (front_occlusion.cu).
//
// A lattice point (i0, i1, i2) on world axes (x, y, z) reads each of the
// three factorised terms F_p [N, G_a, G_b, C] (lattice.py
// lattice_features) at its two axes, takes the plane mean in the JAX
// package's order ((F_0 + F_1) + F_2) / 3, and decodes sigma:
// FC(C->64) -> softplus -> net2's sigma row, then the density filters.
#pragma once

#include "common.cuh"

constexpr int LAT_HIDDEN = 64;

struct LatticeTerm {
  const float* F;   // [N, G_a, G_b, C] contiguous f32
  int a, b;         // the two world axes (a < b)
};

struct LatticeTerms {
  LatticeTerm t[3];
};

// The sigma-only decoder in shared memory, with the equalized-lr gains
// applied once.
template <int C>
struct SigmaMLP {
  float w0[LAT_HIDDEN * C];
  float b0[LAT_HIDDEN];
  float w1[LAT_HIDDEN];   // net2's row 0
  float b1;
};

template <int C>
__device__ __forceinline__ void load_sigma_mlp(SigmaMLP<C>& m, const float* w0,
                                               const float* b0, const float* w1,
                                               const float* b1, float g0, float g1,
                                               float bias_scale) {
  for (int i = threadIdx.x; i < LAT_HIDDEN * C; i += blockDim.x) m.w0[i] = w0[i] * g0;
  for (int i = threadIdx.x; i < LAT_HIDDEN; i += blockDim.x) {
    m.b0[i] = b0[i] * bias_scale;
    m.w1[i] = w1[i] * g1;
  }
  if (threadIdx.x == 0) m.b1 = b1[0] * bias_scale;
}

// feat[c] = ((F_0 + F_1) + F_2) / 3 at lattice index idx on a lattice of
// per-axis sizes size, batch n.
template <int C>
__device__ __forceinline__ void lattice_feature(const LatticeTerms& terms, int n,
                                                const int idx[3], const int size[3],
                                                float feat[C]) {
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const LatticeTerm& t = terms.t[p];
    const float* row = t.F + (((long long)n * size[t.a] + idx[t.a]) * size[t.b] + idx[t.b]) * C;
#pragma unroll
    for (int c = 0; c < C; c += 4) {
      const float4 v = *reinterpret_cast<const float4*>(row + c);
      if (p == 0) {
        feat[c] = v.x; feat[c + 1] = v.y; feat[c + 2] = v.z; feat[c + 3] = v.w;
      } else {
        feat[c] += v.x; feat[c + 1] += v.y; feat[c + 2] += v.z; feat[c + 3] += v.w;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) feat[c] = feat[c] / 3.f;
}

template <int C>
__device__ __forceinline__ float sigma_decode(const SigmaMLP<C>& m, const float feat[C]) {
  float sigma = 0.f;
#pragma unroll 4
  for (int j = 0; j < LAT_HIDDEN; ++j) {
    float h = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) h = fmaf(m.w0[j * C + c], feat[c], h);
    sigma = fmaf(m.w1[j], softplus_f(h + m.b0[j]), sigma);
  }
  return sigma + m.b1;
}

// _apply_density_filters at world point (x, z): triplane crop, then cull
// (mode 1) or binarize (mode 2) clouds.
__device__ __forceinline__ float density_filters(float sigma, float x, float z, int use_crop,
                                                 float crop_lim, int cull_mode,
                                                 float cull_thresh) {
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
__device__ __forceinline__ float cell_center(int g, int G, double bw) {
  return (float)(((double)g + 0.5) / G * bw - bw / 2);
}
