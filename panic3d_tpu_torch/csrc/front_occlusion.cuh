// K7b's read of paste-front's occlusion volume at one surface point
// (panic3d_tpu/models/volumetric/lattice.py:303 sample_front_occlusion),
// shared by front_occlusion.cu's sampler and K8's grid-occlusion entry
// (paste_front.cu), so that both compile the same rounded operations.
#pragma once

#include "common.cuh"

// The occlusion toward +z over [pz + offset, pz + offset + seg_len] at the
// plane-space point (px, py, pz): the border-clamped trilinear read of vol
// [D=Gx, H=Gy, W=Gz] at (pz + offset, py, px) * scale (scale = 2 / box_warp;
// grid_sample_3d_points' query order), plus the zero-feature density d0
// over the segment's lengths outside the box, as 1 - exp(-A_total).
__device__ __forceinline__ float front_occlusion_at(const float* __restrict__ vol, int Gx,
                                                    int Gy, int Gz, float d0, float px, float py,
                                                    float pz, float scale, float half_bw,
                                                    float offset, float seg_len) {
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
  const bool inside_xy = fabsf(px) <= half_bw && fabsf(py) <= half_bw;
  const float len_below = fminf(fmaxf(__fsub_rn(-half_bw, z0), 0.f), seg_len);
  const float len_above = fminf(fmaxf(__fsub_rn(__fadd_rn(z0, seg_len), half_bw), 0.f), seg_len);
  const float a_total = inside_xy ? __fadd_rn(acc, __fmul_rn(d0, __fadd_rn(len_below, len_above)))
                                  : __fmul_rn(d0, seg_len);
  return 1.f - expf(-a_total);
}
