// The 3xTF32 tensor-core product shared by K1's kernels (triplane_decode.cu)
// and K1's backward form (triplane_decode_grad.cu): mma.sync m16n8k8 in
// TF32 with f32 accumulation, each operand split v = hi + lo (hi =
// cvt.rna(v), lo = cvt.rna(v - hi)), and a_lo*b_hi + a_hi*b_lo + a_hi*b_hi
// summed, which keeps a product within f32 rounding of the plain version's.
// Fragments (lane = 4g + t): A (16x8, row-major) a0 = A[g][t], a1 = A[g+8][t],
// a2 = A[g][t+4], a3 = A[g+8][t+4]; B (8x8, column-major) b0 = B[t][g],
// b1 = B[t+4][g]; C (16x8) c0 = C[g][2t], c1 = C[g][2t+1], c2 = C[g+8][2t],
// c3 = C[g+8][2t+1].
#pragma once

#include "common.cuh"

// TF32 rounding of v as cvt.rna does it (nearest, ties away from zero)
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// 3xTF32 split: v = hi + lo, both TF32; lo carries the bits hi drops
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// a B fragment pair, split: (b0 hi, b1 hi, b0 lo, b1 lo)
__device__ __forceinline__ uint4 split_pair(float b0, float b1) {
  uint4 r;
  split_tf32(b0, r.x, r.z);
  split_tf32(b1, r.y, r.w);
  return r;
}

// d += a (16x8, row-major) * b (8x8, col-major); TF32 in, f32 accumulation
__device__ __forceinline__ void mma_tf32(float d[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b in 3xTF32: a_lo*b_hi + a_hi*b_lo, then a_hi*b_hi (the small
// products first); a_lo*b_lo (~2^-22 relative) is dropped
__device__ __forceinline__ void mma_3xtf32(float d[4], const uint32_t hi[4],
                                           const uint32_t lo[4], const uint4& b) {
  mma_tf32(d, lo, b.x, b.y);
  mma_tf32(d, hi, b.z, b.w);
  mma_tf32(d, hi, b.x, b.y);
}

// an A fragment (rows g, g+8; columns t, t+4 of the 8-wide k-step at f),
// split into TF32 hi and lo
__device__ __forceinline__ void load_a(const float* f, int g, int stride, uint32_t hi[4],
                                       uint32_t lo[4]) {
  split_tf32(f[g * stride], hi[0], lo[0]);
  split_tf32(f[(g + 8) * stride], hi[1], lo[1]);
  split_tf32(f[g * stride + 4], hi[2], lo[2]);
  split_tf32(f[(g + 8) * stride + 4], hi[3], lo[3]);
}

