// K9 point_mesh_distance: for each point, the minimum over the mesh's
// triangles of the exact squared point-to-triangle distance.
//
// Replaces (JAX): panic3d_tpu/eval/mesh_metrics.py:point_mesh_distance_sq
// (:61), a lax.scan over 2048-triangle chunks of
// point_triangle_distance_sq (:23), the brute-force [P, T] problem that
// stands in for igl's AABB trees in the chamfer / F1 metrics.
//
// What bounds it on the H100: instruction issue. Every (point, triangle)
// pair is evaluated (no culling), and the plain version's ~118 f32
// operations a pair are each rounded on their own (no contracted
// multiply-add, so the result is exact against it): the pipe runs at its
// non-FMA rate, half the 67 TFLOP/s the roofline divides by. The inputs are
// a few MB.
//
// Design. A first launch (triangle_records_kernel) computes each
// triangle's constants once, into a global buffer of 160-byte records (see
// Tri). The distance kernel gives each thread PPT points (the wrapper hands
// them over in Morton order, so that a warp's points lie close together and
// take the same branches) and each block every gridDim.y-th tile of TILE
// triangles (so that the costlier pairs near the surface spread over the
// blocks), streamed through shared memory by cp.async, one tile ahead into
// the other of two buffers; one broadcast read of a record serves PPT
// pairs. Per pair it cuts the instructions without changing a
// rounding that reaches the result (tests/test_torch_mesh_distance_branches.py
// proves each decision on the CPU against
// eval/mesh_metrics.py:point_triangle_distance_sq_branches):
// - each edge's t exactly 0 where dot <= 0 and exactly 1 where
//   dot >= len2; there the closest point is a vertex, whose squared
//   distance is computed once for the edges that share it; the quotient
//   and the closest point only in between;
// - the inside test only for a pair that a fused multiply-add filter of
//   the barycentric numerators puts in or near the triangle's prism; then
//   the exact numerators, and the quotients, their sum and d_plane only
//   where the numerators' signs and sum allow the pair to be inside (see
//   tri_d for the margins).
// Every kept value is the plain version's (mesh_metrics.py, one PyTorch op
// per multiply, add and divide), rounded with __fmul_rn/__fadd_rn/__fdiv_rn.
// Blocks fold their minima into the output with an integer atomicMin on the
// f32 bits (squared distances are >= 0, so the order of the bits is the
// order of the values, and the result does not depend on the block order).
#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int PPT = 4;          // points per thread
constexpr int TILE = 64;        // triangle records per shared-memory tile
constexpr int REC = 10;         // float4 per record (40 floats, 160 bytes)

struct V3 { float x, y, z; };

__device__ __forceinline__ V3 sub3(V3 u, V3 v) {
  return {__fsub_rn(u.x, v.x), __fsub_rn(u.y, v.y), __fsub_rn(u.z, v.z)};
}

// (u.x*v.x + u.y*v.y) + u.z*v.z, each product and sum rounded
__device__ __forceinline__ float dot3(V3 u, V3 v) {
  return __fadd_rn(__fadd_rn(__fmul_rn(u.x, v.x), __fmul_rn(u.y, v.y)), __fmul_rn(u.z, v.z));
}

__device__ __forceinline__ V3 cross3(V3 u, V3 v) {
  return {__fsub_rn(__fmul_rn(u.y, v.z), __fmul_rn(u.z, v.y)),
          __fsub_rn(__fmul_rn(u.z, v.x), __fmul_rn(u.x, v.z)),
          __fsub_rn(__fmul_rn(u.x, v.y), __fmul_rn(u.y, v.x))};
}

// squared distance from p to the segment s -> s + se (sp = p - s, dd_s =
// |sp|^2; e the segment's end, dd_e = |p - e|^2, eq: s + se rounds to e in
// every component). den is len2, or 1 where len2 is 0. clamp(dot / den, 0,
// 1) is exactly 0 where dot <= 0 and exactly 1 where dot >= den (den > 0;
// rounding is monotone): at t = 0 the closest point is s, so the distance
// is dd_s; at t = 1 it is s + se, which is e when eq, so dd_e. Only
// between them (or at t = 1 when s + se is not e) is the quotient and the
// closest point computed, with the plain version's roundings.
__device__ __forceinline__ float seg_d(V3 p, V3 s, V3 sp, V3 se, float den, float dd_s,
                                       float dd_e, bool eq) {
  const float dt = dot3(sp, se);
  float d = dt <= 0.f ? dd_s : dd_e;
  if (dt > 0.f && (dt < den || !eq)) {
    const float t = dt < den ? __fdiv_rn(dt, den) : 1.f;
    const V3 closest = {__fadd_rn(s.x, __fmul_rn(t, se.x)), __fadd_rn(s.y, __fmul_rn(t, se.y)),
                        __fadd_rn(s.z, __fmul_rn(t, se.z))};
    const V3 dv = sub3(p, closest);
    d = dot3(dv, dv);
  }
  return d;
}

// The record of one triangle, 40 floats in order: a, ab, ac, n, b, bc, c,
// den_ab, den_ac, den_bc, safe, thr, n2 > 0 (1 or 0), the bits of an int
// (1 where a + ab rounds to b, 2 where a + ac rounds to c, 4 where b + bc
// rounds to c), then the inside filter's m_g = n x ab, k_g, m_b = ac x n,
// k_b, d_tri, safe_hi and s_hi, and 1 unused
struct Tri {
  V3 a, ab, ac, n, b, bc, c;
  float den_ab, den_ac, den_bc, safe, thr, n2pos;
  int ends;
  V3 mg, mb;
  float kg, kb, dtri, safe_hi, s_hi;
};

__device__ __forceinline__ Tri unpack_tri(const float4* r) {
  const float4 r0 = r[0], r1 = r[1], r2 = r[2], r3 = r[3], r4 = r[4], r5 = r[5], r6 = r[6],
               r7 = r[7], r8 = r[8], r9 = r[9];
  Tri t;
  t.a = {r0.x, r0.y, r0.z};
  t.ab = {r0.w, r1.x, r1.y};
  t.ac = {r1.z, r1.w, r2.x};
  t.n = {r2.y, r2.z, r2.w};
  t.b = {r3.x, r3.y, r3.z};
  t.bc = {r3.w, r4.x, r4.y};
  t.c = {r4.z, r4.w, r5.x};
  t.den_ab = r5.y;
  t.den_ac = r5.z;
  t.den_bc = r5.w;
  t.safe = r6.x;
  t.thr = r6.y;
  t.n2pos = r6.z;
  t.ends = __float_as_int(r6.w);
  t.mg = {r7.x, r7.y, r7.z};
  t.kg = r7.w;
  t.mb = {r8.x, r8.y, r8.z};
  t.kb = r8.w;
  t.dtri = r9.x;
  t.safe_hi = r9.y;
  t.s_hi = r9.z;
  return t;
}

// The exact squared distance of a pair, with the plain version's roundings.
// (1) The edges, each clamped as seg_d says (a vertex distance, computed
// once for the two edges that share it, except where t lies between 0 and
// 1). (2) The inside test, only for a pair in or near the triangle's prism:
// - the filter "near" passes every pair the plain test calls inside. The
//   numerators num_g = (ab x ap).n and num_b = (ap x ac).n are the triple
//   products ap.m_g and ap.m_b, which ug and ub compute with fused
//   multiply-adds; each differs from its exact value by at most ~10.1 u
//   |n|_inf |e|_inf |ap|_1 (u = 2^-24, e = ab or ac), so ug from num_g by
//   at most 20.1 u of it, and k_e = 2^-17 |n|_inf |e|_inf (128 u) covers
//   that 6x over; d_tri = safe 2^-99 + 2^-100 covers the threshold below
//   and the absolute error of results under 2^-126. Inside means beta >= 0,
//   gamma >= 0 and beta + gamma <= 1, so num_g + num_b <= safe (1 + 3.02 u);
//   s_hi = safe (1 + 2^-20) + 2 d_tri bounds it with the same margins;
// - the candidates, from the exact numerators: beta = num_b / safe >= 0
//   holds where num_b >= 0, or where num_b < 0 and the quotient underflows
//   to -0.0, which needs |num_b| <= safe 2^-150, so every such pair has
//   num_b >= thr = -(safe 2^-100); and beta + gamma <= 1 needs
//   num_g + num_b <= safe_hi = safe (1 + 2^-20);
// - the quotients, their sum and d_plane only for a candidate.
__device__ __forceinline__ float tri_d(V3 p, const Tri& tr) {
  const V3 ap = sub3(p, tr.a), bp = sub3(p, tr.b), cp = sub3(p, tr.c);
  const float dd_a = dot3(ap, ap), dd_b = dot3(bp, bp), dd_c = dot3(cp, cp);
  float d = fminf(fminf(seg_d(p, tr.a, ap, tr.ab, tr.den_ab, dd_a, dd_b, tr.ends & 1),
                        seg_d(p, tr.a, ap, tr.ac, tr.den_ac, dd_a, dd_c, tr.ends & 2)),
                  seg_d(p, tr.b, bp, tr.bc, tr.den_bc, dd_b, dd_c, tr.ends & 4));
  const float l1 = fabsf(ap.x) + fabsf(ap.y) + fabsf(ap.z);
  const float ug = fmaf(ap.x, tr.mg.x, fmaf(ap.y, tr.mg.y, ap.z * tr.mg.z));
  const float ub = fmaf(ap.x, tr.mb.x, fmaf(ap.y, tr.mb.y, ap.z * tr.mb.z));
  const float eg = fmaf(l1, tr.kg, tr.dtri), eb = fmaf(l1, tr.kb, tr.dtri);
  if (tr.n2pos != 0.f && ug >= -eg && ub >= -eb && ug + ub <= eg + eb + tr.s_hi) {
    const float num_g = dot3(cross3(tr.ab, ap), tr.n);
    const float num_b = dot3(cross3(ap, tr.ac), tr.n);
    if (num_g >= tr.thr && num_b >= tr.thr && __fadd_rn(num_g, num_b) <= tr.safe_hi) {
      const float gamma = __fdiv_rn(num_g, tr.safe);
      const float beta = __fdiv_rn(num_b, tr.safe);
      if (beta >= 0.f && gamma >= 0.f && __fadd_rn(beta, gamma) <= 1.f) {
        const float dot_n = dot3(ap, tr.n);
        d = __fdiv_rn(__fmul_rn(dot_n, dot_n), tr.safe);
      }
    }
  }
  return d;
}

__device__ __forceinline__ bool same3(V3 u, V3 v) {
  return __float_as_int(u.x) == __float_as_int(v.x) && __float_as_int(u.y) == __float_as_int(v.y)
         && __float_as_int(u.z) == __float_as_int(v.z);
}

__device__ __forceinline__ V3 add3(V3 u, V3 v) {
  return {__fadd_rn(u.x, v.x), __fadd_rn(u.y, v.y), __fadd_rn(u.z, v.z)};
}

__global__ void __launch_bounds__(THREADS) triangle_records_kernel(
    const float* __restrict__ verts, const int* __restrict__ faces, float4* __restrict__ rec,
    int T) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= T) return;
  const int* f = faces + (long long)i * 3;
  const V3 a = {verts[f[0] * 3 + 0], verts[f[0] * 3 + 1], verts[f[0] * 3 + 2]};
  const V3 b = {verts[f[1] * 3 + 0], verts[f[1] * 3 + 1], verts[f[1] * 3 + 2]};
  const V3 c = {verts[f[2] * 3 + 0], verts[f[2] * 3 + 1], verts[f[2] * 3 + 2]};
  const V3 ab = sub3(b, a), ac = sub3(c, a), bc = sub3(c, b);
  const V3 n = cross3(ab, ac);
  const float n2 = dot3(n, n);
  const float l_ab = dot3(ab, ab), l_ac = dot3(ac, ac), l_bc = dot3(bc, bc);
  const float safe = n2 == 0.f ? 1.f : n2;
  const int ends = (same3(add3(a, ab), b) ? 1 : 0) | (same3(add3(a, ac), c) ? 2 : 0) |
                   (same3(add3(b, bc), c) ? 4 : 0);
  const V3 mg = cross3(n, ab), mb = cross3(ac, n);
  const float n_inf = fmaxf(fabsf(n.x), fmaxf(fabsf(n.y), fabsf(n.z)));
  const float kg = n_inf * fmaxf(fabsf(ab.x), fmaxf(fabsf(ab.y), fabsf(ab.z))) * 0x1p-17f;
  const float kb = n_inf * fmaxf(fabsf(ac.x), fmaxf(fabsf(ac.y), fabsf(ac.z))) * 0x1p-17f;
  float4* r = rec + (long long)i * REC;
  r[0] = make_float4(a.x, a.y, a.z, ab.x);
  r[1] = make_float4(ab.y, ab.z, ac.x, ac.y);
  r[2] = make_float4(ac.z, n.x, n.y, n.z);
  r[3] = make_float4(b.x, b.y, b.z, bc.x);
  r[4] = make_float4(bc.y, bc.z, c.x, c.y);
  r[5] = make_float4(c.z, l_ab == 0.f ? 1.f : l_ab, l_ac == 0.f ? 1.f : l_ac,
                     l_bc == 0.f ? 1.f : l_bc);
  r[6] = make_float4(safe, -__fmul_rn(safe, 0x1p-100f), n2 > 0.f ? 1.f : 0.f,
                     __int_as_float(ends));
  r[7] = make_float4(mg.x, mg.y, mg.z, kg);
  r[8] = make_float4(mb.x, mb.y, mb.z, kb);
  const float dtri = safe * 0x1p-99f + 0x1p-100f;
  const float safe_hi = safe * (1.f + 0x1p-20f);
  r[9] = make_float4(dtri, safe_hi, safe_hi + 2.f * dtri, 0.f);
}

__device__ __forceinline__ void load_tile(float4* dst, const float4* __restrict__ rec, int t0,
                                          int nt) {
  for (int q = threadIdx.x; q < nt * REC; q += THREADS)
    cp_async16(reinterpret_cast<float*>(dst + q),
               reinterpret_cast<const float*>(rec + (long long)t0 * REC + q));
  cp_async_commit();
}

__global__ void __launch_bounds__(THREADS) point_mesh_distance_kernel(
    const float* __restrict__ points, const float4* __restrict__ rec, float* __restrict__ out,
    int P, int T) {
  __shared__ float4 tiles[2][TILE * REC];
  V3 p[PPT];
  float best[PPT];
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    const int pi = (blockIdx.x * PPT + q) * THREADS + threadIdx.x;
    p[q] = pi < P ? V3{points[pi * 3 + 0], points[pi * 3 + 1], points[pi * 3 + 2]}
                  : V3{0.f, 0.f, 0.f};
    best[q] = __int_as_float(0x7f800000);   // +inf
  }
  // the block's tiles: every gridDim.y-th tile of triangles from tile
  // blockIdx.y, so that each block sees triangles from all over the mesh
  // (a mesh's triangle order is spatial, and the pairs near the surface
  // cost more)
  const int tiles_total = (T + TILE - 1) / TILE;
  if ((int)blockIdx.y >= tiles_total) return;
  load_tile(tiles[0], rec, blockIdx.y * TILE, min(TILE, T - (int)blockIdx.y * TILE));
  for (int ti = blockIdx.y, k = 0; ti < tiles_total; ti += gridDim.y, ++k) {
    const int t0 = ti * TILE, nt = min(TILE, T - t0);
    const int next = ti + gridDim.y;
    if (next < tiles_total) {   // the next tile into the other buffer, then wait for this one
      load_tile(tiles[(k + 1) & 1], rec, next * TILE, min(TILE, T - next * TILE));
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float4* tile = tiles[k & 1];
#pragma unroll 1
    for (int j = 0; j < nt; ++j) {
      const Tri tr = unpack_tri(tile + j * REC);
#pragma unroll
      for (int q = 0; q < PPT; ++q) best[q] = fminf(best[q], tri_d(p[q], tr));
    }
    __syncthreads();   // this buffer is read before the load after next lands in it
  }
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    const int pi = (blockIdx.x * PPT + q) * THREADS + threadIdx.x;
    if (pi < P) atomicMin(reinterpret_cast<int*>(out + pi), __float_as_int(best[q]));
  }
}

}  // namespace

// points [P,3], verts [V,3] f32; faces [T,3] int32 indices into verts;
// rec: scratch of T * 160 bytes, 16-byte aligned (the triangle records);
// out [P] f32, filled with +inf by the caller (min-folded in place).
PANIC3D_EXPORT int point_mesh_distance(const float* points, const float* verts,
                                       const int* faces, float* rec, float* out, int P, int T,
                                       void* stream) {
  if (P < 1 || T < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  triangle_records_kernel<<<(T + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      verts, faces, reinterpret_cast<float4*>(rec), T);
  int dev = 0, sms = 132, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, point_mesh_distance_kernel, THREADS, 0);
  const int point_blocks = (P + THREADS * PPT - 1) / (THREADS * PPT);
  // one wave: as many blocks as the card holds at once (at least one split
  // per point block), each with at least one full tile of triangles
  long long splits = (long long)sms * (per_sm > 0 ? per_sm : 1) / point_blocks;
  const long long max_splits = (T + TILE - 1) / TILE;
  if (splits < 1) splits = 1;
  if (splits > max_splits) splits = max_splits;
  if (splits > 65535) splits = 65535;
  point_mesh_distance_kernel<<<dim3(point_blocks, (unsigned)splits), THREADS, 0, s>>>(
      points, reinterpret_cast<const float4*>(rec), out, P, T);
  return (int)cudaGetLastError();
}
