// K9 point_mesh_distance: for each point, the minimum over the mesh's
// triangles of the exact squared point-to-triangle distance.
//
// Replaces (JAX): panic3d_tpu/eval/mesh_metrics.py:point_mesh_distance_sq
// (:61), a lax.scan over 2048-triangle chunks of
// point_triangle_distance_sq (:23), the brute-force [P, T] problem that
// stands in for igl's AABB trees in the chamfer / F1 metrics.
//
// What bounds it on the H100: operations. Each (point, triangle) pair costs
// ~118 f32 operations (three clipped edge distances, the plane distance and
// the barycentric inside test, six of them IEEE divisions) and reads
// nothing new: 10,000 points against ~1e6 triangles is ~1.2 TFLOP, ~18 ms
// at 67 TFLOP/s, while the inputs are a few MB.
//
// Design: a block holds 128 points in registers (one a thread) and streams
// its share of the triangles through shared memory in tiles of 128; each
// triangle's a, b, b-a, c-a, c-b, normal, |n|^2 and squared edge lengths are
// computed once per tile by one thread. Blocks split the triangles as well
// as the points (enough blocks to fill the card), and fold their running
// minima into the output with an integer atomicMin on the f32 bits (the
// squared distances are >= 0, so the order of the bits is the order of the
// values, and the result does not depend on the order of the blocks). Every
// operation is the plain version's (mesh_metrics.py:point_triangle_distance_sq,
// one PyTorch op per multiply, add and divide), explicitly rounded with
// __fmul_rn/__fadd_rn/__fdiv_rn so that nvcc contracts nothing: exact
// against it. Degenerate triangles take the same where(.., 1, ..) guards; no
// padding triangles are needed.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;    // points per block
constexpr int TILE = 128;       // triangles per shared-memory tile

struct V3 { float x, y, z; };

struct Tri {
  V3 a, b, ab, ac, bc, n;
  float n2, l_ab, l_ac, l_bc;
};

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

// squared distance from p to the segment s -> s + se (sp = p - s)
__device__ __forceinline__ float seg_d(V3 p, V3 s, V3 sp, V3 se, float len2) {
  float t = __fdiv_rn(dot3(sp, se), len2 == 0.f ? 1.f : len2);
  t = fminf(fmaxf(t, 0.f), 1.f);
  const V3 closest = {__fadd_rn(s.x, __fmul_rn(t, se.x)), __fadd_rn(s.y, __fmul_rn(t, se.y)),
                      __fadd_rn(s.z, __fmul_rn(t, se.z))};
  const V3 d = sub3(p, closest);
  return dot3(d, d);
}

__device__ __forceinline__ float tri_d(V3 p, const Tri& tr) {
  const V3 ap = sub3(p, tr.a);
  const float d_edges = fminf(fminf(seg_d(p, tr.a, ap, tr.ab, tr.l_ab),
                                    seg_d(p, tr.a, ap, tr.ac, tr.l_ac)),
                              seg_d(p, tr.b, sub3(p, tr.b), tr.bc, tr.l_bc));
  const float safe = tr.n2 == 0.f ? 1.f : tr.n2;
  const float dot_n = dot3(ap, tr.n);
  const float d_plane = __fdiv_rn(__fmul_rn(dot_n, dot_n), safe);
  const float gamma = __fdiv_rn(dot3(cross3(tr.ab, ap), tr.n), safe);
  const float beta = __fdiv_rn(dot3(cross3(ap, tr.ac), tr.n), safe);
  const bool inside = beta >= 0.f && gamma >= 0.f && __fadd_rn(beta, gamma) <= 1.f &&
                      tr.n2 > 0.f;
  return inside ? d_plane : d_edges;
}

__global__ void __launch_bounds__(THREADS) point_mesh_distance_kernel(
    const float* __restrict__ points, const float* __restrict__ verts,
    const int* __restrict__ faces, float* __restrict__ out, int P, int T) {
  __shared__ Tri tile[TILE];
  const int pi = blockIdx.x * THREADS + threadIdx.x;
  V3 p = {0.f, 0.f, 0.f};
  if (pi < P) p = {points[pi * 3 + 0], points[pi * 3 + 1], points[pi * 3 + 2]};
  const int t_lo = (int)((long long)T * blockIdx.y / gridDim.y);
  const int t_hi = (int)((long long)T * (blockIdx.y + 1) / gridDim.y);
  float best = __int_as_float(0x7f800000);   // +inf
  for (int t0 = t_lo; t0 < t_hi; t0 += TILE) {
    const int nt = min(TILE, t_hi - t0);
    __syncthreads();
    if (threadIdx.x < nt) {
      const int* f = faces + (long long)(t0 + threadIdx.x) * 3;
      const V3 a = {verts[f[0] * 3 + 0], verts[f[0] * 3 + 1], verts[f[0] * 3 + 2]};
      const V3 b = {verts[f[1] * 3 + 0], verts[f[1] * 3 + 1], verts[f[1] * 3 + 2]};
      const V3 c = {verts[f[2] * 3 + 0], verts[f[2] * 3 + 1], verts[f[2] * 3 + 2]};
      Tri tr;
      tr.a = a;
      tr.b = b;
      tr.ab = sub3(b, a);
      tr.ac = sub3(c, a);
      tr.bc = sub3(c, b);
      tr.n = cross3(tr.ab, tr.ac);
      tr.n2 = dot3(tr.n, tr.n);
      tr.l_ab = dot3(tr.ab, tr.ab);
      tr.l_ac = dot3(tr.ac, tr.ac);
      tr.l_bc = dot3(tr.bc, tr.bc);
      tile[threadIdx.x] = tr;
    }
    __syncthreads();
    for (int j = 0; j < nt; ++j) best = fminf(best, tri_d(p, tile[j]));
  }
  if (pi < P && t_hi > t_lo) atomicMin(reinterpret_cast<int*>(out + pi), __float_as_int(best));
}

}  // namespace

// points [P,3], verts [V,3] f32; faces [T,3] int32 indices into verts;
// out [P] f32, filled with +inf by the caller (min-folded in place).
PANIC3D_EXPORT int point_mesh_distance(const float* points, const float* verts,
                                       const int* faces, float* out, int P, int T,
                                       void* stream) {
  if (P < 1 || T < 1) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int point_blocks = (P + THREADS - 1) / THREADS;
  // about eight blocks per SM in all, each with at least one full tile
  long long splits = (8LL * sms + point_blocks - 1) / point_blocks;
  const long long max_splits = (T + TILE - 1) / TILE;
  if (splits > max_splits) splits = max_splits;
  if (splits > 65535) splits = 65535;
  point_mesh_distance_kernel<<<dim3(point_blocks, (unsigned)splits), THREADS, 0,
                               static_cast<cudaStream_t>(stream)>>>(points, verts, faces, out,
                                                                    P, T);
  return (int)cudaGetLastError();
}
