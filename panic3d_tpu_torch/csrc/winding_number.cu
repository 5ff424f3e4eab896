// K13 winding_number: the exact generalised winding number of each query
// point with respect to a triangle mesh, sum over the triangles of the
// van Oosterom-Strackee solid angle 2 atan2(num, den), divided by 4 pi.
//
// Replaces (JAX): panic3d_tpu/eval/gltf.py:winding_numbers (:77), a jitted
// dense [Q, T] op chunked over the queries, which remove_innards (:109)
// runs with every vertex of a GT head as a query (Q = V) to drop the
// interior geometry (winding number >= 1.3).
//
// What bounds it on the H100: the arithmetic of the Q x T pairs. The inputs
// are a few MB; each pair takes ~60 f32 operations (three differences,
// three norms, a cross product, four dot products, den's seven operations),
// three square roots and the atan2's reciprocal on the SFU (4 MUFU
// operations a pair, the bound chip_smoke.py divides by). None of the f32
// operations is contracted (below), so instruction issue, not the SFU, is
// the ceiling in practice: ~88 SASS instructions a pair in the inner loop
// (chip_smoke.py counts them; __fsqrt_rn, atan2f and a Kahan sum a pair
// took ~187).
//
// Design (as K9's, csrc/mesh_distance.cu):
// - A first launch (gather_tris_kernel) writes tris = verts[faces] as 3
//   float4 a triangle (A.xyz B.x | B.yz C.xy | C.z and 3 zeros), so that a
//   triangle is three 16-byte shared-memory reads.
// - The winding kernel gives each thread QPT queries, whose coordinates
//   and sums stay in registers, and each block every gridDim.y-th tile of
//   TILE triangles, streamed through shared memory by cp.async, the next
//   tile in flight into the other of two buffers: all lanes of a warp read
//   the same triangle (a broadcast), and one read serves QPT pairs.
// - Each query sums a tile's terms into an f32 partial (one add a pair) and
//   folds the partial into its running sum with Kahan's compensation once
//   a tile. The running (sum, compensation) of each split goes to scratch;
//   a last launch (winding_reduce_kernel) adds the splits in their fixed
//   order, again compensated, so two runs give the same bits (no atomics).
//   tests/test_torch_winding_order.py holds this order of summation
//   (eval/gltf.py:winding_numbers_tiled) against f64 on the CPU.
// - The splits: as many blocks as the card holds at once (one wave), at
//   least one tile of triangles a split.
//
// Numerics. num and den are computed in the plain version's order
// (eval/gltf.py:winding_numbers_plain, one PyTorch op per operation) with
// __fmul_rn / __fadd_rn / __fsub_rn, so nvcc does not contract a * b + c
// into an FMA: where den < 0 and num is near 0 (a query in the plane of a
// triangle but outside it) the sign of num picks the +pi or -pi branch of
// atan2, and a contraction would move it. The three norms are the SFU's
// square root (sqrt.approx, one MUFU each; they reach only den's magnitude,
// never a sign), and atan2 is its own (half_atan2 below: the reciprocal on
// the SFU, a minimax polynomial, the quadrant from the signs of num and den,
// as atan2f's). The terms are summed as atan2 and doubled once at the end
// (exact). For a triangle that has the query as a vertex, a, b or c is
// exactly 0, num and den are signed zeros and the term is a zero of num's
// sign (+pi or -pi of num's sign where den is -0), as the plain version's.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int QPT = 4;                      // queries a thread
constexpr int QPB = THREADS * QPT;          // queries a block
constexpr int TILE = 32;                    // triangles a shared-memory tile (a partial)
constexpr int REC = 3;                      // float4 a triangle
constexpr float FOUR_PI = 12.566370614359172f;

__global__ void gather_tris_kernel(const float* __restrict__ verts, const int* __restrict__ faces,
                                   float4* __restrict__ tris, int V, int T) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  float p[12];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int v = faces[t * 3 + k];
    const bool ok = v >= 0 && v < V;        // an index out of range reads NaN
#pragma unroll
    for (int d = 0; d < 3; ++d) p[k * 3 + d] = ok ? verts[v * 3 + d] : __int_as_float(0x7fc00000);
  }
  p[9] = p[10] = p[11] = 0.f;
  tris[t * REC + 0] = make_float4(p[0], p[1], p[2], p[3]);
  tris[t * REC + 1] = make_float4(p[4], p[5], p[6], p[7]);
  tris[t * REC + 2] = make_float4(p[8], p[9], p[10], p[11]);
}

// the n triangles from t0 into shared memory (REC 16-byte copies each)
__device__ __forceinline__ void load_tile(float4* dst, const float4* tris, int t0, int n) {
  const float4* src = tris + (long long)t0 * REC;
  for (int i = threadIdx.x; i < n * REC; i += THREADS)
    cp_async16(reinterpret_cast<float*>(dst + i), reinterpret_cast<const float*>(src + i));
  cp_async_commit();
}

__device__ __forceinline__ float dot3(float ux, float uy, float uz, float vx, float vy,
                                      float vz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ux, vx), __fmul_rn(uy, vy)), __fmul_rn(uz, vz));
}

// |v| with the SFU's square root (one MUFU; __fsqrt_rn adds ~7 instructions)
__device__ __forceinline__ float norm3(float x, float y, float z) {
  const float n2 = dot3(x, y, z, x, y, z);
  float r;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(n2));
  return r;
}

// atan2(y, x) for finite or NaN y, x: t = min / max of |y|, |x| (0 where
// the larger is below FLT_MIN: signed zeros and flushed denormals), atan(t)
// by a minimax polynomial in t^2 (max error 1.4 ulp on [0, 1] with an exact
// t; fitted in f64 on a dense grid), then pi/2 - r where |y| > |x|, pi - r
// where x has its sign bit set, and y's sign. So atan2(+-0, +0) = +-0 and
// atan2(+-0, -0) = +-pi, as atan2f.
__device__ __forceinline__ float half_atan2(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float mx = fmaxf(ax, ay), mn = fminf(ax, ay);
  float rcp;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(rcp) : "f"(mx));
  const float t = mx < 1.17549435e-38f ? 0.f : mn * rcp;   // NaN stays NaN
  const float s = t * t;
  float r = 2.922184765e-03f;
  r = fmaf(r, s, -1.637890562e-02f);
  r = fmaf(r, s, 4.323862866e-02f);
  r = fmaf(r, s, -7.555311918e-02f);
  r = fmaf(r, s, 1.066788733e-01f);
  r = fmaf(r, s, -1.421165466e-01f);
  r = fmaf(r, s, 1.999386251e-01f);
  r = fmaf(r, s, -3.333315849e-01f);
  r = fmaf(r * s, t, t);
  if (ay > ax) r = 1.57079637f - r;
  if (signbit(x)) r = 3.14159274f - r;
  return copysignf(r, y);
}

// atan2(num, den) of one triangle (its records r0..r2) seen from q: half
// its solid angle
__device__ __forceinline__ float half_angle(float4 r0, float4 r1, float4 r2, float qx, float qy,
                                            float qz) {
  const float ax = __fsub_rn(r0.x, qx), ay = __fsub_rn(r0.y, qy), az = __fsub_rn(r0.z, qz);
  const float bx = __fsub_rn(r0.w, qx), by = __fsub_rn(r1.x, qy), bz = __fsub_rn(r1.y, qz);
  const float cx = __fsub_rn(r1.z, qx), cy = __fsub_rn(r1.w, qy), cz = __fsub_rn(r2.x, qz);
  const float la = norm3(ax, ay, az);
  const float lb = norm3(bx, by, bz);
  const float lc = norm3(cx, cy, cz);
  // b x c, as torch.linalg.cross: (by cz - bz cy, bz cx - bx cz, bx cy - by cx)
  const float kx = __fsub_rn(__fmul_rn(by, cz), __fmul_rn(bz, cy));
  const float ky = __fsub_rn(__fmul_rn(bz, cx), __fmul_rn(bx, cz));
  const float kz = __fsub_rn(__fmul_rn(bx, cy), __fmul_rn(by, cx));
  const float num = dot3(ax, ay, az, kx, ky, kz);
  // la lb lc + (a.b) lc + (b.c) la + (c.a) lb, left to right
  float den = __fmul_rn(__fmul_rn(la, lb), lc);
  den = __fadd_rn(den, __fmul_rn(dot3(ax, ay, az, bx, by, bz), lc));
  den = __fadd_rn(den, __fmul_rn(dot3(bx, by, bz, cx, cy, cz), la));
  den = __fadd_rn(den, __fmul_rn(dot3(cx, cy, cz, ax, ay, az), lb));
  return half_atan2(num, den);
}

// s += y with Kahan's compensation c (the sum is s - c)
__device__ __forceinline__ void kahan_add(float& s, float& c, float y) {
  const float d = __fsub_rn(y, c);
  const float t = __fadd_rn(s, d);
  c = __fsub_rn(__fsub_rn(t, s), d);
  s = t;
}

__global__ void __launch_bounds__(THREADS) winding_number_kernel(
    const float4* __restrict__ tris, const float* __restrict__ queries,
    float2* __restrict__ part, int Q, int T) {
  __shared__ float4 tiles[2][TILE * REC];
  float qx[QPT], qy[QPT], qz[QPT], s[QPT], c[QPT];
#pragma unroll
  for (int q = 0; q < QPT; ++q) {
    const int qi = (blockIdx.x * QPT + q) * THREADS + threadIdx.x;
    const bool live = qi < Q;
    qx[q] = live ? queries[qi * 3 + 0] : 0.f;
    qy[q] = live ? queries[qi * 3 + 1] : 0.f;
    qz[q] = live ? queries[qi * 3 + 2] : 0.f;
    s[q] = c[q] = 0.f;
  }
  // the block's tiles: every gridDim.y-th tile of triangles from tile
  // blockIdx.y (the launcher gives every split at least one)
  const int tiles_total = (T + TILE - 1) / TILE;
  load_tile(tiles[0], tris, blockIdx.y * TILE, min(TILE, T - (int)blockIdx.y * TILE));
  for (int ti = blockIdx.y, k = 0; ti < tiles_total; ti += gridDim.y, ++k) {
    const int nt = min(TILE, T - ti * TILE);
    const int next = ti + gridDim.y;
    if (next < tiles_total) {   // the next tile into the other buffer, then wait for this one
      load_tile(tiles[(k + 1) & 1], tris, next * TILE, min(TILE, T - next * TILE));
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float4* tile = tiles[k & 1];
    float p[QPT];
#pragma unroll
    for (int q = 0; q < QPT; ++q) p[q] = 0.f;
#pragma unroll 1
    for (int j = 0; j < nt; ++j) {
      const float4 r0 = tile[j * REC + 0], r1 = tile[j * REC + 1], r2 = tile[j * REC + 2];
#pragma unroll
      for (int q = 0; q < QPT; ++q) p[q] = __fadd_rn(p[q], half_angle(r0, r1, r2, qx[q], qy[q], qz[q]));
    }
#pragma unroll
    for (int q = 0; q < QPT; ++q) kahan_add(s[q], c[q], p[q]);
    __syncthreads();   // this buffer is read before the load after next lands in it
  }
#pragma unroll
  for (int q = 0; q < QPT; ++q) {
    const int qi = (blockIdx.x * QPT + q) * THREADS + threadIdx.x;
    if (qi < Q) part[(long long)blockIdx.y * Q + qi] = make_float2(s[q], c[q]);
  }
}

// out[q] = 2 (sum over the splits, in order) / 4 pi, compensated
__global__ void winding_reduce_kernel(const float2* __restrict__ part, float* __restrict__ out,
                                      int Q, int splits) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= Q) return;
  float s = 0.f, c = 0.f;
  for (int k = 0; k < splits; ++k) {
    const float2 v = part[(long long)k * Q + qi];
    kahan_add(s, c, v.x);
    kahan_add(s, c, -v.y);
  }
  out[qi] = __fdiv_rn(__fmul_rn(2.f, __fsub_rn(s, c)), FOUR_PI);
}

}  // namespace

// The splits of the triangles for Q queries and T triangles: as many blocks
// as the card holds at once, at least one tile of triangles a split.
PANIC3D_EXPORT int winding_number_splits(int Q, int T) {
  int dev = 0, sms = 132, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, winding_number_kernel, THREADS, 0);
  const long long query_blocks = (Q + QPB - 1) / QPB;
  long long splits = (long long)sms * (per_sm > 0 ? per_sm : 1) / (query_blocks > 0 ? query_blocks : 1);
  const long long max_splits = (T + TILE - 1) / TILE;
  if (splits > max_splits) splits = max_splits;
  if (splits > 65535) splits = 65535;
  return splits < 1 ? 1 : (int)splits;
}

// verts [V,3] f32; faces [T,3] int32 indices into verts; queries [Q,3] f32;
// scratch: 48 T bytes (the triangles) then 8 splits Q bytes (the splits'
// sums), 16-byte aligned; out [Q] f32. splits from winding_number_splits
// (any value from 1 to the tiles of T is valid).
PANIC3D_EXPORT int winding_number(const float* verts, const int* faces, const float* queries,
                                  float* scratch, float* out, int V, int T, int Q, int splits,
                                  void* stream) {
  if (Q < 1 || T < 1 || V < 1 || splits < 1 || splits > (T + TILE - 1) / TILE || splits > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float4* tris = reinterpret_cast<float4*>(scratch);
  float2* part = reinterpret_cast<float2*>(tris + (long long)T * REC);
  gather_tris_kernel<<<(T + THREADS - 1) / THREADS, THREADS, 0, st>>>(verts, faces, tris, V, T);
  winding_number_kernel<<<dim3((Q + QPB - 1) / QPB, splits), THREADS, 0, st>>>(tris, queries,
                                                                                 part, Q, T);
  winding_reduce_kernel<<<(Q + THREADS - 1) / THREADS, THREADS, 0, st>>>(part, out, Q, splits);
  return (int)cudaGetLastError();
}
