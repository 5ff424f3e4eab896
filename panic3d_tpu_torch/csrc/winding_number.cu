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
// three square roots and the atan2, whose reciprocal and polynomial run on
// the SFU and the FMA pipe. None of them is contracted (below), so the f32
// pipe runs at its FMA-free rate.
//
// Design. A first launch (gather_tris_kernel) writes tris = verts[faces]
// as 9 floats a triangle (36 bytes, so a tile of a multiple of 4 triangles
// starts on a 16-byte boundary). The winding kernel gives each query a
// group of LANES lanes (32 / LANES queries a warp, 256 / LANES a block);
// the block streams the triangles through shared memory in tiles of TILE,
// by cp.async, the next tile in flight into the other of two buffers while
// the block works on this one. Lane l of a group takes the triangles l,
// l + LANES, ... of each tile: a warp reads LANES records at a time, whose
// 9-float stride puts them in distinct banks, and the groups of the warp
// read the same ones (a broadcast). Each lane sums its terms in f32 with
// Kahan's compensation; the group's partial sums are added by shuffles at
// the end, and one lane writes the sum divided by 4 pi.
//
// Numerics. num and den are computed in the plain version's order
// (eval/gltf.py:winding_numbers_plain, one PyTorch op per operation) with
// __fmul_rn / __fadd_rn / __fsub_rn, so nvcc does not contract a * b + c
// into an FMA: where den < 0 and num is near 0 (a query in the plane of a
// triangle but outside it) the sign of num picks the +pi or -pi branch of
// atan2, and a contraction would move it. The summation order differs from
// the plain version's, so chip_smoke.py holds both against an f64
// evaluation. For a triangle that has the query as a vertex, a, b or c is
// exactly 0, num and den are signed zeros (den is +0) and atan2 gives a
// zero of num's sign, as the plain version's does.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int LANES = 8;                    // lanes that share one query
constexpr int QPB = THREADS / LANES;        // queries a block
constexpr int TILE = 256;                   // triangles a shared-memory tile
constexpr int TRI = 9;                      // floats a triangle
constexpr int CHUNKS = TILE * TRI / 4;      // 16-byte copies a tile
constexpr float FOUR_PI = 12.566370614359172f;

__global__ void gather_tris_kernel(const float* __restrict__ verts, const int* __restrict__ faces,
                                   float* __restrict__ tris, int V, int T) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int v = faces[t * 3 + k];
    const bool ok = v >= 0 && v < V;        // an index out of range reads NaN
#pragma unroll
    for (int d = 0; d < 3; ++d)
      tris[t * TRI + k * 3 + d] = ok ? verts[v * 3 + d] : __int_as_float(0x7fc00000);
  }
}

// the tile of triangles from t0 into shared memory: CHUNKS 16-byte copies,
// those past the end of the scratch zero-filled (n_chunks: its 16-byte
// chunks in all)
__device__ __forceinline__ void load_tile(float* dst, const float* tris, int t0,
                                          long long n_chunks) {
  const long long c0 = (long long)t0 * TRI / 4;
  for (int i = threadIdx.x; i < CHUNKS; i += THREADS) {
    const bool valid = c0 + i < n_chunks;
    cp_async16_zfill(dst + i * 4, tris + (valid ? (c0 + i) * 4 : 0), valid);
  }
  cp_async_commit();
}

__device__ __forceinline__ float dot3(float ux, float uy, float uz, float vx, float vy,
                                      float vz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ux, vx), __fmul_rn(uy, vy)), __fmul_rn(uz, vz));
}

// 2 atan2(num, den) of one triangle (its 9 floats at r) seen from q
__device__ __forceinline__ float solid_angle(const float* r, float qx, float qy, float qz) {
  const float ax = __fsub_rn(r[0], qx), ay = __fsub_rn(r[1], qy), az = __fsub_rn(r[2], qz);
  const float bx = __fsub_rn(r[3], qx), by = __fsub_rn(r[4], qy), bz = __fsub_rn(r[5], qz);
  const float cx = __fsub_rn(r[6], qx), cy = __fsub_rn(r[7], qy), cz = __fsub_rn(r[8], qz);
  const float la = __fsqrt_rn(dot3(ax, ay, az, ax, ay, az));
  const float lb = __fsqrt_rn(dot3(bx, by, bz, bx, by, bz));
  const float lc = __fsqrt_rn(dot3(cx, cy, cz, cx, cy, cz));
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
  return __fmul_rn(2.f, atan2f(num, den));
}

__global__ void __launch_bounds__(THREADS) winding_number_kernel(
    const float* __restrict__ tris, const float* __restrict__ queries, float* __restrict__ out,
    int Q, int T) {
  __shared__ __align__(16) float tiles[2][TILE * TRI];
  const int lane = threadIdx.x % LANES;
  const int qi = blockIdx.x * QPB + threadIdx.x / LANES;
  const bool live = qi < Q;
  const float qx = live ? queries[qi * 3 + 0] : 0.f;
  const float qy = live ? queries[qi * 3 + 1] : 0.f;
  const float qz = live ? queries[qi * 3 + 2] : 0.f;
  const long long n_chunks = ((long long)T * TRI + 3) / 4;
  const int n_tiles = (T + TILE - 1) / TILE;
  float s = 0.f, comp = 0.f;   // Kahan: the sum and its lost low part
  load_tile(tiles[0], tris, 0, n_chunks);
  for (int k = 0; k < n_tiles; ++k) {
    if (k + 1 < n_tiles) {   // the next tile into the other buffer, then wait for this one
      load_tile(tiles[(k + 1) & 1], tris, (k + 1) * TILE, n_chunks);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* tile = tiles[k & 1];
    const int nt = min(TILE, T - k * TILE);
#pragma unroll 2
    for (int j = lane; j < nt; j += LANES) {
      const float y = __fsub_rn(solid_angle(tile + j * TRI, qx, qy, qz), comp);
      const float t = __fadd_rn(s, y);
      comp = __fsub_rn(__fsub_rn(t, s), y);
      s = t;
    }
    __syncthreads();   // this buffer is read before the load after next lands in it
  }
  float v = __fsub_rn(s, comp);
#pragma unroll
  for (int m = LANES / 2; m > 0; m /= 2) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, m));
  if (live && lane == 0) out[qi] = __fdiv_rn(v, FOUR_PI);
}

}  // namespace

// verts [V,3] f32; faces [T,3] int32 indices into verts; queries [Q,3] f32;
// tris: scratch of ceil(9 T / 4) * 16 bytes, 16-byte aligned; out [Q] f32.
PANIC3D_EXPORT int winding_number(const float* verts, const int* faces, const float* queries,
                                  float* tris, float* out, int V, int T, int Q, void* stream) {
  if (Q < 1 || T < 1 || V < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  gather_tris_kernel<<<(T + THREADS - 1) / THREADS, THREADS, 0, st>>>(verts, faces, tris, V, T);
  winding_number_kernel<<<(Q + QPB - 1) / QPB, THREADS, 0, st>>>(tris, queries, out, Q, T);
  return (int)cudaGetLastError();
}
