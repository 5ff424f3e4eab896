// K12 gather_dot: out[p] = table[idx[p]] @ w, f32 with f32 accumulation.
//
// Replaces (Pallas): scripts/bench_pallas_gather.py:pallas_fused (:43, the
// pl.pallas_call at :70), the repository's one Pallas kernel: a probe that
// copies TILE rows of a VMEM-resident [4096, 128] f32 table into scratch by
// scalar-prefetched index, then multiplies the tile by a [128, 64] weight.
//
// What bounds it on the H100: at the probe's shapes (131,072 indices into
// 4,096 rows) the output is 131,072 x 64 f32 = 33.5 MB, ~0.01 ms of writes at
// 3.35 TB/s. The distinct row products are 4,096 x 128 x 64 x 2 = 67 MFLOP,
// ~1 us at 67 TFLOP/s f32: bytes bound. Gathering the rows first and doing
// the dot per output row would be 2.1 GFLOP, 32x the arithmetic for the same
// result.
//
// Design: compute once, then gather. Launch 1 multiplies every table row by
// w into a [R, D] product table, one thread per product, as a sequential
// multiply-add over k -- the plain dot order, so each output row is the
// number the per-row dot gives. A warp shares one table row (broadcast
// loads) and reads w's row k as one coalesced line; table and w (2 MB) stay
// in L2. Launch 2 copies product rows to the output by index with 16-byte
// loads and stores; the 1 MB product table stays in L2, so the output writes
// are the only device-memory traffic that scales with P. Tensor cores (TF32
// would change the numbers) are a later PR's work.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

// prod[r, c] = sum_k table[r, k] * w[k, c], k in order
__global__ void row_products_kernel(const float* __restrict__ table,
                                    const float* __restrict__ w, float* __restrict__ prod,
                                    int R, int K, int D) {
  const unsigned e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (unsigned)R * (unsigned)D) return;
  const unsigned r = e / D, c = e % D;
  const float* row = table + (size_t)r * K;
  float acc = 0.f;
#pragma unroll 8
  for (int k = 0; k < K; ++k) acc = fmaf(row[k], w[(size_t)k * D + c], acc);
  prod[e] = acc;
}

// out[p, :] = prod[clamp(idx[p]), :], one float4 per thread
__global__ void gather_rows_kernel(const int* __restrict__ idx, const float4* __restrict__ prod,
                                   float4* __restrict__ out, unsigned total, unsigned d4, int R) {
  const unsigned e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const unsigned p = e / d4, q = e % d4;
  const int row = min(max(idx[p], 0), R - 1);
  out[e] = prod[(size_t)row * d4 + q];
}

}  // namespace

// idx [P] int32, table [R,K] f32, w [K,D] f32, prod [R,D] f32 scratch, out
// [P,D] f32; D a multiple of 4, P*D and R*D below 2^31 (else
// cudaErrorInvalidValue). Indices are clamped to [0, R).
PANIC3D_EXPORT int gather_dot(const int* idx, const float* table, const float* w, float* prod,
                              float* out, int P, int R, int K, int D, void* stream) {
  if (D % 4 != 0 || D < 4 || R < 1 || P < 0 || (long long)P * D >= (1LL << 31) ||
      (long long)R * D >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned n_prod = (unsigned)R * (unsigned)D;
  row_products_kernel<<<(n_prod + THREADS - 1) / THREADS, THREADS, 0, s>>>(table, w, prod, R,
                                                                          K, D);
  const unsigned total = (unsigned)P * (unsigned)(D / 4);
  if (total > 0) {
    gather_rows_kernel<<<(total + THREADS - 1) / THREADS, THREADS, 0, s>>>(
        idx, reinterpret_cast<const float4*>(prod), reinterpret_cast<float4*>(out), total, D / 4,
        R);
  }
  return (int)cudaGetLastError();
}
