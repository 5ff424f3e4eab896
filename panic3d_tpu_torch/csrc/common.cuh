// Shared helpers for the panic3d_tpu_torch CUDA kernels (plain C interface,
// loaded with ctypes; see panic3d_tpu_torch/kernels/build.py).
#pragma once

#include <math.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define PANIC3D_EXPORT extern "C" __attribute__((visibility("default")))

// dtype codes passed by the Python wrappers
enum DType { DT_F32 = 0, DT_BF16 = 1 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as a dtype cast does
}

// softplus(x) = log(1 + e^x) in the overflow-safe form jax.nn.softplus uses
__host__ __device__ __forceinline__ float softplus_f(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

// softplus on the SFU: max(x, 0) + ln2 lg2(1 + ex2(-|x| log2e)) with the
// flush-to-zero forms of ex2/lg2.approx (one MUFU instruction each, no
// denormal fix-ups: an ex2 result that would be denormal leaves 1 + e = 1
// all the same, and 1 + e lies in [1, 2]). Within ~2e-7 of softplus_f, far
// inside the tolerances of K1 (sigma 1e-4) and K7a (1e-5 x max|A|); for the
// decoders' 64 hidden units, where libm's expf and log1pf cost the most.
__device__ __forceinline__ float softplus_fast(float x) {
  float e, l;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(-fabsf(x) * 1.4426950408889634f));
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(l) : "f"(1.f + e));
  return fmaf(l, 0.6931471805599453f, fmaxf(x, 0.f));
}

// 16 bytes global -> shared without the registers (cp.async, L2 only);
// cp_async16_zfill writes 16 zero bytes instead where valid is false (src
// is then not read)
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async16_zfill(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ int floor_mod(int a, int b) { return a - floor_div(a, b) * b; }

// float atomics through the ordered-integer trick (valid for non-NaN values;
// *addr starts at +inf for min, -inf for max)
__device__ __forceinline__ void atomic_min_f(float* addr, float v) {
  if (!signbit(v)) atomicMin(reinterpret_cast<int*>(addr), __float_as_int(v));
  else atomicMax(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
}

__device__ __forceinline__ void atomic_max_f(float* addr, float v) {
  if (!signbit(v)) atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  else atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
}

PANIC3D_EXPORT const char* panic3d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
