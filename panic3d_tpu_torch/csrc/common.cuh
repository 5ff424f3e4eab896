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
__device__ __forceinline__ float softplus_f(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
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
