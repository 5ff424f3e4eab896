// K5 modconv_epilogue: the modulated conv's epilogue fused with bias_act, in
// one elementwise pass after the weight convolution:
//   x * dcoef[n,c]  ->  + noise[n,h,w]  ->  + bias[c]  ->  lrelu(alpha)  ->  * gain
//   ->  clamp(+-clamp)
// (the noise is one map for the batch, noise_const, read at batch stride 0,
// or one map a sample, noise_mode='random', at batch stride H*W)
// (each stage optional: ToRGB takes bias + clamp, the mapping network's
// FullyConnectedLayer bias + lrelu on [N, F]).
//
// Replaces (JAX): panic3d_tpu/ops/conv.py:modulated_conv2d (:99), its
// demodulation and noise after lax.conv (:144-147), and
// panic3d_tpu/ops/bias_act.py:bias_act (:40), which XLA fuses into the conv
// epilogue on the TPU.
//
// What bounds it on the H100: bytes. Each element is read once and written
// once with about ten operations on it; the per-channel coefficient, the
// bias and the per-pixel noise are small and stay in L1/L2. The largest calls
// (the SR blocks' up=2 convs, bf16 [2,256,256,256] and [2,128,512,512]) read
// and write 67 MB each: ~0.04 ms at 3.35 TB/s.
//
// Design: a grid-stride loop in which each thread takes 16 bytes (8 bf16 or
// 4 f32 values, one channel and one image row segment, when the spatial size
// is a multiple of that) as one vector load and store. The plain version
// (ops/bias_act.py:modconv_epilogue_plain) is a chain of PyTorch ops, each of
// which computes in f32 and rounds to the layer dtype once; the kernel
// repeats those roundings in the same order, with __fmul_rn/__fadd_rn so that
// nvcc does not contract a multiply and an add into one FMA. It is therefore
// exact against its plain version.
//
// Its backward form (modconv_epilogue_grad) replaces what XLA's autodiff
// makes of the same chain of jnp ops in training (the reference's
// _BiasActCudaGrad in StyleGAN2-ADA's bias_act.py): from the output y and
// its gradient dy, the gradient of the pre-activation
//   dz = dy * (|y| < clamp) * gain * (y >= 0 ? 1 : alpha),
// one elementwise pass, rounded to the layer dtype after the gain and after
// the slope as the plain version's autograd rounds them. The slope comes
// from the sign of the output (the pre-activation's, since gain > 0), and
// an output at the clamp passes no gradient. The gradient of dz is the same
// masked product of its own gradient (lrelu's second derivative is 0), so
// the wrapper's autograd.Function calls this entry again for R1's second
// order. The reductions (the bias, the demodulation coefficients,
// noise_strength) and dx = dz * dcoef are PyTorch ops on dz
// (ops/bias_act.py). Bound: bytes (read dy and y, write dz).
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

// the value a PyTorch op of dtype T stores for the f32 result v
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f(from_f<T>(v)); }

struct Params {
  const float* dcoef;           // [N*C] or null
  const float* noise;           // [N or 1, inner] or null
  long long noise_stride;       // its batch stride: 0 or inner
  const float* noise_strength;  // 0-d, or null for 1
  const float* bias;            // [C] or null
  long long total;
  int C, inner, lrelu;
  float alpha, gain, clamp;
  int use_clamp;
};

template <typename T>
__device__ __forceinline__ float epilogue(float v, float d, float nz, float b,
                                          const Params& p) {
  if (p.dcoef) v = round_to<T>(__fmul_rn(v, d));
  if (p.noise) v = round_to<T>(__fadd_rn(v, nz));
  if (p.bias) v = round_to<T>(__fadd_rn(v, b));
  if (p.lrelu && !(v >= 0.f)) v = round_to<T>(__fmul_rn(v, p.alpha));
  v = round_to<T>(__fmul_rn(v, p.gain));     // exact when gain == 1
  if (p.use_clamp) v = round_to<T>(fminf(fmaxf(v, -p.clamp), p.clamp));
  return v;
}

// VEC consecutive elements per step; they share one channel (inner % VEC == 0)
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS) modconv_epilogue_kernel(
    const T* __restrict__ x, T* __restrict__ y, Params p) {
  const float strength = p.noise_strength ? *p.noise_strength : 1.f;
  const long long stride = (long long)gridDim.x * blockDim.x * VEC;
  for (long long e0 = (blockIdx.x * (long long)blockDim.x + threadIdx.x) * VEC; e0 < p.total;
       e0 += stride) {
    const long long row = e0 / p.inner;                 // n * C + c
    const int hw = (int)(e0 - row * p.inner);
    const int c = (int)(row % p.C);
    const float* nrow = p.noise ? p.noise + (row / p.C) * p.noise_stride + hw : nullptr;
    // the plain version's .to(dtype) of the demodulation coefficient and bias
    const float d = p.dcoef ? round_to<T>(p.dcoef[row]) : 0.f;
    const float b = p.bias ? round_to<T>(p.bias[c]) : 0.f;
    __align__(16) T v[VEC];
    if constexpr (VEC * sizeof(T) == 16) {
      *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(x + e0);
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) v[k] = x[e0 + k];
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      // noise * noise_strength in f32, then .to(dtype)
      const float nz = p.noise ? round_to<T>(__fmul_rn(nrow[k], strength)) : 0.f;
      v[k] = from_f<T>(epilogue<T>(to_f(v[k]), d, nz, b, p));
    }
    if constexpr (VEC * sizeof(T) == 16) {
      *reinterpret_cast<uint4*>(y + e0) = *reinterpret_cast<const uint4*>(v);
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) y[e0 + k] = v[k];
    }
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* x, void* y, const Params& p, cudaStream_t stream) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = (p.total / VEC + THREADS - 1) / THREADS;
  if (blocks > 32LL * sms) blocks = 32LL * sms;
  if (blocks < 1) blocks = 1;
  modconv_epilogue_kernel<T, VEC><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), p);
  return cudaGetLastError();
}

// the backward form: dz = dy * (|y| < clamp) * gain * (y >= 0 ? 1 : alpha)
struct GradParams {
  long long total;
  int lrelu, use_clamp;
  float alpha, gain, clamp;
};

template <typename T>
__device__ __forceinline__ float grad_one(float g, float yv, const GradParams& p) {
  if (p.use_clamp && !(fabsf(yv) < p.clamp)) return 0.f;
  g = round_to<T>(__fmul_rn(g, p.gain));
  if (p.lrelu && !(yv >= 0.f)) g = round_to<T>(__fmul_rn(g, p.alpha));
  return g;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS) modconv_epilogue_grad_kernel(
    const T* __restrict__ dy, const T* __restrict__ y, T* __restrict__ dz, GradParams p) {
  const long long stride = (long long)gridDim.x * blockDim.x * VEC;
  for (long long e0 = (blockIdx.x * (long long)blockDim.x + threadIdx.x) * VEC; e0 < p.total;
       e0 += stride) {
    __align__(16) T g[VEC];
    __align__(16) T yv[VEC];
    if constexpr (VEC * sizeof(T) == 16) {
      *reinterpret_cast<uint4*>(g) = *reinterpret_cast<const uint4*>(dy + e0);
      *reinterpret_cast<uint4*>(yv) = *reinterpret_cast<const uint4*>(y + e0);
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        g[k] = dy[e0 + k];
        yv[k] = y[e0 + k];
      }
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) g[k] = from_f<T>(grad_one<T>(to_f(g[k]), to_f(yv[k]), p));
    if constexpr (VEC * sizeof(T) == 16) {
      *reinterpret_cast<uint4*>(dz + e0) = *reinterpret_cast<const uint4*>(g);
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) dz[e0 + k] = g[k];
    }
  }
}

template <typename T, int VEC>
cudaError_t launch_grad(const void* dy, const void* y, void* dz, const GradParams& p,
                        cudaStream_t stream) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = (p.total / VEC + THREADS - 1) / THREADS;
  if (blocks > 32LL * sms) blocks = 32LL * sms;
  if (blocks < 1) blocks = 1;
  modconv_epilogue_grad_kernel<T, VEC><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(y), static_cast<T*>(dz), p);
  return cudaGetLastError();
}

}  // namespace

// x, y: contiguous [N, C, inner] (inner = H*W for NCHW, 1 for [N, F]) of
// dtype f32 or bf16, 16-byte aligned; dcoef [N*C] f32, noise [inner] f32 at
// noise_stride 0 or [N, inner] f32 at noise_stride inner (times
// noise_strength, a 0-d f32, when that is not null), bias [C] f32, each null
// when absent. lrelu: 0 for the linear activation, 1 for leaky relu with
// slope alpha.
PANIC3D_EXPORT int modconv_epilogue(
    const void* x, void* y, int dtype, long long total, int C, int inner,
    const float* dcoef, const float* noise, const float* noise_strength,
    const float* bias, int lrelu, float alpha, float gain, int use_clamp, float clamp,
    long long noise_stride, void* stream) {
  if (C < 1 || inner < 1 || total % ((long long)C * inner) != 0 ||
      (noise_stride != 0 && noise_stride != inner))
    return (int)cudaErrorInvalidValue;
  Params p{dcoef, noise, noise_stride, noise_strength, bias, total, C, inner, lrelu, alpha,
           gain, clamp, use_clamp};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16)
    return (int)(inner % 8 == 0 ? launch<__nv_bfloat16, 8>(x, y, p, s)
                                : launch<__nv_bfloat16, 1>(x, y, p, s));
  return (int)(inner % 4 == 0 ? launch<float, 4>(x, y, p, s) : launch<float, 1>(x, y, p, s));
}

// The backward form. dy, y, dz: contiguous, `total` values of dtype f32 or
// bf16, 16-byte aligned; lrelu, alpha, gain and the clamp as the forward
// call took them. dz = dy * (|y| < clamp) * gain * (y >= 0 ? 1 : alpha).
PANIC3D_EXPORT int modconv_epilogue_grad(const void* dy, const void* y, void* dz, int dtype,
                                         long long total, int lrelu, float alpha, float gain,
                                         int use_clamp, float clamp, void* stream) {
  if (total < 1) return (int)cudaErrorInvalidValue;
  GradParams p{total, lrelu, use_clamp, alpha, gain, clamp};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16)
    return (int)(total % 8 == 0 ? launch_grad<__nv_bfloat16, 8>(dy, y, dz, p, s)
                                : launch_grad<__nv_bfloat16, 1>(dy, y, dz, p, s));
  return (int)(total % 4 == 0 ? launch_grad<float, 4>(dy, y, dz, p, s)
                              : launch_grad<float, 1>(dy, y, dz, p, s));
}
