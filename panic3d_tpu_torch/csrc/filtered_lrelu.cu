// K11 filtered_lrelu: bias -> zero-insert upsample, pad/crop, FIR (fu) ->
// leaky relu x gain, clamp -> FIR (fd), decimate, for NCHW images, in one
// launch.
//
// Replaces (JAX): panic3d_tpu/ops/filtered_lrelu.py:filtered_lrelu (:22), the
// composition upfirdn2d -> bias_act -> upfirdn2d that the JAX package leaves
// XLA to fuse; the reference's own CUDA op (filtered_lrelu.cu) fuses it as
// this kernel does. Its one consumer is the alias-free synthesis layer
// (panic3d_tpu/models/stylegan3.py:AFSynthesisLayer), at up 2 or 4 with 12 or
// 24 taps, down 2 with 12 taps or StyleGAN3-R's 12x12 radial filter, and as
// the toRGB layer's bias and clamp alone (no filters, slope 1, gain 1).
//
// What bounds it on the H100: the up-sampled intermediate. Unfused, it is
// written to device memory and read back (StyleGAN3-R's layer 10 at batch 4
// in bf16: 4 x 288 x 1074^2, ~2.7 GB each way, where the layer's input and
// output are ~0.8 GB). Here it never leaves shared memory, so the bytes are
// the input once and the output once; what is left is the FIR arithmetic
// (f32, the taps that meet inserted zeros skipped): ~60-80 FMAs an output
// with separable filters, ~190 with the radial one, so the radial layers and
// the largest separable ones are bound by operations, the rest by bytes.
//
// Design: one block of 32x8 threads owns a 32x32 output tile of one (n, c)
// image. The wrapper's plan (ops/filtered_lrelu.py:k11_plan)
// gives each tile's input-window start and, for each intermediate position
// of a tile's window, the first up tap of its phase and the input it meets
// (the same for every tile, since a tile starts at a multiple of up in the
// intermediate). The block
//  1. stages its input window in shared memory as f32, bias added, zeros
//     outside the image (a negative padding is a crop: the window starts
//     inside the image);
//  2. up pass, polyphase and separable: each intermediate column, then each
//     intermediate row, takes only the taps of its phase (taps/up of them);
//  3. applies the leaky relu, the gain and the clamp in place;
//  4. down pass: the output tile by fd, separable (rows, then columns) or
//     2-D (the radial filter), every down-th intermediate pixel;
// accumulating in f32 and rounding once to the input's dtype (f32 or bf16),
// where the plain version rounds after each step in bf16. Each pass sums its
// taps in the plain version's order, so in f32 the two agree bit for bit.
//
// StyleGAN3's geometries (up 2 or 4 with 6 taps a phase, 12 down taps, or
// the toRGB's single taps) run forms compiled for them: a thread's columns
// (tx + 32 i) and rows (ty + 8 i) keep one phase each, so it holds its up
// taps in registers, and the down taps are constant operands; each
// multiply-add then reads one shared-memory operand. The first design read
// both operands from shared memory and divided every element's index:
// 22-65x its bound at StyleGAN3-T's geometries (PERF.md, PR 10).
#include "common.cuh"

namespace {

constexpr int TO = 32;        // output tile side
constexpr int TX = 32, TY = 8;   // the block: a warp a row, 8 rows (TX == TO)
constexpr int MAXT = 64;      // tiles an axis: outputs up to 2048 a side
constexpr int MAXI = 96;      // intermediate window side: (TO - 1) * down + fd taps
constexpr int MAX_FU = 32;
constexpr int MAX_FD = 144;   // 1-D up to 32 taps, or 12x12

// ops/filtered_lrelu.py:_Plan mirrors this layout field for field
struct Plan {
  float fu[MAX_FU];           // up taps, flipped and gained by up (one axis)
  float fd[MAX_FD];           // down taps, flipped: fdn (separable) or fdn x fdn
  int in0[2 * MAXT];          // [axis: y, x][tile]: input-window start
  short k0[2 * MAXI];         // [axis][window position]: first up tap of its phase
  short src[2 * MAXI];        // [axis][window position]: the input that tap meets
  int fuh, fdn, fd2d, up, down, ti, tin, tiles_y, tiles_x, H, W, OH, OW;
  float gain, slope, clamp;   // clamp < 0: none
};

size_t smem_floats(const Plan& p) {
  return MAX_FU + MAX_FD + 4 * MAXI + (size_t)p.tin * p.tin + (size_t)p.tin * p.ti +
         (size_t)p.ti * p.ti + (size_t)p.ti * TO;
}

// UP, TPP (up taps a phase: fuh / up), FDN (down taps a side): the
// StyleGAN3 geometries, fixed at compile time, so each thread holds its
// phase's up taps in registers (its columns, tx + 32 i, and its rows,
// ty + 8 i, keep one phase each) and the down taps are constant operands;
// UP = 0: any other geometry, every loop bound and tap read at run time.
template <typename T, int UP, int TPP, int FDN>
__global__ void __launch_bounds__(TX * TY) filtered_lrelu_kernel(
    const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ bias, int C,
    const Plan p) {
  constexpr bool FIXED = UP > 0;
  extern __shared__ float smem[];
  const int ti = p.ti, tin = p.tin, down = p.down;
  const int up = FIXED ? UP : p.up, fuh = FIXED ? UP * TPP : p.fuh, fdn = FIXED ? FDN : p.fdn;
  float* s_fu = smem;
  float* s_fd = s_fu + MAX_FU;
  int* s_k0 = reinterpret_cast<int*>(s_fd + MAX_FD);   // [2][MAXI]
  int* s_src = s_k0 + 2 * MAXI;                        // [2][MAXI]
  float* s_in = reinterpret_cast<float*>(s_src + 2 * MAXI);   // [tin][tin]
  float* s_h = s_in + tin * tin;     // [tin][ti]: the horizontal up pass
  float* s_mid = s_h + tin * ti;     // [ti][ti]: the activated intermediate
  float* s_d = s_mid + ti * ti;      // [ti][TO]: the horizontal down pass
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TX + tx;
  const long long nc = blockIdx.z;
  const int c = (int)(nc % C);

  for (int i = tid; i < MAX_FU; i += TX * TY) s_fu[i] = p.fu[i];
  for (int i = tid; i < MAX_FD; i += TX * TY) s_fd[i] = p.fd[i];
  for (int i = tid; i < 2 * MAXI; i += TX * TY) {
    s_k0[i] = p.k0[i];
    s_src[i] = p.src[i];
  }
  const float b = bias != nullptr ? bias[c] : 0.f;
  const int iy0 = p.in0[blockIdx.y], ix0 = p.in0[MAXT + blockIdx.x];
  const T* xs = x + nc * p.H * p.W;
  for (int r = ty; r < tin; r += TY) {
    const int iy = iy0 + r;
    const bool row_in = iy >= 0 && iy < p.H;
    for (int q = tx; q < tin; q += TX) {
      const int ix = ix0 + q;
      s_in[r * tin + q] = (row_in && ix >= 0 && ix < p.W)
                              ? to_f(xs[(long long)iy * p.W + ix]) + b : 0.f;
    }
  }
  __syncthreads();

  // up pass, columns: s_h[r][j] = sum over the taps of column j's phase
  {
    float tu[FIXED ? TPP : 1];
    if constexpr (FIXED) {
      const int k0 = p.k0[MAXI + tx];
#pragma unroll
      for (int m = 0; m < TPP; ++m) tu[m] = p.fu[k0 + m * UP];
    }
    for (int j = tx; j < ti; j += TX) {
      const float* base = s_in + s_src[MAXI + j];
      for (int r = ty; r < tin; r += TY) {
        const float* row = base + r * tin;
        float acc = 0.f;
        if constexpr (FIXED) {
#pragma unroll
          for (int m = 0; m < TPP; ++m) acc = fmaf(tu[m], row[m], acc);
        } else {
          for (int k = s_k0[MAXI + j], m = 0; k < fuh; k += up, ++m)
            acc = fmaf(s_fu[k], row[m], acc);
        }
        s_h[r * ti + j] = acc;
      }
    }
  }
  __syncthreads();

  // up pass, rows; then leaky relu, gain, clamp
  {
    float tu[FIXED ? TPP : 1];
    if constexpr (FIXED) {
      const int k0 = p.k0[ty];
#pragma unroll
      for (int m = 0; m < TPP; ++m) tu[m] = p.fu[k0 + m * UP];
    }
    for (int r = ty; r < ti; r += TY) {
      const float* rows = s_h + s_src[r] * ti;
      for (int j = tx; j < ti; j += TX) {
        const float* col = rows + j;
        float acc = 0.f;
        if constexpr (FIXED) {
#pragma unroll
          for (int m = 0; m < TPP; ++m) acc = fmaf(tu[m], col[m * ti], acc);
        } else {
          for (int k = s_k0[r], m = 0; k < fuh; k += up, ++m)
            acc = fmaf(s_fu[k], col[m * ti], acc);
        }
        float v = (acc >= 0.f ? acc : acc * p.slope) * p.gain;
        if (p.clamp >= 0.f) v = fminf(fmaxf(v, -p.clamp), p.clamp);
        s_mid[r * ti + j] = v;
      }
    }
  }
  __syncthreads();

  // down pass: lane tx owns output column tx of the tile (TX == TO)
  const int oy0 = blockIdx.y * TO, ox0 = blockIdx.x * TO;
  const bool col_out = ox0 + tx < p.OW;
  T* dst = y + nc * p.OH * p.OW + ox0 + tx;
  if (p.fd2d) {
    for (int r = ty; r < TO; r += TY) {
      if (!col_out || oy0 + r >= p.OH) continue;
      const float* win = s_mid + r * down * ti + tx * down;
      float acc = 0.f;
      if constexpr (FIXED) {
#pragma unroll
        for (int a = 0; a < FDN; ++a)
#pragma unroll
          for (int bb = 0; bb < FDN; ++bb) acc = fmaf(p.fd[a * FDN + bb], win[a * ti + bb], acc);
      } else {
        for (int a = 0; a < fdn; ++a)
          for (int bb = 0; bb < fdn; ++bb) acc = fmaf(s_fd[a * fdn + bb], win[a * ti + bb], acc);
      }
      dst[(long long)(oy0 + r) * p.OW] = from_f<T>(acc);
    }
    return;
  }
  // separable: every intermediate row at the tile's output columns, then
  // the output rows
  for (int r = ty; r < ti; r += TY) {
    const float* row = s_mid + r * ti + tx * down;
    float acc = 0.f;
    if constexpr (FIXED) {
#pragma unroll
      for (int bb = 0; bb < FDN; ++bb) acc = fmaf(p.fd[bb], row[bb], acc);
    } else {
      for (int bb = 0; bb < fdn; ++bb) acc = fmaf(s_fd[bb], row[bb], acc);
    }
    s_d[r * TO + tx] = acc;
  }
  __syncthreads();
  for (int r = ty; r < TO; r += TY) {
    if (!col_out || oy0 + r >= p.OH) continue;
    const float* col = s_d + r * down * TO + tx;
    float acc = 0.f;
    if constexpr (FIXED) {
#pragma unroll
      for (int a = 0; a < FDN; ++a) acc = fmaf(p.fd[a], col[a * TO], acc);
    } else {
      for (int a = 0; a < fdn; ++a) acc = fmaf(s_fd[a], col[a * TO], acc);
    }
    dst[(long long)(oy0 + r) * p.OW] = from_f<T>(acc);
  }
}

template <typename T, int UP, int TPP, int FDN>
cudaError_t launch(const void* x, void* y, const float* bias, int NC, int C, const Plan& p,
                   cudaStream_t stream) {
  const size_t smem = smem_floats(p) * sizeof(float);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(filtered_lrelu_kernel<T, UP, TPP, FDN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(p.tiles_x, p.tiles_y, NC);
  filtered_lrelu_kernel<T, UP, TPP, FDN><<<grid, dim3(TX, TY), smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), bias, C, p);
  return cudaGetLastError();
}

// StyleGAN3's geometries (up 2 or 4 with 6 taps a phase and 12 down taps,
// the toRGB's single taps) take the compiled forms, any other the general one
template <typename T>
cudaError_t dispatch(const void* x, void* y, const float* bias, int NC, int C, const Plan& p,
                     cudaStream_t s) {
  const int tpp = p.fuh % p.up == 0 ? p.fuh / p.up : 0;
  if (p.up == 2 && tpp == 6 && p.fdn == 12) return launch<T, 2, 6, 12>(x, y, bias, NC, C, p, s);
  if (p.up == 4 && tpp == 6 && p.fdn == 12) return launch<T, 4, 6, 12>(x, y, bias, NC, C, p, s);
  if (p.up == 1 && tpp == 1 && p.fdn == 1) return launch<T, 1, 1, 1>(x, y, bias, NC, C, p, s);
  return launch<T, 0, 0, 0>(x, y, bias, NC, C, p, s);
}

}  // namespace

// x: [N*C, H, W] (f32 or bf16), y: [N*C, OH, OW] in the same dtype; bias: C
// f32 on the device, or null; plan: the host plan of this geometry
// (ops/filtered_lrelu.py:k11_plan), passed to the kernel by value. N*C <=
// 65535.
PANIC3D_EXPORT int filtered_lrelu(const void* x, void* y, int dtype, int NC, int C,
                                  const float* bias, const Plan* plan, void* stream) {
  if (plan == nullptr || NC < 1 || NC > 65535 || C < 1) return (int)cudaErrorInvalidValue;
  const Plan& p = *plan;
  if (p.fuh < 1 || p.fuh > MAX_FU || p.fdn < 1 || p.up < 1 || p.down < 1 ||
      (p.fd2d ? p.fdn * p.fdn : p.fdn) > MAX_FD || p.ti < 1 || p.ti > MAXI || p.tin < 1 ||
      p.tiles_y < 1 || p.tiles_y > MAXT || p.tiles_x < 1 || p.tiles_x > MAXT || p.OH < 1 ||
      p.OW < 1 || p.H < 1 || p.W < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16) return (int)dispatch<__nv_bfloat16>(x, y, bias, NC, C, p, s);
  return (int)dispatch<float>(x, y, bias, NC, C, p, s);
}
