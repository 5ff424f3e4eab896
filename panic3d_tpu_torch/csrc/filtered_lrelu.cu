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
// (f32, the taps that meet inserted zeros skipped): ~66-72 FMAs an output
// with separable filters, ~190 with the radial one, so the f32 FMA rate
// bounds StyleGAN3's layers, and, in a kernel that keeps its intermediates
// in shared memory, the shared-memory rate next: 128 B a clock an SM
// against 128 FMAs, so a pass must do 4 FMAs for each 4-byte word it loads
// or stores to run at the FMA rate.
//
// Every form accumulates in f32 and rounds once to the input's dtype (f32
// or bf16), where the plain version rounds after each step in bf16. Each
// pass sums an output's taps in the plain version's order (the up pass by
// columns, then by rows; the down pass by rows, then by columns, or a-major
// over the 2-D filter), so in f32 the two agree bit for bit, and every form
// computes an intermediate value with the same multiply-adds, whatever tile
// holds it.
//
// Two designs, picked by the host plan (ops/filtered_lrelu.py:k11_plan,
// Plan::form; nothing here re-decides it):
//
// The strip form, StyleGAN3's geometries: up 2 or 4 with 6 taps a
// phase, down 2 with 12 taps (separable or the 12x12 radial filter), the
// padding's phase S = p0 mod up that StyleGAN3 gives (1 at up 2, 2 at up 4),
// compiled as template arguments. A block of 256 threads owns a t_y x t_x
// output tile of one (n, c) image; the plan picks t per geometry (a tile the
// whole 36^2 or 52^2 output, 42^2 at 84^2, 46-55 at the large layers: the
// fewest multiply-adds counting the halo and the strips' padding, at most
// 74 KB of shared memory; 3 blocks an SM, as __launch_bounds__ asks, which
// caps a thread at 80 registers). Each pass is register-
// blocked: a thread computes a strip of outputs along the pass's axis from
// a window it loads once, 16 bytes a load, every tap a constant operand
// (an index fixed at compile time into the plan, a kernel parameter):
//  0. staging: the input window, bias added, widened once, zeros outside;
//     at up 2, 8 scalar loads in flight a thread (StyleGAN3's inputs are
//     38-534 wide, 2 mod 4 elements, so every other row starts off a
//     16-byte, and in bf16 an 8-byte, boundary: no vector load fits every
//     row);
//  1. up pass by columns: a thread 4 x up consecutive intermediate columns
//     of one input row (8 at up 2: both phases of 4 pairs) from a window of
//     9-10 inputs, 4.0-8.0 FMAs a word loaded;
//  2. up pass by rows, the activation and the clamp: a thread 8 rows x 4
//     columns from 8-9 rows of float4, 5.3-6.0 FMAs a word;
//  3. separable down pass by rows: a thread 8 outputs of one row from 26
//     intermediate values (7 float4), 3.4 FMAs a word;
//  4. down pass by columns: a thread 8 outputs of one column from 26 rows,
//     3.7 FMAs a word, stored to the output;
//  3'. radial: a thread 4 x 2 outputs from 18 rows of 14 values (4 float4
//     each), 4.0 FMAs a word.
// Threads walk their pass's rows (passes 1 and 3) or its columns (2, 4
// and 3'), so a warp's 16-byte loads and stores meet no bank conflicts:
// lanes on neighbouring rows read rows whose stride is 4 mod 8 words. The
// intermediate and the input share one buffer, the up pass's rows and the
// down pass's another, so a block holds two. A strip that runs past the
// tile computes values no output reads (the plan counts them).
//
// The tile form (the first): a block of 32x8 threads owns a 32x32 output tile;
// the plan gives each tile's input-window start and, for each intermediate
// position of a tile's window, the first up tap of its phase and the input
// it meets. The block stages its window, runs the up pass by columns and
// rows, the activation, and the down pass (separable or 2-D), each multiply-
// add reading one shared-memory operand. It takes every geometry the strip
// form does not: a form compiled for the toRGB's single taps, any other
// geometry at run time.
#include "common.cuh"

namespace {

constexpr int TO = 32;        // the tile form's output tile side
constexpr int TX = 32, TY = 8;   // the tile form's block: a warp a row, 8 rows (TX == TO)
constexpr int MAXT = 64;      // tiles an axis: outputs up to 2048 a side
constexpr int MAXI = 96;      // the tile form's intermediate window side
constexpr int MAX_FU = 32;
constexpr int MAX_FD = 144;   // 1-D up to 32 taps, or 12x12

// the strip form's layout (ops/filtered_lrelu.py:_Strip mirrors it): the
// tile, the buffers' strides in floats (4 mod 8: 16-byte rows, neighbouring
// rows on other banks) and each pass's strip counts
struct Strip {
  int t_y, t_x;               // output tile sides
  int tiles_y, tiles_x;
  int in0[2 * MAXT];          // [axis][tile]: the input window's start
  int rh, in_cols;            // staged input rows (= pass 1's rows) and columns
  int si, sh, sm, sd;         // strides: input, up pass by columns, intermediate, down rows
  int nq1, nqi, nqj, nqo, nq4;   // strips: pass 1 (columns), pass 2 (rows, column quads),
                                 // pass 3 (x: 8 outputs; radial 2), pass 4 (y: 8; radial 4)
  int ti_y;                   // pass 3's rows (the intermediate window's height)
  int off_b;                  // the second buffer's offset, floats
  int smem;                   // bytes
};

// ops/filtered_lrelu.py:_Plan mirrors this layout field for field. The
// fields up to clamp are the tile form's, laid out as its first plan was.
struct Plan {
  float fu[MAX_FU];           // up taps, flipped and gained by up (one axis)
  float fd[MAX_FD];           // down taps, flipped: fdn (separable) or fdn x fdn
  int in0[2 * MAXT];          // [axis: y, x][tile]: input-window start (tile form)
  short k0[2 * MAXI];         // [axis][window position]: first up tap of its phase
  short src[2 * MAXI];        // [axis][window position]: the input that tap meets
  int fuh, fdn, fd2d, up, down, ti, tin, tiles_y, tiles_x, H, W, OH, OW;
  float gain, slope, clamp;   // clamp < 0: none
  int form;                   // Form
  Strip st;                   // the strip form's layout
};

// the plan's forms (ops/filtered_lrelu.py:FORMS)
enum Form {
  F_TILE = 0, F_TILE_UP1 = 1,
  F_STRIP_UP2 = 2, F_STRIP_UP2_RADIAL = 3, F_STRIP_UP4 = 4, F_STRIP_UP4_RADIAL = 5,
};

size_t smem_floats(const Plan& p) {
  return MAX_FU + MAX_FD + 4 * MAXI + (size_t)p.tin * p.tin + (size_t)p.tin * p.ti +
         (size_t)p.ti * p.ti + (size_t)p.ti * TO;
}

// UP, TPP (up taps a phase: fuh / up), FDN (down taps a side) fixed at
// compile time (the toRGB's single taps: UP = TPP = FDN = 1), so each thread
// holds its phase's up taps in registers (its columns, tx + 32 i, and its
// rows, ty + 8 i, keep one phase each) and the down taps are constant
// operands; UP = 0: any other geometry, every loop bound and tap read at
// run time.
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

// ---------------------------------------------------------------------------
// the strip form

constexpr int ST_THREADS = 256;
constexpr int ST_TPP = 6;     // up taps a phase
constexpr int ST_FDN = 12;    // down taps a side (down 2)
constexpr int ST_SMEM_MAX = 100 * 1024;
constexpr int ST_LOADS = 8;      // staging: loads in flight a thread

// intermediate position u of a window that starts at a multiple of UP: the
// offset of its first tap's input from the window's first input,
// ceil((u - S) / UP), and that tap's index in fu, (S - u) mod UP
template <int UP, int S>
__device__ constexpr int src_of(int u) { return (u - S + UP - 1) / UP; }
template <int UP, int S>
__device__ constexpr int k0_of(int u) { return ((S - u) % UP + UP) % UP; }

// a thread's walk over a pass's items (q, r), q = item / n, r = item % n,
// item = tid, tid + 256, ...: one division a pass
struct Walk {
  int q, r, dq, dr, n;
  __device__ Walk(int tid, int n_) : n(n_) {
    q = tid / n;
    r = tid - q * n;
    dq = ST_THREADS / n;
    dr = ST_THREADS - dq * n;
  }
  __device__ void next() {
    q += dq;
    r += dr;
    if (r >= n) {
      r -= n;
      ++q;
    }
  }
};

__device__ __forceinline__ void put4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void get4(const float* p, float* v) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

// pass 1, the up pass by columns: item (q, r) = U = 4 UP intermediate
// columns from 4q UP of input row r, from the window of the 4q inputs on
// (3 float4: src_of(U - 1) + TPP <= 12 values)
template <int UP, int S>
__device__ __forceinline__ void strip_up_columns(const Plan& p, const float* s_in, float* s_h,
                                                 int tid) {
  constexpr int U = 4 * UP, NW = src_of<UP, S>(U - 1) + ST_TPP;
  static_assert(NW <= 12, "the window is 3 float4");
  const Strip& st = p.st;
  Walk w(tid, st.rh);
  for (; w.q < st.nq1; w.next()) {
    const float* row = s_in + w.r * st.si + 4 * w.q;
    float v[12];
#pragma unroll
    for (int k = 0; k < 3; ++k) get4(row + 4 * k, v + 4 * k);
    float acc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      acc[u] = 0.f;
#pragma unroll
      for (int m = 0; m < ST_TPP; ++m)
        acc[u] = fmaf(p.fu[k0_of<UP, S>(u) + m * UP], v[src_of<UP, S>(u) + m], acc[u]);
    }
    float* dst = s_h + w.r * st.sh + U * w.q;
#pragma unroll
    for (int k = 0; k < U / 4; ++k) put4(dst + 4 * k, acc + 4 * k);
  }
}

// pass 2, the up pass by rows, then the leaky relu, the gain and the clamp:
// item (qi, qj) = intermediate rows 8 qi .. 8 qi + 7 at columns 4 qj .. 4 qj
// + 3, from h rows 8 qi / UP on, one float4 row at a time
template <int UP, int S>
__device__ __forceinline__ void strip_up_rows(const Plan& p, const float* s_h, float* s_mid,
                                              int tid) {
  constexpr int U = 8, NW = src_of<UP, S>(U - 1) + ST_TPP;
  const Strip& st = p.st;
  const float slope = p.slope, gain = p.gain, clamp = p.clamp;
  Walk w(tid, st.nqj);
  for (; w.q < st.nqi; w.next()) {
    const float* col = s_h + (U / UP) * w.q * st.sh + 4 * w.r;
    float acc[U][4];
#pragma unroll
    for (int u = 0; u < U; ++u) acc[u][0] = acc[u][1] = acc[u][2] = acc[u][3] = 0.f;
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      float v[4];
      get4(col + k * st.sh, v);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int m = k - src_of<UP, S>(u);
        if (m >= 0 && m < ST_TPP) {
          const float tap = p.fu[k0_of<UP, S>(u) + m * UP];
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[u][e] = fmaf(tap, v[e], acc[u][e]);
        }
      }
    }
    float* dst = s_mid + U * w.q * st.sm + 4 * w.r;
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float a = (acc[u][e] >= 0.f ? acc[u][e] : acc[u][e] * slope) * gain;
        if (clamp >= 0.f) a = fminf(fmaxf(a, -clamp), clamp);
        acc[u][e] = a;
      }
      put4(dst + u * st.sm, acc[u]);
    }
  }
}

// pass 3, the separable down pass by rows: item (q, i) = the 8 outputs
// 8q .. 8q + 7 of intermediate row i, from its columns 16q .. 16q + 25
__device__ __forceinline__ void strip_down_rows(const Plan& p, const float* s_mid, float* s_d,
                                                int tid) {
  const Strip& st = p.st;
  Walk w(tid, st.ti_y);
  for (; w.q < st.nqo; w.next()) {
    const float* row = s_mid + w.r * st.sm + 16 * w.q;
    float acc[8];
#pragma unroll
    for (int o = 0; o < 8; ++o) acc[o] = 0.f;
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      float v[4];
      get4(row + 4 * k, v);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int o = 0; o < 8; ++o) {
          const int bb = 4 * k + e - 2 * o;
          if (bb >= 0 && bb < ST_FDN) acc[o] = fmaf(p.fd[bb], v[e], acc[o]);
        }
    }
    float* dst = s_d + w.r * st.sd + 8 * w.q;
    put4(dst, acc);
    put4(dst + 4, acc + 4);
  }
}

// pass 4, the down pass by columns: item (q, x) = output rows 8q .. 8q + 7
// of tile column x, from down rows 16q .. 16q + 25; stored where inside the
// tile and the image
template <typename T>
__device__ __forceinline__ void strip_down_columns(const Plan& p, const float* s_d,
                                                   T* __restrict__ y, int vy, int vx,
                                                   int tid) {
  const Strip& st = p.st;
  Walk w(tid, st.t_x);
  for (; w.q < st.nq4; w.next()) {
    const float* col = s_d + 16 * w.q * st.sd + w.r;
    float acc[8];
#pragma unroll
    for (int o = 0; o < 8; ++o) acc[o] = 0.f;
#pragma unroll
    for (int k = 0; k < 26; ++k) {
      const float v = col[k * st.sd];
#pragma unroll
      for (int o = 0; o < 8; ++o) {
        const int a = k - 2 * o;
        if (a >= 0 && a < ST_FDN) acc[o] = fmaf(p.fd[a], v, acc[o]);
      }
    }
    if (w.r < vx) {
#pragma unroll
      for (int o = 0; o < 8; ++o)
        if (8 * w.q + o < vy) y[(long long)(8 * w.q + o) * p.OW + w.r] = from_f<T>(acc[o]);
    }
  }
}

// pass 3', the radial (12x12) down pass: item (q, x) = outputs rows 4q ..
// 4q + 3 at columns 2x, 2x + 1, from intermediate rows 8q .. 8q + 17 at
// columns 4x .. 4x + 13, a row at a time (a-major, then b: the plain order)
template <typename T>
__device__ __forceinline__ void strip_down_radial(const Plan& p, const float* s_mid,
                                                  T* __restrict__ y, int vy, int vx, int tid) {
  const Strip& st = p.st;
  Walk w(tid, st.nqo);
  for (; w.q < st.nq4; w.next()) {
    const float* base = s_mid + 8 * w.q * st.sm + 4 * w.r;
    float acc[4][2];
#pragma unroll
    for (int o = 0; o < 4; ++o) acc[o][0] = acc[o][1] = 0.f;
#pragma unroll
    for (int k = 0; k < 18; ++k) {
      float v[16];
#pragma unroll
      for (int c = 0; c < 4; ++c) get4(base + k * st.sm + 4 * c, v + 4 * c);
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        const int a = k - 2 * o;
        if (a >= 0 && a < ST_FDN) {
#pragma unroll
          for (int bb = 0; bb < ST_FDN; ++bb) {
            acc[o][0] = fmaf(p.fd[a * ST_FDN + bb], v[bb], acc[o][0]);
            acc[o][1] = fmaf(p.fd[a * ST_FDN + bb], v[2 + bb], acc[o][1]);
          }
        }
      }
    }
#pragma unroll
    for (int o = 0; o < 4; ++o)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (4 * w.q + o < vy && 2 * w.r + e < vx)
          y[(long long)(4 * w.q + o) * p.OW + 2 * w.r + e] = from_f<T>(acc[o][e]);
  }
}

// the strip form: a block of 256 threads a t_y x t_x output tile of one
// (n, c) image, buffer A the input then the intermediate, buffer B the up
// pass by columns then the down pass by rows
template <typename T, int UP, int S, bool RADIAL>
__global__ void __launch_bounds__(ST_THREADS, 3) filtered_lrelu_strip_kernel(
    const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ bias, int C,
    const __grid_constant__ Plan p) {
  extern __shared__ float4 smem4[];
  float* buf_a = reinterpret_cast<float*>(smem4);
  float* buf_b = buf_a + p.st.off_b;
  const Strip& st = p.st;
  const int tid = threadIdx.x;
  const long long nc = blockIdx.z;
  const float b = bias != nullptr ? bias[nc % C] : 0.f;

  // 0. the input window, bias added, zeros outside the image. At up 2 a
  // thread's elements (row, column) = (tid + 256 i) / in_cols, % in_cols,
  // ST_LOADS loads issued before the first is stored; at up 4, whose input
  // windows are a quarter of a tile's area, a warp a row, a lane a column
  // (faster there on the card)
  {
    const int iy0 = st.in0[blockIdx.y], ix0 = st.in0[MAXT + blockIdx.x];
    const T* xs = x + nc * p.H * p.W;
    if constexpr (UP == 2) {
      Walk w(tid, st.in_cols);
      while (w.q < st.rh) {
        float v[ST_LOADS];
        int at[ST_LOADS];
#pragma unroll
        for (int k = 0; k < ST_LOADS; ++k) {
          const int iy = iy0 + w.q, ix = ix0 + w.r;
          const bool in = w.q < st.rh;
          v[k] = in && iy >= 0 && iy < p.H && ix >= 0 && ix < p.W
                     ? to_f(xs[(long long)iy * p.W + ix]) + b
                     : 0.f;
          at[k] = in ? w.q * st.si + w.r : -1;
          w.next();
        }
#pragma unroll
        for (int k = 0; k < ST_LOADS; ++k)
          if (at[k] >= 0) buf_a[at[k]] = v[k];
      }
    } else {
      const int warp = tid >> 5, lane = tid & 31;
      for (int r = warp; r < st.rh; r += ST_THREADS / 32) {
        const int iy = iy0 + r;
        const bool row_in = iy >= 0 && iy < p.H;
        const T* xr = xs + (long long)iy * p.W;
        for (int q = lane; q < st.in_cols; q += 32) {
          const int ix = ix0 + q;
          buf_a[r * st.si + q] = (row_in && ix >= 0 && ix < p.W) ? to_f(xr[ix]) + b : 0.f;
        }
      }
    }
  }
  __syncthreads();
  strip_up_columns<UP, S>(p, buf_a, buf_b, tid);
  __syncthreads();
  strip_up_rows<UP, S>(p, buf_b, buf_a, tid);
  __syncthreads();
  const int oy0 = blockIdx.y * st.t_y, ox0 = blockIdx.x * st.t_x;
  const int vy = min(st.t_y, p.OH - oy0), vx = min(st.t_x, p.OW - ox0);
  T* yt = y + nc * p.OH * p.OW + (long long)oy0 * p.OW + ox0;
  if constexpr (RADIAL) {
    strip_down_radial<T>(p, buf_a, yt, vy, vx, tid);
  } else {
    strip_down_rows(p, buf_a, buf_b, tid);
    __syncthreads();
    strip_down_columns<T>(p, buf_b, yt, vy, vx, tid);
  }
}

template <typename T, int UP, int TPP, int FDN>
cudaError_t launch_tile(const void* x, void* y, const float* bias, int NC, int C, const Plan& p,
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

template <typename T, int UP, int S, bool RADIAL>
cudaError_t launch_strip(const void* x, void* y, const float* bias, int NC, int C,
                         const Plan& p, cudaStream_t stream) {
  // the largest shared memory a block may ask for, and the carveout that
  // leaves the most of it (once per instantiation)
  static const cudaError_t attr = [] {
    const cudaError_t e = cudaFuncSetAttribute(filtered_lrelu_strip_kernel<T, UP, S, RADIAL>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               ST_SMEM_MAX);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(filtered_lrelu_strip_kernel<T, UP, S, RADIAL>,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                (int)cudaSharedmemCarveoutMaxShared);
  }();
  if (attr != cudaSuccess) return attr;
  const Strip& st = p.st;
  if (st.smem < 16 || st.smem > ST_SMEM_MAX || st.t_y < 1 || st.t_x < 1 || st.tiles_y < 1 ||
      st.tiles_y > MAXT || st.tiles_x < 1 || st.tiles_x > MAXT || st.rh < 1 || st.nq1 < 1 ||
      st.nqi < 1 || st.nqj < 1 || st.nqo < 1 || st.nq4 < 1 || st.ti_y < 1 || st.off_b < 0 ||
      (st.si | st.sh | st.sm | st.sd | st.off_b) % 4 != 0 || p.down != 2 || p.fdn != ST_FDN ||
      p.fuh != UP * ST_TPP || p.up != UP || (p.fd2d != 0) != RADIAL)
    return cudaErrorInvalidValue;
  dim3 grid(st.tiles_x, st.tiles_y, NC);
  filtered_lrelu_strip_kernel<T, UP, S, RADIAL><<<grid, ST_THREADS, st.smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), bias, C, p);
  return cudaGetLastError();
}

// the plan's form, launched as it says
template <typename T>
cudaError_t dispatch(const void* x, void* y, const float* bias, int NC, int C, const Plan& p,
                     cudaStream_t s) {
  const int tpp = p.fuh % p.up == 0 ? p.fuh / p.up : 0;
  switch (p.form) {
    case F_TILE: return launch_tile<T, 0, 0, 0>(x, y, bias, NC, C, p, s);
    case F_TILE_UP1:
      if (p.up != 1 || tpp != 1 || p.fdn != 1) break;
      return launch_tile<T, 1, 1, 1>(x, y, bias, NC, C, p, s);
    case F_STRIP_UP2: return launch_strip<T, 2, 1, false>(x, y, bias, NC, C, p, s);
    case F_STRIP_UP2_RADIAL: return launch_strip<T, 2, 1, true>(x, y, bias, NC, C, p, s);
    case F_STRIP_UP4: return launch_strip<T, 4, 2, false>(x, y, bias, NC, C, p, s);
    case F_STRIP_UP4_RADIAL: return launch_strip<T, 4, 2, true>(x, y, bias, NC, C, p, s);
    default: break;
  }
  return cudaErrorInvalidValue;
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
