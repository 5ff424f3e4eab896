"""Bilinear 2-D and trilinear 3-D point sampling (panic3d_tpu/ops/grid_sample.py).

``grid_sample_2d`` is the image-grid form of the 2-D sample: the
equivariance metrics resample with it (eval/equivariance.py), the training
loss mask reads the front view through it (training/loss.py), and ADA warps
the discriminator's images with it (training/augment.py). On CUDA tensors it
is the wrapper of kernel K14 (csrc/grid_sample.cu, f32), run inside
``GridSample2d``, an autograd.Function whose backward is K14's backward form
(``grid_sample_2d_grad``: the input's gradient, a tile of points added into
its source footprint in shared memory and flushed with atomics, or added
with an atomic a corner where the footprint is large: ``k14_tile_plan``),
itself an autograd.Function whose backward is K14's forward on the same grid
(the backward is linear in its gradient, and its transpose is the sample),
so R1 differentiates it twice. The grid takes no gradient on any path of the
port (ADA's comes from random draws, the loss mask's from a rounded data
grid, EQ-R's from a fixed matrix): a grid that requires grad raises. On CPU
tensors ``grid_sample_2d`` is the plain composition below, which autograd
differentiates in full.

``grid_sample_2d_points`` is the plain half of kernel K1 (the triplane
lookup of models/volumetric/renderer.py:triplane_decode_plain, zeros
padding) and of K8 (paste-front's border-padded front projection).
``grid_sample_3d_points`` is the plain version of K7's trilinear read of the
occlusion volume and of K10's, the deep planes' trilinear sample that
kernel runs fused with the decoder (renderer.py:triplane_decode_deep,
csrc/triplane_decode.cu). The JAX package's corner packing (pack_bilinear_2d and its
border form) is a TPU row-width trick and is not ported; its border form is
bit-equal to the unpacked border path here.
"""

from __future__ import annotations

import torch

from ..kernels import KERNELS, require_no_grad
from ..kernels import build as kb


def _unnormalize(coord, size, align_corners=False):
    """[-1, 1] -> texel coordinates, in the JAX op's order of operations."""
    if align_corners:
        return (coord + 1) / 2 * (size - 1)
    return ((coord + 1) * size - 1) / 2


def _setup(coord, size, acc, dtype, align_corners=False):
    i = _unnormalize(coord.to(acc), size, align_corners)
    i0f = torch.floor(i)
    return i0f.to(torch.int64), (i - i0f)[..., None].to(dtype)


def _check_padding(padding_mode):
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"padding_mode must be 'zeros' or 'border', got {padding_mode!r}")


def _corners(N, H, W, points, padding_mode, align_corners, dtype):
    """The four corners of each point of ``points`` [N,P,2]: [(flat row
    index [N,P], valid [N,P], or None under border padding)] in the order
    00, 01, 10, 11, and the weights wx1, wy1 [N,P,1] in ``dtype``. Border
    padding clamps the corner indices (the weights come from the unclamped
    coordinate), which is torch's border mode."""
    acc = torch.promote_types(points.dtype, torch.float32)
    ix0, wx1 = _setup(points[..., 0], W, acc, dtype, align_corners)
    iy0, wy1 = _setup(points[..., 1], H, acc, dtype, align_corners)
    base = (torch.arange(N, device=points.device) * (H * W))[:, None]
    out = []
    for iy, ix in ((iy0, ix0), (iy0, ix0 + 1), (iy0 + 1, ix0), (iy0 + 1, ix0 + 1)):
        lin = iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1) + base
        valid = None if padding_mode == "border" else (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
        out.append((lin, valid))
    return out, wx1, wy1


def _zero_outside(v, valid):
    if valid is None:
        return v
    return torch.where(valid[..., None], v, torch.zeros((), dtype=v.dtype, device=v.device))


def grid_sample_2d_points(input, points, padding_mode="zeros", align_corners=False):
    """Sample ``input`` [N,C,H,W] at ``points`` [N,P,2] (x, y in [-1, 1])
    -> [N,P,C], as torch's grid_sample(mode='bilinear') does with zeros or
    border padding and either ``align_corners``. The lerp runs in the
    input's dtype, as in the JAX op:
    top = v00 + (v01 - v00) wx, bot likewise, out = top + (bot - top) wy."""
    _check_padding(padding_mode)
    N, C, H, W = input.shape
    P = points.shape[1]
    flat = input.reshape(N, C, H * W).transpose(1, 2).reshape(N * H * W, C)
    corners, wx1, wy1 = _corners(N, H, W, points, padding_mode, align_corners, input.dtype)
    v00, v01, v10, v11 = (_zero_outside(flat[lin.reshape(-1)].reshape(N, P, C), valid)
                          for lin, valid in corners)
    top = v00 + (v01 - v00) * wx1
    bot = v10 + (v11 - v10) * wx1
    return top + (bot - top) * wy1


def grid_sample_2d_plain(input, grid, padding_mode="zeros", align_corners=False):
    """The image-grid form (panic3d_tpu/ops/grid_sample.py:256) in plain
    PyTorch: ``input`` [N,C,H,W] sampled at ``grid`` [N,Hg,Wg,2] (x, y in
    [-1, 1]) -> [N,C,Hg,Wg], bilinear. The CPU path and K14's oracle."""
    N, C = input.shape[:2]
    gshape = tuple(grid.shape[1:-1])
    out = grid_sample_2d_points(input, grid.reshape(N, -1, 2), padding_mode, align_corners)
    return out.transpose(1, 2).reshape(N, C, *gshape)


def grid_sample_2d_grad_plain(grad, grid, in_shape, padding_mode="zeros", align_corners=False):
    """The plain version of K14's backward form: the gradient to the input
    (of shape ``in_shape`` [N,C,H,W]) of :func:`grid_sample_2d_plain` at
    ``grid``, from the output's gradient ``grad`` [N,C,Hg,Wg]. A point's
    four corner terms are autograd's of the lerp, in its order of rounding
    (g_top = g - g wy, g_bot = g wy, g00 = g_top - g_top wx, g01 = g_top wx,
    the bottom row likewise), added into a zeroed gradient by index_add_;
    corners outside the image add nothing under zeros padding."""
    _check_padding(padding_mode)
    N, C, H, W = in_shape
    g = grad.reshape(N, C, -1).transpose(1, 2)
    corners, wx1, wy1 = _corners(N, H, W, grid.reshape(N, -1, 2), padding_mode, align_corners,
                                 grad.dtype)
    g_top = g - g * wy1
    g_bot = g * wy1
    terms = (g_top - g_top * wx1, g_top * wx1, g_bot - g_bot * wx1, g_bot * wx1)
    flat = torch.zeros((N * H * W, C), dtype=grad.dtype, device=grad.device)
    for (lin, valid), v in zip(corners, terms):
        flat.index_add_(0, lin.reshape(-1), _zero_outside(v, valid).reshape(-1, C))
    return flat.reshape(N, H * W, C).transpose(1, 2).reshape(N, C, H, W)


_K14_ARGS = (kb.PTR, kb.PTR, kb.PTR, kb.INT, kb.INT, kb.INT, kb.INT, kb.INT, kb.INT, kb.INT,
             kb.INT, kb.PTR)
_PADDING = {"zeros": 0, "border": 1}
K14_TILE = 16             # csrc/grid_sample.cu: a block's tile of 16 x 16 output points
K14_STAGE_TEXELS = 1024   # the largest footprint the staged branch takes (4 texels a point)


def k14_tile_plan(grid, H, W, padding_mode="zeros", align_corners=False):
    """K14's backward's footprint test (csrc/grid_sample.cu) in PyTorch: for each tile
    of K14_TILE x K14_TILE output points of ``grid`` [N,Hg,Wg,2] sampling an
    H x W image, the bounding box of its points' valid corners (under border
    padding the clamped corners), its x-start rounded down to a multiple of
    4 and its width up to one; the tile takes the staged branch where the
    box holds at most K14_STAGE_TEXELS texels, the direct branch where it
    holds more or nothing. -> dict of [N,Ty,Tx] tensors: ``x``, ``y`` (the
    box's first column and row), ``w``, ``h`` (its row stride and rows; the
    copy of a row stops at the image's width), ``empty``, ``staged``."""
    _check_padding(padding_mode)
    N, Hg, Wg, _ = grid.shape
    acc = torch.promote_types(grid.dtype, torch.float32)
    x0, _ = _setup(grid[..., 0], W, acc, grid.dtype, align_corners)
    y0, _ = _setup(grid[..., 1], H, acc, grid.dtype, align_corners)
    big = 2 ** 31 - 1
    lo_x, hi_x, lo_y, hi_y = (torch.full_like(x0, v) for v in (big, -big, big, -big))
    for dy in (0, 1):
        for dx in (0, 1):
            xs, ys = x0 + dx, y0 + dy
            ok = (torch.ones_like(xs, dtype=torch.bool) if padding_mode == "border"
                  else (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H))
            xc, yc = xs.clamp(0, W - 1), ys.clamp(0, H - 1)
            lo_x = torch.where(ok, torch.minimum(lo_x, xc), lo_x)
            hi_x = torch.where(ok, torch.maximum(hi_x, xc), hi_x)
            lo_y = torch.where(ok, torch.minimum(lo_y, yc), lo_y)
            hi_y = torch.where(ok, torch.maximum(hi_y, yc), hi_y)
    T = K14_TILE
    pad = (0, -Wg % T, 0, -Hg % T)

    def per_tile(v, fill, reduce):
        v = torch.nn.functional.pad(v, pad, value=fill)
        v = v.reshape(N, v.shape[1] // T, T, v.shape[2] // T, T)
        return reduce(reduce(v, 4), 2)

    lo_x = per_tile(lo_x, big, torch.amin)
    hi_x = per_tile(hi_x, -big, torch.amax)
    lo_y = per_tile(lo_y, big, torch.amin)
    hi_y = per_tile(hi_y, -big, torch.amax)
    empty = lo_x == big
    zero = torch.zeros_like(lo_x)
    bx = torch.where(empty, zero, lo_x - lo_x % 4)
    bw = torch.where(empty, zero, (hi_x + 1 - bx + 3) // 4 * 4)
    by = torch.where(empty, zero, lo_y)
    bh = torch.where(empty, zero, hi_y + 1 - lo_y)
    staged = ~empty & (bw * bh <= K14_STAGE_TEXELS)
    return {"x": bx, "y": by, "w": bw, "h": bh, "empty": empty, "staged": staged}


def _k14_operands(x, grid, what, image_hw=None):
    """Check one K14 launch's operands, an f32 [N,C,H,W] tensor and an f32
    grid [N,Hg,Wg,2] on its CUDA device, for an image of ``image_hw`` (by
    default x's H, W) -> (x, grid), both contiguous, the grid 8-byte
    aligned."""
    if x.dtype != torch.float32 or grid.dtype != torch.float32:
        raise TypeError(f"{what} takes float32 tensors (every caller's dtype), got "
                        f"{x.dtype} and a grid of {grid.dtype}")
    if x.ndim != 4 or grid.ndim != 4 or grid.shape[-1] != 2 or grid.shape[0] != x.shape[0]:
        raise ValueError(f"{what} takes [N,C,H,W] and a grid [N,Hg,Wg,2], got "
                         f"{tuple(x.shape)} and {tuple(grid.shape)}")
    if not (x.is_cuda and grid.device == x.device):
        raise ValueError(f"{what} runs on CUDA tensors of one device, got {x.device} and "
                         f"{grid.device}")
    N = x.shape[0]
    H, W = image_hw or x.shape[2:]
    Hg, Wg = grid.shape[1:3]
    if H * W >= 2 ** 31 or Hg * Wg >= 2 ** 31 or N > 65535 or -(-Hg // K14_TILE) > 65535:
        raise ValueError(f"{what}: an image {tuple(x.shape)} or a grid {tuple(grid.shape)} "
                         f"beyond the kernel's 32-bit offsets or its launch's limits")
    grid = grid.contiguous()
    if grid.data_ptr() % 8:   # the kernel reads a point as a float2
        grid = grid.clone()
    return x.contiguous(), grid


def _launch_k14(x, grid, padding_mode, align_corners):
    """One launch of K14's forward: :func:`grid_sample_2d_plain` on f32 CUDA
    tensors."""
    _check_padding(padding_mode)
    x, grid = _k14_operands(x, grid, "K14 grid_sample_2d")
    N, C, H, W = x.shape
    Hg, Wg = grid.shape[1:3]
    y = torch.empty((N, C, Hg, Wg), device=x.device, dtype=torch.float32)
    kb.launch("grid_sample_2d", _K14_ARGS, x.data_ptr(), grid.data_ptr(), y.data_ptr(), N, C, H,
              W, Hg, Wg, _PADDING[padding_mode], int(bool(align_corners)),
              torch.cuda.current_stream(x.device).cuda_stream)
    KERNELS["grid_sample_2d"].launches += 1
    return y


def _launch_k14_grad(grad, grid, in_shape, padding_mode, align_corners):
    """One launch of K14's backward form: :func:`grid_sample_2d_grad_plain`
    on f32 CUDA tensors. The input's gradient is zeroed, then each tile of
    points adds its corner terms into its footprint in shared memory and
    flushes it with atomics, or, where the footprint fails the staged test,
    adds them with atomics one by one (their order, and so the last bits of
    a sum, varies from run to run)."""
    _check_padding(padding_mode)
    N, C, H, W = in_shape
    if tuple(grad.shape) != (N, C) + tuple(grid.shape[1:3]):
        raise ValueError(f"K14 grid_sample_2d_grad: a gradient {tuple(grad.shape)} for the "
                         f"input {tuple(in_shape)} and the grid {tuple(grid.shape)}")
    grad, grid = _k14_operands(grad, grid, "K14 grid_sample_2d_grad", (H, W))
    gx = torch.zeros((N, C, H, W), device=grad.device, dtype=torch.float32)
    kb.launch("grid_sample_2d_grad", _K14_ARGS, grad.data_ptr(), grid.data_ptr(),
              gx.data_ptr(), N, C, H, W, grid.shape[1], grid.shape[2], _PADDING[padding_mode],
              int(bool(align_corners)), torch.cuda.current_stream(grad.device).cuda_stream)
    KERNELS["grid_sample_2d_grad"].launches += 1
    return gx


class GridSample2d(torch.autograd.Function):
    """K14 with its backward: the forward launches K14 on CUDA tensors (the
    plain version on CPU ones), the backward is :class:`GridSample2dGrad`
    on the same grid. ``cfg`` = (padding_mode, align_corners). The grid
    takes no gradient."""

    @staticmethod
    def forward(ctx, x, grid, cfg):
        y = _launch_k14(x, grid, *cfg) if x.is_cuda else grid_sample_2d_plain(x, grid, *cfg)
        ctx.save_for_backward(grid)
        ctx.in_shape, ctx.cfg = tuple(x.shape), cfg
        return y

    @staticmethod
    def backward(ctx, dy):
        (grid,) = ctx.saved_tensors
        return GridSample2dGrad.apply(dy, grid, ctx.in_shape, ctx.cfg), None, None


class GridSample2dGrad(torch.autograd.Function):
    """The input's gradient from the output's: K14's backward form on CUDA
    tensors, its plain version on CPU ones. It is linear in the output's
    gradient, so its own backward is the sample of the incoming gradient on
    the same grid (:class:`GridSample2d`)."""

    @staticmethod
    def forward(ctx, dy, grid, in_shape, cfg):
        fn = _launch_k14_grad if dy.is_cuda else grid_sample_2d_grad_plain
        ctx.save_for_backward(grid)
        ctx.cfg = cfg
        return fn(dy, grid, in_shape, *cfg)

    @staticmethod
    def backward(ctx, ddx):
        (grid,) = ctx.saved_tensors
        return GridSample2d.apply(ddx, grid, ctx.cfg), None, None, None


def grid_sample_2d_kernel(input, grid, padding_mode="zeros", align_corners=False):
    """K14 on a CUDA tensor, differentiable to ``input`` (:class:`GridSample2d`):
    same contract as :func:`grid_sample_2d_plain`, f32 only. A grid that
    requires grad raises under grad mode."""
    require_no_grad("grid_sample_2d", grid)
    if not input.is_cuda:
        raise ValueError(f"K14 runs on CUDA tensors, got one on {input.device}")
    return GridSample2d.apply(input, grid, (padding_mode, bool(align_corners)))


def grid_sample_2d(input, grid, padding_mode="zeros", align_corners=False):
    """Bilinear sample of ``input`` [N,C,H,W] at ``grid`` [N,Hg,Wg,2] (x, y
    in [-1, 1]) -> [N,C,Hg,Wg], zeros or border padding: the plain version
    on CPU tensors, kernel K14 on CUDA tensors."""
    if input.device.type == "cpu":
        return grid_sample_2d_plain(input, grid, padding_mode, align_corners)
    if input.device.type == "cuda":
        return grid_sample_2d_kernel(input, grid, padding_mode, align_corners)
    raise RuntimeError(f"grid_sample_2d: no path for device {input.device}")


def grid_sample_3d_points(input, points, padding_mode="zeros"):
    """Sample ``input`` [N,C,D,H,W] at ``points`` [N,P,3] (x, y, z in
    [-1, 1], indexing W, H, D) -> [N,P,C], trilinear, align_corners=False;
    the two z slices are blended as out = 0 + lerp_xy(z0)*(1-wz) +
    lerp_xy(z1)*wz, the JAX op's association."""
    _check_padding(padding_mode)
    N, C, D, H, W = input.shape
    P = points.shape[1]
    flat = input.reshape(N, C, D * H * W).transpose(1, 2).reshape(N * D * H * W, C)
    acc = torch.promote_types(points.dtype, torch.float32)
    ix0, wx1 = _setup(points[..., 0], W, acc, input.dtype)
    iy0, wy1 = _setup(points[..., 1], H, acc, input.dtype)
    iz0, wz1 = _setup(points[..., 2], D, acc, input.dtype)
    base = (torch.arange(N, device=input.device) * (D * H * W))[:, None]

    def gather(iz, iy, ix):
        lin = (iz.clamp(0, D - 1) * H + iy.clamp(0, H - 1)) * W + ix.clamp(0, W - 1) + base
        vals = flat[lin.reshape(-1)].reshape(N, P, C)
        if padding_mode == "border":
            return vals
        valid = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H) & (iz >= 0) & (iz < D)
        return torch.where(valid[..., None], vals, torch.zeros((), dtype=vals.dtype,
                                                               device=vals.device))

    out = 0
    for dz, wz in ((0, 1 - wz1), (1, wz1)):
        v00 = gather(iz0 + dz, iy0, ix0)
        v01 = gather(iz0 + dz, iy0, ix0 + 1)
        v10 = gather(iz0 + dz, iy0 + 1, ix0)
        v11 = gather(iz0 + dz, iy0 + 1, ix0 + 1)
        top = v00 + (v01 - v00) * wx1
        bot = v10 + (v11 - v10) * wx1
        out = out + (top + (bot - top) * wy1) * wz
    return out
