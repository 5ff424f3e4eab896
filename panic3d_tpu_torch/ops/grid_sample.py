"""Bilinear 2-D and trilinear 3-D point sampling (panic3d_tpu/ops/grid_sample.py).

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


def _unnormalize(coord, size):
    """align_corners=False: [-1, 1] -> texel coordinates."""
    return ((coord + 1) * size - 1) / 2


def _setup(coord, size, acc, dtype):
    i = _unnormalize(coord.to(acc), size)
    i0f = torch.floor(i)
    return i0f.to(torch.int64), (i - i0f)[..., None].to(dtype)


def _check_padding(padding_mode):
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"padding_mode must be 'zeros' or 'border', got {padding_mode!r}")


def grid_sample_2d_points(input, points, padding_mode="zeros"):
    """Sample ``input`` [N,C,H,W] at ``points`` [N,P,2] (x, y in [-1, 1])
    -> [N,P,C], as torch's grid_sample(mode='bilinear', align_corners=False)
    does with zeros or border padding. Border padding clamps the corner
    indices (the weights come from the unclamped coordinate), which is
    torch's border mode. The lerp runs in the input's dtype, as in the JAX
    op."""
    _check_padding(padding_mode)
    N, C, H, W = input.shape
    P = points.shape[1]
    flat = input.reshape(N, C, H * W).transpose(1, 2).reshape(N * H * W, C)
    acc = torch.promote_types(points.dtype, torch.float32)
    ix0, wx1 = _setup(points[..., 0], W, acc, input.dtype)
    iy0, wy1 = _setup(points[..., 1], H, acc, input.dtype)
    base = (torch.arange(N, device=input.device) * (H * W))[:, None]

    def gather(iy, ix):
        lin = iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1) + base
        vals = flat[lin.reshape(-1)].reshape(N, P, C)
        if padding_mode == "border":
            return vals
        valid = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
        return torch.where(valid[..., None], vals, torch.zeros((), dtype=vals.dtype,
                                                               device=vals.device))

    v00 = gather(iy0, ix0)
    v01 = gather(iy0, ix0 + 1)
    v10 = gather(iy0 + 1, ix0)
    v11 = gather(iy0 + 1, ix0 + 1)
    top = v00 + (v01 - v00) * wx1
    bot = v10 + (v11 - v10) * wx1
    return top + (bot - top) * wy1


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
