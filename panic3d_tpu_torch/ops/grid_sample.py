"""Bilinear 2-D point sampling (panic3d_tpu/ops/grid_sample.py:42).

``grid_sample_2d_points`` is the plain half of kernel K1: the triplane
lookup of models/volumetric/renderer.py:triplane_decode_plain. The JAX
package's corner packing (pack_bilinear_2d) is a TPU row-width trick and is
not ported; K1 reads the four corners from channels-last planes instead.
"""

from __future__ import annotations

import torch


def grid_sample_2d_points(input, points):
    """Sample ``input`` [N,C,H,W] at ``points`` [N,P,2] (x, y in [-1, 1])
    -> [N,P,C], as torch's grid_sample(mode='bilinear', padding_mode='zeros',
    align_corners=False) does. The lerp runs in the input's dtype, as in the
    JAX op. (The border padding paste-front needs comes with that slice.)"""
    N, C, H, W = input.shape
    P = points.shape[1]
    flat = input.reshape(N, C, H * W).transpose(1, 2).reshape(N * H * W, C)
    acc = torch.promote_types(points.dtype, torch.float32)
    ix = ((points[..., 0].to(acc) + 1) * W - 1) / 2
    iy = ((points[..., 1].to(acc) + 1) * H - 1) / 2
    ix0f, iy0f = torch.floor(ix), torch.floor(iy)
    wx1 = (ix - ix0f)[..., None].to(input.dtype)
    wy1 = (iy - iy0f)[..., None].to(input.dtype)
    ix0, iy0 = ix0f.to(torch.int64), iy0f.to(torch.int64)
    base = (torch.arange(N, device=input.device) * (H * W))[:, None]

    def gather(iy, ix):
        lin = iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1) + base
        vals = flat[lin.reshape(-1)].reshape(N, P, C)
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
