"""Difference-of-Gaussians line extraction (panic3d_tpu/utils/sketchers.py,
the role of the reference's `_util/sketchers_v2.py:48-83` batch_dog, as the
line filler calls it with t=1.0, sigma=0.5, k=1.6). The blurs are
kornia-style fixed-size kernels (2*int(sigma*kernel_factor)+1 taps,
replicate padding) applied as a separable depthwise convolution on NCHW;
F.conv2d stands for JAX's conv_general_dilated (both correlate).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .device import constant


def _gauss_kernel1d(kern: int, sigma: float) -> np.ndarray:
    # kornia convention: centred taps, normalised to sum 1
    x = np.arange(kern, dtype=np.float64) - (kern - 1) / 2
    g = np.exp(-0.5 * (x / sigma) ** 2)
    return (g / g.sum()).astype(np.float32)


def gaussian_blur2d(img, kern: int, sigma: float):
    """Separable gaussian blur, replicate padding, NCHW."""
    k = constant(_gauss_kernel1d(kern, sigma), img.device).to(img.dtype)
    C = img.shape[1]
    lo, hi = (kern - 1) // 2, kern // 2
    x = F.conv2d(F.pad(img, (0, 0, lo, hi), mode="replicate"),
                 k.view(1, 1, kern, 1).expand(C, 1, kern, 1), groups=C)
    return F.conv2d(F.pad(x, (lo, hi, 0, 0), mode="replicate"),
                    k.view(1, 1, 1, kern).expand(C, 1, 1, kern), groups=C)


def rgb_to_grayscale(img):
    w = constant((0.299, 0.587, 0.114), img.device).to(img.dtype)
    return torch.einsum("nchw,c->nhw", img[:, :3], w)[:, None]


def batch_dog(img, t=2.0, sigma=1.0, k=1.6, epsilon=0.01, kernel_factor=4, clip=True):
    """(bs, {1,3,4}, h, w) -> (bs, 1, h, w) line-ness map."""
    ch = img.shape[1]
    if ch in (3, 4):
        img = rgb_to_grayscale(img)
    elif ch != 1:
        raise ValueError(f"batch_dog takes 1, 3 or 4 channels, not {ch}")
    kern0 = max(2 * int(sigma * kernel_factor) + 1, 3)
    kern1 = max(2 * int(sigma * k * kernel_factor) + 1, 3)
    g0 = gaussian_blur2d(img, kern0, sigma)
    g1 = gaussian_blur2d(img, kern1, sigma * k)
    ans = 0.5 + t * (g1 - g0) - epsilon
    return ans.clamp(0, 1) if clip else ans
