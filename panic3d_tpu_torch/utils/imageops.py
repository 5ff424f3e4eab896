"""Small image ops of paste-front (panic3d_tpu/utils/imageops.py:14-75):
nearest resize, kornia's normalised sobel magnitude, and flat-kernel
erosion / dilation, in plain PyTorch on NCHW tensors. They are the plain
versions of what kernel K8 (csrc/paste_front.cu) computes per pixel."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_nearest(x, size: int):
    """torch F.interpolate(mode='nearest') on NCHW (floor-index convention)."""
    N, C, H, W = x.shape
    idx_y = torch.floor(torch.arange(size, device=x.device) * (H / size)).long()
    idx_x = torch.floor(torch.arange(size, device=x.device) * (W / size)).long()
    return x[:, :, idx_y][:, :, :, idx_x]


_SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))


def sobel_magnitude(x):
    """kornia.filters.sobel (normalised: the classic kernel / 8, reflect
    padding), then the L2 norm over channels and both directions ->
    [N,1,H,W]."""
    N, C, H, W = x.shape
    kx = torch.tensor(_SOBEL_X, dtype=x.dtype, device=x.device) / 8.0
    ky = kx.T
    xp = F.pad(x, (1, 1, 1, 1), mode="reflect")

    def dconv(k):   # a true convolution, as the JAX op's flipped correlate
        return F.conv2d(xp, torch.flip(k, (0, 1)).expand(C, 1, 3, 3), groups=C)

    gx, gy = dconv(kx), dconv(ky)
    return torch.sqrt(torch.sum(gx ** 2 + gy ** 2, dim=1, keepdim=True) + 1e-12)


def _morph(x, kernel_size: int, op: str):
    """Morphology with an all-ones square structuring element."""
    lo, hi = (kernel_size - 1) // 2, kernel_size // 2
    fill = float("inf") if op == "erode" else float("-inf")
    xp = F.pad(x, (lo, hi, lo, hi), value=fill)
    win = xp.unfold(2, kernel_size, 1).unfold(3, kernel_size, 1)
    win = win.reshape(*win.shape[:4], -1)
    return win.amin(-1) if op == "erode" else win.amax(-1)


def erosion(x, kernel_size: int):
    """kornia.morphology.erosion with ones(k, k) (values only, flat kernel)."""
    return _morph(x, kernel_size, "erode")


def dilation(x, kernel_size: int):
    """kornia.morphology.dilation with ones(k, k)."""
    return _morph(x, kernel_size, "dilate")
