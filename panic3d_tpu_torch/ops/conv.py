"""2-D convolution with FIR up/downsampling, and StyleGAN2's modulated conv
(panic3d_tpu/ops/conv.py).

The weight convolution itself is ``F.conv2d`` (cuDNN on the card), as the
JAX package leaves it to ``lax.conv_general_dilated``; the FIR resampling
around it is upfirdn2d (kernel K4 on the card).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .upfirdn2d import _get_filter_size, _parse_padding, upfirdn2d


def _conv2d(x, w, stride=1, padding=(0, 0, 0, 0), groups=1, flip_weight=True):
    """Plain 2-D correlation (flip_weight=True is F.conv2d's convention)."""
    if not flip_weight:
        w = w.flip([-1, -2])
    px0, px1, py0, py1 = padding
    w = w.to(x.dtype)
    if px0 == px1 and py0 == py1 and px0 >= 0 and py0 >= 0:
        return F.conv2d(x, w, stride=stride, padding=(py0, px0), groups=groups)
    return F.conv2d(F.pad(x, [px0, px1, py0, py1]), w, stride=stride, groups=groups)


def conv2d_resample(x, w, f=None, up: int = 1, down: int = 1, padding=0,
                    groups: int = 1, flip_weight: bool = True,
                    flip_filter: bool = False):
    """2-D conv with optional FIR-filtered up/downsampling; ``padding`` is
    relative to the upsampled image (reference conv2d_resample.py:47-144)."""
    if x.ndim != 4 or w.ndim != 4:
        raise ValueError("conv2d_resample takes NCHW input and OIHW weight")
    fw, fh = _get_filter_size(f)
    px0, px1, py0, py1 = _parse_padding(padding)
    if up > 1:
        px0 += (fw + up - 1) // 2
        px1 += (fw - up) // 2
        py0 += (fh + up - 1) // 2
        py1 += (fh - up) // 2
    if down > 1:
        px0 += (fw - down + 1) // 2
        px1 += (fw - down) // 2
        py0 += (fh - down + 1) // 2
        py1 += (fh - down) // 2
    if up > 1:
        # zero-insert + FIR + pad in one upfirdn2d, then the weight conv (both
        # are linear shift-invariant, so they commute)
        x = upfirdn2d(x, f, up=up, padding=[px0, px1, py0, py1], gain=up ** 2,
                      flip_filter=flip_filter)
        px0 = px1 = py0 = py1 = 0
        if down > 1 and f is not None:
            x = upfirdn2d(x, f, flip_filter=flip_filter)
    elif down > 1 and f is not None:
        x = upfirdn2d(x, f, padding=[px0, px1, py0, py1], flip_filter=flip_filter)
        px0 = px1 = py0 = py1 = 0
    return _conv2d(x, w, stride=down, padding=(px0, px1, py0, py1),
                   groups=groups, flip_weight=flip_weight)


def modulated_conv2d(x, weight, styles, noise: Optional[torch.Tensor] = None,
                     up: int = 1, down: int = 1, padding: int = 0,
                     resample_filter=None, demodulate: bool = True,
                     flip_weight: bool = True):
    """StyleGAN2 modulated convolution, non-fused form: scale the input by
    the styles, convolve with the shared weight, scale the output by the
    demodulation coefficients 1/sqrt(sum((w*s)^2) + 1e-8), computed in f32."""
    batch_size = x.shape[0]
    out_channels, in_channels, kh, kw = weight.shape
    if tuple(styles.shape) != (batch_size, in_channels):
        raise ValueError(f"styles {tuple(styles.shape)} vs ({batch_size}, {in_channels})")
    dcoefs = None
    if demodulate:
        acc = torch.promote_types(weight.dtype, torch.float32)
        w32 = weight.to(acc)[None] * styles.to(acc)[:, None, :, None, None]
        dcoefs = torch.rsqrt(w32.square().sum(dim=(2, 3, 4)) + 1e-8)   # [N, C_out]
    x = x * styles.to(x.dtype)[:, :, None, None]
    x = conv2d_resample(x, weight.to(x.dtype), f=resample_filter, up=up,
                        down=down, padding=padding, flip_weight=flip_weight)
    if demodulate:
        x = x * dcoefs.to(x.dtype)[:, :, None, None]
    if noise is not None:
        x = x + noise.to(x.dtype)
    return x
