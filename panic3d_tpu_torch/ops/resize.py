"""Image resize with the arithmetic of ``jax.image.resize`` (bilinear and
bicubic, with or without antialiasing), which the JAX package's eval path
calls at three places: measure.py's crops (bilinear), CLIP's 224^2 input
(bicubic) and the ResNet's 256^2 input (bilinear, antialiased when it
shrinks the image).

jax.image.resize builds one weight matrix per resized axis, as
``scale_and_translate`` does: the triangle kernel or Keys' cubic with
a = -0.5, widened by the scale when antialiasing a downscale, each output's
weights renormalised to sum to 1 (so the border is not darkened), and the
outputs whose sample lies outside the input zeroed. ``F.interpolate``
differs at the border (it clamps) and in its cubic (a = -0.75), so the
matrices are built here, with JAX's f32 formula, and applied with two
matrix products (the rows, then the columns, in JAX's order). XLA's CPU
code contracts some of that formula's multiply-adds and turns the division
by the kernel's scale into a product with its reciprocal, differently from
one fused graph to another, so the weights can differ from JAX's by an ulp
of the sample position: a resized image agrees with jax.image.resize
within 3e-6, and the two products with their f64 evaluation within 1e-6
(tests/test_torch_metricnets.py).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_EPS_F32 = float(np.finfo(np.float32).eps)


def _triangle(x):
    return torch.clamp(1 - x.abs(), min=0)


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


_KERNELS = {"bilinear": _triangle, "linear": _triangle, "bicubic": _keys_cubic,
            "cubic": _keys_cubic}


@functools.lru_cache(maxsize=64)
def weight_mat(n_in: int, n_out: int, method: str, antialias: bool, device) -> torch.Tensor:
    """The [n_in, n_out] f32 weights of one resized axis, built on the CPU
    and cached on ``device``."""
    inv_scale = 1.0 / (n_out / n_in)            # Python floats, as JAX takes them
    f32 = torch.float32
    kernel_scale = torch.tensor(max(inv_scale, 1.0) if antialias else 1.0, dtype=f32)
    sample_f = (torch.arange(n_out, dtype=f32) + 0.5) * torch.tensor(inv_scale, dtype=f32) - 0.5
    x = (sample_f[None, :] - torch.arange(n_in, dtype=f32)[:, None]).abs() / kernel_scale
    w = _KERNELS[method](x)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * _EPS_F32,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(device)


def resize(x: torch.Tensor, shape, method: str = "bilinear",
           antialias: bool = True) -> torch.Tensor:
    """jax.image.resize(x, shape, method, antialias) for a float tensor
    whose last two axes are resized (the others must keep their size)."""
    shape = tuple(int(s) for s in shape)
    if shape[:-2] != tuple(x.shape[:-2]):
        raise ValueError(f"resize: only the last two axes change ({tuple(x.shape)} -> {shape})")
    method = method.lower()
    if method not in _KERNELS:
        raise ValueError(f"resize: method {method!r} is not ported")
    x = x.float()
    (h, w), (oh, ow) = x.shape[-2:], shape[-2:]
    if oh != h:
        x = torch.matmul(weight_mat(h, oh, method, antialias, x.device).T, x)
    if ow != w:
        x = torch.matmul(x, weight_mat(w, ow, method, antialias, x.device))
    return x
