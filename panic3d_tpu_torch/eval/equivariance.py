"""Equivariance metrics EQ-T, EQ-T_frac and EQ-R (panic3d_tpu/eval/equivariance.py).

How well a synthesis network that takes a 3x3 input transform commutes with
image-space translation and rotation, as the PSNR between the transformed
render and the render of the transformed input (the reference's
metrics/equivariance.py; ``synthesis_fn(ws, transform) -> NCHW image``).

The operators keep the JAX module's names and static-shape arithmetic
(roll + masks in place of data-dependent slicing). The random draws are
host numbers: ``equivariance_step`` takes them as arguments, and
``compute_equivariance_metrics`` draws them from an explicit
``torch.Generator`` on the CPU, so a test can hand the JAX step the same
draws. Matrices and masks are made on the host or from host numbers and
reach the card without a wait (``utils/device.py:to_device``); the filters
run through the port's filter2d / upsample2d (kernel K4 on the card; the
47x47 and 11x11 rotation filters through its large-filter kernel). One
batch makes the host wait once, for its sums, which the loop adds in fp64.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.grid_sample import grid_sample_2d
from ..ops.upfirdn2d import filter2d, upsample2d
from ..utils.device import to_device


def sinc(x):
    y = (x * math.pi).abs()
    z = torch.sin(y) / y.clamp_min(1e-30)
    return torch.where(y < 1e-30, torch.ones_like(z), z)


def lanczos_window(x, a):
    x = x.abs() / a
    return torch.where(x < 1, sinc(x), torch.zeros_like(x))


def rotation_matrix(angle) -> torch.Tensor:
    """[3,3] f32 on the CPU, from a host angle (radians)."""
    angle = torch.as_tensor(angle, dtype=torch.float32)
    c, s = torch.cos(angle), torch.sin(angle)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, s, zero]), torch.stack([-s, c, zero]),
                        torch.stack([zero, zero, one])])


def _on(t: torch.Tensor, device) -> torch.Tensor:
    """A host tensor on ``device``, copied without making the host wait."""
    return to_device(t.numpy(), device)


def _axis_mask(n, lo, hi, dtype, device):
    """[n] mask of the indices in [lo, hi)."""
    idx = torch.arange(n, device=device)
    return ((idx >= lo) & (idx < hi)).to(dtype)


def _mask(x, h, w, y_range, x_range):
    return (_axis_mask(h, *y_range, x.dtype, x.device)[:, None]
            * _axis_mask(w, *x_range, x.dtype, x.device)[None, :])


def apply_integer_translation(x, tx, ty):
    """T_x (equivariance.py:46-60): shift by round(t * size) pixels; tx, ty
    are host fractions of the image size."""
    N, C, H, W = x.shape
    ix = int(np.round(np.float32(tx) * np.float32(W)))
    iy = int(np.round(np.float32(ty) * np.float32(H)))
    z = torch.roll(x, (iy, ix), dims=(2, 3))
    m = _mask(x, H, W, (iy, H + iy), (ix, W + ix)).expand(x.shape)
    return z * m, m


def apply_fractional_translation(x, tx, ty, a=3):
    """T_x with subpixel shifts (equivariance.py:66-99): separable windowed
    sinc for the fractional part, an integer roll for the rest (the JAX
    module's derivation of the roll and the mask)."""
    N, C, H, W = x.shape
    tx = np.float32(tx) * np.float32(W)
    ty = np.float32(ty) * np.float32(H)
    ix, iy = int(np.floor(tx)), int(np.floor(ty))
    fx, fy = float(tx - np.float32(ix)), float(ty - np.float32(iy))
    b = a - 1

    taps = torch.arange(a * 2, dtype=torch.float32) - b
    fil_x = sinc(taps - fx) * sinc((taps - fx) / a)
    fil_y = sinc(taps - fy) * sinc((taps - fy) / a)
    y = filter2d(x, (fil_x / fil_x.sum())[None, :], padding=[b, a, 0, 0])
    y = filter2d(y, (fil_y / fil_y.sum())[:, None], padding=[0, 0, b, a])
    z = torch.roll(y, (iy - b, ix - b), dims=(2, 3))[:, :, :H, :W]
    m = _mask(x, H, W, (iy + a, H + iy - b), (ix + a, W + ix - b)).expand(x.shape)
    return z * m, m


def construct_affine_bandlimit_filter(mat, a=3, amax=16, aflt=64, up=4, cutoff_in=1,
                                      cutoff_out=1):
    """Oriented low-pass for an affine transform (equivariance.py:105-137):
    the windowed convolution (by FFT) of input- and output-space sinc
    filters, on ``mat``'s device. It is computed in f64 and rounded once to
    f32: an f32 FFT's rounding differs from library to library (cuFFT on
    the card, pocketfft on the CPU), and where the synthesis is nearly
    equivariant (EQ-R above ~100 dB) the metric reads that rounding."""
    if not a <= amax < aflt:
        raise ValueError(f"need a <= amax < aflt, got {a}, {amax}, {aflt}")
    mat = mat.to(torch.float64)
    taps = torch.roll(
        (torch.arange(aflt * up * 2 - 1, dtype=torch.float64, device=mat.device) + 1) / up
        - aflt, 1 - aflt * up)
    yi, xi = torch.meshgrid(taps, taps, indexing="ij")
    out = torch.stack([xi, yi], dim=2) @ mat[:2, :2].T
    xo, yo = out[..., 0], out[..., 1]

    fi = sinc(xi * cutoff_in) * sinc(yi * cutoff_in)
    fo = sinc(xo * cutoff_out) * sinc(yo * cutoff_out)
    f = torch.fft.ifftn(torch.fft.fftn(fi) * torch.fft.fftn(fo)).real

    wi = lanczos_window(xi, a) * lanczos_window(yi, a)
    wo = lanczos_window(xo, a) * lanczos_window(yo, a)
    w = torch.fft.ifftn(torch.fft.fftn(wi) * torch.fft.fftn(wo)).real

    f = f * w
    c = (aflt - amax) * up
    f = torch.roll(f, (aflt * up - 1, aflt * up - 1), dims=(0, 1))[c:-c, c:-c]
    f = torch.nn.functional.pad(f, (0, 1, 0, 1)).reshape(amax * 2, up, amax * 2, up)
    f = f / f.sum(dim=(0, 2), keepdim=True) / (up ** 2)
    return f.reshape(amax * 2 * up, amax * 2 * up)[:-1, :-1].to(torch.float32)


def _affine_grid(theta, N, H, W):
    """torch affine_grid(align_corners=False): the half-pixel-centred base
    grid mapped by the [N,2,3] theta -> [N,H,W,2] xy in [-1, 1]."""
    xs = -1.0 + (2.0 * torch.arange(W, dtype=torch.float32, device=theta.device) + 1.0) / W
    ys = -1.0 + (2.0 * torch.arange(H, dtype=torch.float32, device=theta.device) + 1.0) / H
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)   # [H,W,3]
    return torch.einsum("nij,hwj->nhwi", theta, base)


def _grid_sample_nearest(x, grid):
    """Nearest-neighbour grid sample, zeros padding, align_corners=False."""
    N, C, H, W = x.shape
    ix = torch.round((grid[..., 0] + 1) * W / 2 - 0.5).to(torch.int64)
    iy = torch.round((grid[..., 1] + 1) * H / 2 - 0.5).to(torch.int64)
    valid = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
    n = torch.arange(N, device=x.device)[:, None, None]
    out = x[n, :, iy.clamp(0, H - 1), ix.clamp(0, W - 1)]   # [N,Hg,Wg,C]
    return out.permute(0, 3, 1, 2) * valid[:, None].to(x.dtype)


def apply_affine_transformation(x, mat, up=4, **filter_kwargs):
    """Bandlimited affine resampling (equivariance.py:143-171): filtered
    up-x4, bilinear resample on the transformed grid, border mask. ``mat``
    [3,3] f32 on x's device."""
    N, C, H, W = x.shape
    mat = mat.to(torch.float32)
    f = construct_affine_bandlimit_filter(mat, up=up, **filter_kwargs)
    p = f.shape[0] // 2

    theta = torch.linalg.inv_ex(mat).inverse.clone()
    theta[:2, 2] *= 2
    theta[0, 2] += 1 / up / W
    theta[1, 2] += 1 / up / H
    theta[0, :] *= W / (W + p / up * 2)
    theta[1, :] *= H / (H + p / up * 2)
    theta = theta[:2, :3][None].expand(N, 2, 3)
    g = _affine_grid(theta, N, H, W)

    y = upsample2d(x=x, f=f, up=up, padding=p)
    z = grid_sample_2d(y, g, padding_mode="zeros")

    c = p * 2 + 1
    Hy, Wy = y.shape[2], y.shape[3]
    m = _mask(x, Hy, Wy, (c, Hy - c), (c, Wy - c))
    m = _grid_sample_nearest(m.expand(N, 1, Hy, Wy), g).expand(N, C, H, W)
    return z, m


def apply_fractional_rotation(x, angle, a=3, **filter_kwargs):
    """R_alpha (equivariance.py:177-181), a host angle."""
    mat = _on(rotation_matrix(angle), x.device)
    return apply_affine_transformation(x, mat, a=a, amax=a * 2, **filter_kwargs)


def apply_fractional_pseudo_rotation(x, angle, a=3, **filter_kwargs):
    """R*_alpha (equivariance.py:187-195): the rotation's change of
    frequency content without the rotation, for comparing against R_alpha
    renders."""
    mat = _on(rotation_matrix(-angle), x.device)
    f = construct_affine_bandlimit_filter(mat, a=a, amax=a * 2, up=1, **filter_kwargs)
    y = filter2d(x=x, f=f)
    c = f.shape[0] // 2
    H, W = y.shape[2], y.shape[3]
    return y, _mask(x, H, W, (c, H - c), (c, W - c)).expand(y.shape)


# ---------------------------------------------------------------------------
# the sampling loop (equivariance.py:206-277 compute_equivariance_metrics)

def _translation(t, device):
    m = np.eye(3, dtype=np.float32)
    m[:2, 2] = -np.asarray(t, np.float32)
    return _on(torch.from_numpy(m), device)


def equivariance_step(synthesis_fn, ws, t_int=None, t_frac=None, angle=None):
    """One batch: -> [2k] f32 sums on ws's device, (squared error x mask,
    mask) for each metric given a draw, in the order int / frac / rot.
    ``t_int`` and ``t_frac`` are (tx, ty) fractions of the image size
    (``t_int`` already a whole number of pixels), ``angle`` radians."""
    dev = ws.device
    orig = synthesis_fn(ws, _on(torch.eye(3), dev))
    s = []
    if t_int is not None:
        img = synthesis_fn(ws, _translation(t_int, dev))
        ref, mask = apply_integer_translation(orig, t_int[0], t_int[1])
        s += [(ref - img).square() * mask, mask]
    if t_frac is not None:
        img = synthesis_fn(ws, _translation(t_frac, dev))
        ref, mask = apply_fractional_translation(orig, t_frac[0], t_frac[1])
        s += [(ref - img).square() * mask, mask]
    if angle is not None:
        img = synthesis_fn(ws, _on(rotation_matrix(-angle), dev))
        ref, ref_mask = apply_fractional_rotation(orig, angle)
        pseudo, pseudo_mask = apply_fractional_pseudo_rotation(img, angle)
        mask = ref_mask * pseudo_mask
        s += [(ref - pseudo).square() * mask, mask]
    return torch.stack([v.sum() for v in s])


def draw(generator, img_resolution, translate_max=0.125, rotate_max=1.0,
         compute_eqt_int=False, compute_eqt_frac=False, compute_eqr=False):
    """One batch's random draws from ``generator`` (CPU), as host numbers:
    -> dict(t_int=, t_frac=, angle=), None for a metric not computed."""
    out = dict(t_int=None, t_frac=None, angle=None)
    if compute_eqt_int:
        t = (torch.rand(2, generator=generator) * 2 - 1) * translate_max
        t = torch.round(t * img_resolution) / img_resolution
        out["t_int"] = tuple(t.tolist())
    if compute_eqt_frac:
        t = (torch.rand(2, generator=generator) * 2 - 1) * translate_max
        out["t_frac"] = tuple(t.tolist())
    if compute_eqr:
        u = torch.rand((), generator=generator)
        out["angle"] = float((u * 2 - 1) * (rotate_max * math.pi))
    return out


def compute_equivariance_metrics(synthesis_fn, ws_iter, num_samples: int,
                                 img_resolution: int, translate_max: float = 0.125,
                                 rotate_max: float = 1.0, compute_eqt_int: bool = False,
                                 compute_eqt_frac: bool = False, compute_eqr: bool = False,
                                 generator=None):
    """-> PSNR (or a tuple of PSNRs, in the order int / frac / rot).

    ``synthesis_fn(ws, transform[3,3]) -> NCHW image``; the transform plays
    the role of ``G.synthesis.input.transform``. ``ws_iter`` yields latent
    batches; ``generator`` (a CPU torch.Generator, seed 0 by default) draws
    the shifts and angles."""
    if not (compute_eqt_int or compute_eqt_frac or compute_eqr):
        raise ValueError("no equivariance metric asked for")
    generator = generator if generator is not None else torch.Generator().manual_seed(0)
    sums = None
    done = 0
    while done < num_samples:
        ws = next(ws_iter)
        d = draw(generator, img_resolution, translate_max, rotate_max, compute_eqt_int,
                 compute_eqt_frac, compute_eqr)
        # per-batch f32 sums on the device; the accumulation is fp64 on the host
        s = equivariance_step(synthesis_fn, ws, **d).cpu().numpy().astype(np.float64)
        sums = s if sums is None else sums + s
        done += int(ws.shape[0])
    mses = sums[0::2] / sums[1::2]
    psnrs = np.log10(2) * 20 - np.log10(mses) * 10
    return psnrs[0] if len(psnrs) == 1 else tuple(psnrs)
