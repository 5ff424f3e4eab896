"""Upsample -> FIR filter -> downsample on NCHW images (ops/upfirdn2d.py).

``upfirdn2d`` is the wrapper of CUDA kernel K4 (csrc/upfirdn2d.cu), which
replaces the JAX op's three per-case TPU lowerings. ``upfirdn2d_plain`` is
the same function in plain PyTorch (the reference formula: zero-insert, pad,
grouped correlation, decimate): the CPU path and the kernel's oracle.
``k4_plan`` is what the wrapper hands the kernel for one (filter, padding),
cached: for up=2, down=1 and a 4x4 filter (every call of the flagship) the
polyphase table of the specialised kernel; a filter of one row or one column
at up = down = 1 (the equivariance metrics' EQ-T_frac passes) runs the row
or the column form, and at up or down 2 on its axis (the unfused K11
composition's 1x12 up=2 pass, ADA's sym6 passes) the 1-D polyphase row or
column form; a 4x4 filter at up 1 and down 2 on both axes (the
discriminator's downsample2d) the "down2" form, and at up = down = 1
(conv2d_resample's filter pass before a strided conv) the "fir4" form, one
kernel, which also takes a smaller 2-D filter at up = down = 1
("fir_small", a 3x3). A filter of more than 64 taps (the
equivariance metrics' 47x47 and 11x11 resampling filters, new for every
random angle) is not cached: it goes to the kernel as a device buffer, to
the phase-blocked large-filter kernel ("large") where
``large_phase_geometry`` says it takes the call, else to the tiled one
("large_tiled").

On the card the kernel runs inside ``UpFirDn2d``, an autograd.Function
whose backward is K4's backward form: the transposed upfirdn2d (the filter
rotated by 180 degrees, up and down swapped, the padding by StyleGAN2-ADA's
``_upfirdn2d_cuda`` rule, :func:`transposed_pass`), launched through the same
Function, so that its own backward is the forward call again and R1 can
differentiate it twice. The transposed calls take K4's forward forms: the
discriminator's "down2" calls go back as "up2", its "fir4" passes as
"fir4", the generator's "up2" calls as "down2"; a 1-D polyphase pass goes
back as its transpose ("row_up2" as "row_down2", and so on), "fir_small"
as "fir_small". Each launch is counted
under its variant, a backward one under ``grad_<variant>``. The filter
takes no gradient: a filter that requires grad raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..kernels import KERNELS, require_no_grad
from ..kernels import build as kb
from ..utils.device import to_device


def _parse_scaling(scaling):
    if isinstance(scaling, int):
        scaling = [scaling, scaling]
    sx, sy = (int(s) for s in scaling)
    if sx < 1 or sy < 1:
        raise ValueError(f"scaling must be >= 1, got {scaling}")
    return sx, sy


def _parse_padding(padding):
    if isinstance(padding, int):
        padding = [padding, padding]
    padding = [int(p) for p in padding]
    if len(padding) == 2:
        px, py = padding
        padding = [px, px, py, py]
    px0, px1, py0, py1 = padding
    return px0, px1, py0, py1


def _get_filter_size(f):
    if f is None:
        return 1, 1
    return int(f.shape[-1]), int(f.shape[0])


def setup_filter(f, normalize=True, flip_filter=False, gain=1, separable=None,
                 device=None) -> torch.Tensor:
    """1-D taps with fewer than 8 elements become a 2-D outer product;
    normalized to unit DC gain (reference upfirdn2d.py:73-119)."""
    if f is None:
        f = 1
    f = torch.as_tensor(f, dtype=torch.float32, device=device)
    if f.ndim == 0:
        f = f[None]
    if separable is None:
        separable = f.ndim == 1 and f.numel() >= 8
    if f.ndim == 1 and not separable:
        f = torch.outer(f, f)
    if normalize:
        f = f / f.sum()
    if flip_filter:
        f = f.flip(list(range(f.ndim)))
    return f * (gain ** (f.ndim / 2))


def _out_size(h, w, fh, fw, up, down, pad):
    upx, upy = up
    downx, downy = down
    px0, px1, py0, py1 = pad
    return ((h * upy + py0 + py1 - fh) // downy + 1,
            (w * upx + px0 + px1 - fw) // downx + 1)


def upfirdn2d_plain(x, f2d, up, down, pad):
    """Reference formula. ``f2d`` [fh, fw] is already flipped and gained (it
    is correlated); up/down are (x, y) pairs, pad (px0, px1, py0, py1). Math
    in at least f32; the result has x's dtype."""
    upx, upy = up
    downx, downy = down
    px0, px1, py0, py1 = pad
    n, c, h, w = x.shape
    y = x.to(torch.promote_types(x.dtype, torch.float32))
    y = y.reshape(n, c, h, 1, w, 1)
    y = F.pad(y, [0, upx - 1, 0, 0, 0, upy - 1])
    y = y.reshape(n, c, h * upy, w * upx)
    y = F.pad(y, [max(px0, 0), max(px1, 0), max(py0, 0), max(py1, 0)])
    y = y[:, :, max(-py0, 0): y.shape[2] - max(-py1, 0),
          max(-px0, 0): y.shape[3] - max(-px1, 0)]
    weight = f2d.to(device=y.device, dtype=y.dtype)[None, None].repeat(c, 1, 1, 1)
    y = F.conv2d(y, weight, groups=c)
    return y[:, :, ::downy, ::downx].to(x.dtype)


_K4_ARGS = ((kb.PTR, kb.PTR) + (kb.INT,) * 12
            + (kb.PTR, kb.INT, kb.INT, kb.PTR, kb.PTR, kb.PTR, kb.PTR))
MAX_TAPS = 64   # the most taps the kernel takes by value (csrc/upfirdn2d.cu:MAX_TAPS)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class K4Plan(NamedTuple):
    """What K4's entry point takes for one (filter, up, down, padding), made
    once and cached: the filter (flipped and gained) and, for the family
    every call of the flagship makes (up=2, down=1, 4x4 filter), its
    polyphase table. ``variant`` names the kernel the entry point runs
    (csrc/upfirdn2d.cu decides alike, from the same arguments): "up2" (the
    polyphase kernel), "down2" or "fir4" (the 4x4 form: a 4x4 filter at up
    1 and down 2, or down 1, on both axes), "fir_small" (the 4x4 form at a
    smaller 2-D filter's size, up = down = 1), "row" or "column" (a filter
    of one row, else of one column, at up = down = 1), "row_up2",
    "row_down2", "column_up2" or "column_down2" (the 1-D polyphase forms,
    :func:`poly_variant`), "generic", or "large" / "large_tiled" (a filter
    of more than MAX_TAPS taps, read from a device buffer, no taps here:
    the phase-blocked kernel, else the tiled one)."""
    variant: str
    taps: Optional[ctypes.Array]
    phase_taps: Optional[tuple]   # [ry][rx][j][i]: the tap of x[m+sy[ry]+j, n+sx[rx]+i]
    phase_src: Optional[tuple]    # (sy[0], sy[1], sx[0], sx[1])
    c_phase_taps: Optional[ctypes.Array]
    c_phase_src: Optional[ctypes.Array]


def _phase(r, p0):
    """Output phase r of an up=2 axis with leading pad p0 (_fir_poly_up's
    phase_info): its first tap k0 (then k0 + 2) and its source offset s, so
    output 2m + r reads input m + s and m + s + 1."""
    k0 = (p0 - r) % 2
    return k0, (r + k0 - p0) // 2


POLY_MAX_TAPS = 16   # the most taps of the 1-D polyphase forms (csrc/upfirdn2d.cu)


def poly_variant(fh: int, fw: int, up: tuple, down: tuple) -> Optional[str]:
    """The 1-D polyphase form a call takes (csrc/upfirdn2d.cu:poly_form),
    or None: a filter of one row at up or down 2 on x with y unscaled
    ("row_up2" / "row_down2"), else of one column at up or down 2 on y with
    x unscaled ("column_up2" / "column_down2"), at most POLY_MAX_TAPS taps."""
    for axis, (n, n_other), (u, d), (u_o, d_o) in (
            ("row", (fw, fh), (up[0], down[0]), (up[1], down[1])),
            ("column", (fh, fw), (up[1], down[1]), (up[0], down[0]))):
        if (n_other == 1 and (u_o, d_o) == (1, 1) and (u, d) in ((2, 1), (1, 2))
                and n <= POLY_MAX_TAPS):
            return f"{axis}_{'up2' if u == 2 else 'down2'}"
    return None


@functools.lru_cache(maxsize=256)
def _plan(taps: tuple, fh: int, fw: int, up: tuple, down: tuple, pad: tuple) -> K4Plan:
    c_taps = kb.f32_array(taps)
    if up == (1, 1) and down in ((1, 1), (2, 2)) and (fh, fw) == (4, 4):
        return K4Plan("down2" if down == (2, 2) else "fir4", c_taps, None, None, None, None)
    if up == (1, 1) and down == (1, 1) and 2 <= min(fh, fw) and max(fh, fw) <= 4:
        return K4Plan("fir_small", c_taps, None, None, None, None)
    if up == (1, 1) and down == (1, 1) and 1 in (fh, fw):
        return K4Plan("row" if fh == 1 else "column", c_taps, None, None, None, None)
    poly = poly_variant(fh, fw, up, down)
    if poly:
        return K4Plan(poly, c_taps, None, None, None, None)
    if not (up == (2, 2) and down == (1, 1) and (fh, fw) == (4, 4)):
        return K4Plan("generic", c_taps, None, None, None, None)
    f = [taps[a * fw:(a + 1) * fw] for a in range(fh)]
    ys = [_phase(r, pad[2]) for r in (0, 1)]
    xs = [_phase(r, pad[0]) for r in (0, 1)]
    table = tuple(tuple(tuple(tuple(f[ys[ry][0] + 2 * j][xs[rx][0] + 2 * i] for i in (0, 1))
                              for j in (0, 1)) for rx in (0, 1)) for ry in (0, 1))
    src = (ys[0][1], ys[1][1], xs[0][1], xs[1][1])
    flat = [v for a in table for b in a for c in b for v in c]
    return K4Plan("up2", c_taps, table, src, kb.f32_array(flat), (ctypes.c_int * 4)(*src))


_LARGE = K4Plan("large", None, None, None, None, None)
_LARGE_TILED = K4Plan("large_tiled", None, None, None, None, None)

# upfirdn2d_large_phase_kernel's blocking (csrc/upfirdn2d.cu: LB_*): warps a
# block, a lane's output rows, a warp's job of 16 phase rows x 32 phase
# columns, the most column phases and taps of a phase's row it takes
LB_WARPS, LB_RY, LB_SUB_H, LB_SUB_W, LB_MAX_UPX, LB_MAX_NI = 4, 4, 16, 32, 4, 16
SMEM_MAX = 227 * 1024


class LargePhase(NamedTuple):
    nch: int      # chunks of 4 taps in a phase's tap row
    nbands: int   # a block's bands of LB_SUB_H phase rows
    smem: int     # bytes of shared memory a block


def large_phase_geometry(fh: int, fw: int, up, down) -> Optional[LargePhase]:
    """The phase-blocked large-filter kernel's geometry for a call
    (csrc/upfirdn2d.cu:large_phase), or None where it does not take it
    (down > 1, up > 4 on x, more than 16 taps in a phase's row or fewer
    than 4 rows, or more shared memory than a block has): the staged taps
    [upy][upx][nJ][4 nch],
    the input window (two copies where up > 1 on x) and each warp's
    staged output rows."""
    upx, upy = up
    if tuple(down) != (1, 1) or upx > LB_MAX_UPX:
        return None
    ni, nj = -(-fw // upx), -(-fh // upy)
    if ni > LB_MAX_NI or fh // upy < LB_RY:   # fh // upy: a phase's fewest tap rows
        return None
    nch = -(-ni // 4)
    nbands = 1 if upy >= LB_WARPS else -(-LB_WARPS // upy)
    th, tws = LB_SUB_H * nbands + nj, LB_SUB_W + 4 * nch
    smem = 4 * (upy * upx * nj * 4 * nch + (2 if upx > 1 else 1) * th * tws
                + LB_WARPS * LB_SUB_H * (LB_SUB_W * upx + 1))
    return LargePhase(nch, nbands, smem) if smem <= SMEM_MAX else None


def k4_plan(f2d, up, down, pad) -> K4Plan:
    """The cached plan of a call (f2d [fh, fw] flipped and gained, up/down
    (x, y) pairs, pad (px0, px1, py0, py1)); a filter of more than MAX_TAPS
    taps takes a large-filter kernel, with neither a cache entry nor a copy
    of its taps to the host."""
    fh, fw = int(f2d.shape[0]), int(f2d.shape[1])
    if fh * fw > MAX_TAPS:
        return _LARGE if large_phase_geometry(fh, fw, up, down) else _LARGE_TILED
    taps = tuple(f2d.detach().to("cpu", torch.float32).reshape(-1).tolist())
    return _plan(taps, fh, fw, tuple(up), tuple(down), tuple(pad))


def _launch_k4(x, f2d, up, down, pad, transposed=False):
    """One launch of K4 (see :func:`upfirdn2d_kernel`); a launch of the
    backward form counts under ``grad_<variant>``."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"upfirdn2d kernel takes float32 or bfloat16, got {x.dtype}")
    if x.ndim != 4 or not x.is_contiguous():
        raise ValueError("upfirdn2d kernel takes a contiguous NCHW tensor")
    fh, fw = int(f2d.shape[0]), int(f2d.shape[1])
    n, c, h, w = x.shape
    oh, ow = _out_size(h, w, fh, fw, up, down, pad)
    if oh < 1 or ow < 1:
        raise ValueError(f"upfirdn2d: empty output {oh}x{ow}")
    plan = k4_plan(f2d, up, down, pad)
    f_dev = None
    if plan.taps is None:   # a large filter: its taps as a device buffer, copied without a wait
        f_dev = (to_device(f2d.detach().numpy(), x.device) if f2d.device.type == "cpu"
                 else f2d.detach().to(x.device, torch.float32).contiguous())
    y = torch.empty((n, c, oh, ow), device=x.device, dtype=x.dtype)
    kb.launch(
        "upfirdn2d", _K4_ARGS, x.data_ptr(), y.data_ptr(), _DTYPES[x.dtype],
        n * c, h, w, oh, ow, up[0], up[1], down[0], down[1], pad[0], pad[2],
        plan.taps, fw, fh, plan.c_phase_taps, plan.c_phase_src,
        f_dev.data_ptr() if f_dev is not None else None,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    k = KERNELS["upfirdn2d"]
    k.launches += 1
    variant = ("grad_" if transposed else "") + plan.variant
    k.variants[variant] = k.variants.get(variant, 0) + 1
    return y


def transposed_pass(f2d, up, down, pad, in_hw, out_hw):
    """The pass whose output is the gradient of ``upfirdn2d_plain(x, f2d,
    up, down, pad)`` to x (x [.., in_h, in_w], its output [.., out_h,
    out_w]): the filter rotated by 180 degrees, up and down swapped, and
    the padding of StyleGAN2-ADA's _upfirdn2d_cuda backward.
    -> (f2d, up, down, pad)."""
    fh, fw = int(f2d.shape[0]), int(f2d.shape[1])
    (upx, upy), (downx, downy) = up, down
    px0, _, py0, _ = pad
    (ih, iw), (oh, ow) = in_hw, out_hw
    p = (fw - px0 - 1, iw * upx - ow * downx + px0 - upx + 1,
         fh - py0 - 1, ih * upy - oh * downy + py0 - upy + 1)
    return f2d.flip([0, 1]), (downx, downy), (upx, upy), p


class UpFirDn2d(torch.autograd.Function):
    """One upfirdn2d pass (the arguments of :func:`upfirdn2d_plain`) with
    K4's backward form: the forward launches K4 on CUDA tensors (the plain
    version on CPU ones), the backward is this Function on the transposed
    pass, and so differentiable again."""

    @staticmethod
    def forward(ctx, x, f2d, up, down, pad, transposed=False):
        y = (_launch_k4(x.contiguous(), f2d, up, down, pad, transposed) if x.is_cuda
             else upfirdn2d_plain(x, f2d, up, down, pad))
        ctx.save_for_backward(f2d)
        ctx.call = (up, down, pad, tuple(x.shape[2:]), tuple(y.shape[2:]), transposed)
        return y

    @staticmethod
    def backward(ctx, dy):
        (f2d,) = ctx.saved_tensors
        up, down, pad, in_hw, out_hw, transposed = ctx.call
        ft, upt, downt, padt = transposed_pass(f2d, up, down, pad, in_hw, out_hw)
        return UpFirDn2d.apply(dy, ft, upt, downt, padt, not transposed), None, None, None, \
            None, None


def upfirdn2d_kernel(x, f2d, up, down, pad):
    """K4 on a CUDA tensor, differentiable (:class:`UpFirDn2d`): same
    contract as :func:`upfirdn2d_plain`. The filter is a constant: one that
    requires grad raises under grad mode."""
    require_no_grad("upfirdn2d", f2d)
    if not x.is_cuda:
        raise ValueError(f"K4 runs on CUDA tensors, got one on {x.device}")
    return UpFirDn2d.apply(x, f2d, up, down, pad)


def _fir(x, f2d, up, down, pad):
    if x.device.type == "cpu":
        return upfirdn2d_plain(x, f2d, up, down, pad)
    if x.device.type == "cuda":
        return upfirdn2d_kernel(x, f2d, up, down, pad)
    raise RuntimeError(f"upfirdn2d: no path for device {x.device}")


def fir_passes(f, up=1, down=1, padding=0, flip_filter=False, gain=1) -> list:
    """The passes of one upfirdn2d call: [(f2d, up, down, pad)], the
    arguments of :func:`upfirdn2d_plain` (and of the kernel) for each. The
    filter is gained and flipped unless ``flip_filter``; a 1-D (separable)
    filter makes a horizontal and then a vertical pass."""
    if f is None:
        f = torch.ones((1, 1), dtype=torch.float32)
    upx, upy = _parse_scaling(up)
    downx, downy = _parse_scaling(down)
    px0, px1, py0, py1 = _parse_padding(padding)
    f = f.to(torch.float32) * (gain ** (f.ndim / 2))
    if not flip_filter:
        f = f.flip(list(range(f.ndim)))
    if f.ndim == 1:
        return [(f[None, :], (upx, 1), (downx, 1), (px0, px1, 0, 0)),
                (f[:, None], (1, upy), (1, downy), (0, 0, py0, py1))]
    return [(f, (upx, upy), (downx, downy), (px0, px1, py0, py1))]


def upfirdn2d(x, f, up=1, down=1, padding=0, flip_filter=False, gain=1):
    """Pad, upsample, FIR-filter and downsample a batch of NCHW images.

    Zero-insert upsample by ``up``, zero-pad/crop by ``padding`` (relative to
    the upsampled image), correlate with ``f`` (flipped unless
    ``flip_filter``), keep every ``down``-th pixel. A 1-D (separable) filter
    runs as a horizontal then a vertical pass."""
    if x.ndim != 4:
        raise ValueError("upfirdn2d takes NCHW images")
    for spec in fir_passes(f, up, down, padding, flip_filter, gain):
        x = _fir(x, *spec)
    return x


def filter2d(x, f, padding=0, flip_filter=False, gain=1):
    """FIR-filter without scaling (reference upfirdn2d.py:255+)."""
    px0, px1, py0, py1 = _parse_padding(padding)
    fw, fh = _get_filter_size(f)
    p = [px0 + fw // 2, px1 + (fw - 1) // 2, py0 + fh // 2, py1 + (fh - 1) // 2]
    return upfirdn2d(x, f, padding=p, flip_filter=flip_filter, gain=gain)


def upsample2d(x, f, up=2, padding=0, flip_filter=False, gain=1):
    """Filtered upsample (reference upfirdn2d.py:315-351)."""
    upx, upy = _parse_scaling(up)
    px0, px1, py0, py1 = _parse_padding(padding)
    fw, fh = _get_filter_size(f)
    p = [px0 + (fw + upx - 1) // 2, px1 + (fw - upx) // 2,
         py0 + (fh + upy - 1) // 2, py1 + (fh - upy) // 2]
    return upfirdn2d(x, f, up=up, padding=p, flip_filter=flip_filter,
                     gain=gain * upx * upy)


def downsample2d(x, f, down=2, padding=0, flip_filter=False, gain=1):
    """Filtered downsample (reference upfirdn2d.py:355-391)."""
    downx, downy = _parse_scaling(down)
    px0, px1, py0, py1 = _parse_padding(padding)
    fw, fh = _get_filter_size(f)
    p = [px0 + (fw - downx + 1) // 2, px1 + (fw - downx) // 2,
         py0 + (fh - downy + 1) // 2, py1 + (fh - downy) // 2]
    return upfirdn2d(x, f, down=down, padding=p, flip_filter=flip_filter,
                     gain=gain)
