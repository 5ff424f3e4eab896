"""Filtered leaky ReLU (panic3d_tpu/ops/filtered_lrelu.py): bias -> upsample
and FIR-filter (fu) -> leaky relu x gain, clamp -> FIR-filter (fd) and
downsample, the alias-free synthesis layer's nonlinearity.

``filtered_lrelu`` dispatches on the tensor's device: the plain version on
a CPU tensor, CUDA kernel K11 (csrc/filtered_lrelu.cu) on a CUDA tensor.
``filtered_lrelu_plain`` is the JAX package's composition in PyTorch, the
port's plain ``bias_act`` and ``upfirdn2d_plain`` called pass by pass: the
CPU path and the kernel's oracle. ``k11_plan`` is what the kernel wrapper
hands the kernel for one geometry, made on the host and cached: the taps,
each 32x32 output tile's input window and, for each position of a tile's
intermediate window, the first up tap of its phase and the input it meets.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from ..kernels import KERNELS, require_no_grad
from ..kernels import build as kb
from .bias_act import bias_act
from .upfirdn2d import _parse_padding, _parse_scaling, fir_passes, upfirdn2d_plain

SQRT2 = math.sqrt(2)
TILE = 32          # output tile side (csrc/filtered_lrelu.cu:TO)
MAX_TILES = 64     # tiles an axis (MAXT)
MAX_WINDOW = 96    # intermediate window side (MAXI)
MAX_FU = 32
MAX_FD = 144


def filtered_lrelu_plain(x, fu=None, fd=None, b=None, up: int = 1, down: int = 1, padding=0,
                         gain: float = SQRT2, slope: float = 0.2,
                         clamp: Optional[float] = None, flip_filter: bool = False):
    """The JAX package's composition (filtered_lrelu.py:41-47): bias, then
    upfirdn2d up with ``fu``, the padding and gain up^2, then lrelu x gain
    and the clamp, then upfirdn2d down with ``fd``. Each step (each pass of
    a separable filter) rounds to x's dtype."""
    x = bias_act(x, b)
    for spec in fir_passes(fu, up=up, padding=padding, gain=up ** 2, flip_filter=flip_filter):
        x = upfirdn2d_plain(x, *spec)
    x = bias_act(x, act="lrelu", alpha=slope, gain=gain, clamp=clamp)
    for spec in fir_passes(fd, down=down, flip_filter=flip_filter):
        x = upfirdn2d_plain(x, *spec)
    return x


class _Plan(ctypes.Structure):
    """csrc/filtered_lrelu.cu:Plan, field for field."""
    _fields_ = [("fu", ctypes.c_float * MAX_FU), ("fd", ctypes.c_float * MAX_FD),
                ("in0", ctypes.c_int * (2 * MAX_TILES)),
                ("k0", ctypes.c_short * (2 * MAX_WINDOW)),
                ("src", ctypes.c_short * (2 * MAX_WINDOW))] + [
        (n, ctypes.c_int) for n in ("fuh", "fdn", "fd2d", "up", "down", "ti", "tin", "tiles_y",
                                    "tiles_x", "H", "W", "OH", "OW")] + [
        (n, ctypes.c_float) for n in ("gain", "slope", "clamp")]


class K11Plan(NamedTuple):
    """One geometry's plan. Per axis (y, x): ``in0[t]``, the input row or
    column where tile t's window starts; ``mid0[t]``, the intermediate one
    (t * TILE * down); and for window position i, ``k0[i]``, the first up
    tap of its phase (then k0 + up, k0 + 2 up, ...), and ``src[i]``, the
    window's input index that tap meets (then src + 1, ...). ``ti`` and
    ``tin`` are the intermediate and input windows' sides; ``mid`` and
    ``out`` the intermediate's and output's (H, W)."""
    fu: tuple          # flipped, gained by up: one axis
    fd: tuple          # flipped: fdn taps, or fdn * fdn when fd2d
    fd2d: bool
    up: int
    down: int
    mid: tuple
    out: tuple
    tiles: tuple
    ti: int
    tin: int
    in0: tuple
    mid0: tuple
    k0: tuple
    src: tuple
    c_plan: Optional[_Plan]


def _axis(n_in, p0, p1, fuh, fdn, up, down):
    n_mid = n_in * up + p0 + p1 - fuh + 1
    n_out = (n_mid - fdn) // down + 1
    tiles = -(-n_out // TILE)
    ti = (TILE - 1) * down + fdn
    mid0 = tuple(t * TILE * down for t in range(tiles))
    in0 = tuple((m - p0) // up for m in mid0)
    k0 = tuple((p0 - i) % up for i in range(ti))
    src = tuple((i + k0[i] - p0) // up - (-p0 // up) for i in range(ti))
    reach = max(s + len(range(k, fuh, up)) for s, k in zip(src, k0))
    return n_mid, n_out, tiles, ti, in0, mid0, k0, src, reach


@functools.lru_cache(maxsize=256)
def _plan(fu: tuple, fd: tuple, fd2d: bool, up: int, down: int, pad: tuple, h: int, w: int,
          gain: float, slope: float, clamp: Optional[float]) -> K11Plan:
    px0, px1, py0, py1 = pad
    fuh = len(fu)
    fdn = math.isqrt(len(fd)) if fd2d else len(fd)
    ay = _axis(h, py0, py1, fuh, fdn, up, down)
    ax = _axis(w, px0, px1, fuh, fdn, up, down)
    if min(ay[1], ax[1]) < 1:
        raise ValueError(f"filtered_lrelu: empty output {ay[1]}x{ax[1]}")
    tin = max(ay[8], ax[8])
    plan = K11Plan(fu, fd, fd2d, up, down, (ay[0], ax[0]), (ay[1], ax[1]), (ay[2], ax[2]),
                   ay[3], tin, (ay[4], ax[4]), (ay[5], ax[5]), (ay[6], ax[6]), (ay[7], ax[7]),
                   None)
    fits = (fuh <= MAX_FU and len(fd) <= MAX_FD and plan.ti <= MAX_WINDOW
            and max(plan.tiles) <= MAX_TILES and (TILE * down) % up == 0)
    if not fits:
        return plan
    c = _Plan()
    c.fu[:fuh] = fu
    c.fd[:len(fd)] = fd
    for a in (0, 1):
        c.in0[a * MAX_TILES:a * MAX_TILES + plan.tiles[a]] = plan.in0[a]
        c.k0[a * MAX_WINDOW:a * MAX_WINDOW + plan.ti] = plan.k0[a]
        c.src[a * MAX_WINDOW:a * MAX_WINDOW + plan.ti] = plan.src[a]
    c.fuh, c.fdn, c.fd2d, c.up, c.down, c.ti, c.tin = fuh, fdn, int(fd2d), up, down, plan.ti, tin
    c.tiles_y, c.tiles_x, c.H, c.W = plan.tiles[0], plan.tiles[1], h, w
    c.OH, c.OW = plan.out
    c.gain, c.slope, c.clamp = gain, slope, -1.0 if clamp is None else clamp
    return plan._replace(c_plan=c)


def _taps(f):
    return tuple(f.detach().to("cpu", torch.float32).reshape(-1).tolist())


def k11_plan(x_shape, fu=None, fd=None, up: int = 1, down: int = 1, padding=0,
             gain: float = SQRT2, slope: float = 0.2, clamp: Optional[float] = None,
             flip_filter: bool = False) -> K11Plan:
    """The cached plan of a call on an NCHW input of ``x_shape``; the
    filters are prepared as upfirdn2d prepares them (fir_passes). ``c_plan``
    is None when the kernel does not take the geometry."""
    if fu is not None and fu.ndim != 1:
        raise NotImplementedError("K11 takes a 1-D (separable) up filter or none")
    if (fd is not None and fd.ndim == 2) and fd.shape[0] != fd.shape[1]:
        raise NotImplementedError("K11 takes a square 2-D down filter")
    if clamp is not None and clamp < 0:
        raise ValueError("clamp must be >= 0")
    (upx, upy), (downx, downy) = _parse_scaling(up), _parse_scaling(down)
    if upx != upy or downx != downy:
        raise NotImplementedError("K11 takes the same up and down factors on both axes")
    # no fu: one tap a pass, each with the gain's square root, as the plain
    # version's 1x1 filter with the gain up^2
    fu = torch.ones(1) if fu is None else fu
    f_up = fir_passes(fu, up=upx, gain=upx ** 2, flip_filter=flip_filter)[0][0]
    f_down = fir_passes(fd, down=downx, flip_filter=flip_filter)[0][0]
    return _plan(_taps(f_up), _taps(f_down), fd is not None and fd.ndim == 2, upx, downx,
                 _parse_padding(padding), int(x_shape[2]), int(x_shape[3]), float(gain),
                 float(slope), None if clamp is None else float(clamp))


_K11_ARGS = (kb.PTR, kb.PTR, kb.INT, kb.INT, kb.INT, kb.PTR, kb.PTR, kb.PTR)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def filtered_lrelu_kernel(x, fu=None, fd=None, b=None, up: int = 1, down: int = 1, padding=0,
                          gain: float = SQRT2, slope: float = 0.2,
                          clamp: Optional[float] = None, flip_filter: bool = False):
    """Launch K11 on a CUDA tensor: same contract as
    :func:`filtered_lrelu_plain`, accumulated in f32 and rounded once."""
    require_no_grad("filtered_lrelu", x, fu, fd, b)
    if x.dtype not in _DTYPES:
        raise TypeError(f"filtered_lrelu kernel takes float32 or bfloat16, got {x.dtype}")
    if x.ndim != 4:
        raise ValueError("filtered_lrelu kernel takes NCHW images")
    plan = k11_plan(x.shape, fu, fd, up, down, padding, gain, slope, clamp, flip_filter)
    if plan.c_plan is None:
        raise NotImplementedError(
            f"filtered_lrelu kernel: geometry outside its limits (up {plan.up}, down "
            f"{plan.down}, {len(plan.fu)} up taps, {len(plan.fd)} down taps, tiles "
            f"{plan.tiles}, window {plan.ti})")
    x = x.contiguous()
    n, c = x.shape[:2]
    if b is not None:
        if b.shape != (c,):
            raise ValueError(f"filtered_lrelu: bias of shape {tuple(b.shape)} for {c} channels")
        b = b.detach().to(x.device, torch.float32).contiguous()
    y = torch.empty((n, c) + plan.out, device=x.device, dtype=x.dtype)
    kb.launch("filtered_lrelu", _K11_ARGS, x.data_ptr(), y.data_ptr(), _DTYPES[x.dtype], n * c,
              c, b.data_ptr() if b is not None else None, ctypes.addressof(plan.c_plan),
              torch.cuda.current_stream(x.device).cuda_stream)
    KERNELS["filtered_lrelu"].launches += 1
    return y


def filtered_lrelu(x, fu=None, fd=None, b=None, up: int = 1, down: int = 1, padding=0,
                   gain: float = SQRT2, slope: float = 0.2, clamp: Optional[float] = None,
                   flip_filter: bool = False):
    """Bias, upsample + FIR, leaky relu x gain + clamp, FIR + downsample:
    the plain version on CPU tensors, kernel K11 on CUDA tensors."""
    args = (x, fu, fd, b, up, down, padding, gain, slope, clamp, flip_filter)
    if x.device.type == "cpu":
        return filtered_lrelu_plain(*args)
    if x.device.type == "cuda":
        return filtered_lrelu_kernel(*args)
    raise RuntimeError(f"filtered_lrelu: no path for device {x.device}")
