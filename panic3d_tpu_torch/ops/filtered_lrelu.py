"""Filtered leaky ReLU (panic3d_tpu/ops/filtered_lrelu.py): bias -> upsample
and FIR-filter (fu) -> leaky relu x gain, clamp -> FIR-filter (fd) and
downsample, the alias-free synthesis layer's nonlinearity.

``filtered_lrelu`` dispatches on the tensor's device: the plain version on
a CPU tensor, CUDA kernel K11 (csrc/filtered_lrelu.cu) on a CUDA tensor.
``filtered_lrelu_plain`` is the JAX package's composition in PyTorch, the
port's plain ``bias_act`` and ``upfirdn2d_plain`` called pass by pass: the
CPU path and the kernel's oracle. ``k11_plan`` is what the kernel wrapper
hands the kernel for one geometry, made on the host and cached: the taps,
the form (the strip form at StyleGAN3's geometries, with the output tile
it picks and its buffers' layout, ``strip_layout``; else the tile form),
and the tile form's 32x32 tiles: each tile's input window and, for each
position of a tile's intermediate window, the first up tap of its phase
and the input it meets.
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
TILE = 32          # the tile form's output tile side (csrc/filtered_lrelu.cu:TO)
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


class _Strip(ctypes.Structure):
    """csrc/filtered_lrelu.cu:Strip, field for field."""
    _fields_ = [(n, ctypes.c_int) for n in ("t_y", "t_x", "tiles_y", "tiles_x")] + [
        ("in0", ctypes.c_int * (2 * MAX_TILES))] + [
        (n, ctypes.c_int) for n in ("rh", "in_cols", "si", "sh", "sm", "sd", "nq1", "nqi", "nqj",
                                    "nqo", "nq4", "ti_y", "off_b", "smem")]


class _Plan(ctypes.Structure):
    """csrc/filtered_lrelu.cu:Plan, field for field: the tile form's fields
    (the first plan's, unchanged), then the form and the strip form's layout."""
    _fields_ = [("fu", ctypes.c_float * MAX_FU), ("fd", ctypes.c_float * MAX_FD),
                ("in0", ctypes.c_int * (2 * MAX_TILES)),
                ("k0", ctypes.c_short * (2 * MAX_WINDOW)),
                ("src", ctypes.c_short * (2 * MAX_WINDOW))] + [
        (n, ctypes.c_int) for n in ("fuh", "fdn", "fd2d", "up", "down", "ti", "tin", "tiles_y",
                                    "tiles_x", "H", "W", "OH", "OW")] + [
        (n, ctypes.c_float) for n in ("gain", "slope", "clamp")] + [
        ("form", ctypes.c_int), ("st", _Strip)]


# csrc/filtered_lrelu.cu:Form
FORMS = {"tile": 0, "tile_up1": 1, "strip_up2": 2, "strip_up2_radial": 3, "strip_up4": 4,
         "strip_up4_radial": 5}
# the strip form's compiled geometries: up -> the padding's phase p0 mod up
STRIP_PHASE = {2: 1, 4: 2}
STRIP_TPP, STRIP_FDN, STRIP_DOWN = 6, 12, 2
STRIP_SMEM = 74 * 1024      # bytes a block at most: 3 blocks an SM
STRIP_TILES = range(8, 64)  # output tile sides the plan weighs


class StripLayout(NamedTuple):
    """The strip form's layout at output tile sides ``t`` (y, x): the
    fields of csrc/filtered_lrelu.cu:Strip, and ``fmas``, the multiply-adds
    a tile's passes do, strips' padding included (the plan's cost)."""
    t: tuple
    tiles: tuple
    in0: tuple          # per axis: each tile's input-window start
    rh: int             # staged input rows, pass 1's rows
    in_cols: int        # staged input columns
    si: int
    sh: int
    sm: int
    sd: int
    nq1: int            # pass 1: strips of 4 up intermediate columns
    nqi: int            # pass 2: strips of 8 intermediate rows ...
    nqj: int            # ... by 4 columns
    nqo: int            # pass 3: strips of 8 outputs along x (radial: 2)
    nq4: int            # pass 4: strips of 8 output rows (radial: 4)
    ti_y: int
    off_b: int
    smem: int
    fmas: int


def _stride(n):
    """The smallest stride >= n that is 4 mod 8 floats: 16-byte rows, and 8
    neighbouring rows' float4 on 8 different groups of 4 banks."""
    return n + (4 - n % 8) % 8


def _src(u, up, s):
    """Intermediate position u of a window starting at a multiple of up:
    its first tap's input, from the window's first (csrc: src_of)."""
    return -(-(u - s) // up)


def strip_layout(t, up, radial, p0, n_out):
    """The strip form's layout at output tile sides t = (t_y, t_x), up 2 or
    4, down 2 with 12 taps; p0 = (py0, px0), n_out = (OH, OW). Mirrors the
    kernel's strips (csrc/filtered_lrelu.cu: strip_up_columns, strip_up_rows,
    strip_down_rows, strip_down_columns, strip_down_radial)."""
    s = STRIP_PHASE[up]
    ti = [2 * (ta - 1) + STRIP_FDN for ta in t]
    tiles = tuple(-(-n // ta) for n, ta in zip(n_out, t))
    in0 = tuple(tuple(k * ta * STRIP_DOWN // up - p // up for k in range(nt))
                for ta, nt, p in zip(t, tiles, p0))
    u1 = 4 * up
    if radial:
        nqo, nq4 = -(-t[1] // 2), -(-t[0] // 4)
        mid_cols = 4 * (nqo - 1) + 16               # pass 3' reads
        mid_rows = 8 * (nq4 - 1) + 18
    else:
        nqo, nq4 = -(-t[1] // 8), -(-t[0] // 8)
        mid_cols = 16 * (nqo - 1) + 28              # pass 3 reads
        mid_rows = ti[0]
    nqj = -(-ti[1] // 4)
    nqi = -(-mid_rows // 8)
    nq1 = -(-4 * nqj // u1)
    rh = 8 * (nqi - 1) // up + _src(7, up, s) + STRIP_TPP   # pass 2's reads
    in_cols = (nq1 - 1) * u1 // up + 12                     # pass 1's reads
    si, sh = _stride(in_cols), _stride(nq1 * u1)
    sm = _stride(max(4 * nqj, mid_cols))
    sd = 0 if radial else _stride(8 * nqo)
    d_rows = 16 * (nq4 - 1) + 26                            # pass 4's reads
    a = max(rh * si, 8 * nqi * sm)
    b = rh * sh if radial else max(rh * sh, d_rows * sd)
    a += -a % 4
    fmas = rh * nq1 * u1 * STRIP_TPP + 8 * nqi * 4 * nqj * STRIP_TPP
    fmas += (4 * nq4 * 2 * nqo * STRIP_FDN ** 2 if radial else
             ti[0] * 8 * nqo * STRIP_FDN + 8 * nq4 * t[1] * STRIP_FDN)
    return StripLayout(tuple(t), tiles, in0, rh, in_cols, si, sh, sm, sd, nq1, nqi, nqj, nqo,
                       nq4, ti[0], a, 4 * (a + b), fmas)


def _strip_plan(up, radial, p0, n_out):
    """The strip form's layout with the fewest multiply-adds over the image
    (halo and padding counted) among square tiles whose block fits in
    STRIP_SMEM, a tile starting at a multiple of up in the intermediate;
    the larger tile at a tie. None where no tile fits."""
    best = None
    for t in STRIP_TILES:
        if (t * STRIP_DOWN) % up:
            continue
        lay = strip_layout((t, t), up, radial, p0, n_out)
        if lay.smem > STRIP_SMEM or max(lay.tiles) > MAX_TILES:
            continue
        cost = lay.fmas * lay.tiles[0] * lay.tiles[1]
        if best is None or cost <= best[0]:
            best = (cost, lay)
    return None if best is None else best[1]


class K11Plan(NamedTuple):
    """One geometry's plan. ``form``: the kernel's form (FORMS): a strip
    form where ``strip`` (its StripLayout) is given, else the tile form,
    whose fields follow. Per axis (y, x): ``in0[t]``, the input row or
    column where 32x32 tile t's window starts; ``mid0[t]``, the
    intermediate one (t * TILE * down); and for window position i,
    ``k0[i]``, the first up tap of its phase (then k0 + up, k0 + 2 up,
    ...), and ``src[i]``, the window's input index that tap meets (then
    src + 1, ...). ``ti`` and ``tin`` are the tile form's intermediate and
    input windows' sides; ``mid`` and ``out`` the intermediate's and
    output's (H, W)."""
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
    form: str
    strip: Optional[StripLayout]
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


def _form(fuh, fdn, fd2d, up, down, py0, px0):
    """The kernel's form for a geometry (csrc/filtered_lrelu.cu: dispatch):
    the strip form at StyleGAN3's (up 2 or 4 with 6 taps a phase, down 2
    with 12 taps, the padding's phase STRIP_PHASE[up] on both axes), the
    tile form's compiled one for the toRGB's single taps, else the tile
    form."""
    if (up in STRIP_PHASE and fuh == up * STRIP_TPP and fdn == STRIP_FDN
            and down == STRIP_DOWN and py0 % up == px0 % up == STRIP_PHASE[up]):
        return f"strip_up{up}{'_radial' if fd2d else ''}"
    if up == 1 and fuh == 1 and fdn == 1:
        return "tile_up1"
    return "tile"


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
    form = _form(fuh, fdn, fd2d, up, down, py0, px0)
    strip = (_strip_plan(up, fd2d, (py0, px0), (ay[1], ax[1])) if form.startswith("strip")
             else None)
    if form.startswith("strip") and strip is None:
        form = "tile"
    plan = K11Plan(fu, fd, fd2d, up, down, (ay[0], ax[0]), (ay[1], ax[1]), (ay[2], ax[2]),
                   ay[3], tin, (ay[4], ax[4]), (ay[5], ax[5]), (ay[6], ax[6]), (ay[7], ax[7]),
                   form, strip, None)
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
    c.form = FORMS[form]
    if strip is not None:
        st = c.st
        st.t_y, st.t_x = strip.t
        st.tiles_y, st.tiles_x = strip.tiles
        for a in (0, 1):
            st.in0[a * MAX_TILES:a * MAX_TILES + strip.tiles[a]] = strip.in0[a]
        for n in _Strip._fields_:
            if n[0] not in ("t_y", "t_x", "tiles_y", "tiles_x", "in0"):
                setattr(st, n[0], getattr(strip, n[0]))
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
