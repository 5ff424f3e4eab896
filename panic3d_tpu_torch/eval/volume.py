"""Density / RGB volumes and the coloured iso-surface mesh of a portrait
(panic3d_tpu/eval/volume.py).

The reference decodes a 256^3 coordinate lattice through G.sample_mixed,
filters the density (triplane crop, cloud cull), flips axis 0 and extracts
the level-0.5 surface (``_util/eg3d_metrics3d.py:65-210``). Here the
backbone runs once per portrait, and:

- ``extract_mesh`` (the eval geometry path) decodes the lattice sigma-only
  through kernel K1v (``volume_density`` in csrc/triplane_decode.cu), which
  makes each lattice point from its flat index, applies sigma2density, the
  crop and the cull, and writes the fp16 grid already flipped; one copy
  brings the grid to the host, the repository's C++ marching tetrahedra
  (runtime/native_ops.py) extracts the surface, and K1 decodes the vertex
  colours at the exact vertex world positions;
- ``get_volume`` (the full rgb + sigma volume a viewer reads) decodes the
  lattice in chunks through K1.

Deep planes (triplane_depth > 1) take neither K1v nor K1 but K10, the
trilinear K1 form (csrc/triplane_decode.cu): ``density_grid_deep_kernel``
decodes the whole lattice in one launch with K1v's brick kernel on the deep
volumes (its points from their flat indices, windows of depth slices in
shared memory, the same densities and filters, the grid written flipped),
and renderer.triplane_decode_deep decodes the volume and the vertex
colours.

``density_grid_plain`` is K1v's plain PyTorch version: the CPU path and the
kernel's oracle.
"""

from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np
import torch

from ..cameras import camera_label
from ..kernels import KERNELS, require_no_grad
from ..kernels import build as kb
from ..models.triplane import seeds_to_z
from ..models.volumetric import renderer as vr
from ..runtime.native_ops import marching_tetrahedra
from ..utils.device import constant, to_device


def sigma2density(sigma):
    return 1 - torch.exp(-vr.softplus(sigma - 1))


def create_samples(N: int, cube_length: float) -> np.ndarray:
    """The reference's voxel lattice (eg3d_metrics3d.py:70-92) on the host,
    including its float-division quirk: columns 0 and 1 use f32 division of
    the flat index, so x and y drift by a fraction of a voxel with the z
    index (the lattice is slightly sheared, as the reference meshes are)."""
    origin = np.float32(-cube_length / 2)
    voxel_size = np.float32(cube_length / (N - 1))
    idx = np.arange(N**3, dtype=np.float32)
    s = np.zeros((N**3, 3), dtype=np.float32)
    s[:, 2] = np.arange(N**3, dtype=np.int64) % N
    s[:, 1] = np.mod(idx / np.float32(N), np.float32(N))
    s[:, 0] = np.mod(idx / np.float32(N) / np.float32(N), np.float32(N))
    return s * voxel_size + origin


def _lattice_constants(N: int, cube_length: float):
    """(voxel size, origin) as the f32 values the lattice is built with."""
    return float(np.float32(cube_length / (N - 1))), float(np.float32(-cube_length / 2))


def create_samples_device(N: int, cube_length: float, start: int = 0,
                          stop: Optional[int] = None, device="cuda") -> torch.Tensor:
    """Points [start, stop) of create_samples' lattice (flat order), made on
    ``device`` from their flat indices in f32 (the same values as the host
    lattice; N <= 256 keeps every index exact in f32). -> [stop-start, 3]."""
    stop = N**3 if stop is None else stop
    return lattice_coords(torch.arange(start, stop, dtype=torch.int64, device=device), N,
                          cube_length)


def lattice_coords(idx_i: torch.Tensor, N: int, cube_length: float) -> torch.Tensor:
    """The points of create_samples' lattice at flat indices idx_i (int64,
    any shape) -> [..., 3] f32, computed as create_samples_device does."""
    voxel, origin = _lattice_constants(N, cube_length)
    idx = idx_i.to(torch.float32)
    fN = float(N)
    s0 = torch.fmod(idx / fN / fN, fN)
    s1 = torch.fmod(idx / fN, fN)
    s2 = (idx_i % N).to(torch.float32)
    return torch.stack([s0, s1, s2], -1) * voxel + origin


def _on(v, n: int, dev) -> torch.Tensor:
    """A per-portrait scalar input (list, array or tensor) as f32 on dev."""
    if torch.is_tensor(v):
        return v.to(dev, torch.float32)
    return constant(np.broadcast_to(np.asarray(v, np.float32), (n,)), dev)


def portrait_planes(G, xin: dict, noise_mode: str = "const"):
    """(ws, planes [N,3,C,H,W] f32) of the portraits in ``xin`` (ws | z |
    seeds, cond, optional elevations/azimuths for the camera label the
    mapping zeroes under c_gen_conditioning_zero): volume.py:260-277."""
    dev = G.device
    with torch.no_grad():
        ws = xin.get("ws")
        if ws is None:
            z = xin.get("z")
            if z is None:
                z = seeds_to_z(xin["seeds"], G.z_dim)
            z = z.to(dev, torch.float32) if torch.is_tensor(z) else to_device(z, dev)
            n = z.shape[0]
            cam = camera_label(_on(xin.get("elevations", 0.0), n, dev),
                               _on(xin.get("azimuths", 0.0), n, dev),
                               _on(1.0, n, dev), _on(30.0, n, dev))
            ws = G.mapping(z, cam, xin.get("cond"))
        return ws, G._planes_from_ws(ws, xin.get("cond"), noise_mode=noise_mode)


# ---------------------------------------------------------------------------
# K1v volume_density

@torch.no_grad()
def density_grid_plain(planes, dec: vr.Decoder, N: int, box_warp: float, plane_axes,
                       filters: vr.DensityFilters, dtype=torch.float16, chunk: int = 2**17,
                       start: int = 0, stop: Optional[int] = None,
                       triplane_depth: int = 1) -> torch.Tensor:
    """Densities of lattice points [start, stop) (flat order, not flipped)
    of one portrait's planes [1,3,C*D,H,W] f32 (D = triplane_depth): the
    sigma-only decode,
    sigma2density, the crop on the lattice coordinates and the cloud cull
    on the density (volume.py:285-297), in ``dtype``, ``chunk`` points at a
    time. -> [stop-start]."""
    stop = N**3 if stop is None else stop
    crop, cull, _ = filters
    out = []
    for a in range(start, stop, chunk):
        coords = create_samples_device(N, box_warp, a, min(a + chunk, stop), planes.device)
        feats = vr.sample_from_planes(plane_axes, planes, coords[None], box_warp,
                                      triplane_depth)
        _, sigma = vr.osg_decode(feats, dec, sigma_only=True)
        d = sigma2density(sigma[0, :, 0])
        if crop:
            d = torch.where(vr.triplane_crop_mask(coords, crop, box_warp)[:, 0], -1e3, d)
        if cull:
            d = torch.where(vr.cull_clouds_mask(d, cull), -1e3, d)
        out.append(d.to(dtype))
    return torch.cat(out)


def flip_grid(flat: torch.Tensor, N: int) -> torch.Tensor:
    """Flat-order lattice values -> the [N,N,N] grid with axis 0 flipped
    (volume.py:307), the layout marching tetrahedra reads."""
    return flat.reshape(N, N, N).flip(0)


# K1v's brick decomposition (csrc/triplane_decode.cu:volume_density_kernel),
# mirrored on the CPU by the helpers below for tests/test_torch_volume_bricks.py;
# K10's lattice form is the same kernel on the deep volumes, with the same
# bricks and windows of depth slices (tests/test_torch_volume_deep_bricks.py)
K1V_BRICK = (4, 8, 16)       # lattice points of a brick in x, y and z
K1V_POOL_TEXELS = 384        # texels of the three plane windows together (Brick::POOL)
K10V_POOL_TEXELS = 768       # K10's lattice form: its windows' texel slices together


def k1v_bricks(N: int, bricks) -> tuple:
    """Lattice indices (xi, yi, zi) [B, 512] of the bricks (bx, by, bz)
    [B, 3] (an int64 tensor), points in the kernel's thread order (z
    fastest, then y, then x); N must be a multiple of 16 here."""
    BX, BY, BZ = K1V_BRICK
    vr._require(N % BZ == 0, f"the brick helpers take N a multiple of {BZ}, got {N}")
    t = torch.arange(BX * BY * BZ)
    b = torch.as_tensor(bricks, dtype=torch.int64)
    return (b[:, :1] * BX + t // (BY * BZ), b[:, 1:2] * BY + t // BZ % BY,
            b[:, 2:] * BZ + t % BZ)


def k1v_corners(coords, box_warp: float, H: int, W: int, plane_axes, D: int = 1) -> tuple:
    """Each point's corner and weights on each plane, [..., 3] each, as
    K1v computes them from its lattice point: the plane coordinate
    (2 / box_warp) x, projected, then ((g + 1) * size - 1) / 2 rounded op by
    op, and its floor. -> (x0, y0, wx, wy); at depth D > 1 (K10's lattice
    form, the third coordinate indexing D) (x0, y0, z0, wx, wy, wz), the
    corners clamped to [-2, size] as the kernel converts them."""
    g = vr.project_onto_planes(plane_axes, (2.0 / box_warp) * coords.reshape(1, -1, 3))
    g = g.reshape(3, *coords.shape[:-1], 3).movedim(0, -1)     # [..., uvw, plane]
    sizes = (W, H) if D == 1 else (W, H, D)
    i = [((g[..., a, :] + 1) * n - 1) / 2 for a, n in enumerate(sizes)]
    f = [torch.floor(v) for v in i]
    c = [v.to(torch.int64) if D == 1 else v.clamp(-2, n).to(torch.int64)
         for v, n in zip(f, sizes)]
    return (*c, *(v - fv for v, fv in zip(i, f)))


def k1v_windows(x0, y0, z0=None, D: int = 1) -> torch.Tensor:
    """Each brick's plane windows from its points' corners [B, 512, 3]: [B,
    3, 4] of (x_lo, y_lo, x_hi, y_hi), the texels [x_lo, x_hi] x [y_lo,
    y_hi] that the kernel stages (the largest corner + 1 for the bilinear
    neighbour); with z0 (depth D > 1) [B, 3, 6] of (x_lo, y_lo, z_lo, x_hi,
    y_hi, z_hi), [z_lo, z_hi] the slices of z0 .. z0 + 1 inside the volume
    (z_hi < z_lo when there is none)."""
    lo = [x0.amin(1), y0.amin(1)]
    hi = [x0.amax(1) + 1, y0.amax(1) + 1]
    if z0 is not None:
        lo.append(z0.amin(1).clamp_min(0))
        hi.append((z0.amax(1) + 1).clamp_max(D - 1))
    return torch.stack(lo + hi, -1)


def k1v_window_texels(win) -> torch.Tensor:
    """The texels (texel slices at depth) of each brick's three windows
    together, [B], from k1v_windows."""
    n = win.shape[-1] // 2
    return (win[..., n:] - win[..., :n] + 1).clamp_min(0).prod(-1).sum(-1)


def k1v_crop_class(kept) -> torch.Tensor:
    """Each brick's crop class from its points' crop decisions [B, 512]: 0
    when every point is cropped (the kernel writes -1e3 and decodes
    nothing), 2 when every point is kept, 1 when it straddles the box."""
    return kept.any(1).long() + kept.all(1).long()


@torch.no_grad()
def density_bricks_plain(planes, dec: vr.Decoder, N: int, box_warp: float, plane_axes,
                         filters: vr.DensityFilters, bricks, triplane_depth: int = 1) -> tuple:
    """K1v's decode of the bricks (bx, by, bz) [B, 3] as the kernel reads
    the planes: each plane window cut out of one portrait's planes
    [1,3,C*D,H,W] (zeros outside the plane), each point's corners read
    from its brick's window at (y0 - y_lo, x0 - x_lo), the lerps and plane
    mean of grid_sample_2d_points and sample_from_planes, the sigma-only
    decode, sigma2density, the crop and the cull, in f32. At depth D =
    triplane_depth > 1, K10's lattice form: windows of the slices
    [z_lo, z_hi] cut from the volumes [C, D, H, W], each corner
    slice read at z - z_lo (zeros outside the volume) and the slices
    blended in grid_sample_3d_points' order, 0 + s(z0) (1 - wz) + s(z1) wz.
    -> (densities [B, 512], features [B, 512, C], windows [B, 3, 4 or 6])."""
    D = triplane_depth
    CD, H, W = planes.shape[2:]
    C = CD // D
    xi, yi, zi = k1v_bricks(N, bricks)
    coords = lattice_coords((xi * N + yi) * N + zi, N, box_warp)
    corners = k1v_corners(coords, box_warp, H, W, plane_axes, D)
    if D == 1:
        (x0, y0, wx, wy), z0, wz = corners, torch.zeros_like(corners[0]), None
        win = k1v_windows(x0, y0)
        z_lo = torch.zeros_like(win[..., 0])
    else:
        x0, y0, z0, wx, wy, wz = corners
        win = k1v_windows(x0, y0, z0, D)
        z_lo = win[..., 2]
    n = win.shape[-1] // 2
    ww, wh = win[..., n] - win[..., 0] + 1, win[..., n + 1] - win[..., 1] + 1
    nz = (win[..., 2 * n - 1] - z_lo + 1).clamp_min(1) if D > 1 else torch.ones_like(ww)
    # the windows [B, 3, NZ, WH, WW, C], cut from the volumes padded with
    # zeros in x and y (a window's slices all lie inside the volume)
    pad = int(max(ww.max(), wh.max()))
    vol = planes[0].reshape(3, C, D, H, W)
    padded = torch.nn.functional.pad(vol, (pad, pad, pad, pad)).permute(0, 2, 3, 4, 1)
    s = torch.arange(int(nz.max()))
    r = torch.arange(int(wh.max()))
    c = torch.arange(int(ww.max()))
    tz = (z_lo[..., None, None, None] + s[:, None, None]).clamp(0, D - 1)
    ty = (win[..., 1, None, None, None] + r[:, None]).clamp(-pad, H + pad - 1) + pad
    tx = (win[..., 0, None, None, None] + c).clamp(-pad, W + pad - 1) + pad
    p_idx = torch.arange(3)[None, :, None, None, None]
    windows = padded[p_idx, tz, ty, tx]
    feats = 0
    for p in range(3):
        ry, rx = y0[..., p] - win[:, None, p, 1], x0[..., p] - win[:, None, p, 0]
        vr._require(bool((ry >= 0).all() and (ry + 1 < wh[:, None, p]).all() and (rx >= 0).all()
                         and (rx + 1 < ww[:, None, p]).all()), "a corner outside its window")
        wp = windows[:, p]
        b = torch.arange(wp.shape[0])[:, None]
        fx, fy = wx[..., p, None], wy[..., p, None]
        smp = []
        for dz in range(2 if D > 1 else 1):
            z = z0[..., p] + dz
            inside = (z >= 0) & (z < D)
            rz = z - z_lo[:, None, p]
            vr._require(bool(((rz >= 0) & (rz < nz[:, None, p]))[inside].all()),
                        "a corner slice outside its window")
            rz = rz.clamp(0, int(nz.max()) - 1)
            v00, v01 = wp[b, rz, ry, rx], wp[b, rz, ry, rx + 1]
            v10, v11 = wp[b, rz, ry + 1, rx], wp[b, rz, ry + 1, rx + 1]
            top = v00 + (v01 - v00) * fx
            bot = v10 + (v11 - v10) * fx
            smp.append(torch.where(inside[..., None], top + (bot - top) * fy, 0.0))
        if D == 1:
            feats = feats + smp[0]
        else:
            w1 = wz[..., p, None]
            feats = feats + (0 + smp[0] * (1 - w1) + smp[1] * w1)
    feats = feats / 3
    _, sigma = vr.osg_decode(feats.reshape(1, 1, -1, C), dec, sigma_only=True)
    d = sigma2density(sigma.reshape(feats.shape[:2]))
    crop, cull, _ = filters
    if crop:
        d = torch.where(vr.triplane_crop_mask(coords, crop, box_warp)[..., 0], -1e3, d)
    if cull:
        d = torch.where(vr.cull_clouds_mask(d, cull), -1e3, d)
    return d, feats, win


_K1V_ARGS = ((kb.PTR,) * 6 + (kb.INT,) * 5 + (kb.PTR,) + (kb.FLOAT,) * 6
             + (kb.INT, kb.FLOAT, kb.INT, kb.FLOAT, kb.PTR, kb.PTR))
_GRID_DTYPES = {torch.float16: 1, torch.float32: 0}


def density_grid_kernel(planes, dec: vr.Decoder, N: int, box_warp: float, plane_axes,
                        filters: vr.DensityFilters, dtype=torch.float16,
                        stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch K1v on CUDA planes: the whole flipped [N,N,N] grid in one
    launch (same values as flip_grid(density_grid_plain(...))). ``stats``,
    an int32 tensor of 3 on the planes' device, is added to: bricks skipped
    by the crop, columns skipped in the bricks decoded, and planes read
    outside a window (the windows together larger than K1V_POOL_TEXELS)."""
    require_no_grad("volume_density", planes, dec)
    vr._require(planes.dtype == torch.float32 and planes.ndim == 5
                and tuple(planes.shape[:2]) == (1, 3),
                "K1v takes one portrait's f32 planes [1,3,C,H,W]")
    C, H, W = planes.shape[2:]
    vr._require(C == dec.w0.shape[1], f"K1v takes bilinear planes (triplane_depth 1): {C} "
                f"plane channels for a decoder of {dec.w0.shape[1]}; deep planes take "
                "density_grid_deep_kernel")
    vr._require(C in (8, 16, 32), f"K1v supports 8, 16 or 32 plane channels, got {C}")
    vr._require(dtype in _GRID_DTYPES, f"K1v writes float16 or float32, not {dtype}")
    vr._require(2 <= N <= 256, f"K1v takes 2 <= N <= 256, got {N}")
    dev = planes.device
    planes_cl = planes[0].permute(0, 2, 3, 1).contiguous()        # [3,H,W,C]
    w0, b0, w1, b1 = vr._decoder_f32(dec, dev)
    vr._require(tuple(w0.shape) == (64, C) and tuple(w1.shape) == (33, 64),
                "K1v takes a 64-wide hidden layer and 33 outputs")
    grid = torch.empty((N, N, N), dtype=dtype, device=dev)
    voxel, origin = _lattice_constants(N, box_warp)
    crop, cull, _ = filters
    proj = np.linalg.inv(plane_axes)[:, :, :2]                  # [plane][xyz][uv]
    kb.launch(
        "volume_density", _K1V_ARGS, planes_cl.data_ptr(), w0.data_ptr(), b0.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), grid.data_ptr(), _GRID_DTYPES[dtype], N, H, W, C,
        kb.f32_array(proj.reshape(-1)), 2.0 / box_warp, dec.lr_mul / math.sqrt(C),
        dec.lr_mul / math.sqrt(64), dec.lr_mul, voxel, origin, int(bool(crop)),
        (box_warp / 2 - crop) if crop else 0.0, int(bool(cull)), float(cull or 0.0),
        stats.data_ptr() if stats is not None else None, vr._stream(planes))
    KERNELS["volume_density"].launches += 1
    return grid


def lattice_kernel(N: int, box_warp: float, device) -> torch.Tensor:
    """The lattice K1v decodes, [N^3,3] f32 in flat order, made on the card
    by K1v's own device function (volume_lattice in triplane_decode.cu): a
    check of K1v's points against create_samples_device, on no path, so not
    counted as a launch."""
    vr._require(2 <= N <= 256, f"K1v takes 2 <= N <= 256, got {N}")
    coords = torch.empty((N**3, 3), dtype=torch.float32, device=device)
    kb.launch("volume_lattice", (kb.PTR, kb.INT, kb.FLOAT, kb.FLOAT, kb.PTR),
              coords.data_ptr(), N, *_lattice_constants(N, box_warp), vr._stream(coords))
    return coords


_K10V_ARGS = ((kb.PTR,) * 6 + (kb.INT,) * 6 + (kb.PTR,) + (kb.FLOAT,) * 6
              + (kb.INT, kb.FLOAT, kb.INT, kb.FLOAT, kb.PTR, kb.PTR))


def density_grid_deep_kernel(planes, dec: vr.Decoder, N: int, box_warp: float, plane_axes,
                             filters: vr.DensityFilters, triplane_depth: int,
                             dtype=torch.float16,
                             stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch K10's lattice form (K1v's brick kernel on the deep volumes)
    on one portrait's deep CUDA planes [1,3,C*D,H,W] f32: the whole flipped
    [N,N,N] grid in one launch (same values as
    flip_grid(density_grid_plain(..., triplane_depth=D))). ``stats`` as
    density_grid_kernel's (the windows' texel slices together larger than
    K10V_POOL_TEXELS count as planes read outside a window)."""
    require_no_grad("volume_density_deep", planes, dec)
    vr._require(planes.dtype == torch.float32 and planes.ndim == 5
                and tuple(planes.shape[:2]) == (1, 3),
                "K10's lattice form takes one portrait's f32 planes [1,3,C*D,H,W]")
    vr._require(dtype in _GRID_DTYPES, f"K10 writes float16 or float32, not {dtype}")
    vr._require(2 <= N <= 256, f"K10's lattice form takes 2 <= N <= 256, got {N}")
    vols = vr.deep_volumes_cl(planes, triplane_depth)             # [3,D,H,W,C]
    _, D, H, W, C = vols.shape
    vr._require(C in (8, 16, 32), f"K10 supports 8, 16 or 32 plane channels, got {C}")
    vr._require(max(D, H, W) <= 1000, "K10's lattice form takes D, H, W <= 1000")
    dev = planes.device
    w0, b0, w1, b1 = vr._decoder_f32(dec, dev)
    vr._require(tuple(w0.shape) == (64, C) and tuple(w1.shape) == (33, 64),
                "K10 takes a 64-wide hidden layer and 33 outputs")
    grid = torch.empty((N, N, N), dtype=dtype, device=dev)
    crop, cull, _ = filters
    kb.launch(
        "volume_density_deep", _K10V_ARGS, vols.data_ptr(), w0.data_ptr(), b0.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), grid.data_ptr(), _GRID_DTYPES[dtype], N, D, H, W, C,
        kb.f32_array(vr.deep_proj(plane_axes)), 2.0 / box_warp, dec.lr_mul / math.sqrt(C),
        dec.lr_mul / math.sqrt(64), dec.lr_mul, *_lattice_constants(N, box_warp),
        int(bool(crop)), (box_warp / 2 - crop) if crop else 0.0, int(bool(cull)),
        float(cull or 0.0), stats.data_ptr() if stats is not None else None,
        vr._stream(planes))
    KERNELS["volume_density_deep"].launches += 1
    return grid


@torch.no_grad()
def density_grid(planes, dec: vr.Decoder, N: int, box_warp: float, plane_axes,
                 filters: vr.DensityFilters, dtype=torch.float16, chunk: int = 2**17,
                 triplane_depth: int = 1):
    """The filtered density grid [N,N,N] of one portrait, axis 0 flipped:
    the plain version (in chunks) on CPU planes; on CUDA planes K1v, or
    K10's lattice form for deep planes (triplane_depth > 1)."""
    if planes.device.type == "cpu":
        return flip_grid(density_grid_plain(planes, dec, N, box_warp, plane_axes, filters,
                                            dtype, chunk, triplane_depth=triplane_depth), N)
    if planes.device.type == "cuda" and triplane_depth != 1:
        return density_grid_deep_kernel(planes, dec, N, box_warp, plane_axes, filters,
                                        triplane_depth, dtype)
    if planes.device.type == "cuda":
        return density_grid_kernel(planes, dec, N, box_warp, plane_axes, filters, dtype)
    raise RuntimeError(f"density_grid: no path for device {planes.device}")


# ---------------------------------------------------------------------------
# entry points

def get_volume(G, xin: dict, resolution: int = 256, chunk: int = 2**17,
               triplane_crop: Optional[float] = None,
               cull_clouds: Optional[float] = None) -> dict:
    """The full volume of one portrait (volume.py:161, get_eg3d_volume):
    coordinates [1,3,N,N,N], sigmas [1,1,...], rgbs [1,32,...] and filtered
    densities [1,1,...] as numpy arrays, axis 0 of the lattice flipped. The
    lattice is decoded through K1 (K10 for deep planes), ``chunk`` points
    per launch."""
    bw = G.rk["box_warp"]
    tc = xin.get("triplane_crop", triplane_crop)
    cc = xin.get("cull_clouds", cull_clouds)
    _, planes = portrait_planes(G, xin)
    N = resolution
    samples = create_samples(N, bw)
    sig, rgb = [], []
    with torch.no_grad():
        for a in range(0, N**3, chunk):
            coords = create_samples_device(N, bw, a, min(a + chunk, N**3), G.device)
            out = G.sample_mixed_planes(planes, coords[None])
            sig.append(out["sigma"][0])
            rgb.append(out["rgb"][0])
        sigmas, rgbs = torch.cat(sig)[None], torch.cat(rgb)[None]
        densities = sigma2density(sigmas)
        samples_t = to_device(samples, G.device)[None]
        if tc:
            densities = torch.where(vr.triplane_crop_mask(samples_t, tc, bw), -1e3, densities)
        if cc:
            densities = torch.where(vr.cull_clouds_mask(densities, cc), -1e3, densities)

    def fmt(x):
        x = x.reshape(1, N, N, N, -1).flip(1).permute(0, 4, 1, 2, 3)
        return x.float().cpu().numpy()

    return dict(coordinates=fmt(samples_t), sigmas=fmt(sigmas), rgbs=fmt(rgbs),
                densities=fmt(densities))


def _stage_clock(device, stages: Optional[dict]):
    """mark(name) records the seconds since the last mark under ``name`` in
    ``stages``, after waiting for the device; a no-op without ``stages``."""
    last = [time.perf_counter()]

    def mark(name):
        if stages is None:
            return
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        stages[name] = now - last[0]
        last[0] = now

    return mark


def vertex_world(verts: np.ndarray, N: int, box_warp: float) -> np.ndarray:
    """World coordinates [V,3] f32 of mesh vertices given in the flipped
    grid's index units, with the lattice's fractional x/y drift (see
    create_samples): the points extract_mesh decodes the colours at
    (volume.py:313-349)."""
    vi = verts.astype(np.float32)
    voxel = box_warp / (N - 1)
    x_idx = N - 1 - vi[:, 0]
    y_idx = vi[:, 1]
    z_idx = vi[:, 2]
    return np.stack([(x_idx + y_idx / N + z_idx / (N * N)) * voxel - box_warp / 2,
                     (y_idx + z_idx / N) * voxel - box_warp / 2,
                     z_idx * voxel - box_warp / 2], axis=1)


def extract_mesh(G, xin: dict, resolution: int = 256, chunk: int = 2**17, level: float = 0.5,
                 density_dtype=torch.float16, stages: Optional[dict] = None) -> dict:
    """Portrait -> coloured mesh (volume.py:234): the planes, the filtered
    density grid (K1v, or K10's lattice form for deep planes; ``xin`` may
    hold triplane_crop and cull_clouds), one copy of it to the host,
    marching tetrahedra at ``level``, then the vertex colours decoded (K1,
    or K10 for deep planes) at the exact vertex world positions,
    including the lattice's fractional x/y drift. With ``stages`` (a dict),
    the device is waited for after each stage and its seconds recorded
    under planes, decode, copy, tetrahedra and colours.
    -> {verts [V,3] f32 world units, faces [T,3] int32, colors [V,3] in
    [0,1], normals None, values None}."""
    rk = G.rk
    bw = rk["box_warp"]
    N = resolution
    mark = _stage_clock(G.device, stages)
    _, planes = portrait_planes(G, xin)
    mark("planes")
    with torch.no_grad():
        grid = density_grid(planes, G._decoder(), N, bw,
                            vr.generate_plane_axes(rk.get("use_triplane", False)),
                            vr.DensityFilters(xin.get("triplane_crop"), xin.get("cull_clouds")),
                            density_dtype, chunk, G.triplane_depth)
        mark("decode")
        vol = grid.cpu().float().numpy()      # one copy of the grid; f16 -> f32 on the host
        mark("copy")
        verts, faces = marching_tetrahedra(vol, level)
        mark("tetrahedra")
        colors = np.zeros((len(verts), 3), np.float32)
        if len(verts):
            world = vertex_world(verts, N, bw)
            rgb = G.sample_mixed_planes(planes, to_device(world[None], G.device))["rgb"]
            colors = rgb[0, :, :3].float().cpu().numpy()
        mark("colours")
    verts_w = verts / N * bw - 0.5 * bw
    return dict(verts=verts_w.astype(np.float32), faces=faces, normals=None, values=None,
                colors=np.clip(colors, 0, 1))


def marching_cubes(vol: np.ndarray, rgbs: np.ndarray, boxwarp: float,
                   level: float = 0.5) -> dict:
    """Surface at ``level`` with vertex colours read at the integer vertex
    indices (eg3d_metrics3d.py:186-210). vol [N,N,N] density, rgbs
    [3,N,N,N]; verts scaled into box_warp units as the reference does,
    v / N * bw - bw / 2."""
    shape_res = vol.shape[-1]
    verts, faces = marching_tetrahedra(np.asarray(vol, np.float32), level)
    vi = verts.astype(int)
    colors = rgbs[:3, vi[:, 0], vi[:, 1], vi[:, 2]].T
    verts_w = verts / shape_res * boxwarp - 0.5 * boxwarp
    return dict(verts=verts_w.astype(np.float32), faces=faces, normals=None, values=None,
                colors=colors.astype(np.float32))
