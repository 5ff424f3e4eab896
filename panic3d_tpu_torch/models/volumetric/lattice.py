"""Factorised axis-aligned lattice decode and the front-occlusion volume
(panic3d_tpu/models/volumetric/lattice.py:49-353).

Each triplane depends on two world axes, so resampling it onto an
axis-aligned lattice takes two small 1-D bilinear resample matrices (two
plain matmuls), and the per-point triplane feature is the broadcast sum

    feat[i,j,k] = ((F_xy[i,j] + F_xz[i,k]) + F_yz[j,k]) / 3

(the plane mean of OSGDecoder, in the JAX package's summation order). The
ESS occupancy (renderer.ess_occupancy, kernel K6) and paste-front's
per-portrait occlusion volume (kernel K7, csrc/front_occlusion.cu) consume
these terms; the [M,C] feature block never reaches device memory in either
kernel. K7's volume factors the first layer through the sum: it computes
P_t = W0 F_t per term once, and each lattice point adds three rows of P.

K7's two wrappers (``occlusion_volume``, ``occlusion_sample``) sit here
beside their plain versions; each takes its plain version only for CPU
tensors.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Tuple

import numpy as np
import torch

from ...kernels import KERNELS, require_no_grad
from ...kernels import build as kb
from ...ops.grid_sample import grid_sample_3d_points


def resample_matrix_1d(norm_coords: np.ndarray, size: int) -> np.ndarray:
    """Dense [G, size] bilinear resample matrix at normalised coords: row g
    holds the weights grid_sample (align_corners=False, zeros padding) uses
    to sample a length-``size`` signal at norm_coords[g]; taps outside
    [0, size) are dropped. Built in float64 and cast, so the weights are
    exact for power-of-two grids."""
    p = ((norm_coords.astype(np.float64) + 1.0) * size - 1.0) / 2.0
    p0 = np.floor(p)
    w1 = p - p0
    cols = np.arange(size, dtype=np.int64)[None, :]
    m = ((cols == p0[:, None]) * (1.0 - w1[:, None])
         + (cols == (p0[:, None] + 1)) * w1[:, None])
    return m.astype(np.float32)


def plane_axis_map(plane_axes: np.ndarray):
    """Which world axis feeds each plane's local (u, v), with its sign:
    [((axis_u, sign_u), (axis_v, sign_v)), ...] per plane. Every plane basis
    must be a signed permutation (both EG3D bases are)."""
    inv = np.linalg.inv(plane_axes)
    out = []
    for p in range(inv.shape[0]):
        axes = []
        for d in range(2):
            col = inv[p][:, d]
            nz = np.nonzero(np.abs(col) > 1e-8)[0]
            assert len(nz) == 1, "factorised lattice decode requires axis-aligned plane bases"
            axes.append((int(nz[0]), float(col[nz[0]])))
        out.append(axes)
    return out


def lattice_axis_coords(grid, box_warp: float):
    """Per-axis world coords of the lattice CELL CENTRES, float64:
    (g + 0.5) / G * bw - bw / 2."""
    bw = float(box_warp)
    return [(np.arange(g, dtype=np.float64) + 0.5) / g * bw - bw / 2 for g in grid]


@functools.lru_cache(maxsize=64)
def _axis_resample(g: int, box_warp: float, scale: float, size: int, device: torch.device):
    """The resample matrix of a G-cell lattice axis onto a length-``size``
    plane axis, on ``device``, made once (a host-to-device copy would wait
    for the queued work)."""
    coords = lattice_axis_coords((g,), box_warp)[0] * scale
    return torch.as_tensor(resample_matrix_1d(coords, size), device=device)


def _plane_lattice_features(planes, plane_axes, grid, box_warp):
    """Resample each plane onto its two lattice axes: planes [N,3,C,H,W] ->
    [(F [N,Ga,Gb,C] f32, axis_a, axis_b)] with axis_a < axis_b."""
    inv_half = 2.0 / float(box_warp)
    out = []
    H, W = planes.shape[-2:]
    for p, ((au, su), (av, sv)) in enumerate(plane_axis_map(plane_axes)):
        Su = _axis_resample(grid[au], float(box_warp), su * inv_half, W, planes.device)   # u: W
        Sv = _axis_resample(grid[av], float(box_warp), sv * inv_half, H, planes.device)   # v: H
        # F[n, a_u, a_v, c] = sum_{h,w} plane[n,c,h,w] Sv[a_v,h] Su[a_u,w]
        F = torch.einsum("nchw,vh,uw->nuvc", planes[:, p].to(torch.float32), Sv, Su)
        out.append((F, au, av) if au < av else (F.transpose(1, 2), av, au))
    return out


def lattice_features(planes, plane_axes, grid, box_warp: float):
    """The three factorised terms of ``planes`` [N,3,C,H,W] on the
    cell-centre lattice ``grid`` (Gx, Gy, Gz): [(F, axis_a, axis_b)] in
    plane order, each F [N,G_a,G_b,C] f32. Bilinear planes only (the
    callers refuse deep planes, ROADMAP F12)."""
    return _plane_lattice_features(planes, plane_axes, tuple(grid), box_warp)


def _broadcast_term(F, aa, ab):
    """Place F [N,Ga,Gb,C] on lattice axes (aa < ab) of [N,Gx,Gy,Gz,C]."""
    return F.unsqueeze(1 + (3 - aa - ab))


def decode_lattice_terms(terms, decode_fn: Callable, grid, chunk_points: int = 2 ** 21,
                         with_rgb: bool = False, plane_reduce: str = "stack"):
    """decode_lattice from precomputed lattice terms (see decode_lattice)."""
    assert plane_reduce in ("stack", "mean"), plane_reduce
    Gx, Gy, Gz = grid
    parts_all = [_broadcast_term(F, aa, ab) for F, aa, ab in terms]
    N, C = parts_all[0].shape[0], parts_all[0].shape[-1]
    cz = max(1, min(Gz, chunk_points // max(1, Gx * Gy)))
    sig_chunks, rgb_chunks = [], []
    for k0 in range(0, Gz, cz):
        k1 = min(k0 + cz, Gz)
        parts = [t if t.shape[3] == 1 else t[:, :, :, k0:k1] for t in parts_all]
        M = Gx * Gy * (k1 - k0)
        if plane_reduce == "mean":
            feat = sum(parts[1:], parts[0]) / len(parts)
            feat = feat.expand(N, Gx, Gy, k1 - k0, C).reshape(N, 1, M, C)
        else:
            feat = torch.stack([p.expand(N, Gx, Gy, k1 - k0, C).reshape(N, M, C)
                                for p in parts], dim=1)
        rgb, sigma = decode_fn(feat)
        sig_chunks.append(sigma.reshape(N, Gx, Gy, k1 - k0))
        if with_rgb:
            rgb_chunks.append(rgb.reshape(N, Gx, Gy, k1 - k0, rgb.shape[-1]))
    sigma = torch.cat(sig_chunks, dim=3)
    if with_rgb:
        return sigma, torch.cat(rgb_chunks, dim=3)
    return sigma


def decode_lattice(planes, decode_fn: Callable, box_warp: float, grid: Tuple[int, int, int],
                   use_triplane: bool = False, chunk_points: int = 2 ** 21,
                   with_rgb: bool = False, plane_reduce: str = "stack"):
    """Decode sigma [N,Gx,Gy,Gz] (and rgb [N,Gx,Gy,Gz,Cr]) on the
    cell-centre lattice, gather-free (lattice.py:136). ``decode_fn`` maps
    stacked features [N,P,M,C] to (rgb, sigma). plane_reduce='stack' hands
    it the three per-plane features; 'mean' takes the plane mean here, in
    the broadcast add, and hands it [N,1,M,C] (valid only for decoders that
    mean over the planes, as OSGDecoder does). Chunked over z so a feature
    block stays under ``chunk_points`` rows. Bilinear planes only, as
    lattice_features."""
    from .renderer import generate_plane_axes

    assert planes.ndim == 5, "decode_lattice needs raw [N,3,C,H,W] planes"
    terms = lattice_features(planes, generate_plane_axes(use_triplane), grid, box_warp)
    return decode_lattice_terms(terms, decode_fn, grid, chunk_points, with_rgb, plane_reduce)


def lattice_world_coords(grid, box_warp: float, device=None):
    """[Gx,Gy,Gz,3] f32 world coords of the cell centres."""
    ax = [torch.as_tensor(a, dtype=torch.float32, device=device)
          for a in lattice_axis_coords(grid, box_warp)]
    X, Y, Z = torch.meshgrid(*ax, indexing="ij")
    return torch.stack([X, Y, Z], dim=-1)


# ---------------------------------------------------------------------------
# K7 occlusion_volume

def occlusion_volume_plain(terms, dec, box_warp: float, grid, filters):
    """The suffix-integrated +z opacity volume of lattice.py:239 from the
    factorised terms: plane-mean sigma-only decode, the density filters at
    the cell centres, density = softplus(sigma-1), and
    A = (reverse cumsum of density along z - density/2) * dz ->
    A [N,Gx,Gy,Gz] f32."""
    from . import renderer as vr

    N = terms[0][0].shape[0]
    Gx, Gy, Gz = grid
    bw = float(box_warp)
    sigma = decode_lattice_terms(terms, lambda f: vr.osg_decode(f, dec, sigma_only=True),
                                 grid, plane_reduce="mean")
    xyz = lattice_world_coords(grid, bw, sigma.device)
    sigma = vr._apply_density_filters(
        sigma.reshape(N, -1, 1), xyz.reshape(1, -1, 3).expand(N, -1, 3), bw,
        *filters).reshape(N, Gx, Gy, Gz)
    density = vr.softplus(sigma.float() - 1)
    suffix = torch.flip(torch.cumsum(torch.flip(density, (3,)), dim=3), (3,))
    return (suffix - 0.5 * density) * (bw / Gz)


# per term: renderer.lattice_term_args (pointer, two axes, three strides)
_K7A_ARGS = ((kb.PTR, kb.INT, kb.INT, kb.LONG, kb.LONG, kb.LONG) * 3 + (kb.PTR,) * 6
             + (kb.INT,) * 5 + (kb.DOUBLE,) + (kb.FLOAT,) * 4
             + (kb.INT, kb.FLOAT, kb.INT, kb.FLOAT, kb.PTR))


def occlusion_volume_kernel(terms, dec, box_warp: float, grid, filters):
    """Launch K7's volume on CUDA tensors: same contract as
    occlusion_volume_plain. The factored first layer P (64 f32 a term cell)
    is scratch of this call."""
    require_no_grad("occlusion_volume", terms, dec)
    from . import renderer as vr

    dev = terms[0][0].device
    N, C = terms[0][0].shape[0], terms[0][0].shape[-1]
    Gx, Gy, Gz = grid
    vr._require(C in (8, 16, 32), f"K7 supports 8, 16 or 32 plane channels, got {C}")
    vr._require(Gz % 4 == 0, f"K7 takes Gz a multiple of 4, got {Gz}")
    sizes = (Gx, Gy, Gz)
    for F_, aa, ab in terms:
        vr._require(tuple(F_.shape) == (N, sizes[aa], sizes[ab], C),
                    "K7 terms must match the lattice")
    axes = [(aa, ab) for _, aa, ab in terms]
    vr._require((0, 1) in axes[:2] and sorted(axes)[1:] in ([(0, 2), (0, 2)], [(0, 2), (1, 2)]),
                "K7 takes an (x, y) term among the first two and two terms on (x or y, z)")
    targs, keep = vr.lattice_term_args(terms, dev)
    w0, b0, w1, b1 = vr._decoder_f32(dec, dev)
    vr._require(tuple(w0.shape) == (64, C) and tuple(w1.shape) == (33, 64),
                "K7 takes a 64-wide hidden layer")
    A = torch.empty((N, Gx, Gy, Gz), dtype=torch.float32, device=dev)
    P = torch.empty((sum(F_.shape[0] * F_.shape[1] * F_.shape[2] for F_, _, _ in terms), 64),
                    dtype=torch.float32, device=dev)
    kb.launch(
        "occlusion_volume", _K7A_ARGS, *targs, w0.data_ptr(), b0.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), P.data_ptr(), A.data_ptr(), N, Gx, Gy, Gz, C, float(box_warp),
        float(box_warp) / Gz,
        dec.lr_mul / math.sqrt(C), dec.lr_mul / math.sqrt(64), dec.lr_mul,
        *vr._filter_args(filters, box_warp), vr._stream(A))
    KERNELS["occlusion_volume"].launches += 1
    del keep
    return A


def occlusion_volume(terms, dec, box_warp: float, grid, filters):
    dev = terms[0][0].device
    if dev.type == "cpu":
        return occlusion_volume_plain(terms, dec, box_warp, grid, filters)
    if dev.type == "cuda":
        return occlusion_volume_kernel(terms, dec, box_warp, grid, filters)
    raise RuntimeError(f"occlusion_volume: no path for device {dev}")


def front_occlusion_volume(planes, dec, box_warp: float, options: dict, triplane_crop=None,
                           cull_clouds=None, binarize_clouds=None,
                           grid: Tuple[int, int, int] = (128, 128, 256)):
    """Per-portrait +z opacity integral volume for paste-front occlusion
    (lattice.py:239), computed once per set of planes; every view then
    interpolates it (sample_front_occlusion). -> {'A' [N,Gx,Gy,Gz] (the
    suffix integral at the cell centres), 'density0' (the filtered
    zero-feature density outside the box), 'grid', 'box_warp'}."""
    from . import renderer as vr

    vr.refuse_deep("front_occlusion_volume", options.get("triplane_depth", 1))
    bw = float(box_warp)
    filters = vr.DensityFilters(triplane_crop, cull_clouds, binarize_clouds)
    with torch.no_grad():
        terms = lattice_features(planes.float(),
                                 vr.generate_plane_axes(options.get("use_triplane", False)),
                                 grid, bw)
        A = occlusion_volume(terms, dec, bw, tuple(grid), filters)
        density0 = vr.zero_feature_density(planes, dec, cull_clouds, binarize_clouds)
    return {"A": A, "density0": density0, "grid": tuple(grid), "box_warp": bw}


# ---------------------------------------------------------------------------
# K7 occlusion_sample

def occlusion_sample_plain(A, density0, points, box_warp: float, offset: float,
                           seg_len: float):
    """Occlusion toward +z at each surface point (lattice.py:303): the
    border-clamped trilinear read of A at (p_x, p_y, p_z + offset), plus the
    zero-feature density over the segment's out-of-box lengths, as
    1 - exp(-A_total). A [N,Gx,Gy,Gz], points [N,M,3] -> [N,M,1]."""
    N = A.shape[0]
    bw = float(box_warp)
    d0 = torch.as_tensor(density0, dtype=torch.float32, device=A.device).expand(N)
    z0 = points[..., 2] + offset
    # volume [N, C=1, D=Gx, H=Gy, W=Gz]: the query order is (z, y, x)
    pts = torch.stack([z0, points[..., 1], points[..., 0]], dim=-1) * (2.0 / bw)
    A_p = grid_sample_3d_points(A[:, None], pts, padding_mode="border")[..., 0]
    inside_xy = (points[..., 0].abs() <= bw / 2) & (points[..., 1].abs() <= bw / 2)
    len_below = torch.clamp(-bw / 2 - z0, 0.0, seg_len)
    len_above = torch.clamp(z0 + seg_len - bw / 2, 0.0, seg_len)
    A_total = torch.where(inside_xy, A_p + d0[:, None] * (len_below + len_above),
                          d0[:, None] * seg_len)
    return (1.0 - torch.exp(-A_total))[..., None]


_K7B_ARGS = (kb.PTR,) * 4 + (kb.INT,) * 5 + (kb.LONG,) + (kb.FLOAT,) * 4 + (kb.PTR,)


def occlusion_sample_kernel(A, density0, points, box_warp: float, offset: float,
                            seg_len: float):
    """Launch K7's sampler on CUDA tensors: same contract as
    occlusion_sample_plain."""
    require_no_grad("occlusion_sample", A, density0, points)
    from . import renderer as vr

    N, Gx, Gy, Gz = A.shape
    M = points.shape[1]
    dev = A.device
    # A may be one portrait's volume broadcast over a view batch (stride 0)
    vr._require(A.dtype == torch.float32 and A[0].is_contiguous(),
                "K7 A must be f32 with contiguous [Gx,Gy,Gz] volumes")
    vr._require(points.dtype == torch.float32 and points.is_contiguous()
                and tuple(points.shape) == (N, M, 3) and points.device == dev,
                "K7 points must be contiguous f32 [N,M,3] on A's device")
    d0 = torch.as_tensor(density0, dtype=torch.float32, device=dev).reshape(1).contiguous()
    out = torch.empty((N, M, 1), dtype=torch.float32, device=dev)
    kb.launch("occlusion_sample", _K7B_ARGS, A.data_ptr(), d0.data_ptr(), points.data_ptr(),
              out.data_ptr(), N, M, Gx, Gy, Gz, A.stride(0), 2.0 / box_warp, box_warp / 2,
              float(offset), float(seg_len), vr._stream(A))
    KERNELS["occlusion_sample"].launches += 1
    return out


def occlusion_sample(A, density0, points, box_warp: float, offset: float, seg_len: float):
    args = (A, density0, points, box_warp, offset, seg_len)
    if A.device.type == "cpu":
        return occlusion_sample_plain(*args)
    if A.device.type == "cuda":
        return occlusion_sample_kernel(*args)
    raise RuntimeError(f"occlusion_sample: no path for device {A.device}")


def sample_front_occlusion(vol: dict, points, offset: float, seg_len: float):
    """Occlusion (accumulated alpha toward +z over [p_z + offset,
    p_z + offset + seg_len]) at each plane-space surface point [N,M,3] ->
    [N,M,1] in [0, 1] (lattice.py:303)."""
    return occlusion_sample(vol["A"], vol["density0"], points.contiguous(), vol["box_warp"],
                            offset, seg_len)
