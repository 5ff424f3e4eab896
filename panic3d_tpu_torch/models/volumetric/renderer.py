"""Hierarchical (coarse + importance) triplane volume renderer
(panic3d_tpu/models/volumetric/renderer.py), eval path.

Three CUDA kernels carry the render on the card, each wrapped here beside
its plain PyTorch version:

- K1 ``triplane_decode`` (csrc/triplane_decode.cu): triplane sample -> plane
  mean -> decoder MLP -> density filters, per sample point;
- K2 ``ray_composite`` (csrc/ray_composite.cu): stable depth merge of the
  coarse and fine samples + midpoint-quadrature composite, per ray;
- K3 ``importance_sample`` (csrc/importance_sample.cu): coarse weights ->
  smoothed pdf -> inverse-CDF depths at u = linspace(0, 1, K), per ray.

A wrapper takes its plain version only for CPU tensors; on a CUDA tensor it
launches its kernel or raises. Not ported yet: empty-space skipping
(``options['ess']``), ``ray_start='auto'``, disparity-space sampling,
triplane_depth > 1, random (keyed) sampling, and the TPU-only ray chunking
and corner packing (ROADMAP "Do not port").
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ...kernels import KERNELS
from ...kernels import build as kb
from ...ops.grid_sample import grid_sample_2d_points

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
RENDER_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float64": torch.float64}


def softplus(x):
    """log(1 + e^x) in jax.nn.softplus's overflow-safe form (the kernels use
    the same formula)."""
    return x.clamp_min(0) + torch.log1p(torch.exp(-x.abs()))


def _acc(dtype):
    return torch.promote_types(dtype, torch.float32)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _require(cond, msg):
    if not cond:
        raise ValueError(msg)


# ---------------------------------------------------------------------------
# plane geometry

def generate_plane_axes(use_triplane: bool = False) -> np.ndarray:
    """The three plane bases (renderer.py:26-50); use_triplane=True is the
    corrected third plane the shipped model trains with."""
    third = ([[0, 1, 0], [0, 0, 1], [1, 0, 0]] if use_triplane
             else [[0, 0, 1], [1, 0, 0], [0, 1, 0]])
    return np.asarray([[[1, 0, 0], [0, 1, 0], [0, 0, 1]],
                       [[1, 0, 0], [0, 0, 1], [0, 1, 0]], third], dtype=np.float32)


def project_onto_planes(plane_axes: np.ndarray, coordinates):
    """[N,M,3] -> [N,3,M,3] plane-local coordinates."""
    inv = torch.as_tensor(np.linalg.inv(plane_axes), dtype=coordinates.dtype,
                          device=coordinates.device)
    return torch.einsum("nmc,pcd->npmd", coordinates, inv)


def sample_from_planes(plane_axes, plane_features, coordinates, box_warp: float):
    """Bilinear triplane lookup, planes [N,3,C,H,W] -> [N,3,M,C]."""
    N, n_planes, C, H, W = plane_features.shape
    M = coordinates.shape[1]
    proj = project_onto_planes(plane_axes, (2.0 / box_warp) * coordinates)
    out = grid_sample_2d_points(plane_features.reshape(N * n_planes, C, H, W),
                                proj[..., :2].reshape(N * n_planes, M, 2))
    return out.reshape(N, n_planes, M, C)


# ---------------------------------------------------------------------------
# ray marcher and density filters

def _march_weights(densities, depths):
    """Midpoint-quadrature weights [B,R,S-1,1] of densities/depths [B,R,S,1]."""
    deltas = depths[:, :, 1:] - depths[:, :, :-1]
    dens_mid = softplus((densities[:, :, :-1] + densities[:, :, 1:]) / 2 - 1)
    alpha = 1 - torch.exp(-(dens_mid * deltas))
    shifted = torch.cat([torch.ones_like(alpha[:, :, :1]), 1 - alpha + 1e-10], dim=-2)
    transmittance = torch.cumprod(shifted, dim=-2)[:, :, :-1]
    return alpha * transmittance


def ray_march(colors, densities, depths, white_back: bool):
    """colors [B,R,S,C], densities/depths [B,R,S,1] -> (composite [B,R,C],
    depth [B,R,1], weights [B,R,S-1,1])."""
    colors = colors.to(_acc(colors.dtype))
    weights = _march_weights(densities, depths)
    colors_mid = (colors[:, :, :-1] + colors[:, :, 1:]) / 2
    depths_mid = (depths[:, :, :-1] + depths[:, :, 1:]) / 2
    composite_rgb = (weights * colors_mid).sum(-2)
    weight_total = weights.sum(2)
    composite_depth = (weights * depths_mid).sum(-2) / weight_total
    composite_depth = torch.nan_to_num(composite_depth, nan=float("inf"))
    composite_depth = torch.clamp(composite_depth, depths.min(), depths.max())
    if white_back:
        composite_rgb = composite_rgb + 1 - weight_total
    return composite_rgb * 2 - 1, composite_depth, weights


def triplane_crop_mask(xyz, thresh, boxwarp):
    """True where density is culled: outside the crop box in x and z (the
    reference's allow_bottom term reduces to the same set)."""
    lim = boxwarp / 2 - thresh
    inside = (xyz[..., 0:1].abs() <= lim) & (xyz[..., 2:3].abs() <= lim)
    return ~inside


def cull_clouds_mask(densities, thresh):
    return 1 - torch.exp(-softplus(densities - 1)) < thresh


def _apply_density_filters(densities, xyz, box_warp, triplane_crop, cull_clouds,
                           binarize_clouds):
    if triplane_crop:
        densities = torch.where(triplane_crop_mask(xyz, triplane_crop, box_warp),
                                torch.full_like(densities, -1e3), densities)
    if binarize_clouds:
        densities = torch.where(cull_clouds_mask(densities, binarize_clouds),
                                torch.full_like(densities, -1e3),
                                torch.full_like(densities, 1e3))
    elif cull_clouds:
        densities = torch.where(cull_clouds_mask(densities, cull_clouds),
                                torch.full_like(densities, -1e3), densities)
    return densities


# ---------------------------------------------------------------------------
# sampling (deterministic eval form, key=None)

def sample_stratified(ray_origins, ray_start: float, ray_end: float,
                      depth_resolution: int):
    """Midpoint-stratified depths [N,M,S,1] over a fixed interval
    (renderer.py:303-326 with key=None: jitter 0.5)."""
    N, M, _ = ray_origins.shape
    S = depth_resolution
    depths = torch.linspace(ray_start, ray_end, S, device=ray_origins.device)
    depths = depths.reshape(1, 1, S, 1) + 0.5 * ((ray_end - ray_start) / (S - 1))
    return depths.expand(N, M, S, 1)


def sample_pdf(bins, weights, n_importance: int, eps: float = 1e-5):
    """Inverse-CDF sampling at u = linspace(0, 1, n) (renderer.py:348-387).
    bins [R,B], weights [R,W] with W <= B - 1."""
    R, S = weights.shape
    weights = weights + eps
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], -1)               # [R,S+1]
    u = torch.linspace(0, 1, n_importance, device=cdf.device, dtype=cdf.dtype)
    u = u.expand(R, n_importance).contiguous()
    inds = (cdf[:, None, :] <= u[:, :, None]).sum(-1)                      # searchsorted right
    below = (inds - 1).clamp_min(0)
    above = inds.clamp_max(S)
    cdf_lo, cdf_hi = cdf.gather(1, below), cdf.gather(1, above)
    bins_lo, bins_hi = bins.gather(1, below), bins.gather(1, above)
    denom = cdf_hi - cdf_lo
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    return bins_lo + (u - cdf_lo) / denom * (bins_hi - bins_lo)


def sample_importance(z_vals, weights, n_importance: int):
    """Importance depths from max-pool/avg-pool smoothed coarse weights
    (renderer.py:328-346). z_vals [B,R,S,1], weights [B,R,S-1,1]."""
    B, R, S, _ = z_vals.shape
    z = z_vals.reshape(B * R, S)
    w = weights.reshape(B * R, -1)
    wpad = F.pad(w, (1, 1), value=-math.inf)
    wmax = torch.maximum(wpad[:, :-1], wpad[:, 1:])
    w = (wmax[:, :-1] + wmax[:, 1:]) / 2 + 0.01
    z_mid = 0.5 * (z[:, :-1] + z[:, 1:])
    return sample_pdf(z_mid, w[:, 1:-1], n_importance).reshape(B, R, n_importance, 1)


def unify_samples(d1, c1, s1, x1, d2, c2, s2, x2):
    """Concatenate coarse + fine samples and sort them by depth (stable:
    ties keep coarse first)."""
    depths = torch.cat([d1, d2], -2)
    idx = torch.argsort(depths[..., 0], dim=-1, stable=True)[..., None]

    def take(a):
        return a.gather(2, idx.expand(-1, -1, -1, a.shape[-1]))

    return (take(depths), take(torch.cat([c1, c2], -2)), take(torch.cat([s1, s2], -2)),
            take(torch.cat([x1, x2], -2)))


# ---------------------------------------------------------------------------
# K1 triplane_decode

class Decoder(NamedTuple):
    """OSGDecoder parameters as the kernel takes them: raw equalized-lr
    weights (the gains lr_mul/sqrt(fan_in) and the bias scale lr_mul are
    applied in the kernel) and the rgb activation."""
    w0: torch.Tensor     # [64, C]
    b0: torch.Tensor     # [64]
    w1: torch.Tensor     # [33, 64]
    b1: torch.Tensor     # [33]
    lr_mul: float = 1.0
    force_sigmoid: bool = False


class DensityFilters(NamedTuple):
    triplane_crop: Optional[float] = None
    cull_clouds: Optional[float] = None
    binarize_clouds: Optional[float] = None


def triplane_decode_plain(planes_cl, coords, dec: Decoder, box_warp: float,
                          plane_axes, filters: DensityFilters):
    """planes_cl [N,3,H,W,C] channels-last, coords [N,M,3] ->
    (rgb [N,M,32] in the planes' dtype, filtered sigma [N,M,1]). Math in at
    least f32 (bf16 planes are upcast as they are read)."""
    acc = _acc(planes_cl.dtype)
    planes = planes_cl.to(acc).permute(0, 1, 4, 2, 3)
    x = sample_from_planes(plane_axes, planes, coords.to(acc), box_warp).mean(dim=1)
    C, hidden = dec.w0.shape[1], dec.w0.shape[0]
    x = x @ (dec.w0.to(acc) * (dec.lr_mul / math.sqrt(C))).T + dec.b0.to(acc) * dec.lr_mul
    x = softplus(x)
    x = x @ (dec.w1.to(acc) * (dec.lr_mul / math.sqrt(hidden))).T + dec.b1.to(acc) * dec.lr_mul
    rgb = torch.sigmoid(x[..., 1:])
    if not dec.force_sigmoid:
        rgb = rgb * (1 + 2 * 0.001) - 0.001        # MipNeRF sigmoid clamp
    sigma = _apply_density_filters(x[..., 0:1], coords.to(acc), box_warp, *filters)
    return rgb.to(planes_cl.dtype), sigma


_K1_ARGS = ((kb.PTR, kb.INT) + (kb.PTR,) * 7 + (kb.INT,) * 5 + (kb.PTR,) + (kb.FLOAT,) * 4
            + (kb.INT, kb.INT, kb.FLOAT, kb.INT, kb.FLOAT, kb.PTR))


def triplane_decode_kernel(planes_cl, coords, dec: Decoder, box_warp: float,
                           plane_axes, filters: DensityFilters):
    """Launch K1 on CUDA tensors: same contract as triplane_decode_plain;
    rgb comes back in the planes' dtype, sigma in f32."""
    _require(planes_cl.dtype in _DTYPES, f"K1 planes must be f32 or bf16, got {planes_cl.dtype}")
    _require(planes_cl.ndim == 5 and planes_cl.shape[1] == 3, "K1 planes must be [N,3,H,W,C]")
    N, _, H, W, C = planes_cl.shape
    _require(C in (8, 16, 32), f"K1 supports 8, 16 or 32 plane channels, got {C}")
    _require(planes_cl.is_contiguous() and planes_cl.data_ptr() % 16 == 0,
             "K1 planes must be contiguous and 16-byte aligned")
    _require(coords.dtype == torch.float32 and coords.is_contiguous()
             and coords.ndim == 3 and coords.shape[0] == N and coords.shape[2] == 3,
             "K1 coords must be contiguous f32 [N,M,3]")
    dev = planes_cl.device
    _require(coords.device == dev, "K1 inputs must share a device")
    w0, b0, w1, b1 = (t.to(device=dev, dtype=torch.float32).contiguous()
                      for t in (dec.w0, dec.b0, dec.w1, dec.b1))
    _require(tuple(w0.shape) == (64, C) and tuple(b0.shape) == (64,)
             and tuple(w1.shape) == (33, 64) and tuple(b1.shape) == (33,),
             "K1 takes a 64-wide hidden layer and 33 outputs")
    M = coords.shape[1]
    rgb = torch.empty((N, M, 32), dtype=planes_cl.dtype, device=dev)
    sigma = torch.empty((N, M, 1), dtype=torch.float32, device=dev)
    proj = np.linalg.inv(plane_axes)[:, :, :2]                  # [plane][xyz][uv]
    crop, cull, binarize = filters
    cull_mode, thresh = (2, binarize) if binarize else ((1, cull) if cull else (0, 0.0))
    kb.launch(
        "triplane_decode", _K1_ARGS, planes_cl.data_ptr(), _DTYPES[planes_cl.dtype],
        coords.data_ptr(), w0.data_ptr(), b0.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        rgb.data_ptr(), sigma.data_ptr(), N, M, H, W, C,
        kb.f32_array(proj.reshape(-1)), 2.0 / box_warp,
        dec.lr_mul / math.sqrt(C), dec.lr_mul / math.sqrt(64), dec.lr_mul,
        int(dec.force_sigmoid), int(bool(crop)), (box_warp / 2 - crop) if crop else 0.0,
        cull_mode, float(thresh), _stream(planes_cl),
    )
    KERNELS["triplane_decode"].launches += 1
    return rgb, sigma


def triplane_decode(planes_cl, coords, dec: Decoder, box_warp: float, plane_axes,
                    filters: DensityFilters = DensityFilters()):
    if planes_cl.device.type == "cpu":
        return triplane_decode_plain(planes_cl, coords, dec, box_warp, plane_axes, filters)
    if planes_cl.device.type == "cuda":
        return triplane_decode_kernel(planes_cl, coords, dec, box_warp, plane_axes, filters)
    raise RuntimeError(f"triplane_decode: no path for device {planes_cl.device}")


# ---------------------------------------------------------------------------
# K2 ray_composite

def ray_composite_plain(d1, c1, s1, x1, d2, c2, s2, x2, white_back: bool):
    """ray_march(unify_samples(...)) over colors | xyz. Per half: depths and
    sigmas [B,R,S,1], colors [B,R,S,C], xyz [B,R,S,3]. -> (rgb [B,R,C],
    depth [B,R,1], weight total [B,R,1], xyz [B,R,3]), f32 or wider."""
    acc = _acc(c1.dtype)
    ca1 = torch.cat([c1.to(acc), x1.to(acc)], -1)
    ca2 = torch.cat([c2.to(acc), x2.to(acc)], -1)
    d, c, s, _ = unify_samples(d1, ca1, s1, x1, d2, ca2, s2, x2)
    comp, depth, weights = ray_march(c, s, d, white_back)
    return comp[..., :-3], depth, weights.sum(2), comp[..., -3:]


_K2_ARGS = (kb.PTR,) * 8 + (kb.INT,) + (kb.PTR,) * 4 + (kb.INT,) * 5 + (kb.PTR,)


def ray_composite_kernel(d1, c1, s1, x1, d2, c2, s2, x2, white_back: bool):
    """Launch K2 on CUDA tensors: same contract as ray_composite_plain."""
    B, R, S1, C = c1.shape
    S2 = c2.shape[2]
    _require(c1.dtype in _DTYPES and c2.dtype == c1.dtype, "K2 colors must be f32 or bf16")
    for t, ch, s in ((d1, 1, S1), (s1, 1, S1), (x1, 3, S1), (c1, C, S1),
                     (d2, 1, S2), (s2, 1, S2), (x2, 3, S2), (c2, C, S2)):
        _require(tuple(t.shape) == (B, R, s, ch) and t.is_contiguous()
                 and t.device == c1.device, f"K2 input of shape {tuple(t.shape)}")
        _require(t is c1 or t is c2 or t.dtype == torch.float32,
                 "K2 depths, sigmas and xyz must be f32")
    _require(S1 + S2 <= 1024, "K2 takes at most 1024 samples per ray")
    dev = c1.device
    comp = torch.empty((B, R, C + 3), dtype=torch.float32, device=dev)
    depth = torch.empty((B, R, 1), dtype=torch.float32, device=dev)
    wsum = torch.empty((B, R, 1), dtype=torch.float32, device=dev)
    minmax = torch.empty((2,), dtype=torch.float32, device=dev)
    if S2 == 0:     # no importance pass: the second half is never read
        d2, c2, s2, x2 = d1, c1, s1, x1
    kb.launch(
        "ray_composite", _K2_ARGS, d1.data_ptr(), c1.data_ptr(), s1.data_ptr(),
        x1.data_ptr(), d2.data_ptr(), c2.data_ptr(), s2.data_ptr(), x2.data_ptr(),
        _DTYPES[c1.dtype], comp.data_ptr(), depth.data_ptr(), wsum.data_ptr(),
        minmax.data_ptr(), B * R, S1, S2, C, int(white_back), _stream(c1),
    )
    KERNELS["ray_composite"].launches += 1
    return comp[..., :-3], depth, wsum, comp[..., -3:]


def ray_composite(d1, c1, s1, x1, d2, c2, s2, x2, white_back: bool):
    if c1.device.type == "cpu":
        return ray_composite_plain(d1, c1, s1, x1, d2, c2, s2, x2, white_back)
    if c1.device.type == "cuda":
        return ray_composite_kernel(d1, c1, s1, x1, d2, c2, s2, x2, white_back)
    raise RuntimeError(f"ray_composite: no path for device {c1.device}")


# ---------------------------------------------------------------------------
# K3 importance_sample

def importance_sample_plain(depths, sigmas, n_importance: int):
    """Coarse depths/sigmas [B,R,S,1] -> importance depths [B,R,K,1]."""
    return sample_importance(depths, _march_weights(sigmas, depths), n_importance)


_K3_ARGS = (kb.PTR, kb.PTR, kb.PTR, kb.INT, kb.INT, kb.INT, kb.PTR)


def importance_sample_kernel(depths, sigmas, n_importance: int):
    """Launch K3 on CUDA tensors: same contract as importance_sample_plain."""
    B, R, S, _ = depths.shape
    for t in (depths, sigmas):
        _require(t.dtype == torch.float32 and t.is_contiguous()
                 and tuple(t.shape) == (B, R, S, 1) and t.device == depths.device,
                 "K3 takes contiguous f32 [B,R,S,1] depths and sigmas")
    _require(4 <= S <= 256 and n_importance >= 1, f"K3 takes 4..256 coarse samples, got {S}")
    out = torch.empty((B, R, n_importance, 1), dtype=torch.float32, device=depths.device)
    kb.launch("importance_sample", _K3_ARGS, depths.data_ptr(), sigmas.data_ptr(),
              out.data_ptr(), B * R, S, n_importance, _stream(depths))
    KERNELS["importance_sample"].launches += 1
    return out


def importance_sample(depths, sigmas, n_importance: int):
    if depths.device.type == "cpu":
        return importance_sample_plain(depths, sigmas, n_importance)
    if depths.device.type == "cuda":
        return importance_sample_kernel(depths, sigmas, n_importance)
    raise RuntimeError(f"importance_sample: no path for device {depths.device}")


# ---------------------------------------------------------------------------
# full renderer (renderer.py:864)

class RenderOutput(NamedTuple):
    rgb: torch.Tensor       # [N, R, C] feature samples
    depth: torch.Tensor     # [N, R, 1]
    weights: torch.Tensor   # [N, R, 1] accumulated alpha
    xyz: torch.Tensor       # [N, R, 3] composited world position


def render(planes, decoder: Decoder, ray_origins, ray_directions, options: dict,
           triplane_crop=None, cull_clouds=None, binarize_clouds=None) -> RenderOutput:
    """Two-pass hierarchical render: stratified coarse pass (K1), importance
    depths (K3), fine pass (K1), merged composite (K2). planes [N,3,C,H,W];
    rays [N,R,3]; ``options`` are the reference rendering_kwargs."""
    for key, why in (("ess", "empty-space skipping"),
                     ("disparity_space_sampling", "disparity-space sampling")):
        if options.get(key):
            raise NotImplementedError(f"render: {why} is not ported yet")
    if options.get("triplane_depth", 1) != 1:
        raise NotImplementedError("render: triplane_depth > 1 is not ported yet")
    ray_start, ray_end = options["ray_start"], options["ray_end"]
    if not isinstance(ray_start, (int, float)) or not isinstance(ray_end, (int, float)):
        raise NotImplementedError("render: ray_start/ray_end='auto' is not ported yet")
    N, R, _ = ray_origins.shape
    box_warp = options["box_warp"]
    render_dtype = RENDER_DTYPES[options.get("render_dtype", "bfloat16")]
    # channels-last planes in the render dtype, shared by both passes
    planes_cl = planes.to(render_dtype).permute(0, 1, 3, 4, 2).contiguous()
    plane_axes = generate_plane_axes(options.get("use_triplane", False))
    filters = DensityFilters(triplane_crop, cull_clouds, binarize_clouds)
    white_back = options.get("white_back", False)

    def eval_pass(depths):
        n = depths.shape[2]
        coords = (ray_origins[:, :, None, :] + depths * ray_directions[:, :, None, :])
        coords = coords.reshape(N, R * n, 3).contiguous()
        rgb, sigma = triplane_decode(planes_cl, coords, decoder, box_warp, plane_axes,
                                     filters)
        return (rgb.reshape(N, R, n, -1), sigma.reshape(N, R, n, 1),
                coords.reshape(N, R, n, 3))

    depths_coarse = sample_stratified(ray_origins, ray_start, ray_end,
                                      options["depth_resolution"])
    depths_coarse = depths_coarse.to(ray_origins.dtype).contiguous()
    colors_c, sigma_c, xyz_c = eval_pass(depths_coarse)
    n_imp = options.get("depth_resolution_importance") or 0
    if n_imp > 0:
        depths_fine = importance_sample(depths_coarse, sigma_c, n_imp)
        colors_f, sigma_f, xyz_f = eval_pass(depths_fine)
    else:   # the coarse samples are already depth-ordered
        depths_fine, colors_f, sigma_f, xyz_f = (
            t[:, :, :0] for t in (depths_coarse, colors_c, sigma_c, xyz_c))
    rgb, depth, wsum, xyz = ray_composite(
        depths_coarse, colors_c, sigma_c, xyz_c, depths_fine, colors_f, sigma_f, xyz_f,
        white_back)
    return RenderOutput(rgb=rgb, depth=depth, weights=wsum, xyz=xyz)
