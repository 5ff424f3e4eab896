"""Hierarchical (coarse + importance) triplane volume renderer
(panic3d_tpu/models/volumetric/renderer.py), with empty-space skipping,
ray_start = ray_end = 'auto' (each ray's span through the box), disparity-
space sampling and the keyed form of training (jittered stratified depths,
importance depths at random u: ``render(..., generator=)``, or the draws
``jitter`` and ``u`` themselves, utils/draws.py).

Five CUDA kernels carry the render on the card, each wrapped here beside
its plain PyTorch version:

- K1 ``triplane_decode`` (csrc/triplane_decode.cu): triplane sample -> plane
  mean -> decoder MLP -> density filters, per sample point;
- K2 ``ray_composite`` (csrc/ray_composite.cu): stable depth merge of the
  coarse and fine samples + midpoint-quadrature composite, per ray;
- K3 ``importance_sample`` (csrc/importance_sample.cu): coarse weights ->
  smoothed pdf -> inverse-CDF depths at u = linspace(0, 1, K), or at u
  read from memory (the keyed form), per ray;
- K6 ``ess_occupancy`` and ``ess_narrow`` (csrc/ess.cu): the empty-space-
  skipping occupancy grid decoded from the factorised lattice terms
  (lattice.py), and each ray's narrowed interval with its coarse depths
  (from fixed or per-ray bounds, at jitter 0.5 or a drawn jitter).

A wrapper takes its plain version only for CPU tensors; on a CUDA tensor it
launches its kernel or raises.

Training differentiates K1 and K2: each runs inside an autograd.Function
(``TriplaneDecode``, ``RayComposite``) whose backward is a kernel too, K1's
(csrc/triplane_decode_grad.cu: the decode redone and run backward by a warp
a tile of 16 points on the tensor cores, the weight gradients formed in the
kernel, a partial a quad of warps summed in a fixed order, the plane
gradient by vector atomics, a corner of a run of points in one cell at a
time) and
K2's (``ray_composite_grad``: the merge redone, the alphas' gradient by a
reverse recurrence), each with its plain
version beside it (autograd of the plain forward). The importance depths
take no gradient (the JAX package's stop_gradient, renderer.py:563), nor do
the sample coordinates.

Deep planes (triplane_depth D > 1: planes [N,3,C*D,H,W], channel c*D + d
is feature c at depth d) take ``triplane_decode_deep`` in place of K1: K10,
the trilinear K1 form (csrc/triplane_decode.cu), samples the N*3
channels-last volumes [D,H,W,C] and runs K1's plane mean, decoder MLP and
density filters in the same kernel; its backward form
(``triplane_decode_deep_grad``, TriplaneDecodeDeep) is K1's on the
volumes. The JAX package's ESS and grid paste
occlusion fail at D > 1 (ROADMAP F12); the port refuses them there with a
NotImplementedError that names F12.

Not ported: the TPU-only ray chunking and corner packing (ROADMAP "Do not
port"). The JAX package's chunked render folds the chunk index into the
key; the port renders all rays at once and draws once.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ...kernels import KERNELS, require_no_grad
from ...kernels import build as kb
from ...ops.grid_sample import grid_sample_2d_points, grid_sample_3d_points
from ...utils import draws
from ...utils.device import constant

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
RENDER_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float64": torch.float64}


class _Softplus(torch.autograd.Function):
    """The value in jax.nn.softplus's overflow-safe form, max(x, 0) +
    log1p(e^-|x|); the derivative sigmoid(x), as jax.grad gives it,
    at 0 too (autograd of the formula takes 1 there: |x|'s subgradient 0),
    where the decoder's zero-initialised first-layer bias puts every point
    outside the planes at initialisation."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x.clamp_min(0) + torch.log1p(torch.exp(-x.abs()))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.sigmoid(x)


def softplus(x):
    """log(1 + e^x) in jax.nn.softplus's overflow-safe form (the kernels use
    the same formula), with its derivative sigmoid(x) (_Softplus)."""
    return _Softplus.apply(x)


def _acc(dtype):
    return torch.promote_types(dtype, torch.float32)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _require(cond, msg):
    if not cond:
        raise ValueError(msg)


def refuse_deep(what: str, triplane_depth: int) -> None:
    """Raise at triplane_depth > 1 for the paths the JAX package cannot run
    there (ROADMAP F12): its ESS occupancy and grid occlusion size their
    features from the planes' C*D channels, where the decoder takes C."""
    if triplane_depth != 1:
        raise NotImplementedError(
            f"{what} at triplane_depth={triplane_depth}: the JAX package fails there "
            "(ROADMAP F12: it decodes the planes' C*D channels as C), so the port refuses it; "
            "render without ESS and paste with occ_impl='render'")


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
    """[N,M,3] -> [N,3,M,3] plane-local coordinates (the inverse bases are a
    cached device constant: a copy from the host would wait for the card)."""
    inv = constant(np.linalg.inv(plane_axes).reshape(-1), coordinates.device)
    return torch.einsum("nmc,pcd->npmd", coordinates, inv.reshape(3, 3, 3).to(coordinates.dtype))


def sample_from_planes(plane_axes, plane_features, coordinates, box_warp: float,
                       triplane_depth: int = 1):
    """Triplane lookup, planes [N,3,C*D,H,W] -> [N,3,M,C] (renderer.py:68-93),
    the plain sampler of K1 and K10: bilinear at D = 1; at D > 1 trilinear
    in the volumes [C,D,H,W] at all three projected coordinates (the third
    indexes D), zeros padding."""
    N, n_planes, CD, H, W = plane_features.shape
    M = coordinates.shape[1]
    proj = project_onto_planes(plane_axes, (2.0 / box_warp) * coordinates)
    if triplane_depth == 1:
        out = grid_sample_2d_points(plane_features.reshape(N * n_planes, CD, H, W),
                                    proj[..., :2].reshape(N * n_planes, M, 2))
        return out.reshape(N, n_planes, M, CD)
    C, D = CD // triplane_depth, triplane_depth
    out = grid_sample_3d_points(plane_features.reshape(N * n_planes, C, D, H, W),
                                proj.reshape(N * n_planes, M, 3))
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
# sampling

def get_ray_limits_box(rays_o, rays_d, box_side_length):
    """Ray/AABB entry and exit distances (math_utils.py:46-98); invalid
    rays get (-1, -2). rays_o/rays_d [..., 3] -> (tmin [..., 1], tmax
    [..., 1], valid [..., 1])."""
    half = box_side_length / 2
    inv_d = 1.0 / rays_d
    t_lo = (-half - rays_o) * inv_d
    t_hi = (half - rays_o) * inv_d
    tmin = torch.minimum(t_lo, t_hi).amax(-1)
    tmax = torch.maximum(t_lo, t_hi).amin(-1)
    valid = tmin <= tmax
    tmin = torch.where(valid, tmin, torch.full_like(tmin, -1.0))
    tmax = torch.where(valid, tmax, torch.full_like(tmax, -2.0))
    return tmin[..., None], tmax[..., None], valid[..., None]


def auto_ray_limits(rays_o, rays_d, box_warp: float):
    """ray_start = ray_end = 'auto' (renderer.py:980-989): each ray's span
    through the box; an invalid ray starts at the batch's least valid start
    and ends at its greatest valid start. The fill's min and max stay on the
    device. -> (ray_start [N,R,1], ray_end [N,R,1])."""
    rs, re, valid = get_ray_limits_box(rays_o, rays_d, box_warp)
    big = torch.where(valid, rs, torch.full_like(rs, math.inf))
    small = torch.where(valid, rs, torch.full_like(rs, -math.inf))
    return torch.where(valid, rs, big.amin()), torch.where(valid, re, small.amax())


def batched_linspace(start, stop, num: int):
    """[num, *start.shape] linspace (math_utils.py:101-118), in the JAX
    package's formula start + arange(n)/(n-1) * (stop - start)."""
    steps = torch.arange(num, dtype=torch.float32, device=start.device) / (num - 1)
    steps = steps.reshape((num,) + (1,) * start.ndim)
    return start[None] + steps * (stop - start)[None]


def _jitter(jitter, shape, generator, device, what):
    """The stratified jitter: ``jitter`` [N,M,S,1] as given, a draw from
    ``generator``, else 0.5 (the midpoints of eval, key=None)."""
    if jitter is None and generator is None:
        return 0.5
    if jitter is None:
        return draws.uniform(shape, generator, device, what)
    if tuple(jitter.shape) != tuple(shape):
        raise ValueError(f"{what}: jitter must be {tuple(shape)}, got {tuple(jitter.shape)}")
    return jitter


def sample_stratified(ray_origins, ray_start, ray_end, depth_resolution: int, jitter=None,
                      generator=None, disparity_space_sampling: bool = False):
    """Stratified depths [N,M,S,1] (renderer.py:450-483) over a fixed
    interval (floats) or per-ray intervals ([N,M,1] tensors: 'auto', or
    the ESS-narrowed spans), evenly in depth or, with
    disparity_space_sampling, in inverse depth. Each stratum is offset by
    ``jitter`` [N,M,S,1] (uniform in [0, 1)) times its width: as given,
    drawn from ``generator``, else 0.5 (the midpoints of eval)."""
    N, M, _ = ray_origins.shape
    S = depth_resolution
    dev = ray_origins.device
    jitter = _jitter(jitter, (N, M, S, 1), generator, dev, "sample_stratified")
    if disparity_space_sampling:
        d = torch.linspace(0, 1, S, device=dev).reshape(1, 1, S, 1).expand(N, M, S, 1)
        d = d + jitter * (1 / (S - 1))
        return 1.0 / (1.0 / ray_start * (1.0 - d) + 1.0 / ray_end * d)
    if isinstance(ray_start, (int, float)):
        depths = torch.linspace(ray_start, ray_end, S, device=dev).reshape(1, 1, S, 1)
        depths = depths + jitter * ((ray_end - ray_start) / (S - 1))
        return depths.expand(N, M, S, 1)
    depths = batched_linspace(ray_start, ray_end, S).permute(1, 2, 0, 3)   # [N,M,S,1]
    delta = (ray_end - ray_start) / (S - 1)
    return depths + jitter * delta[..., None]


def _u(u, shape, generator, device, what):
    """The importance u [R,K]: as given, drawn from ``generator``, else
    None (linspace(0, 1, K), eval's)."""
    if u is None and generator is not None:
        return draws.uniform(shape, generator, device, what)
    if u is not None and tuple(u.shape) != tuple(shape):
        raise ValueError(f"{what}: u must be {tuple(shape)}, got {tuple(u.shape)}")
    return u


def sample_pdf(bins, weights, n_importance: int, eps: float = 1e-5, u=None, generator=None):
    """Inverse-CDF sampling (renderer.py:496-545) at ``u`` [R,K] (uniform in
    [0, 1): as given, drawn from ``generator``, else linspace(0, 1, K)).
    bins [R,B], weights [R,W] with W <= B - 1."""
    R, S = weights.shape
    weights = weights + eps
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], -1)               # [R,S+1]
    u = _u(u, (R, n_importance), generator, cdf.device, "sample_pdf")
    if u is None:
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


def sample_importance(z_vals, weights, n_importance: int, u=None, generator=None):
    """Importance depths from max-pool/avg-pool smoothed coarse weights
    (renderer.py:548-564), at ``u`` as sample_pdf takes it. z_vals
    [B,R,S,1], weights [B,R,S-1,1]."""
    B, R, S, _ = z_vals.shape
    z = z_vals.reshape(B * R, S)
    w = weights.reshape(B * R, -1)
    wpad = F.pad(w, (1, 1), value=-math.inf)
    wmax = torch.maximum(wpad[:, :-1], wpad[:, 1:])
    w = (wmax[:, :-1] + wmax[:, 1:]) / 2 + 0.01
    z_mid = 0.5 * (z[:, :-1] + z[:, 1:])
    return sample_pdf(z_mid, w[:, 1:-1], n_importance, u=u,
                      generator=generator).reshape(B, R, n_importance, 1)


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


def _decoder_f32(dec: Decoder, dev):
    """The decoder's raw parameters as contiguous f32 on ``dev``; the
    equalized-lr gains are applied in the kernels."""
    return tuple(t.to(device=dev, dtype=torch.float32).contiguous()
                 for t in (dec.w0, dec.b0, dec.w1, dec.b1))


def _filter_args(filters: DensityFilters, box_warp: float):
    """(use_crop, crop_lim, cull_mode, cull_thresh) as K1, K6 and K7 take
    them; cull_mode 0 off, 1 cull, 2 binarize."""
    crop, cull, binarize = filters
    cull_mode, thresh = (2, binarize) if binarize else ((1, cull) if cull else (0, 0.0))
    return (int(bool(crop)), (box_warp / 2 - crop) if crop else 0.0, cull_mode,
            float(thresh))


def triplane_decode_plain(planes_cl, coords, dec: Decoder, box_warp: float,
                          plane_axes, filters: DensityFilters):
    """planes_cl [N,3,H,W,C] channels-last, coords [N,M,3] ->
    (rgb [N,M,32] in the planes' dtype, filtered sigma [N,M,1]). Math in at
    least f32 (bf16 planes are upcast as they are read)."""
    acc = _acc(planes_cl.dtype)
    planes = planes_cl.to(acc).permute(0, 1, 4, 2, 3)
    rgb, sigma = osg_decode(sample_from_planes(plane_axes, planes, coords.to(acc), box_warp),
                            dec)
    sigma = _apply_density_filters(sigma, coords.to(acc), box_warp, *filters)
    return rgb.to(planes_cl.dtype), sigma


def osg_decode(feats, dec: Decoder, sigma_only: bool = False):
    """OSGDecoder on sampled features [N,P,M,C] (triplane.py:63-130): mean
    over the planes -> FC(C->64) -> softplus -> FC(64->33) -> (rgb [N,M,32],
    sigma [N,M,1]); sigma_only keeps net2's sigma row alone (rgb None), as
    the density-only consumers (ESS occupancy, occlusion volume) do."""
    acc = _acc(feats.dtype)
    x = feats.to(acc).mean(dim=1)
    C, hidden = dec.w0.shape[1], dec.w0.shape[0]
    x = x @ (dec.w0.to(acc) * (dec.lr_mul / math.sqrt(C))).T + dec.b0.to(acc) * dec.lr_mul
    x = softplus(x)
    w1, b1 = dec.w1.to(acc), dec.b1.to(acc)
    if sigma_only:
        w1, b1 = w1[0:1], b1[0:1]
    x = x @ (w1 * (dec.lr_mul / math.sqrt(hidden))).T + b1 * dec.lr_mul
    if sigma_only:
        return None, x
    rgb = torch.sigmoid(x[..., 1:])
    if not dec.force_sigmoid:
        rgb = rgb * (1 + 2 * 0.001) - 0.001        # MipNeRF sigmoid clamp
    return rgb, x[..., 0:1]


_K1_ARGS = ((kb.PTR, kb.INT) + (kb.PTR,) * 7 + (kb.INT,) * 5 + (kb.PTR,) + (kb.FLOAT,) * 4
            + (kb.INT, kb.INT, kb.FLOAT, kb.INT, kb.FLOAT, kb.PTR))


def _launch_k1(planes_cl, coords, dec: Decoder, box_warp: float, plane_axes,
               filters: DensityFilters):
    """One launch of K1 (see :func:`triplane_decode_kernel`)."""
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
    w0, b0, w1, b1 = _decoder_f32(dec, dev)
    _require(tuple(w0.shape) == (64, C) and tuple(b0.shape) == (64,)
             and tuple(w1.shape) == (33, 64) and tuple(b1.shape) == (33,),
             "K1 takes a 64-wide hidden layer and 33 outputs")
    M = coords.shape[1]
    rgb = torch.empty((N, M, 32), dtype=planes_cl.dtype, device=dev)
    sigma = torch.empty((N, M, 1), dtype=torch.float32, device=dev)
    proj = np.linalg.inv(plane_axes)[:, :, :2]                  # [plane][xyz][uv]
    kb.launch(
        "triplane_decode", _K1_ARGS, planes_cl.data_ptr(), _DTYPES[planes_cl.dtype],
        coords.data_ptr(), w0.data_ptr(), b0.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        rgb.data_ptr(), sigma.data_ptr(), N, M, H, W, C,
        kb.f32_array(proj.reshape(-1)), 2.0 / box_warp,
        dec.lr_mul / math.sqrt(C), dec.lr_mul / math.sqrt(64), dec.lr_mul,
        int(dec.force_sigmoid), *_filter_args(filters, box_warp), _stream(planes_cl),
    )
    KERNELS["triplane_decode"].launches += 1
    return rgb, sigma


def triplane_decode_grad_plain(planes_cl, coords, dec: Decoder, box_warp: float, plane_axes,
                               filters: DensityFilters, g_rgb, g_sigma):
    """The plain version of K1's backward form: autograd of
    :func:`triplane_decode_plain`, to the planes and the decoder's four
    tensors. -> (g_planes_cl, g_w0, g_b0, g_w1, g_b1)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True)
                  for t in (planes_cl, dec.w0, dec.b0, dec.w1, dec.b1)]
        rgb, sigma = triplane_decode_plain(leaves[0], coords.detach(),
                                           dec._replace(w0=leaves[1], b0=leaves[2],
                                                        w1=leaves[3], b1=leaves[4]),
                                           box_warp, plane_axes, filters)
        grads = torch.autograd.grad((rgb, sigma), leaves, (g_rgb, g_sigma), allow_unused=True)
    return tuple(torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads))


_K1G_ARGS = ((kb.PTR, kb.INT) + (kb.PTR,) * 10 + (kb.INT,) * 7 + (kb.PTR,) + (kb.FLOAT,) * 4
             + (kb.INT, kb.INT, kb.FLOAT, kb.INT, kb.FLOAT, kb.PTR))
# csrc/triplane_decode_grad.cu: warps a quad (a tile of 16 points each a
# round), resident CTAs an SM (the persistent grid), and quads a CTA by the
# planes' dtype (each quad with its own rounds and weight partial; the f32
# gather holds more registers, so fewer threads). The kernel refuses a
# quads count other than its dtype's (quads_of).
K1G_WARPS, K1G_CTAS_PER_SM = 4, 1
K1G_QUADS = {torch.bfloat16: 3, torch.float32: 2}


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def k1_grad_ctas(points: int, sms: int, quads: int) -> int:
    """The persistent grid of K1's (and K10's) backward form: a CTA an SM,
    fewer where the points' rounds (4 tiles of 16) fill fewer CTAs of
    ``quads`` quads (K1G_QUADS of the planes' dtype). The weight partials
    are a quad's: ctas x quads rows."""
    rounds = -(-points // (16 * K1G_WARPS))
    return max(1, min(K1G_CTAS_PER_SM * sms, -(-rounds // quads)))


def triplane_decode_grad_kernel(planes_cl, coords, dec: Decoder, box_warp: float, plane_axes,
                                filters: DensityFilters, g_rgb, g_sigma):
    """Launch K1's backward form on CUDA tensors: same contract as
    :func:`triplane_decode_grad_plain`. The kernel adds each corner of a
    run of points in one cell once into an f32 plane gradient (cast to the
    planes' dtype here) and forms the weight gradients itself: a partial a
    quad of warps, summed in a fixed order by its second launch."""
    N, _, H, W, C = planes_cl.shape
    M = coords.shape[1]
    dev = planes_cl.device
    _require(planes_cl.is_contiguous() and coords.is_contiguous()
             and coords.dtype == torch.float32, "K1's backward takes K1's inputs")
    _require(planes_cl.dtype in _DTYPES and C in (8, 16, 32) and planes_cl.data_ptr() % 16 == 0,
             "K1's backward takes K1's planes: f32 or bf16, 8, 16 or 32 channels, aligned")
    _require(N * 3 * (H + 2) * (W + 2) < 2 ** 31,
             "K1's backward indexes the plane cells in 32 bits")
    _require(tuple(g_rgb.shape) == (N, M, 32) and g_rgb.dtype == planes_cl.dtype
             and tuple(g_sigma.shape) == (N, M, 1),
             "K1's backward takes g_rgb [N,M,32] in the planes' dtype and g_sigma [N,M,1]")
    w0, b0, w1, b1 = _decoder_f32(dec, dev)
    g_rgb = g_rgb.contiguous()
    g_sigma = g_sigma.to(torch.float32).contiguous()
    g_planes = torch.zeros(planes_cl.shape, dtype=torch.float32, device=dev)
    quads = K1G_QUADS[planes_cl.dtype]
    ctas = k1_grad_ctas(N * M, _sm_count(dev.index), quads)
    sizes = (64 * C, 33 * 64, 64, 33)
    partials = torch.empty((ctas * quads, sum(sizes)), dtype=torch.float32, device=dev)
    g_w = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    proj = np.linalg.inv(plane_axes)[:, :, :2]
    kb.launch(
        "triplane_decode_grad", _K1G_ARGS, planes_cl.data_ptr(), _DTYPES[planes_cl.dtype],
        coords.data_ptr(), w0.data_ptr(), b0.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        g_rgb.data_ptr(), g_sigma.data_ptr(), g_planes.data_ptr(), partials.data_ptr(),
        g_w.data_ptr(), ctas, quads, N, M, H, W, C, kb.f32_array(proj.reshape(-1)),
        2.0 / box_warp, dec.lr_mul / math.sqrt(C), dec.lr_mul / math.sqrt(64), dec.lr_mul,
        int(dec.force_sigmoid), *_filter_args(filters, box_warp), _stream(planes_cl),
    )
    KERNELS["triplane_decode_grad"].launches += 1
    g_w0, g_w1, g_b0, g_b1 = g_w.split(sizes)
    return (g_planes.to(planes_cl.dtype),) + tuple(
        g.reshape(t.shape).to(t.dtype)
        for g, t in zip((g_w0, g_b0, g_w1, g_b1), (dec.w0, dec.b0, dec.w1, dec.b1)))


class TriplaneDecode(torch.autograd.Function):
    """K1 with its backward form: the forward launches K1 on CUDA tensors
    (the plain version on CPU ones); the backward gives the planes and the
    decoder's weights their gradients, by the kernel on CUDA tensors and by
    autograd of the plain version on CPU ones. ``meta`` = (lr_mul,
    force_sigmoid, box_warp, plane_axes, filters). The coordinates take
    none (the wrapper refuses coordinates that require grad)."""

    @staticmethod
    def forward(ctx, planes_cl, coords, w0, b0, w1, b1, meta):
        lr_mul, force_sigmoid, box_warp, plane_axes, filters = meta
        dec = Decoder(w0, b0, w1, b1, lr_mul, force_sigmoid)
        fn = _launch_k1 if planes_cl.is_cuda else triplane_decode_plain
        rgb, sigma = fn(planes_cl, coords, dec, box_warp, plane_axes, filters)
        ctx.save_for_backward(planes_cl, coords, w0, b0, w1, b1)
        ctx.meta = meta
        return rgb, sigma

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_rgb, g_sigma):
        planes_cl, coords, w0, b0, w1, b1 = ctx.saved_tensors
        lr_mul, force_sigmoid, box_warp, plane_axes, filters = ctx.meta
        dec = Decoder(w0, b0, w1, b1, lr_mul, force_sigmoid)
        N, M = coords.shape[:2]
        if g_rgb is None:
            g_rgb = torch.zeros((N, M, 32), dtype=planes_cl.dtype, device=planes_cl.device)
        if g_sigma is None:
            g_sigma = torch.zeros((N, M, 1), dtype=torch.float32, device=planes_cl.device)
        fn = triplane_decode_grad_kernel if planes_cl.is_cuda else triplane_decode_grad_plain
        g_planes, g_w0, g_b0, g_w1, g_b1 = fn(planes_cl, coords, dec, box_warp, plane_axes,
                                              filters, g_rgb, g_sigma)
        return g_planes, None, g_w0, g_b0, g_w1, g_b1, None


def triplane_decode_kernel(planes_cl, coords, dec: Decoder, box_warp: float,
                           plane_axes, filters: DensityFilters):
    """K1 on CUDA tensors, differentiable in the planes and the decoder's
    weights (:class:`TriplaneDecode`): same contract as
    triplane_decode_plain; rgb comes back in the planes' dtype, sigma in
    f32. Coordinates that require grad raise under grad mode."""
    require_no_grad("triplane_decode", coords)
    _require(planes_cl.is_cuda, f"K1 runs on CUDA tensors, got planes on {planes_cl.device}")
    return TriplaneDecode.apply(planes_cl, coords, dec.w0, dec.b0, dec.w1, dec.b1,
                                (dec.lr_mul, dec.force_sigmoid, box_warp, plane_axes, filters))


def triplane_decode(planes_cl, coords, dec: Decoder, box_warp: float, plane_axes,
                    filters: DensityFilters = DensityFilters()):
    if planes_cl.device.type == "cpu":
        return triplane_decode_plain(planes_cl, coords, dec, box_warp, plane_axes, filters)
    if planes_cl.device.type == "cuda":
        return triplane_decode_kernel(planes_cl, coords, dec, box_warp, plane_axes, filters)
    raise RuntimeError(f"triplane_decode: no path for device {planes_cl.device}")


# ---------------------------------------------------------------------------
# K10 triplane_decode_deep: deep planes, the trilinear K1 form

def deep_volumes_cl(planes, triplane_depth: int, dtype=None):
    """Planes [N,3,C*D,H,W] -> the N*3 channels-last volumes [N*3,D,H,W,C]
    K10 reads (channel c*D + d is feature c at depth d), in ``dtype``
    (the planes' by default); made once per set of planes."""
    N, n_planes, CD, H, W = planes.shape
    D = triplane_depth
    _require(CD % D == 0, f"{CD} plane channels do not split into depth {D}")
    vol = planes.to(dtype or planes.dtype).reshape(N * n_planes, CD // D, D, H, W)
    return vol.permute(0, 2, 3, 4, 1).contiguous()


def deep_proj(plane_axes) -> np.ndarray:
    """The inverse plane bases as K10 takes them: 27 floats [plane][xyz][uvw]."""
    return np.linalg.inv(plane_axes).reshape(-1)


def triplane_decode_deep_plain(volumes_cl, coords, dec: Decoder, box_warp: float,
                               plane_axes, filters: DensityFilters = DensityFilters()):
    """volumes_cl [N*3,D,H,W,C] (deep_volumes_cl), coords [N,M,3] -> (rgb
    [N,M,32] in the volumes' dtype, filtered sigma [N,M,1]): the trilinear
    sample_from_planes, osg_decode and the filters. Math in at least f32
    (bf16 volumes are upcast as they are read), as K1's plain version."""
    acc = _acc(volumes_cl.dtype)
    NP, D, H, W, C = volumes_cl.shape
    N = coords.shape[0]
    planes = volumes_cl.to(acc).permute(0, 4, 1, 2, 3).reshape(N, NP // N, C * D, H, W)
    rgb, sigma = osg_decode(sample_from_planes(plane_axes, planes, coords.to(acc), box_warp, D),
                            dec)
    sigma = _apply_density_filters(sigma, coords.to(acc), box_warp, *filters)
    return rgb.to(volumes_cl.dtype), sigma


_K10_ARGS = ((kb.PTR, kb.INT) + (kb.PTR,) * 7 + (kb.INT,) * 6 + (kb.PTR,) + (kb.FLOAT,) * 4
             + (kb.INT, kb.INT, kb.FLOAT, kb.INT, kb.FLOAT, kb.PTR))


def _launch_k10(volumes_cl, coords, dec: Decoder, box_warp: float, plane_axes,
                filters: DensityFilters = DensityFilters()):
    """One launch of K10 (see :func:`triplane_decode_deep_kernel`)."""
    _require(volumes_cl.dtype in _DTYPES,
             f"K10 volumes must be f32 or bf16, got {volumes_cl.dtype}")
    _require(coords.dtype == torch.float32 and coords.is_contiguous() and coords.ndim == 3
             and coords.shape[2] == 3, "K10 coords must be contiguous f32 [N,M,3]")
    N, M = coords.shape[:2]
    _require(volumes_cl.ndim == 5 and volumes_cl.shape[0] == 3 * N,
             "K10 volumes must be [N*3,D,H,W,C] for coords [N,M,3]")
    _, D, H, W, C = volumes_cl.shape
    _require(C in (8, 16, 32), f"K10 supports 8, 16 or 32 plane channels, got {C}")
    _require(volumes_cl.is_contiguous() and volumes_cl.data_ptr() % 16 == 0,
             "K10 volumes must be contiguous and 16-byte aligned")
    dev = volumes_cl.device
    _require(coords.device == dev, "K10 inputs must share a device")
    w0, b0, w1, b1 = _decoder_f32(dec, dev)
    _require(tuple(w0.shape) == (64, C) and tuple(b0.shape) == (64,)
             and tuple(w1.shape) == (33, 64) and tuple(b1.shape) == (33,),
             "K10 takes a 64-wide hidden layer and 33 outputs")
    rgb = torch.empty((N, M, 32), dtype=volumes_cl.dtype, device=dev)
    sigma = torch.empty((N, M, 1), dtype=torch.float32, device=dev)
    kb.launch(
        "triplane_decode_deep", _K10_ARGS, volumes_cl.data_ptr(), _DTYPES[volumes_cl.dtype],
        coords.data_ptr(), w0.data_ptr(), b0.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        rgb.data_ptr(), sigma.data_ptr(), N, M, D, H, W, C,
        kb.f32_array(deep_proj(plane_axes)), 2.0 / box_warp,
        dec.lr_mul / math.sqrt(C), dec.lr_mul / math.sqrt(64), dec.lr_mul,
        int(dec.force_sigmoid), *_filter_args(filters, box_warp), _stream(volumes_cl),
    )
    KERNELS["triplane_decode_deep"].launches += 1
    return rgb, sigma


def triplane_decode_deep_grad_plain(volumes_cl, coords, dec: Decoder, box_warp: float,
                                    plane_axes, filters: DensityFilters, g_rgb, g_sigma):
    """The plain version of K10's backward form: autograd of
    :func:`triplane_decode_deep_plain`, to the volumes and the decoder's
    four tensors. -> (g_volumes_cl, g_w0, g_b0, g_w1, g_b1)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True)
                  for t in (volumes_cl, dec.w0, dec.b0, dec.w1, dec.b1)]
        rgb, sigma = triplane_decode_deep_plain(leaves[0], coords.detach(),
                                                dec._replace(w0=leaves[1], b0=leaves[2],
                                                             w1=leaves[3], b1=leaves[4]),
                                                box_warp, plane_axes, filters)
        grads = torch.autograd.grad((rgb, sigma), leaves, (g_rgb, g_sigma), allow_unused=True)
    return tuple(torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads))


_K10G_ARGS = ((kb.PTR, kb.INT) + (kb.PTR,) * 10 + (kb.INT,) * 8 + (kb.PTR,) + (kb.FLOAT,) * 4
              + (kb.INT, kb.INT, kb.FLOAT, kb.INT, kb.FLOAT, kb.PTR))


def triplane_decode_deep_grad_kernel(volumes_cl, coords, dec: Decoder, box_warp: float,
                                     plane_axes, filters: DensityFilters, g_rgb, g_sigma):
    """Launch K10's backward form on CUDA tensors: same contract as
    :func:`triplane_decode_deep_grad_plain`. K1's backward form on the deep
    volumes (csrc/triplane_decode_grad.cu, DEEP): the decode again and its
    backward in 3xTF32, each 3-D cell's run of points added once into its 8
    corners of an f32 volume gradient (cast to the volumes' dtype here),
    the weight gradients as quads' partials summed in a fixed order."""
    NP, D, H, W, C = volumes_cl.shape
    N, M = coords.shape[:2]
    dev = volumes_cl.device
    _require(volumes_cl.is_contiguous() and coords.is_contiguous() and NP == 3 * N
             and coords.dtype == torch.float32, "K10's backward takes K10's inputs")
    _require(volumes_cl.dtype in _DTYPES and C in (8, 16, 32)
             and volumes_cl.data_ptr() % 16 == 0,
             "K10's backward takes K10's volumes: f32 or bf16, 8, 16 or 32 channels, aligned")
    _require(N * 3 * (D + 2) * (H + 2) * (W + 2) < 2 ** 31,
             "K10's backward indexes the volume cells in 32 bits")
    _require(tuple(g_rgb.shape) == (N, M, 32) and g_rgb.dtype == volumes_cl.dtype
             and tuple(g_sigma.shape) == (N, M, 1),
             "K10's backward takes g_rgb [N,M,32] in the volumes' dtype and g_sigma [N,M,1]")
    w0, b0, w1, b1 = _decoder_f32(dec, dev)
    g_rgb = g_rgb.contiguous()
    g_sigma = g_sigma.to(torch.float32).contiguous()
    g_vols = torch.zeros(volumes_cl.shape, dtype=torch.float32, device=dev)
    quads = K1G_QUADS[volumes_cl.dtype]
    ctas = k1_grad_ctas(N * M, _sm_count(dev.index), quads)
    sizes = (64 * C, 33 * 64, 64, 33)
    partials = torch.empty((ctas * quads, sum(sizes)), dtype=torch.float32, device=dev)
    g_w = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    kb.launch(
        "triplane_decode_deep_grad", _K10G_ARGS, volumes_cl.data_ptr(),
        _DTYPES[volumes_cl.dtype], coords.data_ptr(), w0.data_ptr(), b0.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), g_rgb.data_ptr(), g_sigma.data_ptr(), g_vols.data_ptr(),
        partials.data_ptr(), g_w.data_ptr(), ctas, quads, N, M, D, H, W, C,
        kb.f32_array(deep_proj(plane_axes)), 2.0 / box_warp, dec.lr_mul / math.sqrt(C),
        dec.lr_mul / math.sqrt(64), dec.lr_mul, int(dec.force_sigmoid),
        *_filter_args(filters, box_warp), _stream(volumes_cl),
    )
    KERNELS["triplane_decode_deep_grad"].launches += 1
    g_w0, g_w1, g_b0, g_b1 = g_w.split(sizes)
    return (g_vols.to(volumes_cl.dtype),) + tuple(
        g.reshape(t.shape).to(t.dtype)
        for g, t in zip((g_w0, g_b0, g_w1, g_b1), (dec.w0, dec.b0, dec.w1, dec.b1)))


class TriplaneDecodeDeep(torch.autograd.Function):
    """K10 with its backward form, as :class:`TriplaneDecode` is K1 with
    its: the forward launches K10 on CUDA tensors (the plain version on CPU
    ones); the backward gives the deep volumes [N*3,D,H,W,C] and the
    decoder's weights their gradients, by the kernel on CUDA tensors and by
    autograd of the plain version on CPU ones (the volumes' gradient reaches
    the planes through deep_volumes_cl's permute). ``meta`` = (lr_mul,
    force_sigmoid, box_warp, plane_axes, filters). The coordinates take
    none."""

    @staticmethod
    def forward(ctx, volumes_cl, coords, w0, b0, w1, b1, meta):
        lr_mul, force_sigmoid, box_warp, plane_axes, filters = meta
        dec = Decoder(w0, b0, w1, b1, lr_mul, force_sigmoid)
        fn = _launch_k10 if volumes_cl.is_cuda else triplane_decode_deep_plain
        rgb, sigma = fn(volumes_cl, coords, dec, box_warp, plane_axes, filters)
        ctx.save_for_backward(volumes_cl, coords, w0, b0, w1, b1)
        ctx.meta = meta
        return rgb, sigma

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_rgb, g_sigma):
        volumes_cl, coords, w0, b0, w1, b1 = ctx.saved_tensors
        lr_mul, force_sigmoid, box_warp, plane_axes, filters = ctx.meta
        dec = Decoder(w0, b0, w1, b1, lr_mul, force_sigmoid)
        N, M = coords.shape[:2]
        if g_rgb is None:
            g_rgb = torch.zeros((N, M, 32), dtype=volumes_cl.dtype, device=volumes_cl.device)
        if g_sigma is None:
            g_sigma = torch.zeros((N, M, 1), dtype=torch.float32, device=volumes_cl.device)
        fn = (triplane_decode_deep_grad_kernel if volumes_cl.is_cuda
              else triplane_decode_deep_grad_plain)
        g_vols, g_w0, g_b0, g_w1, g_b1 = fn(volumes_cl, coords, dec, box_warp, plane_axes,
                                            filters, g_rgb, g_sigma)
        return g_vols, None, g_w0, g_b0, g_w1, g_b1, None


def triplane_decode_deep_kernel(volumes_cl, coords, dec: Decoder, box_warp: float,
                                plane_axes, filters: DensityFilters = DensityFilters()):
    """K10 on CUDA tensors, differentiable in the volumes and the decoder's
    weights (:class:`TriplaneDecodeDeep`): same contract as
    triplane_decode_deep_plain; rgb in the volumes' dtype, sigma in f32.
    Coordinates that require grad raise under grad mode."""
    require_no_grad("triplane_decode_deep", coords)
    _require(volumes_cl.is_cuda, f"K10 runs on CUDA tensors, got volumes on {volumes_cl.device}")
    return TriplaneDecodeDeep.apply(volumes_cl, coords, dec.w0, dec.b0, dec.w1, dec.b1,
                                    (dec.lr_mul, dec.force_sigmoid, box_warp, plane_axes,
                                     filters))


def triplane_decode_deep(volumes_cl, coords, dec: Decoder, box_warp: float, plane_axes,
                         filters: DensityFilters = DensityFilters()):
    """The decode of deep planes, with triplane_decode's contract: the plain
    version on CPU tensors, K10 on CUDA tensors."""
    if volumes_cl.device.type == "cpu":
        return triplane_decode_deep_plain(volumes_cl, coords, dec, box_warp, plane_axes,
                                          filters)
    if volumes_cl.device.type == "cuda":
        return triplane_decode_deep_kernel(volumes_cl, coords, dec, box_warp, plane_axes,
                                           filters)
    raise RuntimeError(f"triplane_decode_deep: no path for device {volumes_cl.device}")


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


@functools.lru_cache(maxsize=None)
def _k2_scratch(dev, stream: int):
    """K2's global depth range and block counter for launches on ``stream``
    (a CUDA stream handle) of ``dev``, made once: (+inf, -inf) and a zero
    counter, as every launch leaves them (the last block of a launch resets
    them). Launches on one stream run in order, so they may share it; each
    stream, and so each CUDA graph captured on its own stream, has its own."""
    buf = torch.zeros((4,), dtype=torch.float32, device=dev)
    buf[0] = math.inf
    buf[1] = -math.inf
    return buf


def _launch_k2(d1, c1, s1, x1, d2, c2, s2, x2, white_back: bool):
    """One launch of K2 (see :func:`ray_composite_kernel`) -> (comp
    [B,R,C+3], depth, wsum)."""
    B, R, S1, C = c1.shape
    S2 = c2.shape[2]
    _require(c1.dtype in _DTYPES and c2.dtype == c1.dtype, "K2 colors must be f32 or bf16")
    for t, ch, s in ((d1, 1, S1), (s1, 1, S1), (x1, 3, S1), (c1, C, S1),
                     (d2, 1, S2), (s2, 1, S2), (x2, 3, S2), (c2, C, S2)):
        _require(tuple(t.shape) == (B, R, s, ch) and t.is_contiguous()
                 and t.device == c1.device, f"K2 input of shape {tuple(t.shape)}")
        _require(t is c1 or t is c2 or t.dtype == torch.float32,
                 "K2 depths, sigmas and xyz must be f32")
    _require(S1 >= 1 and S1 + S2 <= 1024, "K2 takes 1 to 1024 samples per ray, coarse first")
    lanes = C * c1.element_size() // 16       # lanes per 16-byte row chunk
    _require(C * c1.element_size() % 16 == 0 and lanes in (1, 2, 4, 8, 16, 32)
             and c1.data_ptr() % 16 == 0 and c2.data_ptr() % 16 == 0,
             f"K2 takes 16-byte aligned color rows of 16 to 512 bytes (a power of two), got C={C}")
    dev = c1.device
    comp = torch.empty((B, R, C + 3), dtype=torch.float32, device=dev)
    depth = torch.empty((B, R, 1), dtype=torch.float32, device=dev)
    wsum = torch.empty((B, R, 1), dtype=torch.float32, device=dev)
    if S2 == 0:     # no importance pass: the second half is never read
        d2, c2, s2, x2 = d1, c1, s1, x1
    kb.launch(
        "ray_composite", _K2_ARGS, d1.data_ptr(), c1.data_ptr(), s1.data_ptr(),
        x1.data_ptr(), d2.data_ptr(), c2.data_ptr(), s2.data_ptr(), x2.data_ptr(),
        _DTYPES[c1.dtype], comp.data_ptr(), depth.data_ptr(), wsum.data_ptr(),
        _k2_scratch(dev, _stream(c1)).data_ptr(), B * R, S1, S2, C, int(white_back), _stream(c1),
    )
    KERNELS["ray_composite"].launches += 1
    return comp, depth, wsum


def ray_composite_grad_plain(d1, c1, s1, x1, d2, c2, s2, x2, white_back: bool, depth,
                             g_comp, g_depth, g_wsum):
    """The plain version of K2's backward form: autograd of
    :func:`ray_composite_plain` to the colours and sigmas of both halves.
    ``depth`` (the forward's output) is not needed here; g_comp is the
    gradient of (colours | xyz). -> (g_c1, g_s1, g_c2, g_s2)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (c1, s1, c2, s2)]
        rgb, dep, wsum, xyz = ray_composite_plain(d1, leaves[0], leaves[1], x1, d2, leaves[2],
                                                  leaves[3], x2, white_back)
        grads = torch.autograd.grad((torch.cat([rgb, xyz], -1), dep, wsum), leaves,
                                    (g_comp, g_depth, g_wsum), allow_unused=True)
    return tuple(torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads))


_K2G_ARGS = (kb.PTR,) * 8 + (kb.INT,) + (kb.PTR,) * 8 + (kb.INT,) * 5 + (kb.PTR,)


def ray_composite_grad_kernel(d1, c1, s1, x1, d2, c2, s2, x2, white_back: bool, depth,
                              g_comp, g_depth, g_wsum):
    """Launch K2's backward form on CUDA tensors (K2's inputs, its clipped
    depth output and its outputs' gradients): same contract as
    :func:`ray_composite_grad_plain`."""
    B, R, S1, C = c1.shape
    S2 = c2.shape[2]
    _require(S2 >= 1, "K2's backward needs an importance pass (S2 >= 1)")
    dev = c1.device
    g_comp = g_comp.to(torch.float32).contiguous()
    g_depth = g_depth.to(torch.float32).contiguous()
    g_wsum = g_wsum.to(torch.float32).contiguous()
    g_c1, g_c2 = torch.empty_like(c1), torch.empty_like(c2)
    g_s1 = torch.empty(s1.shape, dtype=torch.float32, device=dev)
    g_s2 = torch.empty(s2.shape, dtype=torch.float32, device=dev)
    kb.launch(
        "ray_composite_grad", _K2G_ARGS, d1.data_ptr(), c1.data_ptr(), s1.data_ptr(),
        x1.data_ptr(), d2.data_ptr(), c2.data_ptr(), s2.data_ptr(), x2.data_ptr(),
        _DTYPES[c1.dtype], depth.data_ptr(), g_comp.data_ptr(), g_depth.data_ptr(),
        g_wsum.data_ptr(), g_c1.data_ptr(), g_s1.data_ptr(), g_c2.data_ptr(), g_s2.data_ptr(),
        B * R, S1, S2, C, int(white_back), _stream(c1),
    )
    KERNELS["ray_composite_grad"].launches += 1
    return g_c1, g_s1, g_c2, g_s2


class RayComposite(torch.autograd.Function):
    """K2 with its backward form: the forward launches K2 on CUDA tensors
    (the plain version on CPU ones) -> (comp [B,R,C+3] colours | xyz,
    depth, wsum); the backward gives the colours and sigmas of both halves
    their gradients, by the kernel on CUDA tensors and by autograd of the
    plain version on CPU ones. Depths and xyz take none (the wrapper
    refuses them under grad mode)."""

    @staticmethod
    def forward(ctx, d1, c1, s1, x1, d2, c2, s2, x2, white_back):
        if c1.is_cuda:
            comp, depth, wsum = _launch_k2(d1, c1, s1, x1, d2, c2, s2, x2, white_back)
        else:
            rgb, depth, wsum, xyz = ray_composite_plain(d1, c1, s1, x1, d2, c2, s2, x2,
                                                        white_back)
            comp = torch.cat([rgb, xyz], -1)
        ctx.save_for_backward(d1, c1, s1, x1, d2, c2, s2, x2, depth)
        ctx.white_back = white_back
        return comp, depth, wsum

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_comp, g_depth, g_wsum):
        d1, c1, s1, x1, d2, c2, s2, x2, depth = ctx.saved_tensors
        B, R = c1.shape[:2]
        zeros = functools.partial(torch.zeros, dtype=torch.float32, device=c1.device)
        g_comp = zeros((B, R, c1.shape[-1] + 3)) if g_comp is None else g_comp
        g_depth = zeros((B, R, 1)) if g_depth is None else g_depth
        g_wsum = zeros((B, R, 1)) if g_wsum is None else g_wsum
        fn = ray_composite_grad_kernel if c1.is_cuda else ray_composite_grad_plain
        g_c1, g_s1, g_c2, g_s2 = fn(d1, c1, s1, x1, d2, c2, s2, x2, ctx.white_back, depth,
                                    g_comp, g_depth, g_wsum)
        return None, g_c1, g_s1, None, None, g_c2, g_s2, None, None


def ray_composite_kernel(d1, c1, s1, x1, d2, c2, s2, x2, white_back: bool):
    """K2 on CUDA tensors, differentiable in the colours and sigmas
    (:class:`RayComposite`): same contract as ray_composite_plain. Depths
    and xyz that require grad raise under grad mode."""
    require_no_grad("ray_composite", d1, x1, d2, x2)
    _require(c1.is_cuda, f"K2 runs on CUDA tensors, got colours on {c1.device}")
    comp, depth, wsum = RayComposite.apply(d1, c1, s1, x1, d2, c2, s2, x2, white_back)
    return comp[..., :-3], depth, wsum, comp[..., -3:]


def ray_composite(d1, c1, s1, x1, d2, c2, s2, x2, white_back: bool):
    if c1.device.type == "cpu":
        return ray_composite_plain(d1, c1, s1, x1, d2, c2, s2, x2, white_back)
    if c1.device.type == "cuda":
        return ray_composite_kernel(d1, c1, s1, x1, d2, c2, s2, x2, white_back)
    raise RuntimeError(f"ray_composite: no path for device {c1.device}")


# ---------------------------------------------------------------------------
# K3 importance_sample

def importance_sample_plain(depths, sigmas, n_importance: int, u=None):
    """Coarse depths/sigmas [B,R,S,1] -> importance depths [B,R,K,1], at
    u = linspace(0, 1, K), or at ``u`` [B*R,K] (the keyed form)."""
    return sample_importance(depths, _march_weights(sigmas, depths), n_importance, u=u)


def importance_sample_warp_order(depths, sigmas, n_importance: int, u=None):
    """K3's order of operations (csrc/importance_sample.cu) in PyTorch, for
    the tests. A ray has L lanes (16 at S = 48, else 32), lane l holding
    samples l npl .. l npl + npl - 1 (npl = ceil(S / L)); the transmittance
    and the cdf are Kogge-Stone scans of the lanes' products and sums
    (log2 L shuffles up), continued in order through each lane's own terms;
    the pdf's sum is each lane's sum, then a butterfly; each u is resolved
    by a binary search of fixed steps; ``u`` [B*R,K] read from memory in
    place of linspace(0, 1, K). depths/sigmas [B,R,S,1] -> (fine depths
    [B,R,K,1], the search's cdf index [B*R,K], the count of cdf entries <=
    u [B*R,K])."""
    B, R, S, _ = depths.shape
    K, eps = n_importance, 1e-5
    L = 16 if S == 48 else 32
    N, npl = B * R, -(-S // L)
    W = L * npl
    dev = depths.device
    z = F.pad(depths.reshape(N, S).float(), (0, W - S)).reshape(N, L, npl)
    sg = F.pad(sigmas.reshape(N, S).float(), (0, W - S)).reshape(N, L, npl)
    idx = torch.arange(W, device=dev).reshape(L, npl)
    lane = torch.arange(L, device=dev)

    def shfl_down(x, d):   # lane l takes lane l + d's value, its own past the last
        return torch.cat([x[:, d:], x[:, L - d:]], 1)

    def shfl_up(x, d):     # lane l takes lane l - d's value, its own below lane d
        return torch.cat([x[:, :d], x[:, :L - d]], 1)

    def scan(x, mul):      # inclusive Kogge-Stone scan over the lanes
        d = 1
        while d < L:
            o = shfl_up(x, d)
            x = torch.where(lane >= d, x * o if mul else x + o, x)
            d *= 2
        return x

    def in_order(x, init, mul):   # x [N,L,npl] folded in order from init [N,L]
        out, acc = [], init
        for j in range(npl):
            acc = acc * x[..., j] if mul else acc + x[..., j]
            out.append(acc)
        return torch.stack(out, -1)

    z1 = torch.cat([z[..., 1:], shfl_down(z[..., 0], 1)[..., None]], -1)
    s1 = torch.cat([sg[..., 1:], shfl_down(sg[..., 0], 1)[..., None]], -1)
    live = idx < S - 1
    dens = softplus((sg + s1) / 2 - 1)
    alpha = torch.where(live, 1 - torch.exp(-(dens * (z1 - z))), torch.zeros_like(z))
    f = torch.where(live, 1 - alpha + 1e-10, torch.ones_like(z))
    prod = in_order(f, torch.ones_like(z[..., 0]), True)[..., -1]
    t_excl = shfl_up(scan(prod, True), 1)
    t_excl[:, 0] = 1.0
    trans = torch.cat([t_excl[..., None], in_order(f, t_excl, True)[..., :-1]], -1)
    w = alpha * trans

    Sw = S - 3
    w_n1 = shfl_down(w[..., 1], 1) if npl >= 2 else shfl_down(w[..., 0], 2)
    wext = torch.cat([w, shfl_down(w[..., 0], 1)[..., None], w_n1[..., None]], -1)
    wa, wb, wc = wext[..., :npl], wext[..., 1:npl + 1], wext[..., 2:npl + 2]
    p = ((torch.maximum(wa, wb) + torch.maximum(wb, wc)) / 2 + 0.01) + eps
    p = torch.where(idx < Sw, p, torch.zeros_like(p))
    total = in_order(p, torch.zeros_like(z[..., 0]), False)[..., -1]
    m = L // 2
    while m > 0:
        total = total + total[:, lane ^ m]
        m //= 2
    q = p / total[..., None]
    c_excl = shfl_up(scan(in_order(q, torch.zeros_like(total), False)[..., -1], False), 1)
    c_excl[:, 0] = 0.0
    cdf = in_order(q, c_excl, False).reshape(N, W)[:, :Sw]
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], 1)                # [N, Sw+1]
    bins = (0.5 * (z + z1)).reshape(N, W)[:, :S - 1]

    if u is None:
        u = torch.linspace(0, 1, K, device=dev).expand(N, K).contiguous()
    n = torch.zeros((N, K), dtype=torch.long, device=dev)   # cdf[:n] <= u < cdf[n]
    h = 1                     # the largest power of 2 <= Sw + 1, halved each step
    while h * 2 <= Sw + 1:
        h *= 2
    while h > 0:
        le = cdf.gather(1, (n + h - 1).clamp_max(Sw)) <= u
        n = torch.where((n + h <= Sw + 1) & le, n + h, n)
        h //= 2
    below, above = (n - 1).clamp_min(0), n.clamp_max(Sw)
    c_lo, c_hi = cdf.gather(1, below), cdf.gather(1, above)
    b_lo, b_hi = bins.gather(1, below), bins.gather(1, above)
    denom = c_hi - c_lo
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    out = (b_lo + (u - c_lo) / denom * (b_hi - b_lo)).reshape(B, R, K, 1)
    return out, n, (cdf[:, None, :] <= u[:, :, None]).sum(-1)


_K3_ARGS = (kb.PTR, kb.PTR, kb.PTR, kb.PTR, kb.INT, kb.INT, kb.INT, kb.PTR)


def importance_sample_kernel(depths, sigmas, n_importance: int, u=None):
    """Launch K3 on CUDA tensors: same contract as importance_sample_plain.
    With ``u`` (contiguous f32 [B*R,K]) it runs the form that reads u
    (counted as the variant ``u``)."""
    require_no_grad("importance_sample", depths, sigmas, u)
    B, R, S, _ = depths.shape
    for t in (depths, sigmas):
        _require(t.dtype == torch.float32 and t.is_contiguous()
                 and tuple(t.shape) == (B, R, S, 1) and t.device == depths.device,
                 "K3 takes contiguous f32 [B,R,S,1] depths and sigmas")
    _require(4 <= S <= 256 and n_importance >= 1, f"K3 takes 4..256 coarse samples, got {S}")
    _require(u is None or (u.dtype == torch.float32 and u.is_contiguous()
                           and tuple(u.shape) == (B * R, n_importance)
                           and u.device == depths.device),
             "K3's u must be contiguous f32 [B*R,K] on the depths' device")
    out = torch.empty((B, R, n_importance, 1), dtype=torch.float32, device=depths.device)
    kb.launch("importance_sample", _K3_ARGS, depths.data_ptr(), sigmas.data_ptr(),
              u.data_ptr() if u is not None else None, out.data_ptr(), B * R, S,
              n_importance, _stream(depths))
    k = KERNELS["importance_sample"]
    k.launches += 1
    if u is not None:
        k.variants["u"] = k.variants.get("u", 0) + 1
    return out


def importance_sample(depths, sigmas, n_importance: int, u=None):
    if depths.device.type == "cpu":
        return importance_sample_plain(depths, sigmas, n_importance, u)
    if depths.device.type == "cuda":
        return importance_sample_kernel(depths, sigmas, n_importance, u)
    raise RuntimeError(f"importance_sample: no path for device {depths.device}")


# ---------------------------------------------------------------------------
# empty-space skipping (renderer.py:275-440): a conservative occupancy grid
# decoded once per set of planes narrows each ray's interval to its
# occupied span, so 48+48 samples do the work of 96+96

def zero_feature_density(planes, dec: Decoder, cull_clouds, binarize_clouds):
    """Filtered density of the zero-feature decode (what a point outside
    the box sees), a 0-d f32 tensor (renderer.py:275). triplane_crop is not
    applied (it needs a position): conservative. ``planes`` [N,3,C,H,W]
    gives only the device and the channel count, which must be the
    decoder's (at triplane_depth > 1 it is C*D: F12)."""
    C, n_planes = planes.shape[2], planes.shape[1]
    refuse_deep("zero_feature_density", C // dec.w0.shape[1])
    _, sigma0 = osg_decode(torch.zeros((1, n_planes, 1, C), device=planes.device), dec,
                           sigma_only=True)
    sigma0 = sigma0.float()
    density0 = softplus(sigma0 - 1)
    if binarize_clouds:
        density0 = torch.where(cull_clouds_mask(sigma0, binarize_clouds),
                               torch.zeros_like(density0), torch.full_like(density0, math.inf))
    elif cull_clouds:
        density0 = torch.where(cull_clouds_mask(sigma0, cull_clouds),
                               torch.zeros_like(density0), density0)
    return density0.reshape(-1)[0]


def ess_occupancy_plain(terms, dec: Decoder, box_warp: float, grid: int, supersample: int,
                        thresh: float, filters: DensityFilters):
    """The occupancy of renderer.py:303 from the factorised lattice terms
    (lattice.lattice_features on a (grid*supersample)^3 lattice): the
    plane-mean decode (sigma only), the density filters at the cell centres,
    softplus(sigma-1) > thresh, the supersample max-pool and the 3^3
    dilation -> occ [N,G,G,G] f32 0/1."""
    from . import lattice as vlat

    Gs = grid * supersample
    N = terms[0][0].shape[0]
    sigma = vlat.decode_lattice_terms(
        terms, lambda f: osg_decode(f, dec, sigma_only=True), (Gs, Gs, Gs),
        plane_reduce="mean").reshape(N, -1, 1)
    coords = vlat.lattice_world_coords((Gs, Gs, Gs), box_warp, sigma.device)
    sigma = _apply_density_filters(sigma, coords.reshape(1, -1, 3).expand(N, -1, 3),
                                   box_warp, *filters)
    density = softplus(sigma.float() - 1).reshape(N, 1, Gs, Gs, Gs)
    occ = F.max_pool3d((density > thresh).to(torch.float32), supersample, supersample)
    # SAME padding adds 0 in the JAX op; the window always holds its centre,
    # so max_pool3d's -inf padding gives the same grid
    return F.max_pool3d(occ, 3, 1, 1)[:, 0]


def lattice_term_args(terms, dev):
    """Kernel arguments of the three factorised terms: per term an f32
    [N,Ga,Gb,C] pointer, its two world axes and its strides over N, Ga and
    Gb. The kernels read a row's channels as float4s: a term whose channels
    are not contiguous, or whose rows are not 16-byte aligned, is copied
    (lattice_features' einsum gives permuted views that need no copy)."""
    out, keep = [], []
    for F_, aa, ab in terms:
        _require(F_.device == dev and F_.dtype == torch.float32 and F_.ndim == 4,
                 "lattice terms must be f32 [N,Ga,Gb,C] on the kernel's device")
        if not (F_.stride(3) == 1 and F_.data_ptr() % 16 == 0
                and all(st % 4 == 0 for st in F_.stride()[:3])):
            F_ = F_.contiguous()
        keep.append(F_)
        out += [F_.data_ptr(), int(aa), int(ab), *F_.stride()[:3]]
    return out, keep


_K6A_ARGS = ((kb.PTR, kb.INT, kb.INT, kb.LONG, kb.LONG, kb.LONG) * 3 + (kb.PTR,) * 7
             + (kb.INT,) * 4 + (kb.DOUBLE,) + (kb.FLOAT,) * 4
             + (kb.INT, kb.FLOAT, kb.INT, kb.FLOAT, kb.PTR))


def ess_occupancy_kernel(terms, dec: Decoder, box_warp: float, grid: int, supersample: int,
                         thresh: float, filters: DensityFilters):
    """Launch K6's occupancy on CUDA tensors: same contract as
    ess_occupancy_plain. The factored first layer P (64 f32 a term cell,
    lattice_decode.cuh) is scratch of this call's stream."""
    require_no_grad("ess_occupancy", terms, dec)
    dev = terms[0][0].device
    N, C = terms[0][0].shape[0], terms[0][0].shape[-1]
    Gs = grid * supersample
    _require(supersample in (1, 2), f"K6 takes supersample 1 or 2, got {supersample}")
    _require(C in (8, 16, 32), f"K6 supports 8, 16 or 32 plane channels, got {C}")
    for F_, aa, ab in terms:
        _require(tuple(F_.shape) == (N, Gs, Gs, C), "K6 terms must be [N,Gs,Gs,C]")
    axes = [(int(aa), int(ab)) for _, aa, ab in terms]
    _require((0, 1) in axes[:2] and sorted(axes)[1:] in ([(0, 2), (0, 2)], [(0, 2), (1, 2)]),
             f"K6 takes an (x, y) term among the first two and two (x or y, z) terms, "
             f"got axes {axes}")
    targs, keep = lattice_term_args(terms, dev)
    w0, b0, w1, b1 = _decoder_f32(dec, dev)
    _require(tuple(w0.shape) == (64, C) and tuple(w1.shape) == (33, 64),
             "K6 takes a 64-wide hidden layer")
    pooled = torch.empty((N, grid, grid, grid), dtype=torch.float32, device=dev)
    occ = torch.empty_like(pooled)
    P = torch.empty((3, N, Gs, Gs, 64), dtype=torch.float32, device=dev)
    kb.launch(
        "ess_occupancy", _K6A_ARGS, *targs, w0.data_ptr(), b0.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), pooled.data_ptr(), occ.data_ptr(), P.data_ptr(), N, grid, supersample, C,
        float(box_warp), float(thresh), dec.lr_mul / math.sqrt(C),
        dec.lr_mul / math.sqrt(64), dec.lr_mul, *_filter_args(filters, box_warp),
        _stream(occ))
    KERNELS["ess_occupancy"].launches += 1
    del keep
    return occ


def ess_occupancy_grid(terms, dec: Decoder, box_warp: float, grid: int, supersample: int,
                       thresh: float, filters: DensityFilters):
    dev = terms[0][0].device
    if dev.type == "cpu":
        return ess_occupancy_plain(terms, dec, box_warp, grid, supersample, thresh, filters)
    if dev.type == "cuda":
        return ess_occupancy_kernel(terms, dec, box_warp, grid, supersample, thresh, filters)
    raise RuntimeError(f"ess_occupancy: no path for device {dev}")


def ess_occupancy(plane_axes, planes, dec: Decoder, box_warp: float, options: dict,
                  filters: DensityFilters = DensityFilters()):
    """Conservative occupancy for empty-space skipping (renderer.py:303):
    the planes resampled onto a (grid*supersample)^3 cell-centre lattice
    (two small matmuls per plane, lattice.lattice_features), then K6.
    Always from the raw planes in f32, so every call path yields the same
    occupancy. -> (occ [N,G,G,G] f32 0/1, occ_outside 0-d f32 0/1)."""
    from . import lattice as vlat

    refuse_deep("ess_occupancy", options.get("triplane_depth", 1))
    ess = options["ess"]
    G, ss = int(ess.get("grid", 32)), int(ess.get("supersample", 2))
    thresh = float(ess.get("thresh", 0.01))
    _require(planes.ndim == 5, "ess_occupancy needs raw [N,3,C,H,W] planes")
    with torch.no_grad():
        terms = vlat.lattice_features(planes.float(), plane_axes, (G * ss,) * 3, box_warp)
        occ = ess_occupancy_grid(terms, dec, box_warp, G, ss, thresh, filters)
        density0 = zero_feature_density(planes, dec, filters.cull_clouds,
                                        filters.binarize_clouds)
    return occ, (density0 > thresh).to(torch.float32)


def _scalar_bounds(ray_start, ray_end) -> bool:
    return isinstance(ray_start, (int, float)) and isinstance(ray_end, (int, float))


def _narrow_check(ray_start, ray_end, box_warp, G, K):
    """The no-step-over invariant (renderer.py:394-410): the tap spacing
    must not exceed the occupancy cell; the interval is the configured span
    for fixed bounds, else the box's diagonal."""
    if _scalar_bounds(ray_start, ray_end):
        max_len = float(ray_end) - float(ray_start)
    else:
        max_len = float(np.sqrt(3.0)) * box_warp
    if max_len / K > box_warp / G:
        raise ValueError(
            f"ess: taps={K} cannot cover interval length {max_len:g} at grid={G} (tap "
            f"spacing {max_len / K:g} > cell {box_warp / G:g}); need taps >= "
            f"{int(np.ceil(max_len * G / box_warp))}")


def _ray_bounds(ray_start, ray_end, N, R, dev):
    """The bounds as [N,R,1] f32 tensors: fixed floats filled, per-ray
    tensors broadcast."""
    if isinstance(ray_start, (int, float)):
        rs = torch.full((N, R, 1), float(ray_start), dtype=torch.float32, device=dev)
        re = torch.full((N, R, 1), float(ray_end), dtype=torch.float32, device=dev)
        return rs, re
    return (ray_start.expand(N, R, 1).to(torch.float32),
            ray_end.expand(N, R, 1).to(torch.float32))


def ess_narrow_intervals(occ, occ_outside, ray_origins, ray_directions, ray_start, ray_end,
                         box_warp: float, options: dict):
    """Per-ray [t0, t1] covering the occupied span plus ``margin`` taps
    (renderer.py:378-440): K taps along each ray's interval (fixed floats,
    or per-ray [N,R,1] bounds); rays with no occupied tap keep their full
    interval. -> ([N,R,1] t0, [N,R,1] t1)."""
    ess = options["ess"]
    K, margin = int(ess.get("taps", 64)), float(ess.get("margin", 1))
    N, R, _ = ray_origins.shape
    G = occ.shape[-1]
    _narrow_check(ray_start, ray_end, box_warp, G, K)
    dev = ray_origins.device
    rs, re = _ray_bounds(ray_start, ray_end, N, R, dev)
    L = re - rs
    frac = (torch.arange(K, dtype=torch.float32, device=dev) + 0.5) / K
    tk = rs + frac[None, None, :] * L                                   # [N,R,K]
    pts = ray_origins[:, :, None, :] + tk[..., None] * ray_directions[:, :, None, :]
    gidx = torch.floor((pts / box_warp + 0.5) * G).to(torch.int64)
    inside = ((gidx >= 0) & (gidx < G)).all(-1)
    gc = gidx.clamp(0, G - 1)
    flat = (gc[..., 0] * G + gc[..., 1]) * G + gc[..., 2]
    flat = flat + (torch.arange(N, device=dev) * G ** 3)[:, None, None]
    occ_t = occ.reshape(-1)[flat.reshape(-1)].reshape(N, R, K)
    occ_t = torch.where(inside, occ_t > 0, occ_outside > 0)
    kk = torch.arange(K, dtype=torch.float32, device=dev)
    first = torch.where(occ_t, kk, torch.full_like(kk, math.inf)).amin(-1)
    last = torch.where(occ_t, kk, torch.full_like(kk, -math.inf)).amax(-1)
    hit = torch.isfinite(first)
    step = L[..., 0] / K
    t0 = rs[..., 0] + torch.clamp_min(first - margin, 0.0) * step
    t1 = rs[..., 0] + torch.clamp_max(last + 1 + margin, float(K)) * step
    t0 = torch.where(hit, t0, rs[..., 0])
    t1 = torch.where(hit, t1, re[..., 0])
    return t0[..., None], t1[..., None]


def ess_narrow_plain(occ, occ_outside, ray_origins, ray_directions, ray_start, ray_end,
                     box_warp: float, options: dict, depth_resolution: int, jitter=None):
    """ess_narrow_intervals, then the per-ray stratified coarse depths at
    ``jitter`` [N,R,S,1] (0.5 when None). -> (t0 [N,R,1], t1 [N,R,1],
    depths [N,R,S,1])."""
    t0, t1 = ess_narrow_intervals(occ, occ_outside, ray_origins, ray_directions, ray_start,
                                  ray_end, box_warp, options)
    return t0, t1, sample_stratified(ray_origins, t0, t1, depth_resolution, jitter=jitter)


def ess_narrow_warp_order(occ, occ_outside, ray_origins, ray_directions, ray_start, ray_end,
                          box_warp: float, options: dict, depth_resolution: int,
                          jitter=None):
    """K6b's order of operations (csrc/ess.cu:ess_narrow_kernel) in PyTorch,
    for the tests. A ray is a warp of 32 lanes, lane l holding taps l,
    l + 32, ...; each chunk of 32 taps is a ballot (an integer bitmask of
    the lanes' hits), the first and last occupied taps are the lowest and
    highest set bits of the first and last non-zero ballots, and lane l
    writes depths l, l + 32, ..., each offset by its jitter (0.5 when None)
    times the stratum. The occupancy is read at batch stride
    ``occ.stride(0)`` (0: one grid for every view); the bounds are floats
    or per-ray [N,R,1]. Same contract as ess_narrow_plain."""
    ess = options["ess"]
    K, margin = int(ess.get("taps", 64)), float(ess.get("margin", 1))
    N, R, _ = ray_origins.shape
    G, S = occ.shape[-1], depth_resolution
    _narrow_check(ray_start, ray_end, box_warp, G, K)
    dev = ray_origins.device
    n_rays, lanes = N * R, torch.arange(32, device=dev)
    o = ray_origins.reshape(n_rays, 1, 3)
    d = ray_directions.reshape(n_rays, 1, 3)
    rs, re = (t.reshape(n_rays) for t in _ray_bounds(ray_start, ray_end, N, R, dev))
    L = re - rs
    cells = torch.as_strided(occ, ((N - 1) * occ.stride(0) + G ** 3,), (1,))
    base = (torch.arange(n_rays, device=dev) // R) * occ.stride(0)
    first = torch.full((n_rays,), -1, dtype=torch.int64, device=dev)
    last = torch.full_like(first, -1)
    for k0 in range(0, K, 32):
        k = k0 + lanes                                                  # the lanes' taps
        frac = (k.to(torch.float32) + 0.5) / K
        tk = rs[:, None] + frac[None, :] * L[:, None]                   # [n_rays, 32]
        pts = o + tk[..., None] * d
        gidx = torch.floor((pts / box_warp + 0.5) * G).to(torch.int64)
        inside = ((gidx >= 0) & (gidx < G)).all(-1)
        gc = gidx.clamp(0, G - 1)
        flat = (gc[..., 0] * G + gc[..., 1]) * G + gc[..., 2]
        hit = torch.where(inside, cells[base[:, None] + flat] > 0, occ_outside > 0)
        hit &= (k < K)[None, :]
        bits = (hit.to(torch.int64) << lanes).sum(-1)                   # the ballot
        low = (bits & -bits).clamp_min(1).to(torch.float64).log2().to(torch.int64)
        high = bits.clamp_min(1).to(torch.float64).log2().floor().to(torch.int64)
        first = torch.where((bits != 0) & (first < 0), k0 + low, first)
        last = torch.where(bits != 0, k0 + high, last)
    hit_any = first >= 0
    step = L / K
    t0 = rs + torch.clamp_min(first.to(torch.float32) - margin, 0.0) * step
    t1 = rs + torch.clamp_max(last.to(torch.float32) + 1 + margin, float(K)) * step
    t0 = torch.where(hit_any, t0, rs)
    t1 = torch.where(hit_any, t1, re)
    diff = t1 - t0
    delta = diff / (S - 1)
    jit = (torch.full((n_rays, S), 0.5, device=dev) if jitter is None
           else jitter.reshape(n_rays, S).to(torch.float32))
    depths = torch.empty((n_rays, S), dtype=torch.float32, device=dev)
    for s0 in range(0, S, 32):                                          # lane l: s0 + l
        s = torch.arange(s0, min(s0 + 32, S), device=dev)
        frac = s.to(torch.float32) / (S - 1)
        depths[:, s] = ((t0[:, None] + frac[None, :] * diff[:, None])
                        + jit[:, s] * delta[:, None])
    return (t0.reshape(N, R, 1), t1.reshape(N, R, 1), depths.reshape(N, R, S, 1))


_K6B_ARGS = ((kb.PTR,) * 7 + (kb.INT,) * 4 + (kb.LONG,) + (kb.FLOAT,) * 4 + (kb.INT,)
             + (kb.PTR,) * 3 + (kb.PTR,))


def ess_narrow_kernel(occ, occ_outside, ray_origins, ray_directions, ray_start, ray_end,
                      box_warp: float, options: dict, depth_resolution: int, jitter=None):
    """Launch K6's narrowing on CUDA tensors: same contract as
    ess_narrow_plain. Per-ray bounds (contiguous f32 [N,R,1]) run its
    per-ray form, a jitter (contiguous f32 [N,R,S,1]) its keyed form
    (counted as the variants ``per_ray`` and ``jitter``)."""
    require_no_grad("ess_narrow", occ, occ_outside, ray_origins, ray_directions,
                    None if _scalar_bounds(ray_start, ray_end) else (ray_start, ray_end),
                    jitter)
    ess = options["ess"]
    K, margin = int(ess.get("taps", 64)), float(ess.get("margin", 1))
    N, R, _ = ray_origins.shape
    G, S = occ.shape[-1], depth_resolution
    _narrow_check(ray_start, ray_end, box_warp, G, K)
    dev = occ.device
    for t_ in (ray_origins, ray_directions):
        _require(t_.dtype == torch.float32 and t_.is_contiguous() and t_.device == dev,
                 "K6 rays must be contiguous f32 [N,R,3] on the occupancy's device")
    # occ may be one portrait's grid broadcast over a view batch (stride 0)
    _require(occ.dtype == torch.float32 and occ[0].is_contiguous()
             and tuple(occ.shape) == (N, G, G, G), "K6 occupancy must be f32 [N,G,G,G]")
    _require(S >= 2, "K6 takes at least 2 coarse samples")
    _require(K <= 1024, "K6 takes at most 1024 taps (a lane's hits are one 32-bit mask)")
    per_ray = not _scalar_bounds(ray_start, ray_end)
    bounds = (ray_start, ray_end) if per_ray else ()
    for t_ in bounds:
        _require(t_.dtype == torch.float32 and t_.is_contiguous() and t_.device == dev
                 and tuple(t_.shape) == (N, R, 1), "K6 per-ray bounds must be contiguous f32 "
                 "[N,R,1] on the occupancy's device")
    _require(jitter is None or (jitter.dtype == torch.float32 and jitter.is_contiguous()
                                and tuple(jitter.shape) == (N, R, S, 1) and jitter.device == dev),
             "K6 jitter must be contiguous f32 [N,R,S,1] on the occupancy's device")
    occ_out = occ_outside.to(device=dev, dtype=torch.float32).reshape(1).contiguous()
    t0 = torch.empty((N, R, 1), dtype=torch.float32, device=dev)
    t1 = torch.empty_like(t0)
    depths = torch.empty((N, R, S, 1), dtype=torch.float32, device=dev)
    kb.launch("ess_narrow", _K6B_ARGS, occ.data_ptr(), occ_out.data_ptr(),
              ray_origins.data_ptr(), ray_directions.data_ptr(), t0.data_ptr(),
              t1.data_ptr(), depths.data_ptr(), N * R, R, G, K, occ.stride(0),
              0.0 if per_ray else float(ray_start), 0.0 if per_ray else float(ray_end),
              float(box_warp), margin, S, ray_start.data_ptr() if per_ray else None,
              ray_end.data_ptr() if per_ray else None,
              jitter.data_ptr() if jitter is not None else None, _stream(occ))
    k = KERNELS["ess_narrow"]
    k.launches += 1
    for form, on in (("per_ray", per_ray), ("jitter", jitter is not None)):
        if on:
            k.variants[form] = k.variants.get(form, 0) + 1
    return t0, t1, depths


def ess_narrow(occ, occ_outside, ray_origins, ray_directions, ray_start, ray_end,
               box_warp: float, options: dict, depth_resolution: int, jitter=None):
    args = (occ, occ_outside, ray_origins, ray_directions, ray_start, ray_end, box_warp,
            options, depth_resolution, jitter)
    if occ.device.type == "cpu":
        return ess_narrow_plain(*args)
    if occ.device.type == "cuda":
        return ess_narrow_kernel(*args)
    raise RuntimeError(f"ess_narrow: no path for device {occ.device}")


# ---------------------------------------------------------------------------
# full renderer (renderer.py:864)

class RenderOutput(NamedTuple):
    rgb: torch.Tensor       # [N, R, C] feature samples
    depth: torch.Tensor     # [N, R, 1]
    weights: torch.Tensor   # [N, R, 1] accumulated alpha
    xyz: torch.Tensor       # [N, R, 3] composited world position


def render(planes, decoder: Decoder, ray_origins, ray_directions, options: dict,
           triplane_crop=None, cull_clouds=None, binarize_clouds=None, generator=None,
           jitter=None, u=None) -> RenderOutput:
    """Two-pass hierarchical render: stratified coarse pass (K1), importance
    depths (K3), fine pass (K1), merged composite (K2). planes [N,3,C*D,H,W];
    rays [N,R,3]; ``options`` are the reference rendering_kwargs
    (ray_start = ray_end = 'auto': each ray's span through the box,
    renderer.py:980-989; disparity_space_sampling). At triplane_depth D > 1
    each pass decodes through triplane_decode_deep (K10, the trilinear K1
    form) in place of K1. With ``options['ess']`` (and not disparity-space
    sampling) the coarse depths come from K6's narrowed intervals; the
    occupancy is ``options['_ess_occ']`` when the caller pre-seeds it
    (paste-front's auxiliary renders, turntables), else it is computed here
    from the planes (renderer.py:899-907, :992-997; D = 1 only, F12).

    Keyed (the JAX render_key): the coarse depths are jittered by
    ``jitter`` [N,R,S,1] and the importance depths taken at ``u``
    [N*R,K], each as given or drawn from ``generator`` (jitter first, as
    JAX's k_strat, then u, as its k_imp); with neither, eval's midpoints
    and linspace."""
    depth = options.get("triplane_depth", 1)
    N, R, _ = ray_origins.shape
    box_warp = options["box_warp"]
    if options["ray_start"] == options["ray_end"] == "auto":
        ray_start, ray_end = auto_ray_limits(ray_origins, ray_directions, box_warp)
    else:
        ray_start, ray_end = options["ray_start"], options["ray_end"]
    disparity = options.get("disparity_space_sampling", False)
    render_dtype = RENDER_DTYPES[options.get("render_dtype", "bfloat16")]
    # channels-last planes in the render dtype, shared by both passes
    if depth == 1:
        planes_cl = planes.to(render_dtype).permute(0, 1, 3, 4, 2).contiguous()
        decode = triplane_decode
    else:
        planes_cl = deep_volumes_cl(planes, depth, render_dtype)
        decode = triplane_decode_deep
    plane_axes = generate_plane_axes(options.get("use_triplane", False))
    filters = DensityFilters(triplane_crop, cull_clouds, binarize_clouds)
    white_back = options.get("white_back", False)
    if options.get("ess") and "_ess_occ" not in options:
        options = dict(options, _ess_occ=ess_occupancy(plane_axes, planes, decoder, box_warp,
                                                       options, filters))

    def eval_pass(depths):
        n = depths.shape[2]
        coords = (ray_origins[:, :, None, :] + depths * ray_directions[:, :, None, :])
        coords = coords.reshape(N, R * n, 3).contiguous()
        rgb, sigma = decode(planes_cl, coords, decoder, box_warp, plane_axes, filters)
        return (rgb.reshape(N, R, n, -1), sigma.reshape(N, R, n, 1),
                coords.reshape(N, R, n, 3))

    S = options["depth_resolution"]
    if jitter is None and generator is not None:
        jitter = draws.uniform((N, R, S, 1), generator, ray_origins.device, "render jitter")
    if options.get("ess") and not disparity:
        occ, occ_outside = options["_ess_occ"]
        bounds = (ray_start, ray_end)
        if torch.is_tensor(ray_start):
            bounds = tuple(t.to(torch.float32).contiguous() for t in bounds)
        _, _, depths_coarse = ess_narrow(
            occ, occ_outside, ray_origins, ray_directions, *bounds, box_warp, options, S,
            jitter=jitter.contiguous() if jitter is not None else None)
    else:
        depths_coarse = sample_stratified(ray_origins, ray_start, ray_end, S, jitter=jitter,
                                          disparity_space_sampling=disparity)
    depths_coarse = depths_coarse.to(ray_origins.dtype).contiguous()
    colors_c, sigma_c, xyz_c = eval_pass(depths_coarse)
    n_imp = options.get("depth_resolution_importance") or 0
    if n_imp > 0:
        u = _u(u, (N * R, n_imp), generator, ray_origins.device, "render u")
        # the importance depths take no gradient (renderer.py:563's stop_gradient)
        depths_fine = importance_sample(depths_coarse, sigma_c.detach(), n_imp,
                                        u.contiguous() if u is not None else None)
        colors_f, sigma_f, xyz_f = eval_pass(depths_fine)
    else:   # the coarse samples are already depth-ordered
        depths_fine, colors_f, sigma_f, xyz_f = (
            t[:, :, :0] for t in (depths_coarse, colors_c, sigma_c, xyz_c))
    rgb, depth, wsum, xyz = ray_composite(
        depths_coarse, colors_c, sigma_c, xyz_c, depths_fine, colors_f, sigma_f, xyz_f,
        white_back)
    return RenderOutput(rgb=rgb, depth=depth, weights=wsum, xyz=xyz)
