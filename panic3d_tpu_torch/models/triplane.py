"""TriPlaneGenerator: StyleGAN2 backbone -> triplanes -> volume render -> SR
-> paste-front (panic3d_tpu/models/triplane.py).

``G.f(x)``, the kwargs-dict inference entry, is the public API, as in the
JAX package. It takes every input of the JAX G.f: z / zs (per-slot z+
latents) / seeds / ws latents, latent injection (``dw``, ``dws`` on the ws,
``da_<lvl>`` / ``db_<lvl>`` into the synthesis), ``stop_level``, the noise
modes and the keyed render (``generator=``: a torch.Generator, or a
utils/draws.Replay of given draws, the counterpart of the JAX package's
``noise`` rng and ``render_key``), camera labels from
elevations/azimuths[/distances/fovs] or camera_params, the ortho/pinhole ray
select, mapping, synthesis, triplane_crop / cull_clouds / binarize_clouds,
empty-space skipping (rendering_kwargs['ess']), paste-front compositing
(``paste_params``, grid and render occlusion), deep planes
(rendering_kwargs['triplane_depth'] D > 1: the backbone makes 3*C*D
channels, decoded through kernel K10; ESS and the grid occlusion refuse
D > 1, as the JAX package fails there, ROADMAP F12) and the precomputed inputs
``_planes``, ``_skip_sr``, ``_ess_occ``, ``_occ_vol`` (``_rays_z_aligned``
is accepted and changes nothing: the JAX package's z-aligned gather is a
TPU row trick, bit-equal to the plain render). Kernel K8
(csrc/paste_front.cu) does paste-front's per-pixel work, on the card with
the grid occlusion's read of the volume in the same launch; its wrappers
sit here beside their plain versions, and its backward form
(``paste_front_grad``, PasteComposite) gives the rendered image and
image_xyz their gradients in training.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from ..cameras.conventions import camera_label, get_rays_ortho
from ..cameras.rays import sample_rays
from ..kernels import KERNELS, require_no_grad
from ..kernels import build as kb
from ..ops.grid_sample import grid_sample_2d_points
from ..utils.device import constant
from ..utils.imageops import erosion, resize_nearest, sobel_magnitude
from .stylegan2 import FullyConnectedLayer, Generator, init_weights, resize_bilinear
from .superresolution import SR_MODULES
from .volumetric import lattice as vlat
from .volumetric import renderer as vr

_XYZ_FLIP = (-1.0, 1.0, -1.0)


def seeds_to_z(seeds, z_dim: int) -> np.ndarray:
    """Per-seed z vectors via np.random.RandomState (triplane.py:352-355)."""
    return np.stack([np.random.RandomState(s).randn(z_dim) for s in seeds]).astype(np.float32)


class OSGDecoder(nn.Module):
    """Per-sample MLP decoder (triplane.py:516-548): mean over planes ->
    FC(C->64) -> softplus -> FC(64->33); sigma = channel 0, rgb = sigmoid of
    the rest. ``net`` mirrors the reference's Sequential for its state_dict
    names (net.0, net.2); the decode itself runs in kernel K1
    (renderer.triplane_decode), or for deep planes in
    renderer.triplane_decode_deep, which take :meth:`weights`."""

    def __init__(self, n_features, decoder_lr_mul=1.0, decoder_output_dim=32,
                 hidden_dim=64):
        super().__init__()
        self.lr_mul = decoder_lr_mul
        self.net = nn.Sequential(
            FullyConnectedLayer(n_features, hidden_dim, lr_multiplier=decoder_lr_mul),
            nn.Softplus(),
            FullyConnectedLayer(hidden_dim, 1 + decoder_output_dim,
                                lr_multiplier=decoder_lr_mul),
        )

    def weights(self, force_sigmoid: bool) -> vr.Decoder:
        return vr.Decoder(self.net[0].weight, self.net[0].bias, self.net[2].weight,
                          self.net[2].bias, self.lr_mul, force_sigmoid)


DEFAULT_RENDERING_KWARGS = dict(
    image_resolution=512,
    disparity_space_sampling=False,
    clamp_mode="softplus",
    superresolution_module="training.superresolution.SuperresolutionHybrid8XDC",
    c_gen_conditioning_zero=True,
    c_scale=1.0,
    superresolution_noise_mode="none",
    density_reg=0.25,
    density_reg_p_dist=0.004,
    reg_type="l1",
    decoder_lr_mul=1.0,
    sr_antialias=True,
    white_back=True,
    triplane_depth=1,
    use_triplane=True,
    tanh_rgb_output=False,
    box_warp=0.7,
    ray_start=0.5,
    ray_end=1.5,
    depth_resolution=48,
    depth_resolution_importance=48,
    avg_camera_radius=1.0,
    avg_camera_pivot=(0, 0, 0),
)


class TriPlaneGenerator(nn.Module):
    """triplane.py:30-511. Construct-time config mirrors the reference."""

    def __init__(self, z_dim=512, c_dim=25, w_dim=512, img_resolution=512,
                 img_channels=3, sr_num_fp16_res=0, mapping_kwargs=None,
                 rendering_kwargs=None, sr_kwargs=None, cond_mode="none",
                 triplane_width=32, sr_channels_hidden=256, backbone_resolution=256,
                 synthesis_kwargs=None, neural_rendering_resolution=64,
                 force_sigmoid=False):
        super().__init__()
        self.z_dim = z_dim
        self.img_resolution = img_resolution
        self.backbone_resolution = backbone_resolution
        self.cond_mode = cond_mode
        self.triplane_width = triplane_width
        self.neural_rendering_resolution = neural_rendering_resolution
        self.force_sigmoid = force_sigmoid
        self.rk = dict(DEFAULT_RENDERING_KWARGS, **(rendering_kwargs or {}))
        self.backbone = Generator(
            z_dim=z_dim, c_dim=c_dim, w_dim=w_dim, img_resolution=backbone_resolution,
            img_channels=triplane_width * 3 * self.triplane_depth, cond_mode=cond_mode,
            mapping_kwargs=mapping_kwargs, synthesis_kwargs=synthesis_kwargs)
        self.superresolution = SR_MODULES[self.rk["superresolution_module"]](
            channels=32, img_resolution=img_resolution, sr_num_fp16_res=sr_num_fp16_res,
            sr_antialias=self.rk["sr_antialias"], channels_hidden=sr_channels_hidden,
            w_dim=w_dim, **(sr_kwargs or {}))
        self.decoder = OSGDecoder(triplane_width,
                                  decoder_lr_mul=self.rk.get("decoder_lr_mul", 1),
                                  decoder_output_dim=32)

    def init_weights(self, seed: int) -> "TriPlaneGenerator":
        """Seeded random weights (no checkpoint is loaded)."""
        init_weights(self, seed)
        return self

    @property
    def triplane_depth(self) -> int:
        return self.rk.get("triplane_depth", 1)

    @property
    def num_ws(self) -> int:
        return self.backbone.num_ws

    @property
    def device(self) -> torch.device:
        return self.decoder.net[0].weight.device

    def _t(self, v):
        return torch.as_tensor(v, dtype=torch.float32, device=self.device)

    def mapping(self, z, c, cond=None, truncation_psi=1.0, truncation_cutoff=None):
        """triplane.py:88-122, with c zeroing and c_scale; ``cond`` carries
        resnet_feats for a resnetcond_N cond mode."""
        if self.rk["c_gen_conditioning_zero"]:
            c = torch.zeros_like(c)
        c = c * self.rk.get("c_scale", 0)
        return self.backbone.mapping(z, c, cond, truncation_psi=truncation_psi,
                                     truncation_cutoff=truncation_cutoff)

    def mapping_zplus(self, zs, c, cond=None, truncation_psi=1.0, truncation_cutoff=None):
        """Per-slot z+ mapping (triplane.py:123-143): zs [N,n,z_dim], z_i
        fills w slot i -> ws [N,n,w_dim]."""
        bs, n, dim = zs.shape
        c_new = c[:, None, :].repeat(1, n, 1).reshape(bs * n, -1)
        cond_new = cond
        if cond is not None and "resnet_feats" in cond:
            feats = cond["resnet_feats"]
            cond_new = dict(cond, resnet_feats=feats[:, None, :].repeat(1, n, 1)
                            .reshape(bs * n, -1))
        ans = self.mapping(zs.reshape(bs * n, dim), c_new, cond_new,
                           truncation_psi=truncation_psi, truncation_cutoff=truncation_cutoff)
        ans = ans.reshape(bs, n, n, -1)
        diag = torch.arange(n, device=ans.device)
        return ans[:, diag, diag, :]

    def _planes_from_ws(self, ws, cond, noise_mode="const", generator=None,
                        latent_injection=None, stop_level=None):
        """Backbone synthesis -> planes [N,3,C*D,H,W] (triplane.py:264)."""
        planes = self.backbone.synthesis(ws, cond, noise_mode=noise_mode, generator=generator,
                                         latent_injection=latent_injection,
                                         stop_level=stop_level)
        return planes.reshape(planes.shape[0], 3, self.triplane_width * self.triplane_depth,
                              planes.shape[-2], planes.shape[-1])

    def _decoder(self) -> vr.Decoder:
        return self.decoder.weights(self.force_sigmoid)

    def ess_occupancy_for_planes(self, planes, triplane_crop=None, cull_clouds=None,
                                 binarize_clouds=None):
        """The empty-space-skipping occupancy of ``planes`` (triplane.py:419),
        computed once and passed as ``x['_ess_occ']`` to every view of
        the same portrait. -> (occ [N,G,G,G], occ_outside 0-d)."""
        rk = self.rk
        return vr.ess_occupancy(vr.generate_plane_axes(rk.get("use_triplane", False)), planes,
                                self._decoder(), rk["box_warp"], rk,
                                vr.DensityFilters(triplane_crop, cull_clouds, binarize_clouds))

    def front_occlusion_volume(self, planes, triplane_crop=None, cull_clouds=None,
                               binarize_clouds=None):
        """The paste-front occlusion volume of ``planes`` (triplane.py:640),
        computed once and passed as ``x['_occ_vol']`` to every view."""
        rk = self.rk
        return vlat.front_occlusion_volume(
            planes, self._decoder(), rk["box_warp"], rk, triplane_crop=triplane_crop,
            cull_clouds=cull_clouds, binarize_clouds=binarize_clouds,
            grid=tuple(rk.get("occ_grid", (128, 128, 256))))

    # -- shape sampling ------------------------------------------------------

    def sample_mixed_planes(self, planes, coordinates):
        """Decode (rgb, sigma) at arbitrary world coordinates [N,M,3] from
        precomputed planes [N,3,C*D,H,W] (triplane.py:452) through K1 (K10,
        its trilinear form, at D > 1), in the planes' dtype and with no density
        filters (the volume and mesh paths). -> {'rgb' [N,M,32], 'sigma'
        [N,M,1], 'xyz'}."""
        rk = self.rk
        coords = coordinates.to(torch.float32).contiguous()
        axes = vr.generate_plane_axes(rk.get("use_triplane", False))
        if self.triplane_depth == 1:
            rgb, sigma = vr.triplane_decode(planes.permute(0, 1, 3, 4, 2).contiguous(), coords,
                                            self._decoder(), rk["box_warp"], axes)
        else:
            rgb, sigma = vr.triplane_decode_deep(
                vr.deep_volumes_cl(planes, self.triplane_depth), coords, self._decoder(),
                rk["box_warp"], axes)
        return {"rgb": rgb, "sigma": sigma, "xyz": coordinates}

    def sample_mixed(self, coordinates, directions, ws, cond=None, noise_mode="const",
                     generator=None):
        """Decode (rgb, sigma) at arbitrary coordinates from ws
        (triplane.py:439): the backbone planes, then sample_mixed_planes."""
        planes = self._planes_from_ws(ws, cond, noise_mode=noise_mode, generator=generator)
        return self.sample_mixed_planes(planes, coordinates)

    def synthesis(self, ws, c, cond=None, neural_rendering_resolution: Optional[int] = None,
                  force_rays=None, triplane_crop=None, cull_clouds=None,
                  binarize_clouds=None, normalize_images=True, noise_mode="const",
                  planes=None, skip_superresolution=False, ess_occ=None, generator=None,
                  latent_injection=None, stop_level=None):
        """triplane.py:288-417 -> the output dict. ``planes`` skips the
        backbone, ``skip_superresolution`` leaves ``image`` None (for
        consumers of image_weights only), ``ess_occ`` pre-seeds the ESS
        occupancy. ``generator`` draws the backbone's noise under
        noise_mode='random', the render's jitter and u, then the SR's noise
        under superresolution_noise_mode='random', in that order (the JAX
        package's order of draws)."""
        rk = self.rk
        res = neural_rendering_resolution or self.neural_rendering_resolution
        N = ws.shape[0]
        if force_rays is None:
            ray_origins, ray_directions = sample_rays(
                c[:, :16].reshape(-1, 4, 4), c[:, 16:25].reshape(-1, 3, 3), res)
        else:
            ray_origins, ray_directions = force_rays["ray_origins"], force_rays["ray_directions"]
            if ray_origins.ndim == 4:   # [N,3,r,r] -> [N,M,3]
                ray_origins = ray_origins.reshape(N, 3, -1).transpose(1, 2)
                ray_directions = ray_directions.reshape(N, 3, -1).transpose(1, 2)
        if planes is None:
            planes = self._planes_from_ws(ws, cond, noise_mode=noise_mode, generator=generator,
                                          latent_injection=latent_injection,
                                          stop_level=stop_level)
        if rk.get("ess"):
            # the occupancy depends only on the planes: computed once and
            # shared by every render of them (paste-front, turntables)
            if ess_occ is None:
                ess_occ = self.ess_occupancy_for_planes(planes, triplane_crop, cull_clouds,
                                                        binarize_clouds)
            rk = dict(rk, _ess_occ=ess_occ)
        out = vr.render(planes, self._decoder(), ray_origins.contiguous(),
                        ray_directions.contiguous(), rk, triplane_crop=triplane_crop,
                        cull_clouds=cull_clouds, binarize_clouds=binarize_clouds,
                        generator=generator)

        def image(t):
            return t.transpose(1, 2).reshape(N, -1, res, res)

        feature_image = image(out.rgb)
        xyz_image = 0.5 * (image(out.xyz) + 1) * constant(_XYZ_FLIP, self.device)[None, :, None, None]
        rgb_image = feature_image[:, :3]
        sr_image = None if skip_superresolution else self.superresolution(
            rgb_image, feature_image, ws, noise_mode=rk["superresolution_noise_mode"],
            generator=generator)
        ans = {
            "image": sr_image,
            "image_raw": rgb_image,
            "image_depth": image(out.depth),
            "triplane": planes,
            "image_weights": image(out.weights),
            "image_xyz": xyz_image,
        }
        if ess_occ is not None:
            ans["_ess_occ"] = ess_occ
        if rk.get("tanh_rgb_output", False):
            if ans["image"] is not None:
                ans["image"] = torch.tanh(ans["image"])
            ans["image_raw"] = torch.tanh(ans["image_raw"])
        if not normalize_images:
            if ans["image"] is not None:
                ans["image"] = 0.5 * ans["image"] + 0.5
            ans["image_raw"] = 0.5 * ans["image_raw"] + 0.5
        return ans

    def f(self, x: Dict[str, Any], truncation_psi=1.0, truncation_cutoff=None,
          normalize_images=False, noise_mode="const", generator=None,
          latent_injection=None, stop_level=None):
        """Universal inference entry (triplane.py:473-622). Accepts ws | zs
        | z | seeds, camera_params | (elevations, azimuths[, distances,
        fovs]), cond, latent_injection (also as x['latent_injection'], which
        wins key by key), triplane_crop / cull_clouds / binarize_clouds /
        paste_params, force_rays, and the precomputed _planes / _skip_sr /
        _ess_occ / _occ_vol. noise_mode 'random' draws the backbone's noise
        from ``generator``, which also keys the render (jittered coarse
        depths, importance depths at random u) and the SR's noise under
        superresolution_noise_mode='random' (see synthesis). Returns image,
        image_raw, image_depth, image_weights, image_xyz, triplane,
        normalize_images, plus _ess_occ with ESS on and image_prepaste /
        paste when pasting."""
        x = dict(x)
        if "latent_injection" in x:
            latent_injection = dict(latent_injection or {}, **x["latent_injection"])
        rk = self.rk
        if "ws" not in x and "zs" not in x and "z" not in x:
            x["z"] = self._t(seeds_to_z(x["seeds"], self.z_dim))

        if "camera_params" not in x:
            elev = self._t(x["elevations"])
            x["camera_params"] = camera_label(
                elev, self._t(x["azimuths"]),
                self._t(x["distances"]) if "distances" in x else torch.ones_like(elev),
                self._t(x["fovs"]) if "fovs" in x else 30 * torch.ones_like(elev))
        cam = self._t(x["camera_params"])
        res = x.get("neural_rendering_resolution", self.neural_rendering_resolution)

        force_rays = x.get("force_rays")
        if force_rays is None:   # force by default so the ortho select is uniform
            intrinsics = cam[:, 16:25].reshape(-1, 3, 3)
            ro, rd = sample_rays(cam[:, :16].reshape(-1, 4, 4), intrinsics, res)
            N = ro.shape[0]
            ro = ro.transpose(1, 2).reshape(N, 3, res, res)
            rd = rd.transpose(1, 2).reshape(N, 3, res, res)
            if "elevations" in x:
                # negative-fov cameras are orthographic: compute both, select
                elev = self._t(x["elevations"])
                oro, ord_ = get_rays_ortho(
                    elev, self._t(x["azimuths"]),
                    self._t(x["distances"]) if "distances" in x else torch.ones_like(elev),
                    rk["box_warp"], res)
                is_ortho = (intrinsics[:, 0, 0] < 0)[:, None, None, None]
                ro = torch.where(is_ortho, oro, ro)
                rd = torch.where(is_ortho, ord_, rd)
            force_rays = {"ray_origins": ro, "ray_directions": rd}
            x["force_rays"] = force_rays

        cond = x.get("cond")
        if "ws" not in x:
            # zs: a z for each w slot; one z for every slot takes the plain
            # mapping, identical to mapping_zplus and num_ws times cheaper
            # (triplane.py:508-516)
            if "zs" in x:
                x["ws"] = self.mapping_zplus(self._t(x["zs"]), cam, cond,
                                             truncation_psi=truncation_psi,
                                             truncation_cutoff=truncation_cutoff)
            else:
                x["ws"] = self.mapping(self._t(x["z"]), cam, cond,
                                       truncation_psi=truncation_psi,
                                       truncation_cutoff=truncation_cutoff)
        ws = x["ws"]
        if latent_injection is not None:
            for k in ("dw", "dws"):
                if k in latent_injection:
                    ws = ws + latent_injection[k]
        normalize_images = x.get("normalize_images", normalize_images)
        synth = self.synthesis(
            ws, cam, cond, neural_rendering_resolution=res, force_rays=force_rays,
            triplane_crop=x.get("triplane_crop"), cull_clouds=x.get("cull_clouds"),
            binarize_clouds=x.get("binarize_clouds"), normalize_images=normalize_images,
            noise_mode=noise_mode, planes=x.get("_planes"),
            skip_superresolution=x.get("_skip_sr", False), ess_occ=x.get("_ess_occ"),
            generator=generator, latent_injection=latent_injection, stop_level=stop_level)
        ret = {k: synth[k] for k in ("image", "image_raw", "image_depth", "image_weights",
                                     "triplane", "image_xyz")}
        ret["normalize_images"] = normalize_images
        if "_ess_occ" in synth:
            # shared with paste-front's auxiliary renders
            ret["_ess_occ"] = synth["_ess_occ"]
        x.update(ret)
        if x.get("paste_params"):
            ret["image_prepaste"] = ret["image"]
            paste = self.paste_front(x, ret, noise_mode=noise_mode, generator=generator,
                                     **x["paste_params"])
            ret["paste"] = paste
            ret["image"] = paste["image"]
        return ret

    # -- paste-front compositing (triplane.py:626-815) ------------------------

    def _front_occlusion_vol(self, x):
        """The per-portrait occlusion volume of the grid occlusion
        (triplane.py:657): ``x['_occ_vol']``, else made from the planes."""
        vol = x.get("_occ_vol")
        if vol is None:
            vol = self.front_occlusion_volume(
                x["triplane"], triplane_crop=x.get("triplane_crop"),
                cull_clouds=x.get("cull_clouds"), binarize_clouds=x.get("binarize_clouds"))
        return vol

    def _get_front_occlusion(self, x, out, offset=0.01, noise_mode="const", generator=None):
        """Front occlusion by a re-render along +z from each surface point
        (triplane.py:686, occ_impl='render'), reusing the planes and the
        ESS occupancy; SR is skipped (image_weights does not need it)."""
        ro = out["image_xyz"] * constant(_XYZ_FLIP, self.device)[None, :, None, None]
        ro = ro.clone()
        ro[:, 2] += -(self.rk["ray_start"] - offset)
        rd = torch.zeros_like(ro)
        rd[:, 2] = 1.0
        xin = {k: v for k, v in x.items() if k not in ("paste_params", "force_rays")}
        xin["paste_params"] = None
        xin["force_rays"] = {"ray_origins": ro, "ray_directions": rd}
        if "triplane" in x:
            xin["_planes"] = x["triplane"]
        xin["_skip_sr"] = True
        xin["_rays_z_aligned"] = True
        return self.f(xin, noise_mode=noise_mode, generator=generator)["image_weights"]

    def _get_front_weights(self, x, noise_mode="const", generator=None):
        """The front ortho view's weights (triplane.py:705), for
        front_weight_erosion."""
        bs = x["cond"]["image_ortho_front"].shape[0]
        xin = {k: v for k, v in x.items()
               if k not in ("paste_params", "camera_params", "conditioning_params",
                            "force_rays")}
        xin["elevations"] = torch.zeros(bs, device=self.device)
        xin["azimuths"] = torch.zeros(bs, device=self.device)
        xin["fovs"] = -torch.ones(bs, device=self.device)
        if "triplane" in x:
            xin["_planes"] = x["triplane"]
        xin["_skip_sr"] = True
        return self.f(xin, noise_mode=noise_mode, generator=generator)["image_weights"]

    @staticmethod
    def _get_xyz_discrepancy(xyz, rays):
        """Distance of each composited point from its ray (triplane.py:723)."""
        a, n = rays["ray_origins"], rays["ray_directions"]
        p = xyz * constant(_XYZ_FLIP, xyz.device).to(xyz.dtype)[None, :, None, None]
        perp = (p - a) - torch.sum((p - a) * n, dim=1, keepdim=True) * n
        return torch.linalg.vector_norm(perp, dim=1, keepdim=True)

    def paste_front(self, x, out, mode="default", thresh_weight=0.95, thresh_edges=0.02,
                    thresh_occ=0.05, offset_occ=0.01, thresh_dxyz=0.01,
                    front_weight_erosion=0, force_image=None, occ_impl="grid",
                    noise_mode="const", generator=None, **kwargs):
        """Project the conditioning front view onto the render where the
        surface faces the front camera unoccluded (triplane.py:730). The
        per-pixel masks, projection and blend are kernel K8. With the grid
        occlusion on the card, K8's paste_front_occ entry also reads the
        occlusion volume and the discrepancy at the render's pixels in the
        same launch; elsewhere those r^2 maps are plain torch (the grid's
        read through K7b's sampler) and K8 takes them."""
        bw = self.rk["box_warp"]
        front_rgb = x["cond"]["image_ortho_front"]
        size = out["image"].shape[-1]
        if front_rgb.shape[-1] != size:
            front_rgb = resize_bilinear(front_rgb, size)
        grid = occ_impl == "grid" and isinstance(self.rk["ray_start"], (int, float))
        fused = grid and out["image"].device.type == "cuda"
        seg_len = float(self.rk["ray_end"]) - float(self.rk["ray_start"]) if grid else None
        with torch.no_grad():
            if grid:
                vr.refuse_deep("paste_front with occ_impl='grid'", self.triplane_depth)
                vol = self._front_occlusion_vol(x)
            if not fused:
                occ = (front_occlusion_grid(vol, out["image_xyz"], offset_occ, seg_len) if grid
                       else self._get_front_occlusion(x, out, offset=offset_occ,
                                                      noise_mode=noise_mode,
                                                      generator=generator))
                occ_bin = (occ < thresh_occ).to(torch.float32)
                dxyz = self._get_xyz_discrepancy(out["image_xyz"], x["force_rays"])
            frontw = fwmask = None
            if front_weight_erosion >= 1:
                frontw = self._get_front_weights(x, noise_mode=noise_mode,
                                                 generator=generator)
                fw = erosion((frontw > 0.5).to(torch.float32), front_weight_erosion)
                fwmask = resize_nearest(
                    sample_orthofront(fw, resize_bilinear(out["image_xyz"], size), bw), size)
        if force_image is None:
            tocopy = front_rgb if not x["normalize_images"] else front_rgb * 2 - 1
        else:
            tocopy = force_image
        if fused:
            ans = paste_composite_occ_kernel(
                out["image"], tocopy, out["image_weights"], out["image_xyz"], vol,
                x["force_rays"], bw, offset_occ, seg_len, thresh_occ, thresh_weight,
                thresh_edges, thresh_dxyz, fwmask)
        else:
            ans = paste_composite(out["image"], tocopy, out["image_weights"], out["image_xyz"],
                                  occ_bin, dxyz, bw, thresh_weight, thresh_edges, thresh_dxyz,
                                  fwmask)
        ans["frontweight"] = frontw
        return ans


def front_occlusion_grid(vol, xyz, offset: float, seg_len: float, sample=None):
    """The grid occlusion at each render pixel (triplane.py:657): the total
    +z opacity past each plane-space surface point (image_xyz [N,3,H,W] x
    (-1, 1, -1)) read from the per-portrait volume by ``sample`` (K7b's
    sampler, vlat.sample_front_occlusion, by default) -> [N,1,H,W]."""
    p = xyz * constant(_XYZ_FLIP, xyz.device)[None, :, None, None]
    N, _, H, W = p.shape
    pts = p.reshape(N, 3, -1).transpose(1, 2)
    occ = (sample or vlat.sample_front_occlusion)(vol, pts, offset, seg_len)
    return occ.transpose(1, 2).reshape(N, 1, H, W)


# ---------------------------------------------------------------------------
# K8 paste_front: the per-pixel masks, front projection and blend

def sample_orthofront(front, view_xyz, bw: float):
    """Border-clamped bilinear sample of the front image [N,C,Hf,Wf] at
    each pixel's front-view uv, uv = 1 - (xyz[[1,0]] + bw/2) / bw
    (triplane.py:626) -> [N,C,Hg,Wg]."""
    vij = 1 - (view_xyz[:, [1, 0]] + bw / 2) / bw
    img = front.transpose(2, 3)
    N, C = img.shape[:2]
    Hg, Wg = vij.shape[-2:]
    out = grid_sample_2d_points(img, (vij.permute(0, 2, 3, 1) * 2 - 1).reshape(N, -1, 2),
                                padding_mode="border")
    return out.transpose(1, 2).reshape(N, C, Hg, Wg)


def upsample_bilinear(m, size: int):
    """[N,C,r,r] -> [N,C,size,size], bilinear with align_corners=False:
    F.interpolate's formula (source index clamped at 0, upper neighbour
    clamped at the edge), each multiply and add a torch op of its own, so
    that every rounding is fixed and K8 can repeat it."""
    r = m.shape[-1]
    src = ((torch.arange(size, dtype=torch.float32, device=m.device) + 0.5) * (r / size)
           - 0.5).clamp_min(0.0)
    i0 = src.to(torch.int64)
    i1 = (i0 + 1).clamp_max(r - 1)
    l1 = src - i0
    l0 = 1 - l1
    m = m.to(torch.float32)

    def lerp_w(rows):
        return rows[..., i0] * l0 + rows[..., i1] * l1

    return lerp_w(m[:, :, i0]) * l0[:, None] + lerp_w(m[:, :, i1]) * l1[:, None]


def paste_composite_plain(image, front, weights, xyz, occ_bin, dxyz, bw: float,
                          thresh_weight: float, thresh_edges: float, thresh_dxyz: float,
                          fwmask=None):
    """paste_front's per-pixel work at the output size S = image's
    (triplane.py:750-815): weights, xyz, the binary occlusion map and the
    xyz discrepancy [N,*,r,r] are upsampled to S (bilinear; nearest for
    the discrepancy) and thresholded into masks; the front image is
    projected through the upsampled xyz; the blend is
    image + (paste - image) * mask. -> dict of image, paste, mask and the
    masks (mask_weights, mask_edges, mask_occ, mask_dxyz, mask_frontweight)."""
    image = image.to(torch.float32)
    size = image.shape[-1]
    wmask = (upsample_bilinear(weights, size) > thresh_weight).to(torch.float32)
    xyz_up = upsample_bilinear(xyz, size)
    smask = (sobel_magnitude(xyz_up) < thresh_edges).to(torch.float32)
    fmask = upsample_bilinear(occ_bin, size)
    dmask = (resize_nearest(dxyz, size) < thresh_dxyz).to(torch.float32)
    fw = torch.ones_like(dmask) if fwmask is None else fwmask
    mask = wmask * smask * fmask * dmask * fw
    paste = sample_orthofront(front, xyz_up, bw)
    return {"image": image + (paste - image) * mask, "paste": paste, "mask": mask,
            "mask_weights": wmask, "mask_edges": smask, "mask_occ": fmask,
            "mask_dxyz": dmask, "mask_frontweight": fw}


K8_TILE = (8, 64)   # K8's tile of output pixels, rows x columns (csrc/paste_front.cu)


def _upsample_at(m, rows, cols, size: int):
    """upsample_bilinear(m, size) at output rows ``rows`` and columns
    ``cols`` (1-D index tensors) -> [N,C,len(rows),len(cols)], with the same
    rounded operations."""
    r = m.shape[-1]

    def coeffs(idx):
        src = ((idx.to(torch.float32) + 0.5) * (r / size) - 0.5).clamp_min(0.0)
        i0 = src.to(torch.int64)
        l1 = src - i0
        return i0, (i0 + 1).clamp_max(r - 1), 1 - l1, l1

    h0, h1, lh0, lh1 = coeffs(rows)
    w0, w1, lw0, lw1 = coeffs(cols)
    m = m.to(torch.float32)

    def lerp_w(rows_):
        return rows_[..., w0] * lw0 + rows_[..., w1] * lw1

    return lerp_w(m[:, :, h0]) * lh0[:, None] + lerp_w(m[:, :, h1]) * lh1[:, None]


def paste_composite_tiled(image, front, weights, xyz, occ_bin, dxyz, bw: float,
                          thresh_weight: float, thresh_edges: float, thresh_dxyz: float,
                          fwmask=None):
    """K8's order of operations (csrc/paste_front.cu) in PyTorch, for the
    tests: each tile of K8_TILE output pixels stages the upsampled xyz of
    the tile plus a one-pixel halo (reflect padding at the image border,
    clamped into the image past a partial tile's edge), takes the sobel of
    each pixel from the staged values in the kernel's rounded order, and
    projects the front image through the staged centre with a multiply by
    0.5 in place of each division by 2; pixels past the image's edge are
    cropped. Same contract as paste_composite_plain."""
    image = image.to(torch.float32)
    N, _, S, _ = image.shape
    TH, TW = K8_TILE
    dev = image.device
    nty, ntx = -(-S // TH), -(-S // TW)

    def halo(n_tiles, t):   # [n_tiles * (t + 2)] reflected, clamped indices
        idx = (torch.arange(n_tiles, device=dev)[:, None] * t
               + torch.arange(t + 2, device=dev)[None, :] - 1).reshape(-1)
        idx = torch.where(idx < 0, -idx, torch.where(idx >= S, 2 * S - 2 - idx, idx))
        return idx.clamp(0, S - 1)

    staged = _upsample_at(xyz, halo(nty, TH), halo(ntx, TW), S)
    staged = staged.reshape(N, 3, nty, TH + 2, ntx, TW + 2)

    def at(y, x):   # the stencil's (y, x) neighbour of every tile pixel
        v = staged[:, :, :, y:y + TH, :, x:x + TW]
        return v.reshape(N, 3, nty * TH, ntx * TW)[:, :, :S, :S]

    v = [[at(y, x) for x in range(3)] for y in range(3)]
    gx = (v[0][0] - v[0][2]) + 2 * (v[1][0] - v[1][2])
    gx = ((gx + v[2][0]) - v[2][2]) * 0.125
    gy = (v[0][0] + 2 * v[0][1]) + v[0][2]
    gy = (((gy - v[2][0]) - 2 * v[2][1]) - v[2][2]) * 0.125
    g2 = gx * gx + gy * gy
    mag2 = torch.zeros_like(g2[:, :1])
    for c in range(3):
        mag2 = mag2 + g2[:, c:c + 1]
    smask = (torch.sqrt(mag2 + 1e-12) < thresh_edges).to(torch.float32)
    centre = v[1][1]

    wmask = (upsample_bilinear(weights, S) > thresh_weight).to(torch.float32)
    fmask = upsample_bilinear(occ_bin, S)
    dmask = (resize_nearest(dxyz, S) < thresh_dxyz).to(torch.float32)
    fw = torch.ones_like(dmask) if fwmask is None else fwmask
    mask = wmask * smask * fmask * dmask * fw

    C, Hf, Wf = front.shape[1:]
    u = (1 - (centre[:, 1] + bw / 2) / bw) * 2 - 1
    w_ = (1 - (centre[:, 0] + bw / 2) / bw) * 2 - 1
    ix = ((u + 1) * Hf - 1) * 0.5
    iy = ((w_ + 1) * Wf - 1) * 0.5
    fx, fy = torch.floor(ix), torch.floor(iy)
    wx, wy = (ix - fx)[:, None], (iy - fy)[:, None]
    x0, y0 = fx.to(torch.int64), fy.to(torch.int64)
    f = front.to(torch.float32).reshape(N, C, Hf * Wf)

    def texel(xx, yy):
        lin = (xx.clamp(0, Hf - 1) * Wf + yy.clamp(0, Wf - 1)).reshape(N, 1, S * S)
        return f.gather(2, lin.expand(N, C, S * S)).reshape(N, C, S, S)

    v00, v01 = texel(x0, y0), texel(x0 + 1, y0)
    v10, v11 = texel(x0, y0 + 1), texel(x0 + 1, y0 + 1)
    top = v00 + (v01 - v00) * wx
    bot = v10 + (v11 - v10) * wx
    paste = top + (bot - top) * wy
    return {"image": image + (paste - image) * mask, "paste": paste, "mask": mask,
            "mask_weights": wmask, "mask_edges": smask, "mask_occ": fmask,
            "mask_dxyz": dmask, "mask_frontweight": fw}


_K8_ARGS = ((kb.PTR,) * 2 + (kb.INT,) * 3 + (kb.PTR,) * 5 + (kb.PTR,) * 7 + (kb.INT,) * 3
            + (kb.FLOAT,) * 6 + (kb.PTR,))
_K8_OCC_ARGS = ((kb.PTR,) * 2 + (kb.INT,) * 3 + (kb.PTR,) * 3 + (kb.LONG, kb.PTR)
                + (kb.INT,) * 3 + (kb.PTR,) * 10 + (kb.INT,) * 3 + (kb.FLOAT,) * 11 + (kb.PTR,))
K8_OUTPUTS = ("image", "paste", "mask", "mask_weights", "mask_edges", "mask_occ", "mask_dxyz")


def _k8_operands(image, front, maps, fwmask):
    """K8's checks, and its operands as contiguous f32 tensors: the image
    [N,C,S,S], the front image [N,C,Hf,Wf], ``maps`` ((tensor, channels),
    ...) each [N,channels,r,r], fwmask [N,1,S,S] or None; and its outputs,
    allocated. -> (image, front, maps, fwmask, outputs)."""
    dev = image.device
    image = image.to(torch.float32).contiguous()
    N, _, S, S2 = image.shape
    vr._require(S == S2, "K8 takes square images")
    C = front.shape[1]
    vr._require(C == image.shape[1] and front.shape[0] == N and front.device == dev,
                "K8 front must be [N,C,Hf,Wf] with the image's N and C, on its device")
    r = maps[0][0].shape[-1]
    ins = []
    for t_, ch in maps:
        vr._require(tuple(t_.shape) == (N, ch, r, r) and t_.device == dev,
                    f"K8 takes [N,{ch},r,r] maps on the image's device")
        ins.append(t_.to(torch.float32).contiguous())
    if fwmask is not None:
        vr._require(tuple(fwmask.shape) == (N, 1, S, S), "K8 fwmask must be [N,1,S,S]")
        fwmask = fwmask.to(torch.float32).contiguous()
    out = {"image": torch.empty_like(image),
           "paste": torch.empty((N, C, S, S), dtype=torch.float32, device=dev)}
    for k in K8_OUTPUTS[2:]:
        out[k] = torch.empty((N, 1, S, S), dtype=torch.float32, device=dev)
    return image, front.to(torch.float32).contiguous(), ins, fwmask, out


def _launch_k8(image, front, weights, xyz, occ_bin, dxyz, bw: float, thresh_weight: float,
               thresh_edges: float, thresh_dxyz: float, fwmask=None):
    """One launch of K8's paste_front entry (see paste_composite_kernel)."""
    image, front, maps, fwmask, out = _k8_operands(
        image, front, ((weights, 1), (xyz, 3), (occ_bin, 1), (dxyz, 1)), fwmask)
    (N, C, S, _), r = image.shape, maps[0].shape[-1]
    kb.launch(
        "paste_front", _K8_ARGS, image.data_ptr(), front.data_ptr(), C, *front.shape[2:],
        *(t_.data_ptr() for t_ in maps), fwmask.data_ptr() if fwmask is not None else None,
        *(out[k].data_ptr() for k in K8_OUTPUTS),
        N, S, r, float(bw), float(thresh_weight), float(thresh_edges), float(thresh_dxyz),
        float(r / S), float(r / S), vr._stream(image))
    KERNELS["paste_front"].launches += 1
    return out


_K8G_ARGS = (kb.PTR,) * 4 + (kb.INT,) * 3 + (kb.PTR,) * 4 + (kb.INT,) * 3 + (kb.FLOAT, kb.PTR)


def paste_front_grad_plain(mask, g_image, g_paste, front, xyz, bw: float):
    """The plain version of K8's backward form: the gradient of the blend
    image + (paste - image) * mask with the masks held (the JAX package
    stop-gradients them): g - g mask to the rendered image [N,C,S,S], and
    g mask (+ ``g_paste``, the paste output's own gradient, or None) back
    through sample_orthofront of ``front`` at upsample_bilinear(xyz, S) by
    autograd to the render's image_xyz [N,3,r,r]. -> (g_image, g_xyz)."""
    g_image = g_image.to(torch.float32)
    gp = g_image * mask
    if g_paste is not None:
        gp = gp + g_paste.to(torch.float32)
    with torch.enable_grad():
        leaf = xyz.detach().to(torch.float32).requires_grad_(True)
        paste = sample_orthofront(front.to(torch.float32),
                                  upsample_bilinear(leaf, mask.shape[-1]), bw)
        (g_xyz,) = torch.autograd.grad(paste, leaf, gp)
    return g_image - g_image * mask, g_xyz


def paste_front_grad_kernel(mask, g_image, g_paste, front, xyz, bw: float):
    """Launch K8's backward form on CUDA tensors: same contract as
    paste_front_grad_plain. Two launches (the pixels, then the render's
    texels gathering their footprints), no atomics: the same bits on every
    run."""
    N, C, S, _ = g_image.shape
    r, dev = xyz.shape[-1], g_image.device
    vr._require(tuple(mask.shape) == (N, 1, S, S) and tuple(xyz.shape) == (N, 3, r, r)
                and front.shape[:2] == (N, C) and r <= S and front.device == dev
                and xyz.device == dev and mask.device == dev,
                "K8's backward takes mask [N,1,S,S], g_image [N,C,S,S], front [N,C,Hf,Wf] and "
                "xyz [N,3,r,r] (r <= S) on one device")
    g_out = g_image.to(torch.float32).contiguous()
    if g_paste is not None:
        vr._require(tuple(g_paste.shape) == (N, C, S, S), "K8's backward: g_paste [N,C,S,S]")
        g_paste = g_paste.to(torch.float32).contiguous()
    mask, front = mask.to(torch.float32).contiguous(), front.to(torch.float32).contiguous()
    xyz = xyz.to(torch.float32).contiguous()
    g_img = torch.empty_like(g_out)
    g_up = torch.empty((N, 2, S, S), dtype=torch.float32, device=dev)
    g_xyz = torch.empty((N, 3, r, r), dtype=torch.float32, device=dev)
    kb.launch(
        "paste_front_grad", _K8G_ARGS, mask.data_ptr(), g_out.data_ptr(),
        g_paste.data_ptr() if g_paste is not None else None, front.data_ptr(), C,
        *front.shape[2:], xyz.data_ptr(), g_img.data_ptr(), g_up.data_ptr(), g_xyz.data_ptr(),
        N, S, r, float(bw), vr._stream(g_out))
    KERNELS["paste_front_grad"].launches += 1
    return g_img, g_xyz


class PasteComposite(torch.autograd.Function):
    """K8 (either entry) with its backward form: ``launch(image, xyz)`` runs
    the entry (its other operands bound in) -> the dict of K8_OUTPUTS; the
    rendered image and image_xyz take their gradients from the blended
    image's and the paste's, by the kernel on CUDA tensors and by
    paste_front_grad_plain on CPU ones. The masks are outputs without a
    gradient, and the maps they come from (weights, occlusion, discrepancy,
    the front weights) take none: the JAX package stop-gradients them. The
    front image takes none (the wrappers refuse one that requires grad).
    -> the outputs in K8_OUTPUTS' order."""

    @staticmethod
    def forward(ctx, launch, bw, image, xyz, front):
        out = launch(image, xyz)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(out["mask"], front, xyz)
        ctx.bw, ctx.image_dtype = bw, image.dtype
        masks = tuple(out[k] for k in K8_OUTPUTS[2:])
        ctx.mark_non_differentiable(*masks)
        return (out["image"], out["paste"]) + masks

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_image, g_paste, *_):
        mask, front, xyz = ctx.saved_tensors
        if g_image is None:
            g_image = torch.zeros((mask.shape[0], front.shape[1], *mask.shape[2:]),
                                  dtype=torch.float32, device=mask.device)
        fn = paste_front_grad_kernel if mask.is_cuda else paste_front_grad_plain
        g_img, g_xyz = fn(mask, g_image, g_paste, front, xyz, ctx.bw)
        return None, None, g_img.to(ctx.image_dtype), g_xyz.to(xyz.dtype), None


def _paste_apply(launch, bw, image, xyz, front):
    """PasteComposite's outputs as K8's dict."""
    return dict(zip(K8_OUTPUTS, PasteComposite.apply(launch, bw, image, xyz, front)))


def paste_composite_kernel(image, front, weights, xyz, occ_bin, dxyz, bw: float,
                           thresh_weight: float, thresh_edges: float, thresh_dxyz: float,
                           fwmask=None):
    """Launch K8 on CUDA tensors: same contract as paste_composite_plain,
    differentiable in the image and xyz (PasteComposite). A front image or
    fwmask that requires grad raises under grad mode."""
    require_no_grad("paste_front", front, fwmask)
    out = _paste_apply(
        lambda im, xz: _launch_k8(im, front, weights, xz, occ_bin, dxyz, bw, thresh_weight,
                                  thresh_edges, thresh_dxyz, fwmask), bw, image, xyz, front)
    out["mask_frontweight"] = torch.ones_like(out["mask"]) if fwmask is None else fwmask
    return out


def _occlusion_sample_plain(vol, pts, offset: float, seg_len: float):
    return vlat.occlusion_sample_plain(vol["A"], vol["density0"], pts.contiguous(),
                                       vol["box_warp"], offset, seg_len)


def paste_composite_occ_plain(image, front, weights, xyz, vol, rays, bw: float,
                              offset_occ: float, seg_len: float, thresh_occ: float,
                              thresh_weight: float, thresh_edges: float, thresh_dxyz: float,
                              fwmask=None):
    """paste_front with the grid occlusion from the r^2 render on (the plain
    version of K8's paste_front_occ entry): the grid occlusion read by K7b's
    plain sampler and thresholded, the xyz discrepancy from ``rays`` (the
    force_rays, [N,3,r,r] origins and directions), then
    paste_composite_plain. Same outputs as paste_composite_plain."""
    occ = front_occlusion_grid(vol, xyz, offset_occ, seg_len, _occlusion_sample_plain)
    occ_bin = (occ < thresh_occ).to(torch.float32)
    dxyz = TriPlaneGenerator._get_xyz_discrepancy(xyz, rays)
    return paste_composite_plain(image, front, weights, xyz, occ_bin, dxyz, bw, thresh_weight,
                                 thresh_edges, thresh_dxyz, fwmask)


def _launch_k8_occ(image, front, weights, xyz, vol, rays, bw: float, offset_occ: float,
                   seg_len: float, thresh_occ: float, thresh_weight: float, thresh_edges: float,
                   thresh_dxyz: float, fwmask=None):
    """One launch of K8's paste_front_occ entry (see
    paste_composite_occ_kernel)."""
    A, ro, rd = vol["A"], rays["ray_origins"], rays["ray_directions"]
    image, front, maps, fwmask, out = _k8_operands(
        image, front, ((weights, 1), (xyz, 3), (ro, 3), (rd, 3)), fwmask)
    (N, C, S, _), r, dev = image.shape, maps[0].shape[-1], image.device
    vr._require(r <= S, "K8's grid occlusion takes a render no larger than the image")
    # A may be one portrait's volume broadcast over a view batch (stride 0)
    vr._require(A.dtype == torch.float32 and A.shape[0] == N and A[0].is_contiguous()
                and A.device == dev, "K8 A must be f32 [N,Gx,Gy,Gz] volumes, each contiguous")
    d0 = torch.as_tensor(vol["density0"], dtype=torch.float32, device=dev).reshape(1)
    box = float(vol["box_warp"])
    kb.launch(
        "paste_front_occ", _K8_OCC_ARGS, image.data_ptr(), front.data_ptr(), C,
        *front.shape[2:], maps[0].data_ptr(), maps[1].data_ptr(), A.data_ptr(), A.stride(0),
        d0.data_ptr(), *A.shape[1:], maps[2].data_ptr(), maps[3].data_ptr(),
        fwmask.data_ptr() if fwmask is not None else None,
        *(out[k].data_ptr() for k in K8_OUTPUTS),
        N, S, r, float(bw), float(thresh_weight), float(thresh_edges), float(thresh_dxyz),
        float(r / S), float(r / S), 2.0 / box, box / 2, float(offset_occ), float(seg_len),
        float(thresh_occ), vr._stream(image))
    KERNELS["paste_front_occ"].launches += 1
    return out


def paste_composite_occ_kernel(image, front, weights, xyz, vol, rays, bw: float,
                               offset_occ: float, seg_len: float, thresh_occ: float,
                               thresh_weight: float, thresh_edges: float, thresh_dxyz: float,
                               fwmask=None):
    """Launch K8's paste_front_occ entry on CUDA tensors: same contract as
    paste_composite_occ_plain, differentiable in the image and xyz
    (PasteComposite; the occlusion and the discrepancy are masks and take no
    gradient). A front image or fwmask that requires grad raises under grad
    mode."""
    require_no_grad("paste_front_occ", front, fwmask)
    out = _paste_apply(
        lambda im, xz: _launch_k8_occ(im, front, weights, xz, vol, rays, bw, offset_occ,
                                      seg_len, thresh_occ, thresh_weight, thresh_edges,
                                      thresh_dxyz, fwmask), bw, image, xyz, front)
    # no front-weight mask: ones, as a view of a cached constant (no launch)
    N, _, S, _ = out["mask"].shape
    out["mask_frontweight"] = (constant((1.0,), out["mask"].device).expand(N, 1, S, S)
                               if fwmask is None else fwmask)
    return out


def paste_composite(image, front, weights, xyz, occ_bin, dxyz, bw: float,
                    thresh_weight: float, thresh_edges: float, thresh_dxyz: float,
                    fwmask=None):
    args = (image, front, weights, xyz, occ_bin, dxyz, bw, thresh_weight, thresh_edges,
            thresh_dxyz, fwmask)
    if image.device.type == "cpu":
        return paste_composite_plain(*args)
    if image.device.type == "cuda":
        return paste_composite_kernel(*args)
    raise RuntimeError(f"paste_front: no path for device {image.device}")
