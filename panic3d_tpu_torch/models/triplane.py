"""TriPlaneGenerator: StyleGAN2 backbone -> triplanes -> volume render -> SR
(panic3d_tpu/models/triplane.py).

``G.f(x)``, the kwargs-dict inference entry, is the public API, as in the
JAX package. Ported: z / seeds / ws latents, camera labels from
elevations/azimuths[/distances/fovs] or camera_params, the ortho/pinhole ray
select, mapping, synthesis, triplane_crop / cull_clouds / binarize_clouds.
Not ported yet (raise NotImplementedError): paste_params (paste-front),
per-slot z+ latents (``zs``), latent injection, precomputed planes and the
ESS occupancy inputs.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from ..cameras.conventions import camera_label, get_rays_ortho
from ..cameras.rays import sample_rays
from .stylegan2 import FullyConnectedLayer, Generator, init_weights
from .superresolution import SR_MODULES
from .volumetric import renderer as vr

_UNPORTED_INPUTS = ("zs", "latent_injection", "_planes", "_skip_sr", "_ess_occ",
                    "_occ_vol", "_rays_z_aligned")


def seeds_to_z(seeds, z_dim: int) -> np.ndarray:
    """Per-seed z vectors via np.random.RandomState (triplane.py:352-355)."""
    return np.stack([np.random.RandomState(s).randn(z_dim) for s in seeds]).astype(np.float32)


class OSGDecoder(nn.Module):
    """Per-sample MLP decoder (triplane.py:516-548): mean over planes ->
    FC(C->64) -> softplus -> FC(64->33); sigma = channel 0, rgb = sigmoid of
    the rest. ``net`` mirrors the reference's Sequential for its state_dict
    names (net.0, net.2); the decode itself runs in kernel K1
    (renderer.triplane_decode), which takes :meth:`weights`."""

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
        self.triplane_width = triplane_width
        self.neural_rendering_resolution = neural_rendering_resolution
        self.force_sigmoid = force_sigmoid
        self.rk = dict(DEFAULT_RENDERING_KWARGS, **(rendering_kwargs or {}))
        if self.rk.get("triplane_depth", 1) != 1:
            raise NotImplementedError("triplane_depth > 1 is not ported yet")
        self.backbone = Generator(
            z_dim=z_dim, c_dim=c_dim, w_dim=w_dim, img_resolution=backbone_resolution,
            img_channels=triplane_width * 3, cond_mode=cond_mode,
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
    def num_ws(self) -> int:
        return self.backbone.num_ws

    @property
    def device(self) -> torch.device:
        return self.decoder.net[0].weight.device

    def _t(self, v):
        return torch.as_tensor(v, dtype=torch.float32, device=self.device)

    def mapping(self, z, c, truncation_psi=1.0, truncation_cutoff=None):
        """triplane.py:88-122, with c zeroing and c_scale."""
        if self.rk["c_gen_conditioning_zero"]:
            c = torch.zeros_like(c)
        c = c * self.rk.get("c_scale", 0)
        return self.backbone.mapping(z, c, truncation_psi=truncation_psi,
                                     truncation_cutoff=truncation_cutoff)

    def synthesis(self, ws, c, cond=None, neural_rendering_resolution: Optional[int] = None,
                  force_rays=None, triplane_crop=None, cull_clouds=None,
                  binarize_clouds=None, normalize_images=True, noise_mode="const"):
        """triplane.py:145-252 -> the output dict."""
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
        planes = self.backbone.synthesis(ws, cond, noise_mode=noise_mode)
        planes = planes.reshape(N, 3, self.triplane_width, planes.shape[-2], planes.shape[-1])
        out = vr.render(planes, self.decoder.weights(self.force_sigmoid),
                        ray_origins.contiguous(), ray_directions.contiguous(), rk,
                        triplane_crop=triplane_crop, cull_clouds=cull_clouds,
                        binarize_clouds=binarize_clouds)

        def image(t):
            return t.transpose(1, 2).reshape(N, -1, res, res)

        feature_image = image(out.rgb)
        xyz_image = 0.5 * (image(out.xyz) + 1) * self._t([-1.0, 1.0, -1.0])[None, :, None, None]
        rgb_image = feature_image[:, :3]
        sr_image = self.superresolution(rgb_image, feature_image, ws,
                                        noise_mode=rk["superresolution_noise_mode"])
        ans = {
            "image": sr_image,
            "image_raw": rgb_image,
            "image_depth": image(out.depth),
            "triplane": planes,
            "image_weights": image(out.weights),
            "image_xyz": xyz_image,
        }
        if rk.get("tanh_rgb_output", False):
            ans["image"] = torch.tanh(ans["image"])
            ans["image_raw"] = torch.tanh(ans["image_raw"])
        if not normalize_images:
            ans["image"] = 0.5 * ans["image"] + 0.5
            ans["image_raw"] = 0.5 * ans["image_raw"] + 0.5
        return ans

    def f(self, x: Dict[str, Any], truncation_psi=1.0, truncation_cutoff=None,
          normalize_images=False, noise_mode="const"):
        """Universal inference entry (triplane.py:313-508). Accepts ws | z |
        seeds, camera_params | (elevations, azimuths[, distances, fovs]),
        cond, triplane_crop / cull_clouds / binarize_clouds, force_rays.
        Returns image, image_raw, image_depth, image_weights, image_xyz,
        triplane, normalize_images."""
        x = dict(x)
        for k in _UNPORTED_INPUTS:
            if k in x:
                raise NotImplementedError(f"G.f input {k!r} is not ported yet")
        if x.get("paste_params"):
            raise NotImplementedError("paste_params (paste-front) is not ported yet")
        rk = self.rk
        if "ws" not in x and "z" not in x:
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

        cond = x.get("cond")
        ws = x["ws"] if "ws" in x else self.mapping(
            self._t(x["z"]), cam, truncation_psi=truncation_psi,
            truncation_cutoff=truncation_cutoff)
        normalize_images = x.get("normalize_images", normalize_images)
        synth = self.synthesis(
            ws, cam, cond, neural_rendering_resolution=res, force_rays=force_rays,
            triplane_crop=x.get("triplane_crop"), cull_clouds=x.get("cull_clouds"),
            binarize_clouds=x.get("binarize_clouds"), normalize_images=normalize_images,
            noise_mode=noise_mode)
        return {k: synth[k] for k in ("image", "image_raw", "image_depth",
                                      "image_weights", "triplane", "image_xyz")} | {
            "normalize_images": normalize_images}

    def paste_front(self, *args, **kwargs):
        raise NotImplementedError("paste-front compositing is not ported yet")
