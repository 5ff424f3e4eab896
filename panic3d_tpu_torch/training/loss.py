"""PAniC-3D GAN loss phases (panic3d_tpu/training/loss.py).

Role of `src/training/loss_orthocondA.py` (StyleGAN2LossOrthoCondA): the
adversarial dual-discrimination softplus GAN loss with R1, the ortho-view
reconstruction phases (front/left/right/back/rand: LPIPS + L1 +
boundary-masked alpha L2 + depth L2), the ortho-visibility loss mask, and
the EG3D density regulariser.

Each phase is a function of the batch, the latents and a ``generator``
(a torch.Generator, or a utils/draws.Replay of given draws) that returns
(scalar loss, stats dict); the training loop (training/loop.py) takes its
gradient with autograd. The phases draw in the JAX package's order: a
phase that runs G and then D draws G's (the swap, the noise, the render's
jitter and u) before D's (the label noise). Each ``jax.lax.stop_gradient``
of the JAX phases is a ``.detach()`` (or ``torch.no_grad()`` around
Dmain's generator pass); R1 is ``torch.autograd.grad(create_graph=True)``.
With an ``augment_fn`` (ADA) the discriminator's inputs go through the
augment pipe at the step's ``aug_p`` in Gmain, Dmain and Dreg, drawing from
the phase's generator before D's own draws, as the JAX package splits its
key. The fused recon modes and the path-length phase are not ported (the
trainer refuses them, ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..models.dual_discriminator import filtered_resizing
from ..models.stylegan2 import resize_bilinear
from ..ops.grid_sample import grid_sample_2d
from ..ops.upfirdn2d import filter2d
from ..utils import draws
from ..utils.imageops import dilation, erosion


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Mirrors the trainer CLI lambdas (train_eclustrousC.py:152-181)."""

    r1_gamma: float = 10.0
    blur_init_sigma: float = 0.0
    blur_fade_kimg: float = 200.0
    gpc_reg_prob: Optional[float] = None
    gpc_reg_fade_kimg: float = 1000.0
    neural_rendering_resolution_initial: int = 64
    neural_rendering_resolution_final: Optional[int] = None
    neural_rendering_resolution_fade_kimg: float = 0.0
    dual_discrimination: bool = True
    filter_mode: Any = "antialiased"
    style_mixing_prob: float = 0.0

    lambda_gcond_lpips: float = 10.0
    lambda_gcond_l1: float = 1.0
    lambda_gcond_alpha_l2: float = 0.0
    lambda_gcond_depth_l2: float = 0.0
    lambda_gcond_sides_lpips: float = 0.0
    lambda_gcond_sides_l1: float = 0.0
    lambda_gcond_sides_alpha_l2: float = 0.0
    lambda_gcond_sides_depth_l2: float = 0.0
    lambda_gcond_back_lpips: float = 0.0
    lambda_gcond_back_l1: float = 0.0
    lambda_gcond_back_alpha_l2: float = 0.0
    lambda_gcond_back_depth_l2: float = 0.0
    lambda_gcond_rand_lpips: float = 0.0
    lambda_gcond_rand_l1: float = 0.0
    lambda_gcond_rand_alpha_l2: float = 0.0
    lambda_gcond_rand_depth_l2: float = 0.0

    lossmask_mode_adv: str = "none"
    lossmask_mode_recon: str = "none"
    lambda_recon_lpips: float = 0.0
    lambda_recon_l1: float = 0.0
    lambda_recon_alpha_l2: float = 0.0
    lambda_recon_depth_l2: float = 0.0

    paste_params_mode: Optional[str] = None

    density_reg: float = 0.25
    density_reg_p_dist: float = 0.004
    reg_type: str = "l1"
    box_warp: float = 0.7

    pl_weight: float = 0.0
    pl_batch_shrink: int = 2
    pl_decay: float = 0.01

    @property
    def paste_params(self):
        if self.paste_params_mode in ("A", "Agrad"):
            return dict(mode="default", thresh_weight=0.95, thresh_edges=0.02,
                        thresh_occ=0.05, offset_occ=0.01, thresh_dxyz=0.000005)
        return None

    def blur_sigma(self, cur_nimg) -> float:
        """The progressive blur schedule (loss:208), a host float."""
        if self.blur_fade_kimg <= 0 or self.blur_init_sigma == 0:
            return 0.0
        return max(1 - cur_nimg / (self.blur_fade_kimg * 1e3), 0) * self.blur_init_sigma

    def swapping_prob(self, cur_nimg):
        if self.gpc_reg_prob is None:
            return None
        a = min(cur_nimg / (self.gpc_reg_fade_kimg * 1e3), 1.0) if self.gpc_reg_fade_kimg > 0 \
            else 1.0
        return (1 - a) * 1 + a * self.gpc_reg_prob

    def neural_rendering_resolution(self, cur_nimg) -> int:
        """The resolution ramp (loss_orthocondA.py:214-218); fade 0 with a
        final resolution gives the final one at once."""
        if self.neural_rendering_resolution_final is None:
            return self.neural_rendering_resolution_initial
        a = min(int(cur_nimg) / max(self.neural_rendering_resolution_fade_kimg * 1e3, 1e-8), 1)
        return int(np.rint(self.neural_rendering_resolution_initial * (1 - a)
                           + self.neural_rendering_resolution_final * a))


def active_recon_views(c: LossConfig) -> tuple:
    """Ortho recon views with any active lambda (training_loop_v0.py:221-266)."""
    views = []
    if (c.lambda_gcond_lpips + c.lambda_gcond_l1 + c.lambda_gcond_alpha_l2
            + c.lambda_gcond_depth_l2) > 0:
        views.append("front")
    if (c.lambda_gcond_sides_lpips + c.lambda_gcond_sides_l1
            + c.lambda_gcond_sides_alpha_l2 + c.lambda_gcond_sides_depth_l2) > 0:
        views += ["left", "right"]
    if (c.lambda_gcond_back_lpips + c.lambda_gcond_back_l1
            + c.lambda_gcond_back_alpha_l2 + c.lambda_gcond_back_depth_l2) > 0:
        views.append("back")
    return tuple(views)


def gaussian_blur_filter2d(img, blur_sigma: float):
    """Progressive-blur filter: exp2(-(x/sigma)^2) taps over floor(3 sigma)
    (loss:183-187); identity when that is 0. The JAX package's traced form
    pads the same taps with zeros to a fixed size, which filters alike."""
    blur_size = int(np.floor(blur_sigma * 3))
    if blur_size <= 0:
        return img
    f = torch.exp2(-(torch.arange(-blur_size, blur_size + 1, dtype=torch.float32)
                     / blur_sigma) ** 2)
    return filter2d(img, f / f.sum())


def mask_view_orthofront(front_xyz, front_alpha, view_xyz, view_alpha, boxwarp):
    """Ortho-visibility mask (loss_orthocondA.py:35-54): the view's xyz
    projected into the front-ortho frame, kept where its z matches the
    front depth."""
    bw = boxwarp
    fz = front_xyz[:, 2:3]
    vij = 1 - (view_xyz[:, [1, 0]] + bw / 2) / bw
    vz = view_xyz[:, 2:3]
    src = torch.cat([(front_alpha > 0.5).to(torch.float32), fz], 1)
    grid = vij.permute(0, 2, 3, 1) * 2 - 1
    H = src.shape[-1]
    gq = (torch.round((grid + 1) * H / 2 - 0.5) + 0.5) * 2 / H - 1   # 'nearest' centres
    qs = grid_sample_2d(src.transpose(2, 3), gq)
    zmask = (vz - qs[:, -1:]) < (1.5 / 255) * bw
    return qs[:, :-1] * zmask * (view_alpha > 0.5)


def _boundary_mask(gt_alpha, k: int = 2):
    """(box-filtered alpha - 0.5) * 2 > 0.5: interior / exterior, not boundary."""
    box = F.avg_pool2d(gt_alpha, 2 * k + 1, stride=1, padding=k, count_include_pad=True)
    return (box - 0.5).abs() * 2 > 0.5


def recon_view_losses(out, gt_img, gt_alpha, gt_xyz, lpips_fn, depth_axis):
    """Shared recon-term math (loss_orthocondA.py:280-308,345-374,428-455);
    depth_axis 2 for front/back z, 0 for the sides' x, None for the
    full-xyz norm."""
    loss_lpips = lpips_fn(out["image"], gt_img).mean()
    loss_l1 = (out["image"] - gt_img).abs().mean()
    s = out["image_weights"].shape[-1]
    gt_alpha_s = resize_bilinear(gt_alpha, s)
    msk = _boundary_mask(gt_alpha_s)
    loss_alpha_l2 = ((out["image_weights"] - gt_alpha_s) ** 2 * msk.to(torch.float32)).mean()
    gt_xyz_s = resize_bilinear(gt_xyz, s)
    mskz = (msk & (out["image_weights"] > 0.5) & (gt_alpha_s > 0.5)).detach().to(torch.float32)
    if depth_axis is None:
        d = ((out["image_xyz"] - gt_xyz_s) ** 2).sum(1, keepdim=True).add(1e-12).sqrt()
        loss_depth_l2 = (d * mskz).mean()
    else:
        a = slice(depth_axis, depth_axis + 1)
        loss_depth_l2 = ((out["image_xyz"][:, a] - gt_xyz_s[:, a]) ** 2 * mskz).mean()
    return loss_lpips, loss_l1, loss_alpha_l2, loss_depth_l2


_AZIMUTH = {"front": 0.0, "left": 90.0, "right": -90.0, "back": 180.0}


class OrthoCondLoss:
    """Bundles G/D callables + config into per-phase loss functions.

    G_f(xin, generator) -> the G.f output dict
    G_mapping(z, c, cond) -> ws
    G_sample_mixed(coords, dirs, ws, cond) -> dict with 'sigma'
    D_apply(img_dict, c, cond, generator) -> logits
    lpips_fn(a, b) -> [N]
    augment_fn(images, generator, p) -> images (ADA), or None
    """

    def __init__(self, cfg: LossConfig, G_f, G_mapping, G_sample_mixed, D_apply, lpips_fn,
                 augment_fn=None):
        self.cfg = cfg
        self.G_f = G_f
        self.G_mapping = G_mapping
        self.G_sample_mixed = G_sample_mixed
        self.D_apply = D_apply
        self.lpips_fn = lpips_fn
        self.augment_fn = augment_fn

    # -- G recon phases -----------------------------------------------------

    def g_cond_loss(self, batch, z, generator, view="front"):
        """Gcond / Gside-left / Gside-right / Gside-back / Grand."""
        cfg = self.cfg
        cond = batch["cond"]
        if view == "rand":
            gt_img, gt_alpha, gt_xyz = cond["image"], cond["image_alpha"], cond["image_xyz"]
            xin = {"z": z, "cond": cond, "camera_params": cond["image_camera"],
                   "paste_params": cfg.paste_params}
            depth_axis = None
            lam = (cfg.lambda_gcond_rand_lpips, cfg.lambda_gcond_rand_l1,
                   cfg.lambda_gcond_rand_alpha_l2, cfg.lambda_gcond_rand_depth_l2)
        else:
            n = z.shape[0]
            gt_img = cond[f"image_ortho_{view}"]
            gt_alpha = cond[f"image_ortho_{view}_alpha"]
            gt_xyz = cond[f"image_ortho_{view}_xyz"]
            # on z's device: the angles from the host would make it wait for the card
            xin = {"z": z, "cond": cond, "camera_params": cond[f"image_ortho_{view}_camera"],
                   "elevations": z.new_zeros(n), "azimuths": z.new_full((n,), _AZIMUTH[view]),
                   "distances": z.new_ones(n), "paste_params": cfg.paste_params}
            depth_axis = 0 if view in ("left", "right") else 2
            if view == "front":
                lam = (cfg.lambda_gcond_lpips, cfg.lambda_gcond_l1,
                       cfg.lambda_gcond_alpha_l2, cfg.lambda_gcond_depth_l2)
            elif view == "back":
                lam = (cfg.lambda_gcond_back_lpips, cfg.lambda_gcond_back_l1,
                       cfg.lambda_gcond_back_alpha_l2, cfg.lambda_gcond_back_depth_l2)
            else:
                lam = (cfg.lambda_gcond_sides_lpips, cfg.lambda_gcond_sides_l1,
                       cfg.lambda_gcond_sides_alpha_l2, cfg.lambda_gcond_sides_depth_l2)
        out = self.G_f(xin, generator)
        l_lp, l_l1, l_a, l_d = recon_view_losses(out, gt_img, gt_alpha, gt_xyz, self.lpips_fn,
                                                 depth_axis)
        loss = lam[0] * l_lp + lam[1] * l_l1 + lam[2] * l_a + lam[3] * l_d
        stats = {f"Loss/G/{view}/lpips": l_lp, f"Loss/G/{view}/l1": l_l1,
                 f"Loss/G/{view}/alpha_l2": l_a, f"Loss/G/{view}/depth_l2": l_d,
                 f"Loss/G/{view}": loss}
        return loss, stats

    # -- adversarial helpers --------------------------------------------------

    def _c_gen(self, c, swapping_prob, generator, shape):
        if swapping_prob is None:
            return torch.zeros_like(c)
        take = draws.uniform(shape, generator, c.device, "c swap") < swapping_prob
        return torch.where(take, torch.roll(c, 1, 0), c)

    def run_G(self, z, c, cond, generator, swapping_prob, neural_rendering_resolution):
        """loss_orthocondA.py:157-180: ws from the (possibly swapped) label,
        rendered with the true cameras."""
        c_gen = self._c_gen(c, swapping_prob, generator, (c.shape[0], 1))
        ws = self.G_mapping(z, c_gen, cond)
        if self.cfg.style_mixing_prob > 0:
            # vanilla EG3D style mixing (src/training/loss.py:87-92)
            num_ws = ws.shape[1]
            ws2 = self.G_mapping(draws.normal(tuple(z.shape), generator, z.device, "mixing z"),
                                 c_gen, cond)
            cut = draws.uniform((), generator, z.device, "mixing cutoff")
            gate = draws.uniform((), generator, z.device, "mixing gate")
            cutoff = 1 + int(cut * (num_ws - 1))
            if float(gate) >= self.cfg.style_mixing_prob:
                cutoff = num_ws
            mixed = torch.arange(num_ws, device=ws.device)[None, :, None] >= cutoff
            ws = torch.where(mixed, ws2, ws)
        xin = {"ws": ws, "cond": cond, "camera_params": c, "normalize_images": True,
               "neural_rendering_resolution": neural_rendering_resolution,
               "paste_params": self.cfg.paste_params}
        return self.G_f(xin, generator)

    def run_D(self, img, c, cond, generator, blur_sigma: float = 0.0,
              aug_p: Optional[float] = None):
        if blur_sigma > 0:
            img = dict(img, image=gaussian_blur_filter2d(img["image"], blur_sigma))
        if self.augment_fn is not None and aug_p is not None:
            # joint-pair ADA (loss_orthocondA.py:189-195): the raw stream
            # resized up to full size, the 6-channel pair augmented with one
            # warp, split, and the raw half resized back down, antialiased
            full, raw = img["image"], img["image_raw"]
            up = resize_bilinear(raw, full.shape[-1])
            pair = self.augment_fn(torch.cat([full, up], 1), generator, aug_p)
            img = dict(img, image=pair[:, :full.shape[1]],
                       image_raw=filtered_resizing(pair[:, full.shape[1]:], raw.shape[-1],
                                                   filter_mode="antialiased"))
        return self.D_apply(img, c, cond, generator)

    def prep_real_img(self, real_img, cur_nimg):
        """Raw-stream construction + progressive blur (loss:220-232)."""
        cfg = self.cfg
        res = cfg.neural_rendering_resolution(cur_nimg)
        raw = filtered_resizing(real_img, res, filter_mode=cfg.filter_mode)
        return {"image": real_img,
                "image_raw": gaussian_blur_filter2d(raw, cfg.blur_sigma(cur_nimg)),
                "image_raw_noblur": resize_bilinear(real_img, res)}

    def _lmask(self, batch):
        cond = batch["cond"]
        return mask_view_orthofront(cond["image_ortho_front_xyz"], cond["image_ortho_front_alpha"],
                                    cond["image_xyz"], cond["image_alpha"], self.cfg.box_warp)

    # -- Gmain ---------------------------------------------------------------

    def g_main_loss(self, batch, z, c, generator, cur_nimg, gain=1.0, aug_p=None):
        """Adversarial G phase (+ masked recon, loss:480-576)."""
        cfg = self.cfg
        cond = batch["cond"]
        res = cfg.neural_rendering_resolution(cur_nimg)
        gen_img = self.run_G(z, c, cond, generator, cfg.swapping_prob(cur_nimg), res)
        real_img = None
        stats = {}
        if cfg.lossmask_mode_adv != "none":
            real_img = self.prep_real_img(batch["image"], cur_nimg)
            lmask_adv = 1 - erosion(self._lmask(batch), int(cfg.lossmask_mode_adv.split("_")[-1]))
            raw_mask = (resize_bilinear(lmask_adv, gen_img["image_raw"].shape[-1]) > 0.5).float()
            full_mask = resize_bilinear(lmask_adv, gen_img["image"].shape[-1])
            gen_for_adv = {
                "image": real_img["image"] + (gen_img["image"] - real_img["image"]) * full_mask,
                "image_raw": real_img["image_raw_noblur"]
                + (gen_img["image_raw"] - real_img["image_raw_noblur"]) * raw_mask}
        else:
            gen_for_adv = gen_img
        gen_logits = self.run_D(gen_for_adv, c, cond, generator, cfg.blur_sigma(cur_nimg), aug_p)
        loss_gmain = F.softplus(-gen_logits)
        stats["Loss/scores/fake"] = gen_logits.mean()
        stats["Loss/G/loss"] = loss_gmain.mean()

        loss_grecon = 0.0
        if cfg.lossmask_mode_recon != "none":
            if real_img is None:
                real_img = self.prep_real_img(batch["image"], cur_nimg)
            lmask_recon = dilation(self._lmask(batch), int(cfg.lossmask_mode_recon.split("_")[-1]))
            raw_mask = (resize_bilinear(lmask_recon, gen_img["image_raw"].shape[-1]) > 0.5).float()
            full_mask = resize_bilinear(lmask_recon, gen_img["image"].shape[-1])
            image = (real_img["image"] + (gen_img["image"] - real_img["image"]) * full_mask) \
                * 0.5 + 0.5
            l_lp = self.lpips_fn(image, cond["image"]).mean()
            l_l1 = (image - cond["image"]).abs().mean()
            s = gen_img["image_weights"].shape[-1]
            gt_alpha = resize_bilinear(cond["image_alpha"], s)
            msk = _boundary_mask(gt_alpha)
            l_a = ((gen_img["image_weights"] - gt_alpha) ** 2 * msk.float() * raw_mask).mean()
            gt_xyz = resize_bilinear(cond["image_xyz"], s)
            mskz = (msk & (gen_img["image_weights"] > 0.5) & (gt_alpha > 0.5)).detach().float()
            d = ((gen_img["image_xyz"] - gt_xyz) ** 2).sum(1, keepdim=True).add(1e-12).sqrt()
            l_d = (d * mskz * raw_mask).mean()
            loss_grecon = (cfg.lambda_recon_lpips * l_lp + cfg.lambda_recon_l1 * l_l1
                           + cfg.lambda_recon_alpha_l2 * l_a + cfg.lambda_recon_depth_l2 * l_d)
            stats["Loss/G/loss_recon"] = loss_grecon
        return loss_gmain.mean() * gain + loss_grecon, stats

    # -- Greg: density regularisation -----------------------------------------

    def g_reg_loss(self, batch, z, c, generator, cur_nimg, gain=1.0):
        """Density TV (l1) regulariser (loss:579-688)."""
        cfg = self.cfg
        cond = batch["cond"]
        c_gen = self._c_gen(c, cfg.swapping_prob(cur_nimg), generator, ())
        ws = self.G_mapping(z, c_gen, cond)
        if cfg.reg_type != "l1":
            raise NotImplementedError(f"reg_type {cfg.reg_type!r}: the port's Greg takes 'l1' "
                                      "(ROADMAP Queue 1 item 5)")
        dev = ws.device
        coords = draws.uniform((ws.shape[0], 1000, 3), generator, dev, "Greg coords") * 2 - 1
        pert = coords + draws.normal(tuple(coords.shape), generator, dev, "Greg perturbation") \
            * cfg.density_reg_p_dist
        allc = torch.cat([coords, pert], 1)
        dirs = draws.normal(tuple(allc.shape), generator, dev, "Greg directions")
        sigma = self.G_sample_mixed(allc, dirs, ws, cond)["sigma"]
        half = sigma.shape[1] // 2
        tv = (sigma[:, :half] - sigma[:, half:]).abs().mean() * cfg.density_reg
        return tv * gain, {"Loss/G/reg": tv}

    # -- D phases --------------------------------------------------------------

    def d_main_loss(self, batch, z, c, generator, cur_nimg, gain=1.0, aug_p=None):
        """Dgen + Dreal softplus (loss:690-718); G's pass takes no gradient."""
        cfg = self.cfg
        cond = batch["cond"]
        blur_sigma = cfg.blur_sigma(cur_nimg)
        with torch.no_grad():
            gen_img = self.run_G(z, c, cond, generator, cfg.swapping_prob(cur_nimg),
                                 cfg.neural_rendering_resolution(cur_nimg))
        gen_logits = self.run_D(gen_img, c, cond, generator, blur_sigma, aug_p)
        loss_dgen = F.softplus(gen_logits)
        real_img = self.prep_real_img(batch["image"], cur_nimg)
        real_logits = self.run_D({"image": real_img["image"], "image_raw": real_img["image_raw"]},
                                 c, cond, generator, blur_sigma, aug_p)
        loss_dreal = F.softplus(-real_logits)
        total = (loss_dgen + loss_dreal).mean()
        stats = {"Loss/scores/fake": gen_logits.mean(), "Loss/scores/real": real_logits.mean(),
                 "Loss/signs/fake": gen_logits.sign().mean(),
                 "Loss/signs/real": real_logits.sign().mean(), "Loss/D/loss": total}
        return total * gain, stats

    def d_reg_loss(self, batch, c, generator, cur_nimg, gain=1.0, aug_p=None):
        """R1 penalty by a gradient of the gradient (loss:704-738), through
        the augment when ADA runs (K4's and K14's backward forms, each
        differentiable again)."""
        cfg = self.cfg
        real_img = self.prep_real_img(batch["image"], cur_nimg)
        image = real_img["image"].detach().requires_grad_(True)
        image_raw = real_img["image_raw"].detach().requires_grad_(True)
        logits = self.run_D({"image": image, "image_raw": image_raw}, c, batch["cond"], generator,
                            cfg.blur_sigma(cur_nimg), aug_p)
        g_img, g_raw = torch.autograd.grad(logits.sum(), (image, image_raw), create_graph=True)
        r1 = g_img.square().sum((1, 2, 3))
        if cfg.dual_discrimination:
            r1 = r1 + g_raw.square().sum((1, 2, 3))
        loss = (r1 * (cfg.r1_gamma / 2)).mean()
        return loss * gain, {"Loss/r1_penalty": r1.mean(), "Loss/D/reg": loss}
