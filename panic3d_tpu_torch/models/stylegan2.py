"""StyleGAN2 generator side (panic3d_tpu/models/stylegan2.py:33-699) and
discriminator side (:700-893: MinibatchStdLayer, DiscriminatorBlock,
DiscriminatorEpilogue, Discriminator with its c mapping).

Module and attribute names follow the reference state_dict (b{res}, conv0,
conv1, torgb, affine, fc{i}, embed, noise_const, w_avg), so
runtime/checkpoint.py maps the flax tree onto ``state_dict()`` 1:1.
``use_fp16`` means bfloat16, as in the JAX package. The FIR resampling runs
through upfirdn2d (kernel K4 on the card); the weight convs are cuDNN, and
the epilogue after each (demodulation, noise, bias, leaky relu, gain,
clamp) is one launch of kernel K5, as is the mapping layers' bias + lrelu.
On the card both kernels carry their backward forms (K4's transposed
pass, K5's masked product), so the discriminator's blocks differentiate
twice for R1.

Every cond mode of the JAX package (``_apply_cond``; ``resnetcond_<N>`` in
the mapping), the 'skip', 'resnet' and 'orig' architectures, latent
injection (``da_<lvl>`` / ``db_<lvl>`` after each block) and the three
noise modes. noise_mode='random' draws one [N,1,res,res] map a layer, from
``generator`` (utils/draws.py) or as given.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.bias_act import activation_funcs, modconv_epilogue
from ..ops.conv import conv2d_resample, modulated_conv2d
from ..ops.upfirdn2d import downsample2d, setup_filter, upsample2d
from ..utils import draws


def normalize_2nd_moment(x, dim=1, eps=1e-8):
    return x * torch.rsqrt(x.square().mean(dim=dim, keepdim=True) + eps)


def resize_bilinear(x, size, antialias=False):
    """NCHW bilinear resize, align_corners=False (jax.image.resize
    'bilinear' in the JAX package)."""
    return F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False,
                         antialias=antialias)


def pixel_shuffle_fold(img, fct: int):
    """Fold fct x fct spatial blocks into channels: [B,C,H,W] ->
    [B, fct*fct*C, H/fct, W/fct], channel index (dy*fct + dx)*C + c."""
    B, C, H, W = img.shape
    h, w = H // fct, W // fct
    return (img.reshape(B, C, h, fct, w, fct).permute(0, 3, 5, 1, 2, 4)
            .reshape(B, fct * fct * C, h, w))


def init_weights(module: nn.Module, seed: int) -> None:
    """Seeded initialization of every panic3d_tpu_torch module inside
    ``module`` (the JAX package's init distributions, torch's generator)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if hasattr(m, "reset_parameters_"):
                m.reset_parameters_(gen)


def _randn(t: torch.Tensor, gen, scale=1.0):
    t.copy_(torch.randn(t.shape, generator=gen) * scale)


class FullyConnectedLayer(nn.Module):
    """Equalized-lr dense layer (networks_stylegan2.py:101-136)."""

    def __init__(self, in_features, out_features, bias=True, activation="linear",
                 lr_multiplier=1.0, bias_init=0.0):
        super().__init__()
        self.in_features = in_features
        self.activation = activation
        self.lr_multiplier = lr_multiplier
        self.bias_init = bias_init
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None

    def reset_parameters_(self, gen):
        _randn(self.weight, gen, 1.0 / self.lr_multiplier)
        if self.bias is not None:
            self.bias.fill_(self.bias_init)

    def forward(self, x):
        w = self.weight.to(x.dtype) * (self.lr_multiplier / math.sqrt(self.in_features))
        b = self.bias
        if b is not None and self.lr_multiplier != 1:
            b = b * self.lr_multiplier
        x = x @ w.T
        if self.activation == "linear":
            return x + b.to(x.dtype) if b is not None else x
        if x.ndim != 2:
            raise NotImplementedError("FullyConnectedLayer with an activation takes [N, F]")
        return modconv_epilogue(x, bias=b.to(x.dtype) if b is not None else None,
                                act=self.activation)


class Conv2dLayer(nn.Module):
    """Unmodulated conv with FIR resampling and bias_act
    (networks_stylegan2.py:140-194); the resnet block's 1x1 ``skip``."""

    def __init__(self, in_channels, out_channels, kernel_size, bias=True,
                 activation="linear", up=1, down=1, resample_filter=(1, 3, 3, 1),
                 conv_clamp=None):
        super().__init__()
        self.activation, self.up, self.down = activation, up, down
        self.conv_clamp = conv_clamp
        self.padding = kernel_size // 2
        self.weight_gain = 1 / math.sqrt(in_channels * kernel_size ** 2)
        self.resample_filter = setup_filter(list(resample_filter))   # recomputed, not state
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel_size,
                                               kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None

    def reset_parameters_(self, gen):
        _randn(self.weight, gen)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x, gain=1.0):
        w = (self.weight * self.weight_gain).to(x.dtype)
        x = conv2d_resample(x, w, f=self.resample_filter, up=self.up, down=self.down,
                            padding=self.padding, flip_weight=(self.up == 1))
        act_gain = activation_funcs[self.activation].def_gain * gain
        act_clamp = self.conv_clamp * gain if self.conv_clamp is not None else None
        b = self.bias.to(x.dtype) if self.bias is not None else None
        return modconv_epilogue(x, bias=b, act=self.activation, gain=act_gain, clamp=act_clamp)


def resnet_cond_features(cond_mode: str) -> int:
    """N of a ``resnetcond_N`` token: the resnet features the mapping
    appends to the camera label (0 without one)."""
    for m in cond_mode.split("."):
        if m.startswith("resnetcond_"):
            return int(m.split("_")[-1])
    return 0


class MappingNetwork(nn.Module):
    """networks_stylegan2.py:198-294 (eval form: no w_avg update), with the
    ``resnetcond_N`` feature conditioning (panic3d_tpu/models/stylegan2.py:151)."""

    def __init__(self, z_dim, c_dim, w_dim, num_ws, num_layers=8, embed_features=None,
                 layer_features=None, activation="lrelu", lr_multiplier=0.01,
                 w_avg_beta=0.998, cond_mode="none"):
        super().__init__()
        self.z_dim, self.c_dim, self.w_dim, self.num_ws = z_dim, c_dim, w_dim, num_ws
        self.num_layers = num_layers
        self.resnet_cond = resnet_cond_features(cond_mode)
        if embed_features is None:
            embed_features = w_dim
        if c_dim == 0:
            embed_features = 0
        layer_features = layer_features or w_dim
        features = [z_dim + embed_features] + [layer_features] * (num_layers - 1) + [w_dim]
        if c_dim > 0:
            self.embed = FullyConnectedLayer(c_dim + self.resnet_cond, embed_features)
        for idx in range(num_layers):
            setattr(self, f"fc{idx}", FullyConnectedLayer(
                features[idx], features[idx + 1], activation=activation,
                lr_multiplier=lr_multiplier))
        if num_ws is not None and w_avg_beta is not None:
            self.register_buffer("w_avg", torch.zeros(w_dim))

    def reset_parameters_(self, gen):
        if hasattr(self, "w_avg"):
            self.w_avg.zero_()

    def forward(self, z, c, cond=None, truncation_psi=1.0, truncation_cutoff=None):
        x = normalize_2nd_moment(z.to(torch.float32)) if self.z_dim > 0 else None
        if self.c_dim > 0:
            if self.resnet_cond > 0:
                if cond is None or "resnet_feats" not in cond:
                    raise ValueError(f"resnetcond_{self.resnet_cond} needs cond['resnet_feats']")
                c = torch.cat([c, cond["resnet_feats"][:, :self.resnet_cond].to(c.dtype)], 1)
            y = normalize_2nd_moment(self.embed(c.to(torch.float32)))
            x = torch.cat([x, y], 1) if x is not None else y
        for idx in range(self.num_layers):
            x = getattr(self, f"fc{idx}")(x)
        if self.num_ws is not None:
            x = x[:, None, :].repeat(1, self.num_ws, 1)
        if truncation_psi != 1:
            if self.num_ws is None or truncation_cutoff is None:
                x = self.w_avg + (x - self.w_avg) * truncation_psi
            else:
                head = self.w_avg + (x[:, :truncation_cutoff] - self.w_avg) * truncation_psi
                x = torch.cat([head, x[:, truncation_cutoff:]], 1)
        return x


class SynthesisLayer(nn.Module):
    """Modulated conv + noise + bias_act (networks_stylegan2.py:298-358)."""

    def __init__(self, in_channels, out_channels, w_dim, resolution, kernel_size=3,
                 up=1, use_noise=True, activation="lrelu",
                 resample_filter: Sequence[int] = (1, 3, 3, 1),
                 conv_clamp: Optional[float] = None):
        super().__init__()
        self.up, self.use_noise, self.activation = up, use_noise, activation
        self.resolution = resolution
        self.padding = kernel_size // 2
        self.conv_clamp = conv_clamp
        self.resample_filter = setup_filter(list(resample_filter))   # recomputed, not state
        self.affine = FullyConnectedLayer(w_dim, in_channels, bias_init=1.0)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel_size,
                                               kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels))
        if use_noise:
            self.register_buffer("noise_const", torch.empty(resolution, resolution))
            self.noise_strength = nn.Parameter(torch.empty(()))

    def reset_parameters_(self, gen):
        _randn(self.weight, gen)
        self.bias.zero_()
        if self.use_noise:
            _randn(self.noise_const, gen)
            self.noise_strength.zero_()

    def forward(self, x, w, noise_mode="const", gain=1.0, generator=None, noise=None):
        """noise_mode 'const' adds noise_const, 'random' a [N,1,res,res]
        draw (``noise`` when given, else from ``generator``), each times
        noise_strength; 'none' adds nothing."""
        if noise_mode not in ("random", "const", "none"):
            raise ValueError(f"noise_mode must be 'random', 'const' or 'none', not {noise_mode!r}")
        styles = self.affine(w)
        strength = None
        if self.use_noise and noise_mode == "const":
            noise, strength = self.noise_const, self.noise_strength
        elif self.use_noise and noise_mode == "random":
            shape = (x.shape[0], 1, self.resolution, self.resolution)
            if noise is None:
                noise = draws.normal(shape, generator, x.device, "SynthesisLayer noise")
            elif tuple(noise.shape) != shape:
                raise ValueError(f"SynthesisLayer noise must be {shape}, got {tuple(noise.shape)}")
            strength = self.noise_strength
        else:
            noise = None
        act_gain = activation_funcs[self.activation].def_gain * gain
        act_clamp = self.conv_clamp * gain if self.conv_clamp is not None else None
        return modulated_conv2d(x, self.weight, styles, noise=noise, noise_strength=strength,
                                up=self.up, padding=self.padding,
                                resample_filter=self.resample_filter,
                                flip_weight=(self.up == 1), bias=self.bias,
                                act=self.activation, gain=act_gain, clamp=act_clamp)


class ToRGBLayer(nn.Module):
    """networks_stylegan2.py:362-383."""

    def __init__(self, in_channels, out_channels, w_dim, kernel_size=1, conv_clamp=None):
        super().__init__()
        self.conv_clamp = conv_clamp
        self.padding = kernel_size // 2
        self.weight_gain = 1 / math.sqrt(in_channels * kernel_size ** 2)
        self.affine = FullyConnectedLayer(w_dim, in_channels, bias_init=1.0)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel_size,
                                               kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels))

    def reset_parameters_(self, gen):
        _randn(self.weight, gen)
        self.bias.zero_()

    def forward(self, x, w):
        styles = self.affine(w) * self.weight_gain
        return modulated_conv2d(x, self.weight, styles, demodulate=False, padding=self.padding,
                                bias=self.bias, clamp=self.conv_clamp)


ARCHITECTURES = ("orig", "skip", "resnet")


class SynthesisBlock(nn.Module):
    """networks_stylegan2.py:387-487 in the 'skip', 'resnet' (a 1x1 ``skip``
    conv beside the two layers, each branch at gain sqrt(0.5)) and 'orig'
    architectures; a block has its torgb when it is the last or 'skip'.
    no_up is the superresolution variant (SynthesisBlockNoUp)."""

    def __init__(self, in_channels, out_channels, w_dim, resolution, img_channels,
                 is_last, architecture="skip", resample_filter=(1, 3, 3, 1),
                 conv_clamp: Optional[float] = 256, use_fp16=False, no_up=False):
        super().__init__()
        if architecture not in ARCHITECTURES:
            raise ValueError(f"architecture must be one of {ARCHITECTURES}, not {architecture!r}")
        self.in_channels, self.architecture = in_channels, architecture
        self.use_fp16, self.no_up = use_fp16, no_up
        self.resample_filter = setup_filter(list(resample_filter))   # recomputed, not state
        up = 1 if no_up else 2
        kw = dict(w_dim=w_dim, resolution=resolution, conv_clamp=conv_clamp,
                  resample_filter=resample_filter)
        if in_channels == 0:
            self.const = nn.Parameter(torch.empty(out_channels, resolution, resolution))
        else:
            self.conv0 = SynthesisLayer(in_channels, out_channels, up=up, **kw)
        self.conv1 = SynthesisLayer(out_channels, out_channels, **kw)
        if is_last or architecture == "skip":
            self.torgb = ToRGBLayer(out_channels, img_channels, w_dim=w_dim,
                                    conv_clamp=conv_clamp)
        if in_channels != 0 and architecture == "resnet":
            self.skip = Conv2dLayer(in_channels, out_channels, kernel_size=1, bias=False, up=up,
                                    resample_filter=resample_filter)

    def reset_parameters_(self, gen):
        if self.in_channels == 0:
            _randn(self.const, gen)

    def forward(self, x, img, ws, force_fp32=False, noise_mode="const", generator=None):
        full = torch.float64 if (ws if x is None else x).dtype == torch.float64 else torch.float32
        dtype = torch.bfloat16 if (self.use_fp16 and not force_fp32) else full
        w_iter = iter(ws.unbind(1))
        kw = dict(noise_mode=noise_mode, generator=generator)
        if self.in_channels == 0:
            x = self.const[None].to(dtype).expand((ws.shape[0],) + tuple(self.const.shape))
            x = self.conv1(x, next(w_iter), **kw)
        elif self.architecture == "resnet":
            x = x.to(dtype)
            y = self.skip(x, gain=math.sqrt(0.5))
            x = self.conv0(x, next(w_iter), **kw)
            x = self.conv1(x, next(w_iter), gain=math.sqrt(0.5), **kw)
            x = y + x
        else:
            x = x.to(dtype)
            x = self.conv0(x, next(w_iter), **kw)
            x = self.conv1(x, next(w_iter), **kw)
        if img is not None and not self.no_up:
            img = upsample2d(img, self.resample_filter)
        if hasattr(self, "torgb"):
            y = self.torgb(x, next(w_iter)).to(torch.float32)
            img = img + y if img is not None else y
        return x, img


class SynthesisNetwork(nn.Module):
    """networks_stylegan2.py:491-724 with every cond_mode injection
    (panic3d_tpu/models/stylegan2.py:488-651)."""

    def __init__(self, w_dim, img_resolution, img_channels, cond_mode="none",
                 channel_base=32768, channel_max=512, num_fp16_res=4, conv_clamp=256,
                 architecture="skip"):
        super().__init__()
        self.cond_mode = cond_mode
        self.cm = set(cond_mode.split("."))
        chonk = [int(m.split("_")[-1]) for m in self.cm if m.startswith("reschonk_add_")]
        self.chonkadd = chonk[0] if chonk else 0
        self.block_resolutions = [2 ** i for i in range(2, int(np.log2(img_resolution)) + 1)]
        channels = {res: min(channel_base // res, channel_max) for res in self.block_resolutions}
        fp16_resolution = max(2 ** (int(np.log2(img_resolution)) + 1 - num_fp16_res), 8)
        self.num_ws = 0
        for res in self.block_resolutions:
            self.num_ws += 1 if res == 4 else 2
            setattr(self, f"b{res}", SynthesisBlock(
                channels[res // 2] if res > 4 else 0, channels[res], w_dim=w_dim,
                resolution=res, img_channels=img_channels, is_last=(res == img_resolution),
                architecture=architecture, conv_clamp=conv_clamp,
                use_fp16=(res >= fp16_resolution)))
        self.num_ws += 1   # final torgb

    def forward(self, ws, cond=None, noise_mode="const", generator=None,
                latent_injection=None, stop_level=None):
        """ws [N,num_ws,w_dim] -> the image. Each block takes its convs'
        ws and the next one for its torgb, as the JAX package splits them
        (:498-505, a torgb counted for every block); ``latent_injection``
        adds ``da_<lvl>`` to x and ``db_<lvl>`` to the image after block
        lvl's cond injection; ``stop_level`` returns level stop_level's
        image, upsampled to the full size."""
        ws = ws.to(torch.float32)
        x = img = None
        w_idx = 0
        n_levels = len(self.block_resolutions)
        imgs = []
        for lvl, res in enumerate(self.block_resolutions):
            n_conv = 1 if res == 4 else 2
            cur_ws = ws[:, w_idx: w_idx + n_conv + 1]
            w_idx += n_conv
            x, img = getattr(self, f"b{res}")(x, img, cur_ws, noise_mode=noise_mode,
                                              generator=generator)
            x = self._apply_cond(x, cond, res, lvl, n_levels)
            img = self._inject_image(img, cond, res, lvl, n_levels)
            imgs.append(img)
            if latent_injection is not None:
                if f"da_{lvl}" in latent_injection:
                    x = x + latent_injection[f"da_{lvl}"]
                if f"db_{lvl}" in latent_injection:
                    img = img + latent_injection[f"db_{lvl}"]
        if stop_level is None:
            return img
        ret = imgs[stop_level]
        f = setup_filter([1, 3, 3, 1])
        for _ in range(stop_level + 1, n_levels):
            ret = upsample2d(ret, f)
        return ret

    def _apply_cond(self, x, cond, res, lvl, n_levels):
        """cond_mode injections into x (networks_stylegan2.py:550-694): the
        resnet-feature chonk added at 8^2 (and nothing else there); the
        ortho-front image (with the side views under gt_sides / dorthoA,
        times 4 under cond_img_norm_4) added into the trailing channels
        (add_4), written over them (concatfront), added or multiplied
        resized below the last two levels and pixel-shuffled at them
        (add_shuffle2_4, mult_shuffle2_4); then the plane symmetry priors
        crossavg_4 / crossavgt_38."""
        cm = self.cm
        if self.cond_mode == "none":
            return x
        if res == 8 and self.chonkadd > 0:
            ch = self.chonkadd
            chonk = cond["resnet_chonk"].to(x.dtype)
            return torch.cat([x[:, :ch] + chonk[:, :ch], x[:, ch:]], 1)
        if self.cond_mode.startswith("ortho_front."):
            cimg = cond["image_ortho_front"].flip(-2)
            sides = [v for v in ("gt_sides", "dorthoA") if v in cm]
            for v in sides:
                key = "ortho" if v == "gt_sides" else "dorthoA"
                left = cond[f"image_{key}_left"].transpose(-1, -2).flip(-1, -2)
                right = cond[f"image_{key}_right"].transpose(-1, -2).flip(-1)
                cimg = torch.cat([cimg, left, right], 1)
            cimg = cimg * 2 - 1
            if "cond_img_norm_4" in cm:
                cimg = 4 * cimg
            if "add_4" in cm:
                toadd = resize_bilinear(cimg, x.shape[-1]).to(x.dtype)
                toadd = toadd.repeat(1, int((x.shape[1] / 4) // toadd.shape[1]), 1, 1)
                ch = toadd.shape[1]
                x = torch.cat([x[:, :-ch], x[:, -ch:] + toadd], 1)
            if "concatfront" in cm:
                toadd = resize_bilinear(cimg, x.shape[-1]).to(x.dtype)
                x = torch.cat([x[:, :-toadd.shape[1]], toadd], 1)
            if "add_shuffle2_4" in cm or "mult_shuffle2_4" in cm:
                if lvl < n_levels - 2:
                    toadd = resize_bilinear(cimg, x.shape[-1])
                else:
                    toadd = pixel_shuffle_fold(cimg, cimg.shape[-1] // x.shape[-1])
                toadd = toadd.to(x.dtype)
                toadd = toadd.repeat(1, int((x.shape[1] / 4) // toadd.shape[1]), 1, 1)
                ch = toadd.shape[1]
                tail = x[:, -ch:] + toadd if "add_shuffle2_4" in cm else x[:, -ch:] * toadd
                x = torch.cat([x[:, :-ch], tail], 1)
        if "crossavg_4" in cm or "crossavgt_38" in cm:
            ch = int(x.shape[1] // 8)
            horz, vert = x[:, :ch], x[:, ch:2 * ch]
            parts = [horz.mean(-1, keepdim=True).expand_as(horz),
                     vert.mean(-2, keepdim=True).expand_as(vert)]
            if "crossavg_4" in cm:
                parts.append(x[:, 2 * ch:])
            else:
                parts += [x[:, 2 * ch:3 * ch].transpose(-1, -2), x[:, 3 * ch:]]
            x = torch.cat(parts, 1)
        return x

    def _inject_image(self, img, cond, res, lvl, n_levels):
        """inj_6b_4 (networks_stylegan2.py:550-694): at the last level the
        flipped ortho-front image, times 4, added into the image's first
        channels (not at a level that took the resnet chonk)."""
        if (not self.cond_mode.startswith("ortho_front.") or "inj_6b_4" not in self.cm
                or lvl != n_levels - 1 or (res == 8 and self.chonkadd > 0)):
            return img
        toadd = (cond["image_ortho_front"].flip(-2) * 2 - 1) * 4
        toadd = resize_bilinear(toadd, img.shape[-1]).to(img.dtype)
        ch = toadd.shape[1]
        return torch.cat([img[:, :ch] + toadd, img[:, ch:]], 1)


class Generator(nn.Module):
    """networks_stylegan2.py:728-754."""

    def __init__(self, z_dim, c_dim, w_dim, img_resolution, img_channels,
                 cond_mode="none", mapping_kwargs=None, synthesis_kwargs=None):
        super().__init__()
        self.synthesis = SynthesisNetwork(w_dim=w_dim, img_resolution=img_resolution,
                                          img_channels=img_channels, cond_mode=cond_mode,
                                          **(synthesis_kwargs or {}))
        self.num_ws = self.synthesis.num_ws
        self.mapping = MappingNetwork(z_dim=z_dim, c_dim=c_dim, w_dim=w_dim,
                                      num_ws=self.num_ws, cond_mode=cond_mode,
                                      **(mapping_kwargs or {}))

    def forward(self, z, c, cond=None, truncation_psi=1.0, truncation_cutoff=None,
                **synthesis_kwargs):
        ws = self.mapping(z, c, cond, truncation_psi=truncation_psi,
                          truncation_cutoff=truncation_cutoff)
        return self.synthesis(ws, cond, **synthesis_kwargs)


# ---------------------------------------------------------------------------
# discriminator side


class MinibatchStdLayer(nn.Module):
    """networks_stylegan2.py:847-872: the groups' standard deviation as
    ``num_channels`` extra feature maps (groups of ``group_size`` samples
    taken at stride N / G, as the reference reshapes)."""

    def __init__(self, group_size, num_channels=1):
        super().__init__()
        self.group_size, self.num_channels = group_size, num_channels

    def forward(self, x):
        N, C, H, W = x.shape
        G = min(self.group_size, N) if self.group_size is not None else N
        F_ = self.num_channels
        y = x.reshape(G, -1, F_, C // F_, H, W)
        y = y - y.mean(0)
        y = (y.square().mean(0) + 1e-8).sqrt()
        y = y.mean((2, 3, 4)).reshape(-1, F_, 1, 1)
        y = y.repeat(G, 1, H, W).to(x.dtype)
        return torch.cat([x, y], 1)


class DiscriminatorBlock(nn.Module):
    """networks_stylegan2.py:758-843 ('resnet', 'skip' or 'orig'): fromrgb
    on the first block (every block for 'skip'), conv0, conv1 with down=2,
    and the resnet's 1x1 ``skip`` beside them, each branch at gain
    sqrt(0.5); bfloat16 where ``use_fp16``."""

    def __init__(self, in_channels, tmp_channels, out_channels, resolution, img_channels,
                 architecture="resnet", activation="lrelu", resample_filter=(1, 3, 3, 1),
                 conv_clamp=None, use_fp16=False):
        super().__init__()
        if architecture not in ARCHITECTURES:
            raise ValueError(f"architecture must be one of {ARCHITECTURES}, not {architecture!r}")
        self.in_channels, self.architecture, self.use_fp16 = in_channels, architecture, use_fp16
        self.resample_filter = setup_filter(list(resample_filter))   # recomputed, not state
        if in_channels == 0 or architecture == "skip":
            self.fromrgb = Conv2dLayer(img_channels, tmp_channels, kernel_size=1,
                                       activation=activation, conv_clamp=conv_clamp)
        kw = dict(activation=activation, conv_clamp=conv_clamp)
        if architecture == "resnet":
            self.skip = Conv2dLayer(tmp_channels, out_channels, kernel_size=1, bias=False,
                                    down=2, resample_filter=resample_filter)
        self.conv0 = Conv2dLayer(tmp_channels, tmp_channels, kernel_size=3, **kw)
        self.conv1 = Conv2dLayer(tmp_channels, out_channels, kernel_size=3, down=2,
                                 resample_filter=resample_filter, **kw)

    def forward(self, x, img, force_fp32=False):
        dtype = torch.bfloat16 if (self.use_fp16 and not force_fp32) else torch.float32
        if x is not None:
            x = x.to(dtype)
        if self.in_channels == 0 or self.architecture == "skip":
            img = img.to(dtype)
            y = self.fromrgb(img)
            x = x + y if x is not None else y
            img = (downsample2d(img, self.resample_filter) if self.architecture == "skip"
                   else None)
        if self.architecture == "resnet":
            y = self.skip(x, gain=math.sqrt(0.5))
            x = self.conv0(x)
            x = self.conv1(x, gain=math.sqrt(0.5))
            x = y + x
        else:
            x = self.conv1(self.conv0(x))
        return x, img


class DiscriminatorEpilogue(nn.Module):
    """networks_stylegan2.py:876-933 at 4x4: minibatch std, conv, fc, out,
    and the projection onto the mapped c."""

    def __init__(self, in_channels, cmap_dim, resolution, img_channels, architecture="resnet",
                 mbstd_group_size=4, mbstd_num_channels=1, activation="lrelu",
                 conv_clamp=None):
        super().__init__()
        self.architecture, self.cmap_dim = architecture, cmap_dim
        if architecture == "skip":
            self.fromrgb = Conv2dLayer(img_channels, in_channels, kernel_size=1,
                                       activation=activation)
        self.mbstd = (MinibatchStdLayer(mbstd_group_size, mbstd_num_channels)
                      if mbstd_num_channels > 0 else None)
        self.conv = Conv2dLayer(in_channels + mbstd_num_channels, in_channels, kernel_size=3,
                                activation=activation, conv_clamp=conv_clamp)
        self.fc = FullyConnectedLayer(in_channels * resolution ** 2, in_channels,
                                      activation=activation)
        self.out = FullyConnectedLayer(in_channels, 1 if cmap_dim == 0 else cmap_dim)

    def forward(self, x, img, cmap, force_fp32=False):
        x = x.to(torch.float32)
        if self.architecture == "skip":
            x = x + self.fromrgb(img.to(torch.float32))
        if self.mbstd is not None:
            x = self.mbstd(x)
        x = self.conv(x)
        x = self.out(self.fc(x.reshape(x.shape[0], -1)))
        if self.cmap_dim > 0:
            x = (x * cmap).sum(1, keepdim=True) * (1 / math.sqrt(self.cmap_dim))
        return x


class Discriminator(nn.Module):
    """networks_stylegan2.py:937-998: blocks b{res} from img_resolution down
    to 8, the c mapping (8 layers, z_dim 0) and the epilogue b4; bfloat16
    in the blocks at the top ``num_fp16_res`` resolutions."""

    def __init__(self, c_dim, img_resolution, img_channels, cond_mode="none",
                 architecture="resnet", channel_base=32768, channel_max=512, num_fp16_res=4,
                 conv_clamp=256, cmap_dim=None, block_kwargs=None, mapping_kwargs=None,
                 epilogue_kwargs=None):
        super().__init__()
        res_log2 = int(np.log2(img_resolution))
        self.block_resolutions = [2 ** i for i in range(res_log2, 2, -1)]
        channels = {res: min(channel_base // res, channel_max)
                    for res in self.block_resolutions + [4]}
        fp16_resolution = max(2 ** (res_log2 + 1 - num_fp16_res), 8)
        if cmap_dim is None:
            cmap_dim = channels[4]
        if c_dim == 0:
            cmap_dim = 0
        self.c_dim = c_dim
        for res in self.block_resolutions:
            setattr(self, f"b{res}", DiscriminatorBlock(
                channels[res] if res < img_resolution else 0, channels[res], channels[res // 2],
                resolution=res, img_channels=img_channels, architecture=architecture,
                conv_clamp=conv_clamp, use_fp16=res >= fp16_resolution, **(block_kwargs or {})))
        if c_dim > 0:
            self.mapping = MappingNetwork(z_dim=0, c_dim=c_dim, w_dim=cmap_dim, num_ws=None,
                                          w_avg_beta=None, cond_mode=cond_mode,
                                          **(mapping_kwargs or {}))
        self.b4 = DiscriminatorEpilogue(channels[4], cmap_dim=cmap_dim, resolution=4,
                                        img_channels=img_channels, architecture=architecture,
                                        conv_clamp=conv_clamp, **(epilogue_kwargs or {}))

    def forward(self, img, c, cond=None, force_fp32=False):
        x = None
        for res in self.block_resolutions:
            x, img = getattr(self, f"b{res}")(x, img, force_fp32=force_fp32)
        cmap = self.mapping(None, c, cond) if self.c_dim > 0 else None
        return self.b4(x, img, cmap, force_fp32=force_fp32)
