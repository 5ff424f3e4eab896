"""StyleGAN2 generator side (panic3d_tpu/models/stylegan2.py:33-699).

Module and attribute names follow the reference state_dict (b{res}, conv0,
conv1, torgb, affine, fc{i}, embed, noise_const, w_avg), so
runtime/checkpoint.py maps the flax tree onto ``state_dict()`` 1:1.
``use_fp16`` means bfloat16, as in the JAX package. The FIR resampling runs
through upfirdn2d (kernel K4 on the card); the weight convs are cuDNN.

Ported cond modes: ``ortho_front.add_shuffle2_4.reschonk_add_<N>`` (the
flagship and tiny configs). Others raise NotImplementedError, as do
architectures other than 'skip' and noise_mode='random'.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.bias_act import activation_funcs, bias_act
from ..ops.conv import modulated_conv2d
from ..ops.upfirdn2d import setup_filter, upsample2d

_COND_TOKENS = ("ortho_front", "add_shuffle2_4")


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
        return bias_act(x, b.to(x.dtype) if b is not None else None, dim=x.ndim - 1,
                        act=self.activation)


class MappingNetwork(nn.Module):
    """networks_stylegan2.py:198-294 (eval form: no w_avg update)."""

    def __init__(self, z_dim, c_dim, w_dim, num_ws, num_layers=8, embed_features=None,
                 layer_features=None, activation="lrelu", lr_multiplier=0.01,
                 w_avg_beta=0.998):
        super().__init__()
        self.z_dim, self.c_dim, self.w_dim, self.num_ws = z_dim, c_dim, w_dim, num_ws
        self.num_layers = num_layers
        if embed_features is None:
            embed_features = w_dim
        if c_dim == 0:
            embed_features = 0
        layer_features = layer_features or w_dim
        features = [z_dim + embed_features] + [layer_features] * (num_layers - 1) + [w_dim]
        if c_dim > 0:
            self.embed = FullyConnectedLayer(c_dim, embed_features)
        for idx in range(num_layers):
            setattr(self, f"fc{idx}", FullyConnectedLayer(
                features[idx], features[idx + 1], activation=activation,
                lr_multiplier=lr_multiplier))
        if num_ws is not None and w_avg_beta is not None:
            self.register_buffer("w_avg", torch.zeros(w_dim))

    def reset_parameters_(self, gen):
        if hasattr(self, "w_avg"):
            self.w_avg.zero_()

    def forward(self, z, c, truncation_psi=1.0, truncation_cutoff=None):
        x = normalize_2nd_moment(z.to(torch.float32)) if self.z_dim > 0 else None
        if self.c_dim > 0:
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

    def forward(self, x, w, noise_mode="const", gain=1.0):
        if noise_mode not in ("const", "none"):
            raise NotImplementedError(f"noise_mode={noise_mode!r} is not ported yet")
        styles = self.affine(w)
        noise = None
        if self.use_noise and noise_mode == "const":
            noise = self.noise_const * self.noise_strength
        x = modulated_conv2d(x, self.weight, styles, noise=noise, up=self.up,
                             padding=self.padding, resample_filter=self.resample_filter,
                             flip_weight=(self.up == 1))
        act_gain = activation_funcs[self.activation].def_gain * gain
        act_clamp = self.conv_clamp * gain if self.conv_clamp is not None else None
        return bias_act(x, self.bias.to(x.dtype), act=self.activation, gain=act_gain,
                        clamp=act_clamp)


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
        x = modulated_conv2d(x, self.weight, styles, demodulate=False, padding=self.padding)
        return bias_act(x, self.bias.to(x.dtype), clamp=self.conv_clamp)


class SynthesisBlock(nn.Module):
    """networks_stylegan2.py:387-487, 'skip' architecture; no_up is the
    superresolution variant (SynthesisBlockNoUp)."""

    def __init__(self, in_channels, out_channels, w_dim, resolution, img_channels,
                 is_last, architecture="skip", resample_filter=(1, 3, 3, 1),
                 conv_clamp: Optional[float] = 256, use_fp16=False, no_up=False):
        super().__init__()
        if architecture != "skip":
            raise NotImplementedError(f"architecture={architecture!r} is not ported yet")
        self.in_channels = in_channels
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
        self.torgb = ToRGBLayer(out_channels, img_channels, w_dim=w_dim,
                                conv_clamp=conv_clamp)

    def reset_parameters_(self, gen):
        if self.in_channels == 0:
            _randn(self.const, gen)

    def forward(self, x, img, ws, force_fp32=False, noise_mode="const"):
        full = torch.float64 if (ws if x is None else x).dtype == torch.float64 else torch.float32
        dtype = torch.bfloat16 if (self.use_fp16 and not force_fp32) else full
        w_iter = iter(ws.unbind(1))
        if self.in_channels == 0:
            x = self.const[None].to(dtype).expand((ws.shape[0],) + tuple(self.const.shape))
        else:
            x = x.to(dtype)
            x = self.conv0(x, next(w_iter), noise_mode=noise_mode)
        x = self.conv1(x, next(w_iter), noise_mode=noise_mode)
        if img is not None and not self.no_up:
            img = upsample2d(img, self.resample_filter)
        y = self.torgb(x, next(w_iter)).to(torch.float32)
        img = img + y if img is not None else y
        return x, img


class SynthesisNetwork(nn.Module):
    """networks_stylegan2.py:491-724 with the ported cond_mode injections."""

    def __init__(self, w_dim, img_resolution, img_channels, cond_mode="none",
                 channel_base=32768, channel_max=512, num_fp16_res=4, conv_clamp=256,
                 architecture="skip"):
        super().__init__()
        self.cond_mode = cond_mode
        cm = [] if cond_mode == "none" else cond_mode.split(".")
        chonk = [int(m.split("_")[-1]) for m in cm if m.startswith("reschonk_add_")]
        unsupported = [m for m in cm if m not in _COND_TOKENS and not m.startswith("reschonk_add_")]
        if unsupported or (cm and cm[0] != "ortho_front"):
            raise NotImplementedError(f"cond_mode {cond_mode!r} is not ported yet")
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

    def forward(self, ws, cond=None, noise_mode="const"):
        ws = ws.to(torch.float32)
        x = img = None
        w_idx = 0
        n_levels = len(self.block_resolutions)
        for lvl, res in enumerate(self.block_resolutions):
            n_conv = 1 if res == 4 else 2
            cur_ws = ws[:, w_idx: w_idx + n_conv + 1]
            w_idx += n_conv
            x, img = getattr(self, f"b{res}")(x, img, cur_ws, noise_mode=noise_mode)
            x = self._apply_cond(x, cond, res, lvl, n_levels)
        return img

    def _apply_cond(self, x, cond, res, lvl, n_levels):
        """cond_mode injections (networks_stylegan2.py:550-694): the
        resnet-feature chonk added at 8^2, then the ortho-front image added
        into the trailing channels of every other level (resized below the
        last two levels, pixel-shuffled at them)."""
        if self.cond_mode == "none":
            return x
        if res == 8 and self.chonkadd > 0:
            ch = self.chonkadd
            chonk = cond["resnet_chonk"].to(x.dtype)
            return torch.cat([x[:, :ch] + chonk[:, :ch], x[:, ch:]], 1)
        cimg = cond["image_ortho_front"].flip(-2) * 2 - 1
        if lvl < n_levels - 2:
            toadd = resize_bilinear(cimg, x.shape[-1])
        else:
            toadd = pixel_shuffle_fold(cimg, cimg.shape[-1] // x.shape[-1])
        toadd = toadd.to(x.dtype)
        reps = int((x.shape[1] / 4) // toadd.shape[1])
        toadd = toadd.repeat(1, reps, 1, 1)
        ch = toadd.shape[1]
        return torch.cat([x[:, :-ch], x[:, -ch:] + toadd], 1)


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
                                      num_ws=self.num_ws, **(mapping_kwargs or {}))

    def forward(self, z, c, cond=None, truncation_psi=1.0, truncation_cutoff=None,
                noise_mode="const"):
        ws = self.mapping(z, c, truncation_psi=truncation_psi,
                          truncation_cutoff=truncation_cutoff)
        return self.synthesis(ws, cond, noise_mode=noise_mode)
