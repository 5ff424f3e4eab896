"""Superresolution modules (panic3d_tpu/models/superresolution.py):
SuperresolutionHybrid8XDC (flagship, 64^2 features -> 512^2) and
SuperresolutionHybrid2X (tiny config, -> 128^2)."""

from __future__ import annotations

import torch.nn as nn

from .stylegan2 import SynthesisBlock, resize_bilinear


def __getattr__(name):
    # the reference's `from ... networks_stylegan3 import SynthesisLayer as
    # AFSynthesisLayer` (superresolution.py:22); lazy, so scipy (its filter
    # design) is imported only when it is used
    if name == "AFSynthesisLayer":
        from .stylegan3 import AFSynthesisLayer

        return AFSynthesisLayer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


class SuperresolutionHybrid8XDC(nn.Module):
    """512^2 output, hidden width channels_hidden (superresolution.py:80)."""

    input_resolution = 128

    def __init__(self, channels, img_resolution, sr_num_fp16_res=0, sr_antialias=True,
                 channels_hidden=256, w_dim=512):
        super().__init__()
        self.sr_antialias = sr_antialias
        use_fp16 = sr_num_fp16_res > 0
        kw = dict(w_dim=w_dim, img_channels=3, use_fp16=use_fp16,
                  conv_clamp=256 if use_fp16 else None)
        self.block0 = SynthesisBlock(channels, channels_hidden, resolution=256,
                                     is_last=False, **kw)
        self.block1 = SynthesisBlock(channels_hidden, channels_hidden // 2, resolution=512,
                                     is_last=True, **kw)

    def forward(self, rgb, x, ws, noise_mode="none"):
        ws = ws[:, -1:, :].repeat(1, 3, 1)
        if x.shape[-1] != self.input_resolution:
            antialias = self.sr_antialias and x.shape[-1] > self.input_resolution
            x = resize_bilinear(x, self.input_resolution, antialias=antialias)
            rgb = resize_bilinear(rgb, self.input_resolution, antialias=antialias)
        x, rgb = self.block0(x, rgb, ws, noise_mode=noise_mode)
        x, rgb = self.block1(x, rgb, ws, noise_mode=noise_mode)
        return rgb


class SuperresolutionHybrid2X(nn.Module):
    """128^2 output; the first block does not upsample (superresolution.py:159)."""

    input_resolution = 64

    def __init__(self, channels, img_resolution, sr_num_fp16_res=0, sr_antialias=True,
                 channels_hidden=256, w_dim=512):
        super().__init__()
        self.sr_antialias = sr_antialias
        use_fp16 = sr_num_fp16_res > 0
        kw = dict(w_dim=w_dim, img_channels=3, use_fp16=use_fp16,
                  conv_clamp=256 if use_fp16 else None)
        self.block0 = SynthesisBlock(channels, 128, resolution=64, is_last=False,
                                     no_up=True, **kw)
        self.block1 = SynthesisBlock(128, 64, resolution=128, is_last=True, **kw)

    def forward(self, rgb, x, ws, noise_mode="none"):
        ws = ws[:, -1:, :].repeat(1, 3, 1)
        if x.shape[-1] != self.input_resolution:
            x = resize_bilinear(x, self.input_resolution, antialias=self.sr_antialias)
            rgb = resize_bilinear(rgb, self.input_resolution, antialias=self.sr_antialias)
        x, rgb = self.block0(x, rgb, ws, noise_mode=noise_mode)
        x, rgb = self.block1(x, rgb, ws, noise_mode=noise_mode)
        return rgb


SR_MODULES = {
    name: cls
    for cls in (SuperresolutionHybrid8XDC, SuperresolutionHybrid2X)
    for name in (cls.__name__, f"training.superresolution.{cls.__name__}")
}
