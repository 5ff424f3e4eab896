"""Superresolution modules (panic3d_tpu/models/superresolution.py), the
JAX package's five: SuperresolutionHybrid8XDC (the flagship, 64^2 features
-> 512^2), SuperresolutionHybrid8X (-> 512^2, blocks of 128 and 64),
SuperresolutionHybrid4X and SuperresolutionHybridDeepfp32 (-> 256^2, the
first block at 128^2 without upsampling), SuperresolutionHybrid2X (the
tiny config, -> 128^2). Each has the JAX module's own rule for resizing
its input (and whether that resize is antialiased). The blocks take
``noise_mode`` (the generator's ``superresolution_noise_mode``) and
``generator`` for noise_mode='random'."""

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


class _HybridSR(nn.Module):
    """Two SynthesisBlocks on the last w (repeated for their 3 layers):
    block0 (channels -> block0_out at block0_res, upsampling unless
    block0_no_up), block1 (-> block1_out at twice block0_res)."""

    input_resolution = 128
    block0_res = 256
    block0_no_up = False
    resize_rule = "antialias_down"   # or "sr_antialias", "up_only"

    def __init__(self, channels, img_resolution, sr_num_fp16_res=0, sr_antialias=True,
                 channels_hidden=256, w_dim=512, block0_out=128, block1_out=64):
        super().__init__()
        self.sr_antialias = sr_antialias
        use_fp16 = sr_num_fp16_res > 0
        kw = dict(w_dim=w_dim, img_channels=3, use_fp16=use_fp16,
                  conv_clamp=256 if use_fp16 else None)
        self.block0 = SynthesisBlock(channels, block0_out, resolution=self.block0_res,
                                     is_last=False, no_up=self.block0_no_up, **kw)
        self.block1 = SynthesisBlock(block0_out, block1_out, resolution=2 * self.block0_res,
                                     is_last=True, **kw)

    def _resize(self, rgb, x):
        n, r = self.input_resolution, x.shape[-1]
        if self.resize_rule == "up_only":           # only a smaller input, never antialiased
            if r >= n:
                return rgb, x
            antialias = False
        elif r == n:
            return rgb, x
        elif self.resize_rule == "sr_antialias":
            antialias = self.sr_antialias
        else:                                       # antialiased only when it shrinks
            antialias = self.sr_antialias and r > n
        return (resize_bilinear(rgb, n, antialias=antialias),
                resize_bilinear(x, n, antialias=antialias))

    def forward(self, rgb, x, ws, noise_mode="none", generator=None):
        ws = ws[:, -1:, :].repeat(1, 3, 1)
        rgb, x = self._resize(rgb, x)
        kw = dict(noise_mode=noise_mode, generator=generator)
        x, rgb = self.block0(x, rgb, ws, **kw)
        x, rgb = self.block1(x, rgb, ws, **kw)
        return rgb


class SuperresolutionHybrid8XDC(_HybridSR):
    """512^2 output, hidden width channels_hidden (superresolution.py:263-293)."""

    def __init__(self, channels, img_resolution, sr_num_fp16_res=0, sr_antialias=True,
                 channels_hidden=256, w_dim=512):
        super().__init__(channels, img_resolution, sr_num_fp16_res, sr_antialias,
                         channels_hidden, w_dim, channels_hidden, channels_hidden // 2)


class SuperresolutionHybrid8X(_HybridSR):
    """512^2 output, blocks of 128 and 64 channels (superresolution.py:28-57)."""


class SuperresolutionHybrid4X(_HybridSR):
    """256^2 output; block0 at 128^2 does not upsample; a smaller input is
    resized up to 128^2 (superresolution.py:61-89)."""

    block0_res = 128
    block0_no_up = True
    resize_rule = "up_only"


class SuperresolutionHybridDeepfp32(SuperresolutionHybrid4X):
    """256^2 output from a 128^2 hybrid input, the layout of Hybrid4X
    (superresolution.py:126-154)."""


class SuperresolutionHybrid2X(_HybridSR):
    """128^2 output; block0 at 64^2 does not upsample (superresolution.py:93-121)."""

    input_resolution = 64
    block0_res = 64
    block0_no_up = True
    resize_rule = "sr_antialias"


SR_MODULES = {
    name: cls
    for cls in (SuperresolutionHybrid8XDC, SuperresolutionHybrid8X, SuperresolutionHybrid4X,
                SuperresolutionHybridDeepfp32, SuperresolutionHybrid2X)
    for name in (cls.__name__, f"training.superresolution.{cls.__name__}")
}
