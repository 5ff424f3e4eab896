"""Dual discriminator: discriminates [512^2 image, the raw render upsampled
to it] (panic3d_tpu/models/dual_discriminator.py:20-82).

The two streams are concatenated on channels (a 6-channel input to
stylegan2.Discriminator); the pose label may be noised by ``disc_c_noise``
(a draw from ``generator``, utils/draws.py). ``filtered_resizing`` goes
through ops/resize.py (jax.image.resize's antialiased bilinear), plain
PyTorch, so R1 reaches ``image_raw`` through it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..ops.resize import resize
from ..ops.upfirdn2d import downsample2d, upsample2d
from ..utils import draws
from .stylegan2 import Discriminator, init_weights, resize_bilinear


def filtered_resizing(image, size: int, f=None, filter_mode="antialiased"):
    """dual_discriminator.py:86-102: 'antialiased', 'classic', 'none', or a
    float that blends the aliased and the antialiased resize."""
    if filter_mode == "antialiased":
        return resize(image, tuple(image.shape[:2]) + (size, size), "bilinear", antialias=True)
    if filter_mode == "classic":
        x = upsample2d(image, f, up=2)
        x = resize_bilinear(x, size * 2 + 2)
        return downsample2d(x, f, down=2, flip_filter=True, padding=-1)
    if filter_mode == "none":
        return resize_bilinear(image, size)
    if isinstance(filter_mode, float):
        filtered = resize(image, tuple(image.shape[:2]) + (size, size), "bilinear",
                          antialias=True)
        return (1 - filter_mode) * resize_bilinear(image, size) + filter_mode * filtered
    raise ValueError(filter_mode)


class DualDiscriminator(nn.Module):
    """dual_discriminator.py:106-176; ``disc`` is the Discriminator (the
    flax tree's name, so the weight bridge maps it 1:1)."""

    def __init__(self, c_dim, img_resolution, img_channels=3, cond_mode="none",
                 architecture="resnet", channel_base=32768, channel_max=512, num_fp16_res=4,
                 conv_clamp: Optional[float] = 256, cmap_dim=None, disc_c_noise=0.0,
                 block_kwargs=None, mapping_kwargs=None, epilogue_kwargs=None):
        super().__init__()
        self.img_resolution, self.architecture = img_resolution, architecture
        self.disc_c_noise = disc_c_noise
        self.disc = Discriminator(
            c_dim=c_dim, img_resolution=img_resolution, img_channels=img_channels * 2,
            cond_mode=cond_mode, architecture=architecture, channel_base=channel_base,
            channel_max=channel_max, num_fp16_res=num_fp16_res, conv_clamp=conv_clamp,
            cmap_dim=cmap_dim, block_kwargs=block_kwargs, mapping_kwargs=mapping_kwargs,
            epilogue_kwargs=epilogue_kwargs)

    def init_weights(self, seed: int) -> "DualDiscriminator":
        """Seeded random weights (no checkpoint is loaded)."""
        init_weights(self, seed)
        return self

    def forward(self, img: dict, c, cond=None, force_fp32=False, generator=None):
        """img {'image' [N,3,R,R], 'image_raw' [N,3,r,r]}, c [N,c_dim] ->
        logits [N,1]. With disc_c_noise > 0 the label's noise is drawn from
        ``generator`` (a torch.Generator or a utils/draws.Replay)."""
        image = img["image"]
        image_raw = filtered_resizing(img["image_raw"], image.shape[-1])
        x = torch.cat([image, image_raw.to(image.dtype)], 1)
        if self.disc_c_noise > 0:
            noise = draws.normal(tuple(c.shape), generator, c.device, "disc_c_noise")
            c = c + noise * c.std(0, unbiased=False, keepdim=True) * self.disc_c_noise
        return self.disc(x, c, cond, force_fp32=force_fp32)
