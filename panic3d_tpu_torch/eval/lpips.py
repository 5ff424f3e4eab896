"""LPIPS perceptual distance on AlexNet (panic3d_tpu/eval/lpips.py).

lpips.LPIPS(net='alex') on [-1, 1] images: the AlexNet feature trunk's
five relu taps, unit-normalised over the channels, squared differences,
the non-negative 1x1 heads, spatial means, summed over the taps. The
parameters carry the JAX package's flax names and shapes (``alex.conv1_w``,
``lin0``, ...), so the ``.npz`` that ``load_lpips_params`` reads drives both
packages. The convolutions stay with cuDNN. Without weights the net is
seeded at random: structurally right, not comparable with the paper.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..configs import resolve_device
from ..runtime.checkpoint import load_flax_npz, module_state_from_flax

# channel counts of the five tapped AlexNet stages
ALEX_CHANNELS = (64, 192, 384, 256, 256)
_CONVS = (("conv1", 64, 3, 11, 4, 2), ("conv2", 192, 64, 5, 1, 2), ("conv3", 384, 192, 3, 1, 1),
          ("conv4", 256, 384, 3, 1, 1), ("conv5", 256, 256, 3, 1, 1))

# input normalisation (lpips.ScalingLayer)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class AlexNetFeatures(nn.Module):
    """torchvision AlexNet .features trunk, returning the 5 relu taps."""

    def __init__(self):
        super().__init__()
        for name, cout, cin, k, _, _ in _CONVS:
            self.register_parameter(f"{name}_w", nn.Parameter(torch.zeros(cout, cin, k, k)))
            self.register_parameter(f"{name}_b", nn.Parameter(torch.zeros(cout)))

    def forward(self, x):
        taps = []
        for i, (name, _, _, _, stride, pad) in enumerate(_CONVS):
            if i in (1, 2):
                x = F.max_pool2d(x, 3, 2)
            x = F.relu(F.conv2d(x, getattr(self, f"{name}_w"), getattr(self, f"{name}_b"),
                                stride=stride, padding=pad))
            taps.append(x)
        return taps


class LPIPS(nn.Module):
    """lpips.LPIPS(net='alex'): distance [N] between [-1,1] NCHW images."""

    def __init__(self, device=None):
        super().__init__()
        self.alex = AlexNetFeatures()
        for i, c in enumerate(ALEX_CHANNELS):
            self.register_parameter(f"lin{i}", nn.Parameter(torch.full((c,), 0.1)))
        self.register_buffer("shift", torch.tensor(_SHIFT)[None, :, None, None], persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE)[None, :, None, None], persistent=False)
        self.to(resolve_device(device))

    def init_weights(self, seed: int = 0) -> "LPIPS":
        """Random convolutions (N(0, 2 / fan_in), zero biases) drawn on the
        CPU from ``seed``; the heads stay at 0.1, as the flax init."""
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for name, cout, cin, k, _, _ in _CONVS:
                w = torch.randn((cout, cin, k, k), generator=gen) * np.sqrt(2.0 / (cin * k * k))
                getattr(self.alex, f"{name}_w").copy_(w)
                getattr(self.alex, f"{name}_b").zero_()
        return self

    def load_variables(self, variables) -> "LPIPS":
        """The JAX package's LPIPS variables (a nested mapping of arrays)."""
        self.load_state_dict(module_state_from_flax(variables), strict=True)
        return self

    def forward(self, x0, x1):
        f0 = self.alex((x0 - self.shift) / self.scale)
        f1 = self.alex((x1 - self.shift) / self.scale)
        total = 0.0
        for i, (a, b) in enumerate(zip(f0, f1)):
            a = a * torch.rsqrt((a * a).sum(1, keepdim=True) + 1e-10)
            b = b * torch.rsqrt((b * b).sum(1, keepdim=True) + 1e-10)
            diff = (a - b) ** 2
            lin = getattr(self, f"lin{i}").abs()   # non-negative 1x1 head
            val = (lin[None, :, None, None] * diff).sum(1, keepdim=True)
            total = total + val.mean((2, 3))
        return total[:, 0]


def load_lpips_params(path: str) -> dict:
    """Converted weights (.npz keyed by flax paths, runtime/convert.py) ->
    the variables tree {'params': ...} of numpy arrays."""
    return load_flax_npz(path)
