"""StyleGAN3 alias-free synthesis layer (panic3d_tpu/models/stylegan3.py).

``AFSynthesisLayer`` is the reference's SynthesisLayer
(networks_stylegan3.py:255-393), which its superresolution module imports
as AFSynthesisLayer: modulated conv (cuDNN, then kernel K5's epilogue for
the demodulation) and filtered_lrelu (kernel K11 on the card). The shipped
model never builds it; the same geometry arithmetic as the JAX layer picks
the sampling rates, the filters' taps and the padding. ``use_fp16`` means
bfloat16, as in the rest of the port. The filters are recomputed constants,
not state: the state_dict holds affine.weight, affine.bias, weight, bias and
the magnitude_ema buffer (runtime/checkpoint.py maps them onto the flax
tree).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from ..configs import resolve_device
from ..ops.conv import modulated_conv2d
from ..ops.filtered_lrelu import filtered_lrelu
from .stylegan2 import FullyConnectedLayer, _randn


def design_lowpass_filter(numtaps: int, cutoff: float, width: float, fs: float,
                          radial: bool = False) -> Optional[np.ndarray]:
    """Kaiser separable / jinc radial low-pass (networks_stylegan3.py:367-387)."""
    import scipy.signal
    import scipy.special

    if numtaps < 1:
        raise ValueError(f"numtaps must be >= 1, got {numtaps}")
    if numtaps == 1:
        return None
    if not radial:
        f = scipy.signal.firwin(numtaps=numtaps, cutoff=cutoff, width=width, fs=fs)
        return np.asarray(f, np.float32)
    x = (np.arange(numtaps) - (numtaps - 1) / 2) / fs
    r = np.hypot(*np.meshgrid(x, x))
    with np.errstate(divide="ignore", invalid="ignore"):
        f = scipy.special.j1(2 * cutoff * (np.pi * r)) / (np.pi * r)
    f = np.nan_to_num(f, nan=float(cutoff))  # r=0 limit of j1(2c·πr)/(πr)
    beta = scipy.signal.kaiser_beta(
        scipy.signal.kaiser_atten(numtaps, width / (fs / 2))
    )
    w = np.kaiser(numtaps, beta)
    f = f * np.outer(w, w)
    f = f / np.sum(f)
    return np.asarray(f, np.float32)


class AFSynthesisLayer(nn.Module):
    """Alias-free modulated conv + filtered lrelu (networks_stylegan3.py:255),
    on ``device`` (CUDA unless the caller passes another)."""

    def __init__(self, w_dim, is_torgb, is_critically_sampled, use_fp16, in_channels,
                 out_channels, in_size, out_size, in_sampling_rate, out_sampling_rate,
                 in_cutoff, out_cutoff, in_half_width, out_half_width, conv_kernel=3,
                 filter_size=6, lrelu_upsampling=2, use_radial_filters=False,
                 conv_clamp: Optional[float] = 256, magnitude_ema_beta=0.999, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.is_torgb = is_torgb
        self.use_fp16 = use_fp16
        self.in_channels, self.out_channels = in_channels, out_channels
        self.in_size, self.out_size = in_size, out_size
        self.conv_clamp = conv_clamp
        self.magnitude_ema_beta = magnitude_ema_beta

        self.kernel = 1 if is_torgb else conv_kernel
        tmp_rate = max(in_sampling_rate, out_sampling_rate) * (1 if is_torgb else lrelu_upsampling)
        self.up_factor = int(np.rint(tmp_rate / in_sampling_rate))
        self.down_factor = int(np.rint(tmp_rate / out_sampling_rate))
        if (in_sampling_rate * self.up_factor != tmp_rate
                or out_sampling_rate * self.down_factor != tmp_rate):
            raise ValueError(f"sampling rates {in_sampling_rate}, {out_sampling_rate} do not "
                             f"divide {tmp_rate}")
        up_taps = filter_size * self.up_factor if self.up_factor > 1 and not is_torgb else 1
        down_taps = filter_size * self.down_factor if self.down_factor > 1 and not is_torgb else 1
        fu = design_lowpass_filter(numtaps=up_taps, cutoff=in_cutoff, width=in_half_width * 2,
                                   fs=tmp_rate)
        fd = design_lowpass_filter(numtaps=down_taps, cutoff=out_cutoff,
                                   width=out_half_width * 2, fs=tmp_rate,
                                   radial=use_radial_filters and not is_critically_sampled)
        # host constants: the kernel takes its taps by value
        self.up_filter = None if fu is None else torch.from_numpy(fu)
        self.down_filter = None if fd is None else torch.from_numpy(fd)

        # symmetric-interpretation padding (networks_stylegan3.py:325-331)
        pad_total = (out_size - 1) * self.down_factor + 1
        pad_total -= (in_size + self.kernel - 1) * self.up_factor
        pad_total += up_taps + down_taps - 2
        pad_lo = (pad_total + self.up_factor) // 2
        pad_hi = pad_total - pad_lo
        self.padding = [int(pad_lo), int(pad_hi), int(pad_lo), int(pad_hi)]

        self.affine = FullyConnectedLayer(w_dim, in_channels, bias_init=1.0)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, self.kernel,
                                               self.kernel))
        self.bias = nn.Parameter(torch.empty(out_channels))
        self.register_buffer("magnitude_ema", torch.ones(()))
        self.to(dev)

    def reset_parameters_(self, gen):
        _randn(self.weight, gen)
        self.bias.zero_()
        self.magnitude_ema.fill_(1.0)

    def forward(self, x, w, force_fp32: bool = False, update_emas: bool = False):
        if update_emas:
            with torch.no_grad():
                cur = x.detach().to(torch.float32).square().mean()
                self.magnitude_ema.copy_(
                    cur + (self.magnitude_ema - cur) * self.magnitude_ema_beta)
        input_gain = torch.rsqrt(self.magnitude_ema)

        styles = self.affine(w)
        if self.is_torgb:
            styles = styles * (1 / math.sqrt(self.in_channels * self.kernel ** 2))

        dtype = torch.bfloat16 if (self.use_fp16 and not force_fp32) else torch.float32
        # the scalar input gain commutes with the (demodulated) conv: scale x
        x = modulated_conv2d((x * input_gain).to(dtype), self.weight, styles,
                             padding=self.kernel - 1, demodulate=not self.is_torgb)
        x = filtered_lrelu(
            x, fu=self.up_filter, fd=self.down_filter, b=self.bias.to(x.dtype),
            up=self.up_factor, down=self.down_factor, padding=self.padding,
            gain=1.0 if self.is_torgb else math.sqrt(2), slope=1.0 if self.is_torgb else 0.2,
            clamp=self.conv_clamp)
        if tuple(x.shape[1:]) != (self.out_channels, self.out_size, self.out_size):
            raise RuntimeError(f"AFSynthesisLayer: output {tuple(x.shape)}")
        return x
