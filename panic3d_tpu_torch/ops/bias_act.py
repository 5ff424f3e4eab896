"""Bias + activation + gain + clamp (panic3d_tpu/ops/bias_act.py).

Plain PyTorch for now: on the TPU this is a jnp expression XLA fuses into
the conv epilogue, not a kernel. A fused-epilogue CUDA kernel (bias_act with
the modulated conv's demodulation and noise) heads the kernel queue in
ROADMAP.md.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F


class ActivationSpec(NamedTuple):
    func: Callable
    def_alpha: float
    def_gain: float


activation_funcs = {
    "linear": ActivationSpec(lambda x, alpha: x, 0.0, 1.0),
    "relu": ActivationSpec(lambda x, alpha: torch.relu(x), 0.0, math.sqrt(2)),
    "lrelu": ActivationSpec(
        lambda x, alpha: torch.where(x >= 0, x, x * alpha), 0.2, math.sqrt(2)),
    "tanh": ActivationSpec(lambda x, alpha: torch.tanh(x), 0.0, 1.0),
    "sigmoid": ActivationSpec(lambda x, alpha: torch.sigmoid(x), 0.0, 1.0),
    "elu": ActivationSpec(lambda x, alpha: F.elu(x), 0.0, 1.0),
    "selu": ActivationSpec(lambda x, alpha: F.selu(x), 0.0, 1.0),
    "softplus": ActivationSpec(lambda x, alpha: F.softplus(x), 0.0, 1.0),
    "swish": ActivationSpec(lambda x, alpha: torch.sigmoid(x) * x, 0.0, math.sqrt(2)),
}


def bias_act(x: torch.Tensor, b: Optional[torch.Tensor] = None, dim: int = 1,
             act: str = "linear", alpha: Optional[float] = None,
             gain: Optional[float] = None,
             clamp: Optional[float] = None) -> torch.Tensor:
    """Add per-channel bias along ``dim``, apply ``act``, scale, clamp."""
    spec = activation_funcs[act]
    alpha = float(spec.def_alpha if alpha is None else alpha)
    gain = float(spec.def_gain if gain is None else gain)
    if b is not None:
        if b.ndim != 1 or not 0 <= dim < x.ndim:
            raise ValueError(f"bias of shape {tuple(b.shape)} along dim {dim}")
        shape = [1] * x.ndim
        shape[dim] = -1
        x = x + b.reshape(shape).to(x.dtype)
    x = spec.func(x, alpha)
    if gain != 1:
        x = x * gain
    if clamp is not None:
        if clamp < 0:
            raise ValueError("clamp must be >= 0")
        x = x.clamp(-clamp, clamp)
    return x
