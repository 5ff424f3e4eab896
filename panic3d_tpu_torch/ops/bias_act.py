"""Bias + activation + gain + clamp (panic3d_tpu/ops/bias_act.py), and the
modulated conv's epilogue fused with it.

``bias_act`` is the plain op. ``modconv_epilogue`` is the wrapper of CUDA
kernel K5 (csrc/modconv_epilogue.cu): demodulation, noise, bias, leaky relu,
gain and clamp in one pass after the weight convolution, where the JAX
package leaves XLA to fuse the same chain of jnp ops into the conv.
``modconv_epilogue_plain`` is that chain in PyTorch: the CPU path and the
kernel's oracle.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..kernels import KERNELS, require_no_grad
from ..kernels import build as kb


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


def modconv_epilogue_plain(x, dcoef=None, noise=None, noise_strength=None, bias=None,
                           act: str = "linear", alpha: Optional[float] = None,
                           gain: Optional[float] = None, clamp: Optional[float] = None):
    """x [N,C,H,W] (or [N,C]) -> x * dcoef[n,c] + noise * noise_strength,
    then bias_act along dim 1. Each op rounds to x's dtype, as the JAX
    package's modulated_conv2d and bias_act do: dcoef [N,C] f32 and the
    noise (one [H,W] f32 map for the batch, or [N,1,H,W], one a sample),
    times its strength in f32, are cast to x's dtype before they are
    applied."""
    if dcoef is not None:
        x = x * dcoef.to(x.dtype)[:, :, None, None]
    if noise is not None:
        if noise_strength is not None:
            noise = noise * noise_strength
        x = x + noise.to(x.dtype)
    return bias_act(x, bias, dim=1, act=act, alpha=alpha, gain=gain, clamp=clamp)


_K5_ARGS = ((kb.PTR, kb.PTR, kb.INT, kb.LONG, kb.INT, kb.INT) + (kb.PTR,) * 4
            + (kb.INT, kb.FLOAT, kb.FLOAT, kb.INT, kb.FLOAT, kb.LONG, kb.PTR))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_ACTS = {"linear": 0, "lrelu": 1}


def _f32_on(t, dev, numel, what):
    if t is None:
        return None
    if t.device != dev or t.numel() != numel:
        raise ValueError(f"K5 {what}: {numel} values on {dev}, got {tuple(t.shape)} on {t.device}")
    return t.detach().to(torch.float32).contiguous()


def modconv_epilogue_kernel(x, dcoef=None, noise=None, noise_strength=None, bias=None,
                            act: str = "linear", alpha: Optional[float] = None,
                            gain: Optional[float] = None, clamp: Optional[float] = None):
    """Launch K5 on a CUDA tensor: same contract as
    :func:`modconv_epilogue_plain` (f32 or bf16; linear or lrelu). A
    [N,1,H,W] noise is read at batch stride H*W (the per-sample noise form,
    counted as the variant ``per_sample_noise``), an [H,W] one at stride 0."""
    require_no_grad("modconv_epilogue", x, dcoef, noise, noise_strength, bias)
    if x.dtype not in _DTYPES:
        raise TypeError(f"K5 takes float32 or bfloat16, got {x.dtype}")
    if act not in _KERNEL_ACTS:
        raise NotImplementedError(f"K5 takes the linear and lrelu activations, not {act!r}")
    if x.ndim not in (2, 4) or (x.ndim == 2 and (dcoef is not None or noise is not None)):
        raise ValueError("K5 takes [N,C,H,W], or [N,C] with bias and activation only")
    spec = activation_funcs[act]
    alpha = float(spec.def_alpha if alpha is None else alpha)
    gain = float(spec.def_gain if gain is None else gain)
    if clamp is not None and clamp < 0:
        raise ValueError("clamp must be >= 0")
    x = x.contiguous()
    dev = x.device
    N, C = x.shape[:2]
    inner = x[0, 0].numel()
    per_sample = noise is not None and noise.ndim == 4
    if per_sample and tuple(noise.shape) != (N, 1) + tuple(x.shape[2:]):
        raise ValueError(f"K5 noise: [H,W] or [N,1,H,W] for x {tuple(x.shape)}, got "
                         f"{tuple(noise.shape)}")
    args = [_f32_on(dcoef, dev, N * C, "dcoef"),
            _f32_on(noise, dev, N * inner if per_sample else inner, "noise"),
            _f32_on(noise_strength, dev, 1, "noise_strength"), _f32_on(bias, dev, C, "bias")]
    y = torch.empty_like(x)
    kb.launch(
        "modconv_epilogue", _K5_ARGS, x.data_ptr(), y.data_ptr(), _DTYPES[x.dtype], x.numel(),
        C, inner, *(a.data_ptr() if a is not None else None for a in args),
        _KERNEL_ACTS[act], alpha, gain, int(clamp is not None),
        float(clamp) if clamp is not None else 0.0, inner if per_sample else 0,
        torch.cuda.current_stream(dev).cuda_stream)
    k = KERNELS["modconv_epilogue"]
    k.launches += 1
    if per_sample:
        k.variants["per_sample_noise"] = k.variants.get("per_sample_noise", 0) + 1
    return y


def modconv_epilogue(x, dcoef=None, noise=None, noise_strength=None, bias=None,
                     act: str = "linear", alpha: Optional[float] = None,
                     gain: Optional[float] = None, clamp: Optional[float] = None):
    """Demodulation, noise and bias_act after the modulated conv (or bias_act
    alone on a dense layer's [N,F] output): the plain version on CPU
    tensors, kernel K5 on CUDA tensors."""
    args = (x, dcoef, noise, noise_strength, bias, act, alpha, gain, clamp)
    if x.device.type == "cpu":
        return modconv_epilogue_plain(*args)
    if x.device.type == "cuda":
        return modconv_epilogue_kernel(*args)
    raise RuntimeError(f"modconv_epilogue: no path for device {x.device}")
