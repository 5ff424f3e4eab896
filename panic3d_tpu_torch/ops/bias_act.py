"""Bias + activation + gain + clamp (panic3d_tpu/ops/bias_act.py), and the
modulated conv's epilogue fused with it.

``bias_act`` is the plain op. ``modconv_epilogue`` is the wrapper of CUDA
kernel K5 (csrc/modconv_epilogue.cu): demodulation, noise, bias, leaky relu,
gain and clamp in one pass after the weight convolution, where the JAX
package leaves XLA to fuse the same chain of jnp ops into the conv.
``modconv_epilogue_plain`` is that chain in PyTorch: the CPU path and the
kernel's oracle.

On the card the kernel runs inside ``ModconvEpilogue``, an
autograd.Function whose backward is K5's backward form
(``modconv_epilogue_grad``: dL/d(pre-activation) from the output and its
gradient, in ``EpilogueGrad``, which is differentiable again for R1's second
order), followed by PyTorch's reductions for the bias, the demodulation
coefficients and noise_strength. ``epilogue_grad_plain`` is that form's
plain version: what autograd of ``modconv_epilogue_plain`` computes. The
drawn noise takes no gradient: a noise that requires grad raises.
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


def _launch_k5(x, dcoef, noise, noise_strength, bias, act, alpha, gain, clamp):
    """One launch of K5 (the body of :func:`modconv_epilogue_kernel`)."""
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


def epilogue_grad_plain(dy, y, act: str = "linear", alpha: Optional[float] = None,
                        gain: Optional[float] = None, clamp: Optional[float] = None):
    """The plain version of K5's backward form: dL/d(pre-activation) from
    the epilogue's output ``y`` and its gradient ``dy``, as autograd of
    :func:`modconv_epilogue_plain` computes it (clamp mask, then the gain,
    then the slope, each rounded to dy's dtype); the slope is taken from
    the sign of ``y``, and an output at the clamp passes nothing."""
    if act not in _KERNEL_ACTS:
        raise NotImplementedError(f"K5's backward takes the linear and lrelu activations, "
                                  f"not {act!r}")
    spec = activation_funcs[act]
    alpha = float(spec.def_alpha if alpha is None else alpha)
    gain = float(spec.def_gain if gain is None else gain)
    g = dy
    if clamp is not None:
        g = torch.where(y.abs() < clamp, g, torch.zeros_like(g))
    if gain != 1:
        g = g * gain
    if act == "lrelu":
        g = torch.where(y >= 0, g, g * alpha)
    return g


_K5G_ARGS = (kb.PTR, kb.PTR, kb.PTR, kb.INT, kb.LONG, kb.INT, kb.FLOAT, kb.FLOAT, kb.INT,
             kb.FLOAT, kb.PTR)


def epilogue_grad_kernel(dy, y, act: str = "linear", alpha: Optional[float] = None,
                         gain: Optional[float] = None, clamp: Optional[float] = None):
    """Launch K5's backward form on CUDA tensors: same contract as
    :func:`epilogue_grad_plain`."""
    if not (dy.is_cuda and y.device == dy.device and y.dtype == dy.dtype
            and y.shape == dy.shape and dy.dtype in _DTYPES):
        raise ValueError("K5's backward takes dy and y of one shape and dtype (f32 or bf16) "
                         "on one CUDA device")
    if act not in _KERNEL_ACTS:
        raise NotImplementedError(f"K5's backward takes the linear and lrelu activations, "
                                  f"not {act!r}")
    spec = activation_funcs[act]
    alpha = float(spec.def_alpha if alpha is None else alpha)
    gain = float(spec.def_gain if gain is None else gain)
    dy, y = dy.contiguous(), y.contiguous()
    dz = torch.empty_like(dy)
    kb.launch("modconv_epilogue_grad", _K5G_ARGS, dy.data_ptr(), y.data_ptr(), dz.data_ptr(),
              _DTYPES[dy.dtype], dy.numel(), _KERNEL_ACTS[act], alpha, gain,
              int(clamp is not None), float(clamp) if clamp is not None else 0.0,
              torch.cuda.current_stream(dy.device).cuda_stream)
    KERNELS["modconv_epilogue_grad"].launches += 1
    return dz


class EpilogueGrad(torch.autograd.Function):
    """dz = K5's backward form of (dy, y): the kernel on CUDA tensors, its
    plain version on CPU ones. Linear in dy with a mask that is constant in
    y, so its own backward is the same form on the incoming gradient (and
    none to y): R1 differentiates the discriminator's epilogues twice."""

    @staticmethod
    def forward(ctx, dy, y, cfg):
        ctx.save_for_backward(y)
        ctx.cfg = cfg
        fn = epilogue_grad_kernel if dy.is_cuda else epilogue_grad_plain
        return fn(dy, y, *cfg)

    @staticmethod
    def backward(ctx, ddz):
        (y,) = ctx.saved_tensors
        return EpilogueGrad.apply(ddz, y, ctx.cfg), None, None


class ModconvEpilogue(torch.autograd.Function):
    """K5 with its backward: the forward launches K5 on CUDA tensors (the
    plain version on CPU ones); the backward takes dz from
    :class:`EpilogueGrad` and leaves dx = dz * dcoef and the reductions to
    PyTorch, in the plain version's order of rounding: the bias's and the
    coefficients' sums in the layer dtype, noise_strength's over the noise
    reduced to its own shape first. ``cfg`` = (act, alpha, gain, clamp)."""

    @staticmethod
    def forward(ctx, x, dcoef, noise, noise_strength, bias, cfg):
        args = (x, dcoef, noise, noise_strength, bias, *cfg)
        y = _launch_k5(*args) if x.is_cuda else modconv_epilogue_plain(*args)
        ctx.cfg = cfg
        ctx.bias_dtype = bias.dtype if bias is not None else None
        ctx.save_for_backward(x if dcoef is not None else None, dcoef, noise, noise_strength,
                              y)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, dcoef, noise, noise_strength, y = ctx.saved_tensors
        dz = EpilogueGrad.apply(dy.contiguous(), y, ctx.cfg)
        need = ctx.needs_input_grad
        spatial = tuple(range(2, dz.ndim))
        gx = gd = gns = gb = None
        if need[0]:
            gx = dz * dcoef.to(dz.dtype)[:, :, None, None] if dcoef is not None else dz
        if need[1]:
            gd = (dz * x).sum(spatial).to(dcoef.dtype)
        if need[3]:
            gn = dz.sum_to_size(noise.shape).to(noise.dtype)
            gns = (gn * noise).sum().reshape(noise_strength.shape).to(noise_strength.dtype)
        if need[4]:
            gb = dz.sum((0,) + spatial).to(ctx.bias_dtype)
        return gx, gd, None, gns, gb, None


def modconv_epilogue_kernel(x, dcoef=None, noise=None, noise_strength=None, bias=None,
                            act: str = "linear", alpha: Optional[float] = None,
                            gain: Optional[float] = None, clamp: Optional[float] = None):
    """K5 on a CUDA tensor, differentiable (:class:`ModconvEpilogue`): same
    contract as :func:`modconv_epilogue_plain` (f32 or bf16; linear or
    lrelu). A [N,1,H,W] noise is read at batch stride H*W (the per-sample
    noise form, counted as the variant ``per_sample_noise``), an [H,W] one
    at stride 0. The noise is drawn, not learnt: one that requires grad
    raises under grad mode."""
    require_no_grad("modconv_epilogue", noise)
    if not x.is_cuda:
        raise ValueError(f"K5 runs on CUDA tensors, got one on {x.device}")
    return ModconvEpilogue.apply(x, dcoef, noise, noise_strength, bias,
                                 (act, alpha, gain, clamp))


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
