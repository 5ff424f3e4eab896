"""Weight converters for the eval preprocess and the GAN metrics
(panic3d_tpu/runtime/convert.py: convert_resnet50, convert_rmline and
convert_inception_v3), numpy only: a torch state_dict of the released
artifacts (the danbooru tagger's ResNet50 trunk, the rmlineganA Lightning
checkpoint's generator, the FID detector) -> the flax variables tree that
the port's ResNet50, RMLineGenerator and InceptionV3 load through
runtime/checkpoint.py:module_state_from_flax, and that save_checkpoint
writes as the JAX package's ``resnet/`` and ``rmline/`` directories and
the metric CLIs' ``--inception-weights``.

Loading the torch file (torch.load of a Lightning .ckpt) happens at the
call site, so these take an in-memory {name: array or tensor}.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _np(t):
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def _put(tree: dict, path, val):
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = val


def convert_resnet50(state_dict: Dict[str, np.ndarray]) -> dict:
    """torchvision resnet50 (or the tagger's ``resnet.`` trunk) ->
    ResNet50 variables {'params', 'batch_stats'}."""
    sd = {k.replace("resnet.", ""): _np(v) for k, v in state_dict.items()}
    params: dict = {}
    stats: dict = {}

    def conv_bn(dst, src_conv, src_bn):
        _put(params, dst + ("w",), sd[src_conv + ".weight"])
        _put(params, dst + ("bn", "scale"), sd[src_bn + ".weight"])
        _put(params, dst + ("bn", "bias"), sd[src_bn + ".bias"])
        _put(stats, dst + ("bn", "mean"), sd[src_bn + ".running_mean"])
        _put(stats, dst + ("bn", "var"), sd[src_bn + ".running_var"])

    conv_bn(("stem",), "conv1", "bn1")
    for li, blocks in enumerate([3, 4, 6, 3], start=1):
        for bi in range(blocks):
            base, dst = f"layer{li}.{bi}", (f"layer{li}_{bi}",)
            for ci in (1, 2, 3):
                conv_bn(dst + (f"conv{ci}",), f"{base}.conv{ci}", f"{base}.bn{ci}")
            if bi == 0:
                conv_bn(dst + ("downsample",), f"{base}.downsample.0", f"{base}.downsample.1")
    params["fc_w"] = sd["fc.weight"]
    params["fc_b"] = sd["fc.bias"]
    return {"params": params, "batch_stats": stats}


def convert_rmline(state_dict: Dict[str, np.ndarray], depth: int = 6,
                   use_bn: bool = True) -> dict:
    """rmlineganA Lightning checkpoint ('generator.{i}.*') -> RMLineGenerator
    variables. The torch Sequential interleaves Conv2d / LeakyReLU /
    BatchNorm: convs at 0, 3, 6, ... with BatchNorm (a stride of 3), else
    0, 2, 4, ..."""
    gen = {k[len("generator."):]: _np(v) for k, v in state_dict.items()
           if k.startswith("generator.")}
    params: dict = {}
    stats: dict = {}
    stride = 3 if use_bn else 2
    for i in range(depth):
        ci = i * stride
        params[f"conv{i}_w"] = gen[f"{ci}.weight"]
        params[f"conv{i}_b"] = gen[f"{ci}.bias"]
        if use_bn and i != depth - 1:
            bi = ci + 2
            params[f"bn{i}"] = {"scale": gen[f"{bi}.weight"], "bias": gen[f"{bi}.bias"]}
            stats[f"bn{i}"] = {"mean": gen[f"{bi}.running_mean"],
                               "var": gen[f"{bi}.running_var"]}
    return {"params": params, "batch_stats": stats}


def convert_inception_v3(state_dict: Dict[str, np.ndarray], eps: float = 1e-3) -> dict:
    """torchvision / pytorch-fid ``inception_v3`` state_dict -> the
    InceptionV3 variables {'params'} (eval/inception.py), every BatchNorm
    folded into its conv: the net is inference-only, one conv + bias a layer.

    Source names: ``<block>.conv.weight`` and ``<block>.bn.{weight, bias,
    running_mean, running_var}`` for every BasicConv2d (``Conv2d_1a_3x3``,
    ``Mixed_5b.branch1x1``, ...), and ``fc.{weight, bias}`` ([1008, 2048] in
    the FID checkpoint, [1000, 2048] in torchvision's; both taken). The fold
    runs in float64: w' = w g / sqrt(v + eps), b' = beta - mean g / sqrt(v +
    eps), with torchvision's BasicConv2d eps of 0.001. ``AuxLogits.*``
    (torchvision's, absent from the FID checkpoint) is ignored."""
    sd = {k: _np(v) for k, v in state_dict.items()}
    params: dict = {}
    for k in sorted(sd):
        if not k.endswith(".conv.weight") or k.startswith("AuxLogits."):
            continue
        base = k[: -len(".conv.weight")]
        w = sd[k].astype(np.float64)
        g = sd[base + ".bn.weight"].astype(np.float64)
        beta = sd[base + ".bn.bias"].astype(np.float64)
        mean = sd[base + ".bn.running_mean"].astype(np.float64)
        var = sd[base + ".bn.running_var"].astype(np.float64)
        s = g / np.sqrt(var + eps)
        path = tuple(base.split("."))
        _put(params, path + ("w",), (w * s[:, None, None, None]).astype(np.float32))
        _put(params, path + ("b",), (beta - mean * s).astype(np.float32))
    params["fc_w"] = sd["fc.weight"]
    params["fc_b"] = sd["fc.bias"]
    return {"params": params}
