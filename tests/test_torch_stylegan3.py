"""The port's alias-free synthesis layer (models/stylegan3.py) on the CPU
against the JAX package's, with the weights through state_dict_from_flax.

- design_lowpass_filter: the same numpy / scipy arithmetic, equal bit for
  bit;
- AFSynthesisLayer at the three GEOMS of tests/test_stylegan3.py (a
  mid-band layer, the toRGB, a radial-filter layer) and an up-4 layer at
  narrow width, f32 within 5e-6 x max|out| (the same ops; the conv and the
  FIR sums in another order), and the up-4 layer in bf16 within 2^-6 x
  max|out| (both frameworks round each op to bf16, at other points inside
  the fused ones);
- the magnitude EMA's update, and magnitude_ema in the 'buffers'
  collection;
- chip_smoke.sg3_layer_geometries: StyleGAN3-T's sizes, channels, factors,
  taps and the critically sampled layer's negative padding at 512^2.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panic3d_tpu.models import stylegan3 as jsg3
from panic3d_tpu_torch.kernels import launch_counts
from panic3d_tpu_torch.models import stylegan3 as tsg3
from panic3d_tpu_torch.models.superresolution import AFSynthesisLayer as SRAFLayer
from panic3d_tpu_torch.runtime.checkpoint import flax_path_from_torch, state_dict_from_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GEOMS = [
    dict(is_torgb=False, is_critically_sampled=False, use_radial_filters=False),
    dict(is_torgb=True, is_critically_sampled=True, use_radial_filters=False),
    dict(is_torgb=False, is_critically_sampled=False, use_radial_filters=True),
]
BASE = dict(w_dim=16, use_fp16=False, in_channels=8, out_channels=8, in_size=16, out_size=16,
            in_sampling_rate=16, out_sampling_rate=16, in_cutoff=4.0, out_cutoff=4.0,
            in_half_width=4.0, out_half_width=4.0, conv_clamp=256)
# an up-4 layer (16 -> 32 samples a unit, tmp rate 64: up 4 / down 2, 24 / 12 taps)
UP4 = dict(BASE, is_torgb=False, is_critically_sampled=False, use_radial_filters=False,
           in_channels=6, out_channels=5, out_size=24, out_sampling_rate=32, out_cutoff=6.0,
           out_half_width=5.0)


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("args", [
    (12, 4.0, 8.0, 64.0, False), (24, 6.0, 5.0, 64.0, False), (12, 9.0, 7.0, 64.0, True),
    (12, 256.0, 59.1, 1024.0, False), (1, 4.0, 8.0, 64.0, False)])
def test_design_lowpass_filter_equals_jax(args):
    got, want = tsg3.design_lowpass_filter(*args), jsg3.design_lowpass_filter(*args)
    if want is None:
        assert got is None
    else:
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def _pair(kw):
    rng = np.random.RandomState(0)
    x = rng.randn(2, kw["in_channels"], kw["in_size"], kw["in_size"]).astype(np.float32)
    w = rng.randn(2, kw["w_dim"]).astype(np.float32)
    layer = jsg3.AFSynthesisLayer(**kw)
    variables = layer.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x), jnp.asarray(w))
    # a bias that is not zero, so that the kernel's bias path counts
    variables = jax.tree_util.tree_map(np.asarray, variables)
    variables["params"]["bias"] = rng.randn(kw["out_channels"]).astype(np.float32) * 0.3
    port = tsg3.AFSynthesisLayer(**kw, device="cpu")
    result = port.load_state_dict(state_dict_from_flax(variables), strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    return layer, variables, port, x, w


@pytest.mark.parametrize("kw", [dict(BASE, **g) for g in GEOMS] + [UP4],
                         ids=["midband", "torgb", "radial", "up4"])
def test_af_layer_matches_jax(kw):
    layer, variables, port, x, w = _pair(kw)
    assert set(port.state_dict()) == {"affine.weight", "affine.bias", "weight", "bias",
                                      "magnitude_ema"}
    want = np.asarray(jax.jit(layer.apply)(variables, jnp.asarray(x), jnp.asarray(w)))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    assert got.shape == want.shape == (2, kw["out_channels"], kw["out_size"], kw["out_size"])
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-6 * float(np.abs(want).max()))
    assert sum(launch_counts().values()) == 0


def test_af_layer_bf16_matches_jax():
    kw = dict(UP4, use_fp16=True)
    layer, variables, port, x, w = _pair(kw)
    want = np.asarray(jax.jit(layer.apply)(variables, jnp.asarray(x), jnp.asarray(w))
                      .astype(jnp.float32))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2.0 ** -6 * float(np.abs(want).max()))


def test_magnitude_ema_update_and_collection():
    kw = dict(BASE, **GEOMS[0])
    layer, variables, port, _, w = _pair(kw)
    assert "magnitude_ema" in variables["buffers"]
    assert flax_path_from_torch("synthesis.L3_52_512.magnitude_ema") == (
        "buffers", "synthesis", "L3_52_512", "magnitude_ema")
    assert flax_path_from_torch("synthesis.L3_52_512.up_filter") is None
    x = np.full((1, 8, 16, 16), 3.0, np.float32)
    _, new_vars = layer.apply(variables, jnp.asarray(x), jnp.asarray(w[:1]), update_emas=True,
                              mutable=["buffers"])
    with torch.no_grad():
        port(torch.from_numpy(x), torch.from_numpy(w[:1]), update_emas=True)
    ema = float(port.magnitude_ema)
    assert abs(ema - (9.0 + (1.0 - 9.0) * 0.999)) < 1e-6
    assert ema == float(new_vars["buffers"]["magnitude_ema"])


def test_superresolution_exposes_the_layer():
    assert SRAFLayer is tsg3.AFSynthesisLayer


def test_sg3_layer_geometries():
    geoms = chip_smoke().sg3_layer_geometries("stylegan3-t")
    assert len(geoms) == 15 and geoms[-1]["is_torgb"]
    assert [g["out_channels"] for g in geoms] == [512] * 7 + [483, 323, 215, 144, 96, 64, 64, 3]
    assert [(g["in_size"], g["out_size"]) for g in geoms] == [
        (36, 36), (36, 36), (36, 52), (52, 52), (52, 84), (84, 84), (84, 148), (148, 148),
        (148, 276), (276, 276), (276, 532), (532, 532), (532, 532), (532, 512), (512, 512)]
    assert [g["use_fp16"] for g in geoms] == [False] * 4 + [True] * 11
    assert [g["is_critically_sampled"] for g in geoms] == [False] * 12 + [True] * 3
    layers = [tsg3.AFSynthesisLayer(**g, device="cpu") for g in geoms]
    assert [(m.up_factor, m.down_factor) for m in layers] == (
        [(2, 2), (2, 2), (4, 2), (2, 2), (4, 2), (2, 2), (4, 2), (2, 2), (4, 2), (2, 2), (4, 2)]
        + [(2, 2)] * 3 + [(1, 1)])
    taps = [(None if m.up_filter is None else m.up_filter.shape[0],
             None if m.down_filter is None else tuple(m.down_filter.shape)) for m in layers]
    assert taps == [(m.up_factor * 6, (12,)) for m in layers[:-1]] + [(None, None)]
    assert layers[13].padding == [-11, -12, -11, -12]
    r = chip_smoke().sg3_layer_geometries("stylegan3-r")
    assert [g["out_channels"] for g in r[:3]] == [1024] * 3 and r[0]["conv_kernel"] == 1
    radial = [tsg3.AFSynthesisLayer(**g, device="cpu").down_filter for g in r[:12]]
    assert all(f is not None and tuple(f.shape) == (12, 12) for f in radial)
