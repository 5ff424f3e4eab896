"""Kernel K5's plain version (ops/bias_act.py:modconv_epilogue_plain) inside
the port's SynthesisLayer, ToRGBLayer and FullyConnectedLayer vs the JAX
package's modulated_conv2d -> bias_act, on the CPU in f32.

The layers' weights are numpy-seeded in the flax tree's shapes (non-zero
biases and noise strengths) and carried into the port by
state_dict_from_flax. Tolerances: 1e-5 on the layer outputs (the conv and
demodulation sums run in another order; the epilogue's ops are the same
ops); the tiny G.f after the rewiring within test_torch_generator.py's
bounds (triplanes 1e-4, images 2e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panic3d_tpu import configs as jcfg
from panic3d_tpu.models import stylegan2 as js
from panic3d_tpu.models.triplane import TriPlaneGenerator as JG
from panic3d_tpu_torch import configs as tcfg
from panic3d_tpu_torch.kernels import launch_counts
from panic3d_tpu_torch.models import stylegan2 as ts
from panic3d_tpu_torch.ops.bias_act import bias_act, modconv_epilogue, modconv_epilogue_plain
from panic3d_tpu_torch.runtime.checkpoint import state_dict_from_flax

from test_torch_generator import (F32, IMAGE_TOL, STAGE_TOL, jax_inputs, seeded_variables,
                                  torch_inputs)

LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
W_DIM = 16


def seeded(module, *args, seed=0, **kwargs):
    """The module's flax variables with numpy-seeded values: N(0,1)
    weights and noise, biases ~0.1 (affine biases around 1), noise
    strengths ~0.5."""
    shapes = jax.eval_shape(lambda: module.init({"params": jax.random.PRNGKey(0)}, *args,
                                                **kwargs))
    r = np.random.RandomState(seed)

    def fill(path, leaf):
        names = [p.key for p in path]
        a = np.asarray(r.randn(*leaf.shape), np.float32)
        if names[-1] == "bias":
            a = a * 0.1 + (1.0 if "affine" in names else 0.0)
        elif names[-1] == "noise_strength":
            a = a * 0.5
        return a

    return jax.tree_util.tree_map_with_path(fill, shapes)


def inputs(shape, seed=1):
    r = np.random.RandomState(seed)
    return r.randn(*shape).astype(np.float32), r.randn(2, W_DIM).astype(np.float32)


@pytest.mark.parametrize("up", [1, 2])
@pytest.mark.parametrize("noise_mode", ["const", "none"])
@pytest.mark.parametrize("clamp", [None, 0.5])
def test_synthesis_layer_matches_jax(up, noise_mode, clamp):
    res = 8
    x, w = inputs((2, 6, res // up, res // up))
    jl = js.SynthesisLayer(6, 5, W_DIM, res, up=up, conv_clamp=clamp)
    v = seeded(jl, jnp.asarray(x), jnp.asarray(w), noise_mode="const")
    want = np.asarray(jl.apply(v, jnp.asarray(x), jnp.asarray(w), noise_mode=noise_mode))
    tl = ts.SynthesisLayer(6, 5, W_DIM, res, up=up, conv_clamp=clamp)
    tl.load_state_dict(state_dict_from_flax(v), strict=True)
    with torch.no_grad():
        got = tl(torch.from_numpy(x), torch.from_numpy(w), noise_mode=noise_mode).numpy()
    assert got.shape == want.shape == (2, 5, res, res)
    np.testing.assert_allclose(got, want, **LAYER_TOL)
    if clamp is not None:
        assert np.abs(got).max() <= clamp
        assert (np.abs(got) == clamp).any()               # the clamp is reached
    assert sum(launch_counts().values()) == 0


@pytest.mark.parametrize("clamp", [None, 0.3])
def test_torgb_layer_matches_jax(clamp):
    x, w = inputs((2, 6, 8, 8), seed=2)
    jl = js.ToRGBLayer(6, 3, W_DIM, conv_clamp=clamp)
    v = seeded(jl, jnp.asarray(x), jnp.asarray(w))
    want = np.asarray(jl.apply(v, jnp.asarray(x), jnp.asarray(w)))
    tl = ts.ToRGBLayer(6, 3, W_DIM, conv_clamp=clamp)
    tl.load_state_dict(state_dict_from_flax(v), strict=True)
    with torch.no_grad():
        got = tl(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, **LAYER_TOL)


@pytest.mark.parametrize("lr_multiplier", [1.0, 0.01])
def test_fully_connected_lrelu_matches_jax(lr_multiplier):
    x, _ = inputs((4, 12), seed=3)
    jl = js.FullyConnectedLayer(12, 7, activation="lrelu", lr_multiplier=lr_multiplier)
    v = seeded(jl, jnp.asarray(x))
    want = np.asarray(jl.apply(v, jnp.asarray(x)))
    tl = ts.FullyConnectedLayer(12, 7, activation="lrelu", lr_multiplier=lr_multiplier)
    tl.load_state_dict(state_dict_from_flax(v), strict=True)
    with torch.no_grad():
        got = tl(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **LAYER_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_epilogue_plain_is_the_op_chain(dtype):
    """The plain epilogue is modulated_conv2d's tail then bias_act, each op
    rounded to the layer dtype (what the kernel repeats on the card), and
    the dispatcher takes it for CPU tensors."""
    r = np.random.RandomState(4)
    x = torch.from_numpy(r.randn(2, 3, 4, 4).astype(np.float32) * 300).to(dtype)
    dcoef = torch.from_numpy(r.rand(2, 3).astype(np.float32))
    noise = torch.from_numpy(r.randn(4, 4).astype(np.float32))
    strength = torch.tensor(0.7)
    bias = torch.from_numpy(r.randn(3).astype(np.float32))
    want = x * dcoef.to(dtype)[:, :, None, None]
    want = want + (noise * strength).to(dtype)
    want = bias_act(want, bias, act="lrelu", gain=np.sqrt(2), clamp=256.0)
    kw = dict(act="lrelu", gain=np.sqrt(2), clamp=256.0)
    got = modconv_epilogue_plain(x, dcoef, noise, strength, bias, **kw)
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(modconv_epilogue(x, dcoef, noise, strength, bias, **kw), want)
    assert (got.float().abs() == 256).any()
    assert sum(launch_counts().values()) == 0


@pytest.fixture(scope="module")
def tiny_pair():
    r = np.random.RandomState(5)
    a = {"z": r.randn(2, 64).astype(np.float32),
         "image_ortho_front": r.rand(2, 3, 64, 64).astype(np.float32),
         "resnet_chonk": r.randn(2, 16, 8, 8).astype(np.float32),
         "elevations": np.asarray([0.0, 10.0], np.float32),
         "azimuths": np.asarray([0.0, 45.0], np.float32)}
    g = jcfg.tiny(**F32)
    variables = seeded_variables(g, jax_inputs(a, fov=30.0))
    G = tcfg.tiny(device="cpu", **F32).eval()
    G.load_state_dict(state_dict_from_flax(variables), strict=True)
    return g, variables, G, a


def test_tiny_generator_after_rewiring_matches_jax(tiny_pair):
    g, variables, G, a = tiny_pair
    out_j = jax.jit(lambda v, x: g.apply(v, dict(x, triplane_crop=0.1, cull_clouds=0.5),
                                         method=JG.f, noise_mode="const"))(
        variables, jax_inputs(a, fov=30.0))
    with torch.no_grad():
        out_t = G.f(torch_inputs(a, fov=30.0))
    np.testing.assert_allclose(out_t["triplane"].numpy(), np.asarray(out_j["triplane"]),
                               **STAGE_TOL)
    for k in ("image_raw", "image"):
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]), err_msg=k,
                                   **IMAGE_TOL)
    assert sum(launch_counts().values()) == 0
