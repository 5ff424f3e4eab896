"""The port's 2-D metric nets and resize against the JAX package, on the
CPU, with inputs made from a numpy seed:

- ops/resize.py against jax.image.resize: bilinear and bicubic, antialias
  on and off, up and down, odd sizes. jax.image.resize runs jitted, and
  XLA's CPU code contracts some multiply-adds of its weight formula and
  multiplies by the reciprocal of the kernel's scale, differently in each
  fused graph: the port's weights are that formula in f32, so the images
  agree within 3e-6 (the largest difference seen is 2.4e-6, at 64 -> 13
  without antialiasing); the port's two products agree with their f64
  evaluation within 1e-6;
- LPIPS and CLIP (ViT-B/32) against the JAX modules, on the same .npz of
  flax paths, written here from eval/goldens.py's seeded state_dicts
  through runtime/convert.py, and against tests/goldens/metricnets.npz at
  tests/test_metricnet_goldens.py's tolerances (LPIPS rtol 1e-4 / atol
  1e-5; CLIP rtol 5e-3 / atol 5e-4 and cosine > 0.99999, the tower alone
  against the golden, through CLIPSimilarity against the JAX module);
  psnr against the JAX one.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panic3d_tpu.eval.goldens import (clip_inputs, lpips_inputs, seeded_clip_state_dict,
                                      seeded_lpips_state_dict)
from panic3d_tpu.eval import lpips as jlpips
from panic3d_tpu.eval import metrics2d as jm2d
from panic3d_tpu.runtime.convert import convert_clip_vit_b32, convert_lpips_alex
from panic3d_tpu_torch.eval import lpips as tlpips
from panic3d_tpu_torch.eval import metrics2d as tm2d
from panic3d_tpu_torch.ops.resize import resize, weight_mat

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens", "metricnets.npz")


def save_flax_npz(path, variables):
    """variables {'params': tree} -> an .npz keyed by the flax paths joined
    by '/', as runtime/convert's callers write converted weights."""
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat["/".join(prefix + (k,))] = np.asarray(v, np.float32)

    walk(variables["params"], ())
    np.savez(path, **flat)
    return path


@pytest.fixture(scope="module")
def weight_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("metricnets")
    return (save_flax_npz(str(d / "lpips.npz"), convert_lpips_alex(seeded_lpips_state_dict())),
            save_flax_npz(str(d / "clip.npz"), convert_clip_vit_b32(seeded_clip_state_dict())))


CASES = [((64, 64), (224, 224)), ((37, 53), (224, 224)), ((512, 512), (224, 224)),
         ((300, 301), (256, 256)), ((17, 9), (64, 64)), ((64, 64), (13, 7))]


@pytest.mark.parametrize("method", ["bilinear", "bicubic"])
@pytest.mark.parametrize("antialias", [True, False], ids=["aa", "no-aa"])
def test_resize_matches_jax(method, antialias):
    rng = np.random.RandomState(0)
    for (h, w), (oh, ow) in CASES:
        x = rng.rand(1, 3, h, w).astype(np.float32)
        want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 3, oh, ow), method=method,
                                           antialias=antialias))
        got = resize(torch.from_numpy(x), (1, 3, oh, ow), method, antialias).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=3e-6, err_msg=f"{(h, w, oh, ow)}")
        wh = weight_mat(h, oh, method, antialias, torch.device("cpu")).double().numpy()
        ww = weight_mat(w, ow, method, antialias, torch.device("cpu")).double().numpy()
        exact = wh.T @ x.astype(np.float64) @ ww
        np.testing.assert_allclose(got, exact, rtol=0, atol=1e-6)


def test_lpips_matches_jax_and_golden(weight_files):
    variables = jlpips.load_lpips_params(weight_files[0])
    net = tlpips.LPIPS(device="cpu").load_variables(tlpips.load_lpips_params(weight_files[0]))
    x0, x1 = lpips_inputs()
    got = net(torch.from_numpy(x0), torch.from_numpy(x1)).detach().numpy()
    want = np.asarray(jax.jit(jlpips.LPIPS().apply)(variables, x0, x1))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, np.load(GOLDENS)["lpips_dist"], rtol=1e-4, atol=1e-5)


def test_clip_tower_matches_golden(weight_files):
    tower = tm2d.CLIPImageViT(device="cpu").load_variables(tm2d.load_clip_params(weight_files[1]))
    with torch.no_grad():
        got = tower(torch.from_numpy(clip_inputs())).numpy()
    golden = np.load(GOLDENS)["clip_embed"]
    np.testing.assert_allclose(got, golden, rtol=5e-3, atol=5e-4)
    gn = got / np.linalg.norm(got, axis=-1, keepdims=True)
    rn = golden / np.linalg.norm(golden, axis=-1, keepdims=True)
    assert float(np.sum(gn * rn, axis=-1).min()) > 0.99999


def test_clip_similarity_and_psnr_match_jax(weight_files):
    rng = np.random.RandomState(4)
    a = rng.rand(1, 3, 45, 61).astype(np.float32)
    b = np.clip(a + 0.1 * rng.randn(*a.shape), 0, 1).astype(np.float32)
    jsim = jm2d.CLIPSimilarity(jm2d.load_clip_params(weight_files[1]))

    def jax_similarity(variables, a, b):   # the variables as an argument, not constants
        sim = object.__new__(jm2d.CLIPSimilarity)
        sim.module, sim.variables = jsim.module, variables
        return sim(a, b)

    want = np.asarray(jax.jit(jax_similarity)(jsim.variables, jnp.asarray(a), jnp.asarray(b)))
    tsim = tm2d.CLIPSimilarity(tm2d.load_clip_params(weight_files[1]), device="cpu")
    got = tsim(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert tsim.pretrained
    np.testing.assert_allclose(float(tm2d.psnr(torch.from_numpy(a), torch.from_numpy(b))),
                               float(jm2d.psnr(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)
    np.testing.assert_array_equal(tm2d.CLIP_MEAN, jm2d.CLIP_MEAN)
    np.testing.assert_array_equal(tm2d.CLIP_STD, jm2d.CLIP_STD)
