"""Paste-front's gradient in the port against the JAX package (CPU, f32):

- the tiny generator's G.f with paste_params on, from given planes (the
  backbone skipped, key=None: the quadrature render), both occ_impls: the
  gradient of a random projection of the pasted image to the planes and
  to the decoder's four tensors, against jax.vjp of the JAX G.f with the
  same weights (test_torch_generator's seeded tree) and the same
  projection. The scene's masks pass on part of the image (thresholds
  between the render's quantiles; the discrepancy threshold above every
  distance), so the gradient runs through the blend, the front projection
  and the upsample back into the render. The image_xyz's gradient is the
  paste's alone: channels 0 and 1, none in channel 2. PasteComposite on
  CPU tensors (K8's backward form's plain version, paste_front_grad_plain)
  gives the render's image and xyz autograd's gradients of
  paste_composite_plain;
- trainer.main --tiny --synthetic --paste-params-mode A --max-steps 1 runs
  every phase with finite losses (batch 1: on the CPU each paste builds the
  grid occlusion's 128 x 128 x 256 volume a sample, ~7 s on one thread).

Tolerances: the planes' and the decoder's gradients within 1e-4 relative L2
(observed ~2e-5): f32 on both sides, summed in another order, with the
render's rounding (ROADMAP F2) and jax.image.resize's weights, which stray
~2e-6 from their formula (F11), carried back through the upsample's
transpose; PasteComposite against autograd within 1e-6 relative L2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panic3d_tpu import configs as jcfg
from panic3d_tpu.models.triplane import TriPlaneGenerator as JG
from panic3d_tpu_torch import configs as tcfg
from panic3d_tpu_torch.kernels import launch_counts
from panic3d_tpu_torch.models import triplane as tp
from panic3d_tpu_torch.runtime.checkpoint import state_dict_from_flax
from panic3d_tpu_torch.training import trainer

from test_torch_generator import F32, seeded_variables
from torch_one_thread import torch_one_thread  # noqa: F401  (autouse)

BS, IMG = 2, 128
KW = dict(F32, rendering_kwargs=dict(F32["rendering_kwargs"], occ_grid=(16, 16, 32)),
          force_sigmoid=True)
# weights above 0.8 on about half the pixels, an occlusion under 0.46 on
# about two thirds; every xyz discrepancy passes
PASTE = dict(mode="default", thresh_weight=0.8, thresh_edges=0.02, thresh_occ=0.46,
             offset_occ=0.01, thresh_dxyz=1.0)
DECODER = (("net0", "weight"), ("net0", "bias"), ("net2", "weight"), ("net2", "bias"))
TOL = 1e-4


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def pair():
    r = np.random.RandomState(3)
    a = {"z": r.randn(BS, 64).astype(np.float32),
         "image_ortho_front": r.rand(BS, 3, 64, 64).astype(np.float32),
         "resnet_chonk": r.randn(BS, 16, 8, 8).astype(np.float32),
         "elevations": np.asarray([0.0, 20.0], np.float32),
         "azimuths": np.asarray([0.0, 330.0], np.float32)}
    g = jcfg.tiny(**KW)
    xj = {"z": jnp.asarray(a["z"]), "elevations": jnp.asarray(a["elevations"]),
          "azimuths": jnp.asarray(a["azimuths"]),
          "cond": {"image_ortho_front": jnp.asarray(a["image_ortho_front"]),
                   "resnet_chonk": jnp.asarray(a["resnet_chonk"])}}
    variables = seeded_variables(g, xj)
    variables["params"]["decoder"]["net2"]["bias"][0] -= 2.5
    variables["params"]["decoder"]["net0"]["bias"] += 1.0
    G = tcfg.tiny(device="cpu", **KW).eval()
    G.load_state_dict(state_dict_from_flax(variables), strict=True)
    xt = {"z": torch.from_numpy(a["z"]), "elevations": torch.from_numpy(a["elevations"]),
          "azimuths": torch.from_numpy(a["azimuths"]),
          "cond": {k: torch.from_numpy(a[k]) for k in ("image_ortho_front", "resnet_chonk")}}
    with torch.no_grad():
        planes = G.f(dict(xt))["triplane"]
    proj = np.random.RandomState(5).randn(BS, 3, IMG, IMG).astype(np.float32)
    return g, variables, xj, G, xt, planes, proj


@pytest.mark.parametrize("occ_impl", ["grid", "render"])
def test_paste_gradient_matches_jax(pair, occ_impl):
    g, variables, xj, G, xt, planes, proj = pair
    params = dict(PASTE, occ_impl=occ_impl)
    leaf = planes.clone().requires_grad_(True)
    out = G.f(dict(xt, _planes=leaf, paste_params=params))
    masks = out["paste"]
    assert 0.1 < float(masks["mask"].mean()) < 0.9
    loss = (out["image"] * torch.from_numpy(proj)).sum()
    dec = [dict(G.named_parameters())[f"decoder.net.{0 if a == 'net0' else 2}.{b}"]
           for a, b in DECODER]
    g_planes, g_xyz, *g_dec = torch.autograd.grad(loss, [leaf, out["image_xyz"]] + dec)
    # the image takes image_xyz only through the paste's front projection
    assert float(g_xyz[:, :2].abs().max()) > 0 and float(g_xyz[:, 2].abs().max()) == 0

    def f(pl, decoder):
        v = {**variables, "params": {**variables["params"], "decoder": decoder}}
        res = g.apply(v, dict(xj, _planes=pl, paste_params=params), method=JG.f,
                      noise_mode="const")
        return res["image"], res["paste"]["mask"]

    @jax.jit
    def vjp(pl, decoder):
        (_, mask), fn = jax.vjp(f, pl, decoder)
        return mask, fn((jnp.asarray(proj), jnp.zeros_like(mask)))

    mask_j, (want_planes, want_dec) = vjp(
        jnp.asarray(planes.numpy()), jax.tree_util.tree_map(jnp.asarray,
                                                            variables["params"]["decoder"]))
    # the same pixels pass: no threshold sits within rounding of a value
    np.testing.assert_allclose(masks["mask"].numpy(), np.asarray(mask_j), rtol=0, atol=1e-5)
    assert rel_l2(g_planes, want_planes) <= TOL
    for got, (layer, name) in zip(g_dec, DECODER):
        assert rel_l2(got, want_dec[layer][name]) <= TOL, (layer, name)

    # PasteComposite on CPU tensors: K8's backward form's plain version
    # against autograd of the plain composite on the same render
    with torch.no_grad():
        ren = G.f(dict(xt, _planes=planes, paste_params=params))
    image, xyz = ren["image_prepaste"], ren["image_xyz"]
    front = xt["cond"]["image_ortho_front"]
    front = torch.nn.functional.interpolate(front, size=IMG, mode="bilinear",
                                            align_corners=False)
    maps = (ren["image_weights"], torch.ones_like(ren["image_weights"]),
            torch.zeros_like(ren["image_weights"]))
    args = (G.rk["box_warp"], 0.8, 0.02, 1.0)
    ct = torch.from_numpy(proj)
    leaves = [image.clone().requires_grad_(True), xyz.clone().requires_grad_(True)]
    want = tp.paste_composite_plain(leaves[0], front, maps[0], leaves[1], *maps[1:], *args)
    w_img, w_xyz = torch.autograd.grad(want["image"], leaves, ct)
    leaves = [image.clone().requires_grad_(True), xyz.clone().requires_grad_(True)]
    got = tp._paste_apply(lambda im, xz: tp.paste_composite_plain(im, front, maps[0], xz,
                                                                    *maps[1:], *args),
                          args[0], leaves[0], leaves[1], front)
    np.testing.assert_array_equal(got["mask"].numpy(), want["mask"].detach().numpy())
    assert 0 < float(got["mask"].mean()) < 1
    g_img, g_xyz = torch.autograd.grad(got["image"], leaves, ct)
    assert rel_l2(g_img, w_img) <= 1e-6 and rel_l2(g_xyz, w_xyz) <= 1e-6
    assert sum(launch_counts().values()) == 0


def test_trainer_runs_with_paste(tmp_path):
    out = trainer.main(["--name", "paste", "--outdir", str(tmp_path), "--tiny", "--synthetic",
                        "--device", "cpu", "--batch", "1", "--max-steps", "1",
                        "--paste-params-mode", "A"])
    assert out["loss"].cfg.paste_params is not None
    assert np.isfinite([float(v) for v in out["stats"].values()]).all()
    assert out["state"].opt_G.count >= 3 and out["state"].opt_D.count >= 2
