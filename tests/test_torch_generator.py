"""The port's G.f vs the JAX package's, end to end on the tiny config (CPU).

One numpy-seeded set of weights (made in the flax tree's shapes) is loaded
into both packages -- the port through state_dict_from_flax -- and the same
inputs go through both, pinned to f32 (num_fp16_res=0, render_dtype
float32, sr_num_fp16_res=0). Filling the tree from numpy rather than
taking g.init's values gives non-zero biases and noise strengths (init
zeroes them), so those paths are compared too. Compared stage by stage: ws and the triplanes
at 1e-4, the rendered images at 2e-3 (importance resampling amplifies f32
rounding, ROADMAP F2 / FLAGSHIP_PARITY.json). Run once with perspective
views and once with the fov=-1 orthographic views.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panic3d_tpu import configs as jcfg
from panic3d_tpu.models.triplane import TriPlaneGenerator as JG
from panic3d_tpu_torch import configs as tcfg
from panic3d_tpu_torch.cameras import camera_label
from panic3d_tpu_torch.runtime.checkpoint import state_dict_from_flax

torch.backends.cudnn.allow_tf32 = False

F32 = dict(
    synthesis_kwargs=dict(channel_base=2048, channel_max=64, num_fp16_res=0),
    sr_num_fp16_res=0,
    rendering_kwargs=dict(
        superresolution_module="training.superresolution.SuperresolutionHybrid2X",
        depth_resolution=8, depth_resolution_importance=8, box_warp=0.7,
        ray_start=0.5, ray_end=1.5, white_back=True, use_triplane=True,
        render_dtype="float32"),
)
STAGE_TOL = dict(rtol=1e-4, atol=1e-4)     # ws, triplane: no resampling yet
IMAGE_TOL = dict(rtol=2e-3, atol=2e-3)     # rendered and super-resolved images
BS = 2


def seeded_variables(g, x, seed=0):
    """Random weights in the flax tree's shapes: N(0,1) weights, small
    biases (affine biases around 1, as initialized), non-zero noise
    strengths so the const noise is exercised, a +2.5 sigma bias so the
    density filters leave something to render."""
    shapes = jax.eval_shape(lambda: g.init({"params": jax.random.PRNGKey(0)}, x,
                                           method=JG.f, noise_mode="const"))
    r = np.random.RandomState(seed)

    def fill(path, leaf):
        names = [p.key for p in path]
        a = np.asarray(r.randn(*leaf.shape), np.float32)
        if names[-1] == "bias":
            a = a * 0.1 + (1.0 if names[-2] == "affine" else 0.0)
        elif names[-1] == "noise_strength":
            a = a * 0.1
        if names[-3:] == ["decoder", "net2", "bias"]:
            a[0] += 2.5
        return a

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def pair():
    r = np.random.RandomState(1)
    inputs = {
        "z": r.randn(BS, 64).astype(np.float32),
        "image_ortho_front": r.rand(BS, 3, 64, 64).astype(np.float32),
        "resnet_chonk": r.randn(BS, 16, 8, 8).astype(np.float32),
        "elevations": np.asarray([0.0, 20.0], np.float32),
        "azimuths": np.asarray([0.0, 330.0], np.float32),
    }
    g = jcfg.tiny(**F32)
    variables = seeded_variables(g, jax_inputs(inputs, fov=30.0))
    G = tcfg.tiny(device="cpu", **F32).eval()
    G.load_state_dict(state_dict_from_flax(variables), strict=True)

    @jax.jit
    def jax_f(variables, x):
        return g.apply(variables, dict(x, triplane_crop=0.1, cull_clouds=0.5),
                       method=JG.f, noise_mode="const")

    return g, variables, jax_f, G, inputs


def jax_inputs(a, fov):
    return {"z": jnp.asarray(a["z"]), "elevations": jnp.asarray(a["elevations"]),
            "azimuths": jnp.asarray(a["azimuths"]), "fovs": jnp.full((BS,), fov),
            "cond": {"image_ortho_front": jnp.asarray(a["image_ortho_front"]),
                     "resnet_chonk": jnp.asarray(a["resnet_chonk"])}}


def torch_inputs(a, fov):
    return {"z": torch.from_numpy(a["z"]), "elevations": torch.from_numpy(a["elevations"]),
            "azimuths": torch.from_numpy(a["azimuths"]), "fovs": torch.full((BS,), fov),
            "cond": {"image_ortho_front": torch.from_numpy(a["image_ortho_front"]),
                     "resnet_chonk": torch.from_numpy(a["resnet_chonk"])},
            "triplane_crop": 0.1, "cull_clouds": 0.5}


@pytest.mark.parametrize("fov", [30.0, -1.0], ids=["perspective", "ortho"])
def test_f_matches_jax_stage_by_stage(pair, fov):
    g, variables, jax_f, G, a = pair
    xj, xt = jax_inputs(a, fov), torch_inputs(a, fov)
    out_j = jax.tree_util.tree_map(np.asarray, jax_f(variables, xj))
    cam = camera_label(xt["elevations"], xt["azimuths"], torch.ones(BS), xt["fovs"])
    with torch.no_grad():
        out_t = G.f(xt)
        ws_t = G.mapping(xt["z"], cam)
    ws_j = g.apply(variables, xj["z"], jnp.asarray(cam.numpy()), method=JG.mapping)
    np.testing.assert_allclose(ws_t.numpy(), np.asarray(ws_j), **STAGE_TOL)
    np.testing.assert_allclose(out_t["triplane"].numpy(), out_j["triplane"], **STAGE_TOL)
    for k in ("image_raw", "image_depth", "image_weights", "image_xyz", "image"):
        assert out_t[k].shape == out_j[k].shape, k
        np.testing.assert_allclose(out_t[k].numpy(), out_j[k], err_msg=k, **IMAGE_TOL)
    assert float(out_t["image_weights"].max()) > 0.1     # something rendered


def test_camera_labels_and_ortho_rays_match_jax():
    from panic3d_tpu.cameras import conventions as jconv
    from panic3d_tpu_torch.cameras import conventions as tconv

    elev = np.asarray([0.0, 20.0, -10.0], np.float32)
    azim = np.asarray([0.0, 330.0, 90.0], np.float32)
    dist = np.asarray([1.0, 1.2, 0.9], np.float32)
    fov = np.asarray([30.0, -1.0, 45.0], np.float32)
    np.testing.assert_allclose(
        tconv.camera_label(*map(torch.from_numpy, (elev, azim, dist, fov))).numpy(),
        np.asarray(jconv.camera_label(elev, azim, dist, fov)), rtol=1e-5, atol=1e-6)
    ortho = tconv.get_rays_ortho(*map(torch.from_numpy, (elev, azim, dist)), 0.7, 8)
    for got, want in zip(ortho,
                         jconv.get_rays_ortho(elev, azim, dist, 0.7, 8)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


UNPORTED_RENDERING = {"ray_start_auto": dict(ray_start="auto", ray_end="auto"),
                      "disparity_space_sampling": dict(disparity_space_sampling=True)}


@pytest.mark.parametrize("what", ["zs", "latent_injection", *UNPORTED_RENDERING])
def test_unported_inputs_raise(pair, what):
    G = pair[3]
    x = {"ws": torch.zeros(1, G.num_ws, 64), "camera_params": torch.zeros(1, 25),
         "_planes": torch.zeros(1, 3, 8, 16, 16)}
    with pytest.raises(NotImplementedError):
        if what in UNPORTED_RENDERING:
            rk = dict(F32["rendering_kwargs"], **UNPORTED_RENDERING[what])
            tcfg.tiny(device="cpu", **dict(F32, rendering_kwargs=rk)).f(x)
        else:
            G.f(dict(x, **{what: torch.zeros(1, G.num_ws, 64)}))
