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
from panic3d_tpu_torch.cameras import camera_label, sample_rays
from panic3d_tpu_torch.runtime.checkpoint import state_dict_from_flax
from torch_one_thread import torch_one_thread  # noqa: F401  (autouse)

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
    """The inputs and options G.f once refused, against the JAX package on
    the same weights, each at the stage it changes: z+ latents through
    mapping_zplus (ws at STAGE_TOL), latent injection (dw, dws, da_2, db_3)
    through the backbone synthesis (planes at STAGE_TOL), 'auto' ray bounds
    and disparity-space sampling through the JAX render of the port's
    planes (images at IMAGE_TOL); then G.f with the input equals G.f fed
    that stage's result. The two rendering options run without the
    triplane crop: with 'auto' spans a few fine samples land within f32
    rounding of the crop's edge, where a 1e-6 difference in depth switches a
    sample's density between -1e3 and its decoded value (F2)."""
    g, variables, _, G, a = pair
    xj, xt = jax_inputs(a, 30.0), torch_inputs(a, 30.0)
    cam = camera_label(xt["elevations"], xt["azimuths"], torch.ones(BS), xt["fovs"])
    r = np.random.RandomState(11)
    if what == "zs":
        zs = r.randn(BS, G.num_ws, 64).astype(np.float32)
        ws_j = jax.jit(lambda v, z, c: g.apply(v, z, c, method=JG.mapping_zplus))(
            variables, jnp.asarray(zs), jnp.asarray(cam.numpy()))
        with torch.no_grad():
            ws_t = G.mapping_zplus(torch.from_numpy(zs), cam)
            got = G.f(dict({k: v for k, v in xt.items() if k != "z"}, zs=torch.from_numpy(zs)))
            want = G.f(dict(xt, ws=ws_t))
        np.testing.assert_allclose(ws_t.numpy(), np.asarray(ws_j), **STAGE_TOL)
        assert not np.allclose(ws_t[:, 0].numpy(), ws_t[:, 1].numpy())   # a z a slot
    elif what == "latent_injection":
        li = {"dw": r.randn(BS, 1, 64), "dws": r.randn(BS, G.num_ws, 64),
              "da_2": r.randn(BS, 64, 16, 16), "db_3": r.randn(BS, 24, 32, 32)}
        li = {k: (0.1 * v).astype(np.float32) for k, v in li.items()}
        tli = {k: torch.from_numpy(v) for k, v in li.items()}
        with torch.no_grad():
            ws = G.mapping(xt["z"], cam)
            planes_t = G._planes_from_ws(ws + tli["dw"] + tli["dws"], xt["cond"],
                                         latent_injection=tli)
            got = G.f(dict(xt, latent_injection=tli))
            want = G.f(dict(xt, ws=ws + tli["dw"] + tli["dws"], _planes=planes_t))
        planes_j = jax.jit(lambda v, w, c, l: g.apply(v, w, c, latent_injection=l,
                                                      noise_mode="const",
                                                      method=JG._planes_from_ws))(
            variables, jnp.asarray((ws + tli["dw"] + tli["dws"]).numpy()), xj["cond"],
            {k: jnp.asarray(v) for k, v in li.items()})
        np.testing.assert_allclose(planes_t.numpy(), np.asarray(planes_j), **STAGE_TOL)
    else:
        rk = dict(F32["rendering_kwargs"], **UNPORTED_RENDERING[what])
        G2 = tcfg.tiny(device="cpu", **dict(F32, rendering_kwargs=rk)).eval()
        G2.load_state_dict(G.state_dict())
        xt = {k: v for k, v in xt.items() if k != "triplane_crop"}
        with torch.no_grad():
            got = G2.f(xt)
        o, d = sample_rays(cam[:, :16].reshape(-1, 4, 4), cam[:, 16:25].reshape(-1, 3, 3), 16)
        opts = dict(g.rk, **rk)
        ref = jax.jit(lambda v, pl, o_, d_: g.apply(v, pl, o_, d_, opts, method=_jax_render,
                                                    cull_clouds=0.5))(
            variables, jnp.asarray(got["triplane"].numpy()), jnp.asarray(o.numpy()),
            jnp.asarray(d.numpy()))
        for k, j in (("image_raw", 0), ("image_depth", 1), ("image_weights", 2)):
            img = np.asarray(ref[j]).transpose(0, 2, 1).reshape(BS, -1, 16, 16)
            if k == "image_raw":     # G.f's normalize_images=False: [0, 1]
                img = 0.5 * img[:, :3] + 0.5
            np.testing.assert_allclose(got[k].numpy(), img, err_msg=k, **IMAGE_TOL)
        assert float(got["image_weights"].max()) > 0.1
        return
    for k in ("image", "image_raw", "image_depth", "triplane"):
        assert torch.equal(got[k], want[k]), k


def _jax_render(self, planes, ro, rd, opts, **filters):
    """The JAX render of given planes through the module's decoder."""
    from panic3d_tpu.models.volumetric import renderer as jvr

    return jvr.render(planes, lambda f, **kw: self.decoder(f, force_sigmoid=self.force_sigmoid,
                                                          **kw),
                      ro, rd, opts, **filters)
