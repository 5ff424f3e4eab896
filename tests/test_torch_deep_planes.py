"""Deep planes (triplane_depth D > 1) in the port vs the JAX package (CPU, f32).

A depth-D generator's backbone makes 3*C*D channels; each plane is a volume
[C, D, H, W] sampled trilinearly (renderer.py:68-93), then decoded. In the
port both run in kernel K10, the trilinear K1 form, behind
renderer.triplane_decode_deep (its plain version, sample_from_planes and
osg_decode, on CPU tensors) and, for the mesh, volume.density_grid.
Checked against the JAX package on the same numpy inputs and weights (the
port's through state_dict_from_flax):

- sample_from_planes at D = 2 and 3, and grid_sample_3d_points (the plain
  version of K10's sample) in zeros and border padding, with points beyond
  +-1 on every axis: 1e-5 (f32, the same formulas); the channels-last copy
  K10 reads, exact;
- the K10 dispatcher on CPU tensors through that copy against the JAX
  package's run_model and density filters, rgb and sigma 1e-5;
- state_dict_from_flax on a depth-2 tree, loaded with strict=True;
- the tiny G.f at D = 2, ESS off, stage by stage: ws and the planes 1e-4;
  the coarse pass's filtered sigma, its march weights 1e-5 and the
  importance depths 1e-4 (test_torch_render.py's bounds); the images 2e-3
  (importance resampling amplifies f32 rounding, ROADMAP F2);
- the same G.f with paste-front's occ_impl='render' (the re-render along
  +z): the masks by the pixels that differ, as in test_torch_paste.py, the
  image where every mask agrees at 2e-3;
- the per-portrait path (planes_bundle + render_from_planes) against the
  JAX package's (eval/generate.py's planes and render jits), 2e-3;
- extract_mesh with eval generate's filters and the sigma bias raised, as
  test_torch_volume.py does: no cull decision differs, densities 1e-5,
  identical faces, verts 1e-5;
- from_snapshot_config's three forms against the JAX package's;
- F12: ESS and occ_impl='grid' fail in the JAX package at D = 2 and raise
  NotImplementedError naming F12 in the port.

One jitted JAX G.f (with the render paste, whose image_prepaste is the
paste-off render) serves both G.f tests.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panic3d_tpu import configs as jcfg
from panic3d_tpu.eval import volume as jv
from panic3d_tpu.eval.generate import _get_planes_jit, _get_render_jit
from panic3d_tpu.models.triplane import TriPlaneGenerator as JG
from panic3d_tpu.models.volumetric import renderer as jvr
from panic3d_tpu.ops import grid_sample as jgs
from panic3d_tpu_torch import configs as tcfg
from panic3d_tpu_torch.cameras import camera_label, sample_rays
from panic3d_tpu_torch.eval import volume as tv
from panic3d_tpu_torch.eval.generate import INFERENCE_OPTS, planes_bundle, render_from_planes
from panic3d_tpu_torch.kernels import launch_counts
from panic3d_tpu_torch.models.volumetric import renderer as tvr
from panic3d_tpu_torch.ops import grid_sample as tgs
from panic3d_tpu_torch.runtime.checkpoint import state_dict_from_flax

from test_torch_generator import F32, IMAGE_TOL, STAGE_TOL, seeded_variables
from test_torch_paste import MASKS, count_flips
from test_torch_render import BW, IMP_TOL, TOL, close, decoder_params, jax_decode_fn, t
from test_torch_render import torch_decoder
from torch_one_thread import torch_one_thread  # noqa: F401  (autouse)

DEPTH = 2
RK = dict(F32["rendering_kwargs"], triplane_depth=DEPTH)
KW = dict(F32, rendering_kwargs=RK, force_sigmoid=True)
PASTE_RENDER = dict(INFERENCE_OPTS["paste_params"], occ_impl="render")
OPTS = dict(triplane_crop=0.1, cull_clouds=0.5)
ESS = dict(grid=8, taps=16, thresh=0.01, margin=1.0)
SIGMA_BIAS = 12.0   # added to net2's sigma bias so that voxels survive the cull
BS = 2


@pytest.mark.parametrize("D", [2, 3])
def test_sample_from_planes_deep_matches_jax(D):
    r = np.random.RandomState(10 + D)
    C = 4
    planes = r.randn(2, 3, C * D, 9, 7).astype(np.float32)
    # world points up to 0.45 from the centre: up to 1.29 after 2 / box_warp,
    # so every axis (the depth axis included) has points in the padding
    coords = r.uniform(-0.45, 0.45, (2, 300, 3)).astype(np.float32)
    for use_triplane in (True, False):
        axes = jvr.generate_plane_axes(use_triplane)
        want = jvr.sample_from_planes(axes, jnp.asarray(planes), jnp.asarray(coords), BW, D)
        got = tvr.sample_from_planes(tvr.generate_plane_axes(use_triplane), t(planes),
                                     t(coords), BW, D)
        close(got, want, **TOL)
        assert np.abs(got.numpy()).max() > 0


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_k10_plain_sampler_matches_jax(padding_mode):
    r = np.random.RandomState(30)
    vol = r.randn(3, 5, 2, 6, 7).astype(np.float32)             # [N,C,D,H,W]
    pts = r.uniform(-1.4, 1.4, (3, 200, 3)).astype(np.float32)
    want = jgs.grid_sample_3d_points(jnp.asarray(vol), jnp.asarray(pts), padding_mode)
    got = tgs.grid_sample_3d_points(t(vol), t(pts), padding_mode)
    close(got, want, **TOL)
    # the deep decode's channels-last copy of planes [N,3,C*D,H,W]
    planes = r.randn(2, 3, 4 * 3, 5, 6).astype(np.float32)
    got = tvr.deep_volumes_cl(t(planes), 3)
    want = planes.reshape(6, 4, 3, 5, 6).transpose(0, 2, 3, 4, 1)
    np.testing.assert_array_equal(got.numpy(), want)
    assert sum(launch_counts().values()) == 0


@pytest.mark.parametrize("use_triplane", [True, False])
def test_k10_dispatcher_matches_jax(use_triplane):
    r = np.random.RandomState(31)
    C = 8
    planes = r.randn(2, 3, C * DEPTH, 9, 7).astype(np.float32)
    coords = r.uniform(-0.45, 0.45, (2, 300, 3)).astype(np.float32)   # beyond +-1 in the planes
    p = decoder_params(C)
    axes = jvr.generate_plane_axes(use_triplane)
    rgb_j, sig_j = jvr.run_model(axes, jnp.asarray(planes), jax_decode_fn(p, C, True),
                                 jnp.asarray(coords), BW, DEPTH)
    sig_j = jvr._apply_density_filters(sig_j, jnp.asarray(coords), BW, 0.1, 0.5, None)
    rgb_t, sig_t = tvr.triplane_decode_deep(
        tvr.deep_volumes_cl(t(planes), DEPTH), t(coords), torch_decoder(p, True), BW,
        tvr.generate_plane_axes(use_triplane), tvr.DensityFilters(0.1, 0.5))
    close(rgb_t, rgb_j, **TOL)
    close(sig_t, sig_j, **TOL)
    assert (sig_t.numpy() == -1e3).any() and (sig_t.numpy() > -1e3).any()
    assert sum(launch_counts().values()) == 0


def test_state_dict_from_flax_depth2_loads_strict():
    g = jcfg.tiny(**KW)
    x = {"z": jnp.zeros((1, 64)), "elevations": jnp.zeros(1), "azimuths": jnp.zeros(1),
         "cond": {"image_ortho_front": jnp.zeros((1, 3, 64, 64)),
                  "resnet_chonk": jnp.zeros((1, 16, 8, 8))}}
    variables = seeded_variables(g, x)
    G = tcfg.tiny(device="cpu", **KW)
    result = G.load_state_dict(state_dict_from_flax(variables), strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    torgb = variables["params"]["backbone"]["synthesis"]["b64"]["torgb"]["weight"]
    assert torgb.shape[0] == 8 * 3 * DEPTH
    np.testing.assert_array_equal(G.state_dict()["backbone.synthesis.b64.torgb.weight"], torgb)
    # the flagship at D = 2: 32 * 3 * 2 = 192 channels out of the 256^2 toRGB
    with torch.device("meta"):
        Gf = tcfg.flagship(eval_mode=True, device="meta",
                           rendering_kwargs=dict(triplane_depth=DEPTH))
    assert Gf.state_dict()["backbone.synthesis.b256.torgb.weight"].shape[0] == 192


# ---------------------------------------------------------------------------
# the tiny G.f at D = 2

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
    # a denser scene than seeded_variables' (test_torch_paste.py raises the
    # hidden layer's bias the same way): weights above paste's 0.95 on part
    # of a view, and surface behind surface along +z, so that the weight and
    # the render occlusion masks each stop part of the image
    variables["params"]["decoder"]["net2"]["bias"][0] += 4.0
    variables["params"]["decoder"]["net0"]["bias"] += 1.0
    G = tcfg.tiny(device="cpu", **KW).eval()
    G.load_state_dict(state_dict_from_flax(variables), strict=True)
    xt = {"z": t(a["z"]), "elevations": t(a["elevations"]), "azimuths": t(a["azimuths"]),
          "cond": {"image_ortho_front": t(a["image_ortho_front"]),
                   "resnet_chonk": t(a["resnet_chonk"])}}
    return g, variables, xj, G, xt


@pytest.fixture(scope="module")
def outputs(pair):
    g, variables, xj, G, xt = pair
    jax_f = jax.jit(lambda v, x: g.apply(v, dict(x, paste_params=PASTE_RENDER, **OPTS),
                                         method=JG.f, noise_mode="const"))
    out_j = jax.tree_util.tree_map(np.asarray, {k: v for k, v in jax_f(variables, xj).items()
                                                if k != "normalize_images"})
    with torch.no_grad():
        plain = G.f(dict(xt, **OPTS))
        pasted = G.f(dict(xt, paste_params=PASTE_RENDER, **OPTS))
    return out_j, plain, pasted


def test_f_deep_matches_jax_stage_by_stage(pair, outputs):
    g, variables, xj, G, xt = pair
    out_j, out_t, _ = outputs
    ones = torch.ones(BS)
    cam = camera_label(xt["elevations"], xt["azimuths"], ones, 30 * ones)
    with torch.no_grad():
        ws_t = G.mapping(xt["z"], cam)
    ws_j = g.apply(variables, xj["z"], jnp.asarray(cam.numpy()), method=JG.mapping)
    close(ws_t, ws_j, **STAGE_TOL)
    assert out_t["triplane"].shape == (BS, 3, 8 * DEPTH, 64, 64)
    close(out_t["triplane"], out_j["triplane"], **STAGE_TOL)

    # the coarse pass on the port's planes: decode, march weights, importance
    planes = out_t["triplane"]
    ro, rd = sample_rays(cam[:, :16].reshape(-1, 4, 4), cam[:, 16:25].reshape(-1, 3, 3),
                         G.neural_rendering_resolution)
    depths = tvr.sample_stratified(ro, RK["ray_start"], RK["ray_end"], RK["depth_resolution"])
    N, R, S, _ = depths.shape
    coords = (ro[:, :, None] + depths * rd[:, :, None]).reshape(N, R * S, 3)
    axes = tvr.generate_plane_axes(True)
    p = jax.tree_util.tree_map(np.asarray, variables["params"]["decoder"])
    with torch.no_grad():
        _, sig_t = tvr.triplane_decode_deep(tvr.deep_volumes_cl(planes, DEPTH), coords,
                                            G._decoder(), BW, axes, tvr.DensityFilters(0.1, 0.5))

    @jax.jit
    def coarse(planes, coords, depths):
        _, sig = jvr.run_model(axes, planes, jax_decode_fn(p, 8, True), coords, BW, DEPTH)
        sig = jvr._apply_density_filters(sig, coords, BW, 0.1, 0.5, None).reshape(N, R, S, 1)
        _, _, w = jvr.ray_march(jnp.zeros_like(depths), sig, depths, True)
        return sig, w, jvr.sample_importance(depths, w, RK["depth_resolution_importance"])

    sig_j, w_j, imp_j = coarse(jnp.asarray(planes.numpy()), jnp.asarray(coords.numpy()),
                               jnp.asarray(depths.numpy()))
    sig_t = sig_t.reshape(N, R, S, 1)
    close(sig_t, sig_j, **TOL)
    close(tvr._march_weights(sig_t, depths), w_j, **TOL)
    close(tvr.importance_sample(depths, sig_t, RK["depth_resolution_importance"]), imp_j,
          **IMP_TOL)
    assert (sig_t.numpy() == -1e3).any() and (sig_t.numpy() > -1e3).any()

    for k_t, k_j in (("image_raw", "image_raw"), ("image_depth", "image_depth"),
                     ("image_weights", "image_weights"), ("image_xyz", "image_xyz"),
                     ("image", "image_prepaste")):
        close(out_t[k_t], out_j[k_j], err_msg=k_t, **IMAGE_TOL)
    assert float(out_t["image_weights"].max()) > 0.1
    assert sum(launch_counts().values()) == 0


def test_f_deep_with_render_paste_matches_jax(outputs):
    out_j, _, out_t = outputs
    for k in ("image_raw", "image_depth", "image_weights", "image_xyz", "image_prepaste"):
        close(out_t[k], out_j[k], err_msg=k, **IMAGE_TOL)
    got = {k: v.numpy() for k, v in out_t["paste"].items() if torch.is_tensor(v)}
    want = {k: v for k, v in out_j["paste"].items() if v is not None}
    n_pix = got["mask"].size
    for k in ("mask_weights", "mask_edges", "mask_occ"):
        assert count_flips(got[k], want[k]) <= n_pix // 100, k
    for k in ("mask_weights", "mask_occ"):               # the +z re-render occludes part
        assert 0 < float(got[k].mean()) < 1, k
    agree = np.ones_like(got["mask"], bool)
    for k in MASKS:
        agree &= got[k] == want[k]
    agree3 = np.broadcast_to(agree, got["image"].shape)
    np.testing.assert_allclose(out_t["image"].numpy()[agree3], out_j["image"][agree3],
                               **IMAGE_TOL)
    assert sum(launch_counts().values()) == 0


def test_planes_bundle_and_views_match_jax(pair):
    g, variables, xj, G, xt = pair
    opts = dict(OPTS, paste_params=PASTE_RENDER)
    seed = 5
    cond_j = {k: v[:1] for k, v in xj["cond"].items()}
    cond_t = {k: v[:1] for k, v in xt["cond"].items()}
    bundle_j = _get_planes_jit(g, seed, opts)(variables, cond_j)
    bundle_t = planes_bundle(G, seed, cond_t, opts)
    assert set(bundle_t) == set(bundle_j) == {"ws", "planes"}   # no ESS, no grid volume
    close(bundle_t["planes"], bundle_j["planes"], **STAGE_TOL)
    el, az, fovs = [0.0, 10.0], [0.0, 200.0], [-1.0, 30.0]       # an ortho and a pinhole view
    want = _get_render_jit(g, opts, seed, 2, from_planes=True)(
        variables, *(jnp.asarray(v, jnp.float32) for v in (el, az, fovs)), cond_j, bundle_j)
    got = render_from_planes(G, opts, bundle_t, el, az, fovs, cond_t)
    for k in ("image_xyz", "image_weights"):
        close(got[k], want[k], err_msg=k, **IMAGE_TOL)
    # the pasted image: a pixel whose paste mask flips differs by the
    # paste itself, so at most 1 % of them may lie outside the bound
    diff = np.abs(got["image"].numpy() - np.asarray(want["image"]))
    outside = diff > IMAGE_TOL["atol"] + IMAGE_TOL["rtol"] * np.abs(np.asarray(want["image"]))
    assert outside.mean() <= 0.01, outside.mean()
    assert sum(launch_counts().values()) == 0


def test_extract_mesh_deep_with_filters_matches_jax(pair):
    g, variables, xj, G, xt = pair
    v2 = jax.tree_util.tree_map(np.array, variables)
    v2["params"]["decoder"]["net2"]["bias"][0] += SIGMA_BIAS
    G2 = tcfg.tiny(device="cpu", **KW).eval()
    G2.load_state_dict(state_dict_from_flax(v2), strict=True)
    res, chunk = 16, 1000
    xj1 = {"z": xj["z"][:1], "elevations": jnp.zeros(1), "azimuths": jnp.zeros(1),
           "cond": {k: v[:1] for k, v in xj["cond"].items()}, **OPTS}
    xt1 = {"z": xt["z"][:1].numpy(), "cond": {k: v[:1] for k, v in xt["cond"].items()},
           **OPTS}
    dj = jv.get_volume(g, v2, xj1, resolution=res, chunk=chunk).densities[0, 0]
    _, planes = tv.portrait_planes(G2, xt1)
    dt = tv.density_grid(planes, G2._decoder(), res, BW, tvr.generate_plane_axes(True),
                         tvr.DensityFilters(**OPTS), torch.float32, chunk, DEPTH).numpy()
    kept_j, kept_t = dj > -1e3, dt > -1e3
    assert int((kept_j != kept_t).sum()) == 0
    assert 0 < kept_t.sum() < dt.size // 2
    np.testing.assert_allclose(dt, dj, rtol=0, atol=1e-5)
    mj = jv.extract_mesh(g, v2, xj1, resolution=res, chunk=chunk, density_dtype=jnp.float32)
    mt = tv.extract_mesh(G2, xt1, resolution=res, chunk=chunk, density_dtype=torch.float32)
    assert len(mt["faces"]) > 0
    np.testing.assert_array_equal(mt["faces"], mj.faces)
    np.testing.assert_allclose(mt["verts"], mj.verts, rtol=0, atol=1e-5)
    np.testing.assert_allclose(mt["colors"], mj.colors, rtol=0, atol=1e-4)
    assert sum(launch_counts().values()) == 0


def test_from_snapshot_config_forms_match_jax():
    from panic3d_tpu.training.trainer import build_models, parse_args

    def same(gt, gj):
        for k in ("triplane_depth", "triplane_width", "img_resolution", "backbone_resolution",
                  "cond_mode", "force_sigmoid"):
            assert getattr(gt, k) == getattr(gj, k), k
        assert gt.rk == gj.rk

    def meta(config, **kw):
        with torch.device("meta"):
            return tcfg.from_snapshot_config(config, device="meta", **kw)

    # the model_kwargs form, as the trainer writes it for a depth-2 flagship
    args = parse_args(["--name", "t", "--triplane-depth", "2", "--triplane-width", "16",
                       "--resolution", "256", "--backbone-resolution", "128"])
    mk = build_models(args)[4]
    same(meta({"model_kwargs": mk}), jcfg.from_snapshot_config({"model_kwargs": mk}))
    # the tiny family (with a cond mode the port has)
    mk = dict(family="tiny", cond_mode="ortho_front.add_shuffle2_4.reschonk_add_16")
    gt = meta({"model_kwargs": mk}, eval_mode=True)
    same(gt, jcfg.from_snapshot_config({"model_kwargs": mk}, eval_mode=True))
    assert gt.force_sigmoid
    # the flat legacy form
    legacy = {"cond_mode": "ortho_front.add_shuffle2_4.reschonk_add_512", "triplane_depth": 2,
              "resolution": 256}
    gt = meta(legacy, eval_mode=True)
    same(gt, jcfg.from_snapshot_config(legacy, eval_mode=True))
    assert gt.triplane_depth == 2 and gt.rk["depth_resolution"] == 96
    # a legacy tiny snapshot names the add_4 cond mode, which the port builds
    gj = jcfg.from_snapshot_config({"tiny": True})
    assert gj.cond_mode == "ortho_front.add_4.reschonk_add_16"
    same(meta({"tiny": True}), gj)


def test_f12_ess_and_grid_occlusion_refused_at_depth_2(pair):
    g, variables, xj, G, xt = pair
    # the JAX package: ESS sizes its zero features from the planes' C*D
    # channels, and so does the grid occlusion's lattice decode (jitted:
    # both fail while tracing)
    g_ess = jcfg.tiny(**dict(KW, rendering_kwargs=dict(RK, ess=ESS)))
    with pytest.raises(flax.errors.ScopeParamShapeError):
        jax.jit(lambda v, x: g_ess.apply(v, dict(x, **OPTS), method=JG.f,
                                         noise_mode="const"))(variables, xj)
    with pytest.raises(flax.errors.ScopeParamShapeError):
        jax.jit(lambda v, x: g.apply(
            v, dict(x, paste_params=INFERENCE_OPTS["paste_params"], **OPTS), method=JG.f,
            noise_mode="const"))(variables, xj)
    # the port refuses both, naming F12
    G_ess = tcfg.tiny(device="cpu", **dict(KW, rendering_kwargs=dict(RK, ess=ESS))).eval()
    G_ess.load_state_dict(G.state_dict())
    with torch.no_grad():
        with pytest.raises(NotImplementedError, match="F12"):
            G_ess.f(dict(xt, **OPTS))
        with pytest.raises(NotImplementedError, match="F12"):
            G.f(dict(xt, paste_params=INFERENCE_OPTS["paste_params"], **OPTS))
        with pytest.raises(NotImplementedError, match="F12"):
            G.front_occlusion_volume(torch.zeros(1, 3, 8 * DEPTH, 8, 8))
        with pytest.raises(NotImplementedError, match="F12"):
            tvr.zero_feature_density(torch.zeros(1, 3, 8 * DEPTH, 4, 4),
                                     torch_decoder(decoder_params(8), True), None, None)
    assert sum(launch_counts().values()) == 0
