"""Paste-front in the port vs the JAX package (CPU, f32).

The pieces K7 and K8 replace -- image ops, border and 3-D grid sampling,
the bilinear upsample, the occlusion volume and its sampler, the paste
masks and blend -- each against the JAX function on the same numpy
inputs, then the tiny generator's G.f with ESS and paste on, end to end,
against the JAX G.f with the same weights (test_torch_generator's
numpy-seeded tree through state_dict_from_flax).

Tolerances: f32 on both sides; 1e-5 where only the summation order
differs. The paste masks are thresholds, so they are compared by counting
the pixels where they differ, and the image where every mask agrees.
thresh_dxyz = 5e-6 (the shipped setting) sits near the f32 rounding of the
composited xyz, so the discrepancy mask is expected to differ on a few
pixels there, and the count is bounded, not zero.

The JAX references run jitted, compiled once per case (eager JAX compiles
every primitive on first use: several times the time here), but for the
front-weight erosion's: there the jitted front render sits farther from
the port's at the weights' threshold.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panic3d_tpu import configs as jcfg
from panic3d_tpu.models.stylegan2 import resize_bilinear as j_resize_bilinear
from panic3d_tpu.models.triplane import TriPlaneGenerator as JG
from panic3d_tpu.models.volumetric import lattice as jlat
from panic3d_tpu.ops import grid_sample as jgs
from panic3d_tpu.utils import imageops as jio
from panic3d_tpu_torch import configs as tcfg
from panic3d_tpu_torch.eval.generate import INFERENCE_OPTS
from panic3d_tpu_torch.kernels import launch_counts
from panic3d_tpu_torch.models.stylegan2 import resize_bilinear
from panic3d_tpu_torch.models.triplane import paste_composite, upsample_bilinear
from panic3d_tpu_torch.models.volumetric import lattice as tlat
from panic3d_tpu_torch.ops import grid_sample as tgs
from panic3d_tpu_torch.runtime.checkpoint import state_dict_from_flax
from panic3d_tpu_torch.utils import imageops as tio

from test_torch_generator import F32, seeded_variables
from test_torch_render import BW, close, decoder_params, jax_decode_fn, t, torch_decoder
from torch_one_thread import torch_one_thread  # noqa: F401  (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)
IMAGE_TOL = dict(rtol=2e-3, atol=2e-3)     # G.f images: importance resampling (ROADMAP F2)
ESS = dict(grid=8, taps=16, thresh=0.01, margin=1.0)
OCC_GRID = (16, 16, 32)
PASTE = INFERENCE_OPTS["paste_params"]
MASKS = ("mask_weights", "mask_edges", "mask_occ", "mask_dxyz")
BS = 2
RNG = np.random.RandomState(21)


def test_imageops_match_jax():
    x = RNG.randn(2, 3, 12, 10).astype(np.float32)
    close(tio.sobel_magnitude(t(x)), jio.sobel_magnitude(jnp.asarray(x)), **TOL)
    for k in (1, 2, 3, 4):
        close(tio.erosion(t(x), k), jio.erosion(jnp.asarray(x), k), rtol=0, atol=0)
        close(tio.dilation(t(x), k), jio.dilation(jnp.asarray(x), k), rtol=0, atol=0)
    for size in (24, 30, 64):
        close(tio.resize_nearest(t(x[..., :10, :10]), size),
              jio.resize_nearest(jnp.asarray(x[..., :10, :10]), size), rtol=0, atol=0)


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_grid_sample_2d_and_3d_match_jax(padding_mode):
    img = RNG.randn(2, 3, 7, 9).astype(np.float32)
    pts2 = RNG.uniform(-1.4, 1.4, (2, 50, 2)).astype(np.float32)
    close(tgs.grid_sample_2d_points(t(img), t(pts2), padding_mode),
          jgs.grid_sample_2d_points(jnp.asarray(img), jnp.asarray(pts2), padding_mode), **TOL)
    vol = RNG.randn(2, 2, 5, 6, 7).astype(np.float32)
    pts3 = RNG.uniform(-1.4, 1.4, (2, 50, 3)).astype(np.float32)
    close(tgs.grid_sample_3d_points(t(vol), t(pts3), padding_mode),
          jgs.grid_sample_3d_points(jnp.asarray(vol), jnp.asarray(pts3), padding_mode), **TOL)


def test_border_sample_matches_jax_packed_border():
    """The JAX package's paste projection runs the corner-packed border
    form; it is bit-equal to the unpacked border path the port keeps."""
    img = RNG.rand(2, 3, 16, 16).astype(np.float32)
    pts = RNG.uniform(-1.3, 1.3, (2, 80, 2)).astype(np.float32)
    want = jgs.grid_sample_2d_points_packed_border(jgs.pack_bilinear_2d(jnp.asarray(img)),
                                                   jnp.asarray(pts))
    close(tgs.grid_sample_2d_points(t(img), t(pts), "border"), want, **TOL)


@pytest.mark.parametrize("size_in,size_out", [(64, 512), (16, 128), (64, 64)])
def test_resize_bilinear_upsample_matches_jax_image_resize(size_in, size_out):
    """F.interpolate(bilinear, align_corners=False) vs jax.image.resize
    'bilinear' when upsampling (paste-front's 64 -> 512 masks): both
    sample at (i + 0.5) * in/out - 0.5 and hold the edge texel."""
    x = RNG.randn(2, 3, size_in, size_in).astype(np.float32)
    close(resize_bilinear(t(x), size_out), j_resize_bilinear(jnp.asarray(x), size_out), **TOL)


@pytest.mark.parametrize("size_in,size_out", [(64, 512), (16, 128), (5, 17), (64, 64)])
def test_paste_upsample_matches_interpolate_and_jax(size_in, size_out):
    """K8's plain upsample (one torch op per multiply and add) is
    F.interpolate's formula: equal to it up to f32 rounding of the blend
    (a few ulp of the largest value), and to jax.image.resize."""
    x = np.random.RandomState(size_in + size_out).randn(2, 3, size_in, size_in)
    x = t(x.astype(np.float32))
    got = upsample_bilinear(x, size_out)
    assert got.shape == (2, 3, size_out, size_out)
    close(got, resize_bilinear(x, size_out), rtol=0, atol=4 * 2.0 ** -24 * float(x.abs().max()))
    close(got, j_resize_bilinear(jnp.asarray(x.numpy()), size_out), **TOL)


def occlusion_inputs(C=8, seed=4):
    r = np.random.RandomState(seed)
    planes = (2 * r.randn(2, 3, C, 16, 16)).astype(np.float32)
    p = decoder_params(C, seed)
    p["net2"]["bias"][0] = 1.5
    pts = r.uniform(-0.4, 0.4, (2, 100, 3)).astype(np.float32)   # some outside the box
    return planes, p, pts


@pytest.mark.parametrize("filters", [(0.1, 0.5, None), (None, None, None), (None, None, 0.5)])
def test_front_occlusion_volume_and_sampler_match_jax(filters):
    C = 8
    planes, p, pts = occlusion_inputs(C)
    crop, cull, binarize = filters
    sigma_fn = lambda f: jax_decode_fn(p, C, True)(f, sigma_only=True)   # noqa: E731
    vol_j = jax.jit(lambda pl: jlat.front_occlusion_volume(
        pl, sigma_fn, BW, dict(use_triplane=True), crop, cull, binarize, grid=OCC_GRID,
        plane_reduce="mean"))(jnp.asarray(planes))
    vol_t = tlat.front_occlusion_volume(t(planes), torch_decoder(p, True), BW,
                                        dict(use_triplane=True), crop, cull, binarize,
                                        grid=OCC_GRID)
    A_j = np.asarray(vol_j["A"])
    # a 32-long f32 suffix sum: summation order differs, relative to the max
    close(vol_t["A"], A_j, rtol=1e-5, atol=1e-5 * float(np.abs(A_j).max()))
    assert float(vol_t["density0"]) == pytest.approx(float(vol_j["density0"]), rel=1e-6)
    # the sampler fed the SAME volume
    vol_same = dict(vol_t, A=t(A_j), density0=torch.tensor(float(vol_j["density0"])))
    got = tlat.sample_front_occlusion(vol_same, t(pts), 0.01, 1.0)
    want = jlat.sample_front_occlusion(vol_j, jnp.asarray(pts), 0.01, 1.0)
    close(got, want, **TOL)
    if not binarize:           # binarized clouds occlude everything they touch
        assert 0 < float(got.mean()) < 1


def count_flips(got, want):
    return int((np.asarray(got) != np.asarray(want)).sum())


# ---------------------------------------------------------------------------
# the tiny generator with ESS and paste on

RK = dict(F32["rendering_kwargs"], ess=ESS, occ_grid=OCC_GRID)


@pytest.fixture(scope="module")
def pair():
    return make_pair()


def make_pair():
    r = np.random.RandomState(3)
    a = {"z": r.randn(BS, 64).astype(np.float32),
         "image_ortho_front": r.rand(BS, 3, 64, 64).astype(np.float32),
         "resnet_chonk": r.randn(BS, 16, 8, 8).astype(np.float32),
         "elevations": np.asarray([0.0, 20.0], np.float32),
         "azimuths": np.asarray([0.0, 330.0], np.float32)}
    kw = dict(F32, rendering_kwargs=RK, force_sigmoid=True)
    g = jcfg.tiny(**kw)
    xj = {"z": jnp.asarray(a["z"]), "elevations": jnp.asarray(a["elevations"]),
          "azimuths": jnp.asarray(a["azimuths"]),
          "cond": {"image_ortho_front": jnp.asarray(a["image_ortho_front"]),
                   "resnet_chonk": jnp.asarray(a["resnet_chonk"])}}
    variables = seeded_variables(g, xj)
    # a zero-feature sigma below the cull threshold (so the space outside
    # the box is empty and front-facing surfaces can be unoccluded) and a
    # denser inside: paste then has something to paste
    variables["params"]["decoder"]["net2"]["bias"][0] -= 2.5
    variables["params"]["decoder"]["net0"]["bias"] += 1.0
    G = tcfg.tiny(device="cpu", **kw).eval()
    G.load_state_dict(state_dict_from_flax(variables), strict=True)
    xt = {"z": t(a["z"]), "elevations": t(a["elevations"]), "azimuths": t(a["azimuths"]),
          "cond": {"image_ortho_front": t(a["image_ortho_front"]),
                   "resnet_chonk": t(a["resnet_chonk"])}}
    return g, variables, xj, G, xt


def filtered(x):
    return dict(x, triplane_crop=0.1, cull_clouds=0.5)


@pytest.fixture(scope="module")
def rendered(pair):
    """The port's paste-off G.f outputs, and the x dict paste_front sees."""
    g, variables, xj, G, xt = pair
    with torch.no_grad():
        out = G.f(filtered(xt))
    return out


_JAX_PASTE = {}


def _jax_paste_fn(g, occ_impl, params):
    """JAX paste_front jitted once per (module, occ_impl, params: sorted
    items), its static arguments (the filters, the paste parameters)
    closed over."""
    key = (id(g), occ_impl, params)
    if key not in _JAX_PASTE:
        def fn(variables, arrays, outj):
            x = dict(filtered(arrays), normalize_images=False)
            return g.apply(variables, x, outj, method=JG.paste_front, occ_impl=occ_impl,
                           **dict(params))
        _JAX_PASTE[key] = jax.jit(fn)
    return _JAX_PASTE[key]


def jax_paste(pair, out, occ_impl, params, jit=True):
    """JAX paste_front on the port's out dict (as numpy), jitted or (jit
    False) eager."""
    g, variables, xj, G, xt = pair
    ro, rd = _force_rays(G, xt)
    with torch.no_grad():
        ws = G.mapping(xt["z"], _cam(G, xt))
    x = dict(xj, triplane=jnp.asarray(out["triplane"].numpy()),
             force_rays={"ray_origins": jnp.asarray(ro.numpy()),
                         "ray_directions": jnp.asarray(rd.numpy())},
             _ess_occ=tuple(jnp.asarray(np.asarray(o)) for o in out["_ess_occ"]),
             ws=jnp.asarray(ws.numpy()), camera_params=jnp.asarray(_cam(G, xt).numpy()))
    outj = {k: jnp.asarray(out[k].numpy()) for k in ("image", "image_xyz", "image_weights")}
    if jit:
        res = _jax_paste_fn(g, occ_impl, tuple(sorted(params.items())))(variables, x, outj)
    else:
        res = g.apply(variables, dict(filtered(x), normalize_images=False), outj,
                      method=JG.paste_front, occ_impl=occ_impl, **params)
    return jax.tree_util.tree_map(np.asarray, {k: v for k, v in res.items() if v is not None})


def _cam(G, xt):
    from panic3d_tpu_torch.cameras import camera_label
    return camera_label(xt["elevations"], xt["azimuths"], torch.ones(BS), 30 * torch.ones(BS))


def _force_rays(G, xt):
    from panic3d_tpu_torch.cameras import sample_rays
    cam = _cam(G, xt)
    res = G.neural_rendering_resolution
    ro, rd = sample_rays(cam[:, :16].reshape(-1, 4, 4), cam[:, 16:25].reshape(-1, 3, 3), res)
    return (ro.transpose(1, 2).reshape(BS, 3, res, res),
            rd.transpose(1, 2).reshape(BS, 3, res, res))


def port_paste(pair, out, occ_impl, params):
    g, variables, xj, G, xt = pair
    ro, rd = _force_rays(G, xt)
    with torch.no_grad():
        ws = G.mapping(xt["z"], _cam(G, xt))
        x = dict(filtered(xt), triplane=out["triplane"], normalize_images=False, ws=ws,
                 camera_params=_cam(G, xt), _ess_occ=out["_ess_occ"],
                 force_rays={"ray_origins": ro, "ray_directions": rd})
        res = G.paste_front(x, out, occ_impl=occ_impl, **params)
    return {k: v.numpy() for k, v in res.items() if torch.is_tensor(v)}


def compare_paste(got, want, n_pix, max_dxyz_flips):
    for k in ("mask_weights", "mask_edges", "mask_occ"):
        assert count_flips(got[k], want[k]) <= n_pix // 500, k
    flips = count_flips(got["mask_dxyz"], want["mask_dxyz"])
    assert flips <= max_dxyz_flips, f"mask_dxyz: {flips} pixels differ"
    agree = np.ones_like(got["mask"], bool)
    for k in MASKS + ("mask_frontweight",):
        agree &= got[k] == want[k]
    agree3 = np.broadcast_to(agree, got["image"].shape)
    np.testing.assert_allclose(got["paste"], want["paste"], **TOL)
    np.testing.assert_allclose(got["mask"][agree], want["mask"][agree], **TOL)
    np.testing.assert_allclose(got["image"][agree3], want["image"][agree3], **TOL)


def opaque_variant(G, xt, out):
    """The render with its denser half made opaque and its composited
    points put on their rays (at the composite depth), so that every mask
    passes part of the scene: weights > 0.95 and an xyz discrepancy near
    f32 rounding there."""
    ro, rd = _force_rays(G, xt)
    flip = torch.tensor([-1.0, 1.0, -1.0])[None, :, None, None]
    w = (out["image_weights"] * 2).clamp_max(1.0)
    keep = w > 0.95
    xyz = torch.where(keep, (ro + out["image_depth"] * rd) * flip, out["image_xyz"])
    return dict(out, image_weights=w, image_xyz=xyz)


@pytest.mark.parametrize("occ_impl", ["grid", "render"])
@pytest.mark.parametrize("scene", ["render", "opaque"])
def test_paste_front_matches_jax_on_the_same_render(pair, rendered, occ_impl, scene):
    out = rendered if scene == "render" else opaque_variant(pair[3], pair[4], rendered)
    got = port_paste(pair, out, occ_impl, PASTE)
    want = jax_paste(pair, out, occ_impl, PASTE)
    n_pix = got["mask"].size
    compare_paste(got, want, n_pix, max_dxyz_flips=n_pix // 20)
    if scene == "opaque":      # every mask passes part of the scene and stops part
        for k in MASKS:
            assert 0 < float(got[k].mean()) < 1, k
        assert float(got["mask"].max()) > 0
    assert sum(launch_counts().values()) == 0


def test_paste_front_with_front_weight_erosion_matches_jax(pair, rendered):
    """front_weight_erosion >= 1 (off in every shipped setting): the front
    ortho view's weights, eroded and projected, multiply the mask."""
    out = opaque_variant(pair[3], pair[4], rendered)
    params = dict(PASTE, front_weight_erosion=2)
    got = port_paste(pair, out, "grid", params)
    # eager: the front view's render, jitted, sits farther from the port's
    # at its weights' > 0.5 threshold
    want = jax_paste(pair, out, "grid", params, jit=False)
    n_pix = got["mask"].size
    # the front view's weights are a render (ROADMAP F2 tolerance); their
    # > 0.5 threshold then flips where a weight sits within it of 0.5, and
    # the erosion and projection spread each flip over a few pixels
    close(got["frontweight"], want["frontweight"], **IMAGE_TOL)
    assert count_flips(got["mask_frontweight"], want["mask_frontweight"]) <= n_pix // 50
    assert 0 < float(got["mask_frontweight"].mean()) < 1
    compare_paste(got, want, n_pix, max_dxyz_flips=n_pix // 20)


def test_paste_composite_plain_is_the_paste_front_blend(rendered):
    """K8's plain version on hand-made 64^2-style inputs: every mask at its
    formula, the blend where the mask is 1 and 0."""
    r = np.random.RandomState(9)
    N, S, rr = 1, 32, 8
    image = t(r.rand(N, 3, S, S).astype(np.float32))
    front = t(r.rand(N, 3, S, S).astype(np.float32))
    weights = torch.ones(N, 1, rr, rr)
    xyz = t(r.uniform(-0.3, 0.3, (N, 3, rr, rr)).astype(np.float32)) * 0.01
    occ_bin = torch.ones(N, 1, rr, rr)
    dxyz = torch.zeros(N, 1, rr, rr)
    out = paste_composite(image, front, weights, xyz, occ_bin, dxyz, BW, 0.95, 0.02, 5e-6)
    assert float(out["mask"].min()) == 1.0
    close(out["image"], out["paste"], rtol=0, atol=1e-6)    # image + (paste - image) * 1
    out0 = paste_composite(image, front, 0 * weights, xyz, occ_bin, dxyz, BW, 0.95, 0.02, 5e-6)
    close(out0["image"], image, rtol=0, atol=0)


def test_f_with_ess_and_paste_matches_jax_end_to_end(pair):
    g, variables, xj, G, xt = pair
    out_j = jax.jit(lambda v, x: g.apply(v, dict(filtered(x), paste_params=PASTE), method=JG.f,
                                         noise_mode="const"))(variables, xj)
    out_j = jax.tree_util.tree_map(np.asarray, {k: v for k, v in out_j.items()
                                                if k not in ("normalize_images",)})
    with torch.no_grad():
        out_t = G.f(dict(filtered(xt), paste_params=PASTE))
    occ_j, occ_t = out_j["_ess_occ"][0], out_t["_ess_occ"][0].numpy()
    assert count_flips(occ_t, occ_j) == 0
    for k in ("image_raw", "image_depth", "image_weights", "image_xyz", "image_prepaste"):
        close(out_t[k], out_j[k], err_msg=k, **IMAGE_TOL)
    got = {k: v.numpy() for k, v in out_t["paste"].items() if torch.is_tensor(v)}
    want = {k: v for k, v in out_j["paste"].items() if v is not None}
    n_pix = got["mask"].size
    for k in ("mask_weights", "mask_edges", "mask_occ"):
        assert count_flips(got[k], want[k]) <= n_pix // 100, k
    agree = np.ones_like(got["mask"], bool)
    for k in MASKS:
        agree &= got[k] == want[k]
    agree3 = np.broadcast_to(agree, got["image"].shape)
    np.testing.assert_allclose(out_t["image"].numpy()[agree3], out_j["image"][agree3],
                               **IMAGE_TOL)
    assert float(out_t["image_weights"].max()) > 0.1
