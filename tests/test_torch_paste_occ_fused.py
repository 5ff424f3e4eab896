"""K8's grid-occlusion entry (csrc/paste_front.cu:paste_front_occ), its plain
contract on the CPU.

On the card, paste_front with occ_impl='grid' launches K8 once with the
occlusion volume, the force_rays and the thresholds in place of the r^2
binary occlusion and discrepancy maps: each block reads K7b's occlusion
(front_occlusion.cuh) and the discrepancy at the source pixels its tile
upsamples. ``triplane.py:paste_composite_occ_plain`` is that entry's plain
version. Here, on the tiny config with test_torch_paste's seeded weights and
render, it is held bit for bit against the composition paste_front ran
before the fusion (the plane-space points read by K7b's sampler,
occ < thresh_occ, _get_xyz_discrepancy, paste_composite_plain) and against
paste_front on the CPU, and within test_torch_paste's tolerances against
the JAX package's paste_front(occ_impl='grid'): on the render, on its opaque
variant, and on a variant whose surface points partly leave the box (K7b's
out-of-box branch) and partly lie deep in it, pasted with a thresh_occ that
cuts the binary occlusion map in two.
"""

import numpy as np
import pytest
import torch

from panic3d_tpu_torch.kernels import launch_counts
from panic3d_tpu_torch.models import triplane as tp
from panic3d_tpu_torch.models.stylegan2 import resize_bilinear
from panic3d_tpu_torch.models.volumetric import lattice as vlat

from test_torch_paste import (PASTE, RK, _force_rays, compare_paste, filtered, jax_paste,
                              opaque_variant, pair, port_paste, rendered)   # noqa: F401

KEYS = ("image", "paste", "mask", "mask_weights", "mask_edges", "mask_occ", "mask_dxyz",
        "mask_frontweight")


@pytest.fixture(autouse=True)
def one_thread():
    """The small ops of these loops on one torch thread (beside the other
    test workers, torch's default threads make them crawl)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def volume(pair, rendered):
    G = pair[3]
    with torch.no_grad():
        return G.front_occlusion_volume(rendered["triplane"], 0.1, 0.5)


def leaving_variant(out):
    """The render with the surface points of its left half pushed out of the
    box along x and y (|x|, |y| > box_warp / 2: K7b's out-of-box terms), and
    those of its right half moved to plane-space z = -0.3, under most of the
    volume's density (so that their occlusions spread)."""
    xyz = out["image_xyz"].clone()
    half = xyz.shape[-1] // 2
    xyz[:, :2, :, :half] = xyz[:, :2, :, :half] * 3 + 0.4 * torch.sign(xyz[:, :2, :, :half])
    xyz[:, 2, :, half:] = 0.3
    return dict(out, image_xyz=xyz)


def splitting_thresh(occ):
    """A thresh_occ that cuts the binary occlusion map in two: the median of
    the occlusions above 0 (most of the map reads 0)."""
    return float(occ[occ > 0].median())


def composition(G, out, vol, rays, params):
    """paste_front's grid path as it ran before K8 took the occlusion in
    (triplane.py: _get_front_occlusion_grid, then the threshold, the
    discrepancy and paste_composite), in plain torch."""
    p = out["image_xyz"] * torch.tensor([-1.0, 1.0, -1.0])[None, :, None, None]
    N, _, H, W = p.shape
    seg = float(RK["ray_end"]) - float(RK["ray_start"])
    occ = vlat.sample_front_occlusion(vol, p.reshape(N, 3, -1).transpose(1, 2),
                                      params["offset_occ"], seg)
    occ = occ.transpose(1, 2).reshape(N, 1, H, W)
    occ_bin = (occ < params["thresh_occ"]).to(torch.float32)
    dxyz = G._get_xyz_discrepancy(out["image_xyz"], rays)
    return tp.paste_composite_plain(out["image"], out["front"], out["image_weights"],
                                    out["image_xyz"], occ_bin, dxyz, RK["box_warp"],
                                    params["thresh_weight"], params["thresh_edges"],
                                    params["thresh_dxyz"]), occ


def fused_plain(out, vol, rays, params):
    seg = float(RK["ray_end"]) - float(RK["ray_start"])
    return tp.paste_composite_occ_plain(
        out["image"], out["front"], out["image_weights"], out["image_xyz"], vol, rays,
        RK["box_warp"], params["offset_occ"], seg, params["thresh_occ"],
        params["thresh_weight"], params["thresh_edges"], params["thresh_dxyz"])


def scene_of(pair, rendered, scene):
    G, xt = pair[3], pair[4]
    out = {"render": rendered, "opaque": opaque_variant(G, xt, rendered),
           "leaving": leaving_variant(rendered)}[scene]
    ro, rd = _force_rays(G, xt)
    # the front image at the image's size, as paste_front resizes it
    front = resize_bilinear(xt["cond"]["image_ortho_front"], out["image"].shape[-1])
    return dict(out, front=front), {"ray_origins": ro, "ray_directions": rd}


@pytest.mark.parametrize("scene", ["render", "opaque", "leaving"])
def test_fused_plain_equals_the_composition(pair, rendered, volume, scene):
    out, rays = scene_of(pair, rendered, scene)
    want, occ = composition(pair[3], out, volume, rays, PASTE)
    got = fused_plain(out, volume, rays, PASTE)
    for k in KEYS:
        assert torch.equal(got[k], want[k]), f"{k}: {int((got[k] != want[k]).sum())} differ"
    # and paste_front on the CPU takes the same composition
    via_f = port_paste(pair, out, "grid", PASTE)
    for k in KEYS:
        assert np.array_equal(via_f[k], got[k].numpy()), k
    if scene == "leaving":
        xyz = out["image_xyz"]
        outside = (xyz[:, :2].abs() > RK["box_warp"] / 2).any(1)
        assert 0 < float(outside.float().mean()) < 1
        params = dict(PASTE, thresh_occ=splitting_thresh(occ))
        want, occ2 = composition(pair[3], out, volume, rays, params)
        got = fused_plain(out, volume, rays, params)
        for k in KEYS:
            assert torch.equal(got[k], want[k]), k
        frac = float((occ2 < params["thresh_occ"]).float().mean())
        assert 0.01 < frac < 0.99, frac   # a few percent of the pixels on either side
    assert sum(launch_counts().values()) == 0


@pytest.mark.parametrize("scene", ["render", "leaving"])
def test_fused_plain_matches_jax_paste_front(pair, rendered, volume, scene):
    out, rays = scene_of(pair, rendered, scene)
    params = PASTE
    if scene == "leaving":
        occ = composition(pair[3], out, volume, rays, PASTE)[1]
        params = dict(PASTE, thresh_occ=splitting_thresh(occ))
    got = {k: v.numpy() for k, v in fused_plain(out, volume, rays, params).items()}
    want = jax_paste(pair, out, "grid", params)
    n_pix = got["mask"].size
    compare_paste(got, want, n_pix, max_dxyz_flips=n_pix // 20)
    if scene == "leaving":
        assert 0 < float(got["mask_occ"].mean()) < 1
