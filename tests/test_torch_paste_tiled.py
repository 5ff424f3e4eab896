"""K8's order of operations (csrc/paste_front.cu), proved on the CPU.

The kernel gives each block a tile of 8 x 64 output pixels (4 of a row a
thread): it stages the upsampled xyz of the tile plus a one-pixel halo
(reflect padding at the image border), takes each pixel's sobel from the
staged values and projects the front image through the staged centre,
with a multiply by 0.5 in place of each division by 2.
``triplane.py:paste_composite_tiled`` does the same in PyTorch. Here it is
held bit for bit against ``paste_composite_plain`` on the tiny config's
render at a neural rendering resolution of 64 (the flagship's), pasted at
S = 64, 72 (partial tiles), 128 and 512, on the render and on its opaque
variant; and against the JAX package's ``paste_front`` through
``test_torch_paste``'s fixtures (the tiny render, both occlusion forms), at
that file's tolerances.
"""

import numpy as np
import pytest
import torch

from panic3d_tpu_torch import configs as tcfg
from panic3d_tpu_torch.models import triplane as tp
from panic3d_tpu_torch.models.stylegan2 import resize_bilinear

from test_torch_generator import F32
from test_torch_paste import (PASTE, RK, _force_rays, compare_paste, filtered, jax_paste,
                              opaque_variant, pair, port_paste, rendered)   # noqa: F401
from torch_one_thread import torch_one_thread  # noqa: F401  (autouse)

R64 = 64          # the flagship's neural rendering resolution
KEYS = ("image", "paste", "mask", "mask_weights", "mask_edges", "mask_occ", "mask_dxyz",
        "mask_frontweight")


@pytest.fixture(scope="module")
def render64(pair):
    """The tiny generator (the fixture's weights) rendered at 64^2 rays,
    its opaque variant, and the 64^2 inputs K8 takes from each."""
    _, _, _, G, xt = pair
    G64 = tcfg.tiny(device="cpu", **dict(F32, rendering_kwargs=RK, force_sigmoid=True),
                    neural_rendering_resolution=R64).eval()
    G64.load_state_dict(G.state_dict(), strict=True)
    with torch.no_grad():
        out = G64.f(filtered(xt))
    scenes = {}
    ro, rd = _force_rays(G64, xt)
    for scene, o in (("render", out), ("opaque", opaque_variant(G64, xt, out))):
        dxyz = G64._get_xyz_discrepancy(o["image_xyz"], {"ray_origins": ro,
                                                          "ray_directions": rd})
        occ_bin = (torch.from_numpy(np.random.RandomState(5).rand(2, 1, R64, R64)) < 0.7)
        scenes[scene] = (o["image"], xt["cond"]["image_ortho_front"], o["image_weights"],
                         o["image_xyz"], occ_bin.float(), dxyz)
    return scenes


@pytest.mark.parametrize("scene", ["render", "opaque"])
@pytest.mark.parametrize("S", [64, 72, 128, 512])
def test_tiled_order_equals_plain(render64, S, scene):
    image, front, weights, xyz, occ_bin, dxyz = render64[scene]
    args = (resize_bilinear(image, S), resize_bilinear(front, S), weights, xyz, occ_bin, dxyz,
            RK["box_warp"], PASTE["thresh_weight"], PASTE["thresh_edges"], PASTE["thresh_dxyz"])
    got, want = tp.paste_composite_tiled(*args), tp.paste_composite_plain(*args)
    for k in KEYS:
        assert got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), f"{k}: {int((got[k] != want[k]).sum())} differ"
    # the sobel mask stops part of the scene and passes part
    assert 0 < float(got["mask_edges"].mean()) < 1
    if scene == "opaque":
        assert float(got["mask"].max()) > 0


@pytest.mark.parametrize("occ_impl", ["grid", "render"])
@pytest.mark.parametrize("scene", ["render", "opaque"])
def test_tiled_order_matches_jax_paste_front(pair, rendered, occ_impl, scene, monkeypatch):
    out = rendered if scene == "render" else opaque_variant(pair[3], pair[4], rendered)
    calls = []

    def tiled(*args):
        calls.append(args[0].shape)
        return tp.paste_composite_tiled(*args)

    monkeypatch.setattr(tp, "paste_composite", tiled)
    got = port_paste(pair, out, occ_impl, PASTE)
    assert len(calls) == 1
    want = jax_paste(pair, out, occ_impl, PASTE)
    n_pix = got["mask"].size
    compare_paste(got, want, n_pix, max_dxyz_flips=n_pix // 20)
