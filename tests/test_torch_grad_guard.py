"""The port's kernels without a backward form refuse an input that
requires grad under grad mode (kernels/__init__.py:require_no_grad), and
the five with one (K1, K2, K4, K5, K14) carry the gradient, on the CPU:

- the helper raises only with grad mode on and a tensor that requires grad,
  found in nested tuples (the decoder's NamedTuple), lists and dicts;
- each of the 14 kernel wrappers without a backward raises at its first
  statement when one of its tensor inputs requires grad, before it checks
  the device or launches; so do the keyed forms' new inputs (K3's u, K6b's
  per-ray bounds and jitter) and the inputs the five backward forms give no
  gradient (K5's noise, K4's filter, K1's coordinates, K2's depths, K14's
  grid);
- K1, K2, K4, K5 and K14 and their four backward entry points are wired:
  each autograd.Function, on CPU tensors (its kernel's plain version),
  gives its differentiable inputs a finite gradient and counts no launch;
- the plain CPU forward of the tiny config (G.f) still back-propagates to
  the mapping, the backbone and the decoder.
"""

import numpy as np
import pytest
import torch

from panic3d_tpu_torch import configs as tcfg
from panic3d_tpu_torch.eval import gltf
from panic3d_tpu_torch.eval import mesh_metrics as mm
from panic3d_tpu_torch.eval import volume as vol
from panic3d_tpu_torch.kernels import KERNELS, launch_counts, require_no_grad
from panic3d_tpu_torch.models import triplane as tp
from panic3d_tpu_torch.models.volumetric import lattice as vlat
from panic3d_tpu_torch.models.volumetric import renderer as vr
from panic3d_tpu_torch.ops.bias_act import EpilogueGrad, ModconvEpilogue, modconv_epilogue_kernel
from panic3d_tpu_torch.ops.filtered_lrelu import filtered_lrelu_kernel
from panic3d_tpu_torch.ops.gather_dot import gather_dot_kernel
from panic3d_tpu_torch.ops.grid_sample import (GridSample2d, GridSample2dGrad,
                                               grid_sample_2d_kernel)
from panic3d_tpu_torch.ops.upfirdn2d import UpFirDn2d, setup_filter, upfirdn2d_kernel


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small ops: one torch thread beside the other test workers (ROADMAP
    "Tier-1 time")."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def leaf(*shape, grad=False):
    return torch.zeros(shape, requires_grad=grad)


@pytest.mark.parametrize("grad_mode", [True, False], ids=["grad-on", "grad-off"])
@pytest.mark.parametrize("requires", [True, False], ids=["requires-grad", "no-grad"])
def test_helper(grad_mode, requires):
    dec = vr.Decoder(leaf(64, 8, grad=requires), leaf(64), leaf(33, 64), leaf(33))
    inputs = (leaf(2), [leaf(3), {"dec": dec}], None, 1.5)
    with torch.set_grad_enabled(grad_mode):
        if grad_mode and requires:
            with pytest.raises(RuntimeError, match="no backward"):
                require_no_grad("k", *inputs)
        else:
            require_no_grad("k", *inputs)


def _decoder(grad):
    return vr.Decoder(leaf(64, 8, grad=grad), leaf(64), leaf(33, 64), leaf(33))


# each wrapper with one tensor input that requires grad; the rest are
# placeholders, never reached
WRAPPERS = {
    "volume_density": lambda: vol.density_grid_kernel(
        leaf(1, 3, 8, 4, 4), _decoder(True), 16, 0.7, vr.generate_plane_axes(True),
        vr.DensityFilters()),
    "importance_sample": lambda: vr.importance_sample_kernel(
        leaf(1, 2, 8, 1), leaf(1, 2, 8, 1, grad=True), 4),
    "ess_occupancy": lambda: vr.ess_occupancy_kernel(
        [(leaf(1, 4, 4, 8, grad=True), 0, 1)] * 3, _decoder(False), 0.7, 2, 2, 0.01,
        vr.DensityFilters()),
    "ess_narrow": lambda: vr.ess_narrow_kernel(
        leaf(1, 2, 2, 2), leaf(1), leaf(1, 4, 3, grad=True), leaf(1, 4, 3), 0.5, 1.5, 0.7,
        {"ess": {}}, 8),
    "occlusion_volume": lambda: vlat.occlusion_volume_kernel(
        [(leaf(1, 4, 4, 8), 0, 1)] * 3, _decoder(True), 0.7, (4, 4, 4), vr.DensityFilters()),
    "occlusion_sample": lambda: vlat.occlusion_sample_kernel(
        leaf(1, 4, 4, 4, grad=True), leaf(1), leaf(1, 5, 3), 0.7, 0.01, 1.0),
    "paste_front": lambda: tp.paste_composite_kernel(
        leaf(1, 3, 8, 8, grad=True), leaf(1, 3, 8, 8), leaf(1, 1, 8, 8), leaf(1, 3, 8, 8),
        leaf(1, 1, 8, 8), leaf(1, 1, 8, 8), 0.7, 0.5, 0.5, 0.5),
    "paste_front_occ": lambda: tp.paste_composite_occ_kernel(
        leaf(1, 3, 8, 8), leaf(1, 3, 8, 8), leaf(1, 1, 8, 8), leaf(1, 3, 8, 8),
        {"A": leaf(1, 4, 4, 4, grad=True), "density0": leaf(1), "box_warp": 0.7},
        {"ray_origins": leaf(1, 3, 8, 8), "ray_directions": leaf(1, 3, 8, 8)}, 0.7, 0.01, 1.0,
        0.05, 0.5, 0.5, 0.5),
    "point_mesh_distance": lambda: mm.point_mesh_distance_sq_kernel(
        leaf(5, 3, grad=True), leaf(3, 3), torch.zeros((1, 3), dtype=torch.int32)),
    "winding_number": lambda: gltf.winding_numbers_kernel(
        leaf(4, 3, grad=True), torch.zeros((1, 3), dtype=torch.int64), leaf(2, 3)),
    "triplane_decode_deep": lambda: vr.triplane_decode_deep_kernel(
        leaf(3, 2, 4, 4, 8, grad=True), leaf(1, 5, 3), _decoder(False), 0.7,
        vr.generate_plane_axes(True), vr.DensityFilters()),
    "volume_density_deep": lambda: vol.density_grid_deep_kernel(
        leaf(1, 3, 16, 4, 4), _decoder(True), 16, 0.7, vr.generate_plane_axes(True),
        vr.DensityFilters(), 2),
    "filtered_lrelu": lambda: filtered_lrelu_kernel(leaf(1, 2, 8, 8), leaf(12), leaf(12),
                                                    leaf(2, grad=True), up=2, down=2,
                                                    padding=[5, 6, 5, 6]),
    "gather_dot": lambda: gather_dot_kernel(torch.zeros(4, dtype=torch.int32), leaf(4, 8),
                                            leaf(8, 4, grad=True)),
}


# the keyed forms: the input each form adds requires grad; and the inputs
# the backward forms give no gradient
FORMS = {
    "triplane_decode[coords]": lambda: vr.triplane_decode_kernel(
        leaf(1, 3, 4, 4, 8), leaf(1, 5, 3, grad=True), _decoder(False), 0.7,
        vr.generate_plane_axes(True), vr.DensityFilters()),
    "ray_composite[depths]": lambda: vr.ray_composite_kernel(
        leaf(1, 2, 4, 1, grad=True), leaf(1, 2, 4, 4), leaf(1, 2, 4, 1), leaf(1, 2, 4, 3),
        leaf(1, 2, 4, 1), leaf(1, 2, 4, 4), leaf(1, 2, 4, 1), leaf(1, 2, 4, 3), True),
    "upfirdn2d[filter]": lambda: upfirdn2d_kernel(leaf(1, 2, 4, 4), leaf(4, 4, grad=True),
                                                  (2, 2), (1, 1), (1, 1, 1, 1)),
    "importance_sample[u]": lambda: vr.importance_sample_kernel(
        leaf(1, 2, 8, 1), leaf(1, 2, 8, 1), 4, u=leaf(2, 4, grad=True)),
    "modconv_epilogue[per_sample_noise]": lambda: modconv_epilogue_kernel(
        leaf(2, 4, 3, 3), noise=leaf(2, 1, 3, 3, grad=True)),
    "ess_narrow[per_ray]": lambda: vr.ess_narrow_kernel(
        leaf(1, 2, 2, 2), leaf(1), leaf(1, 4, 3), leaf(1, 4, 3), leaf(1, 4, 1, grad=True),
        leaf(1, 4, 1), 0.7, {"ess": {}}, 8),
    "ess_narrow[jitter]": lambda: vr.ess_narrow_kernel(
        leaf(1, 2, 2, 2), leaf(1), leaf(1, 4, 3), leaf(1, 4, 3), 0.5, 1.5, 0.7, {"ess": {}}, 8,
        jitter=leaf(1, 4, 8, 1, grad=True)),
    "grid_sample_2d[grid]": lambda: grid_sample_2d_kernel(leaf(1, 2, 4, 4),
                                                          leaf(1, 3, 3, 2, grad=True)),
}


@pytest.mark.parametrize("name", list(FORMS))
def test_keyed_form_raises_under_grad_mode(name):
    kernel = name.split("[")[0]
    with pytest.raises(RuntimeError, match=f"^{kernel}: the CUDA kernel has no backward"):
        FORMS[name]()
    assert sum(launch_counts().values()) == 0


def _rand(*shape, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape).astype(np.float32))


def _k1_wiring():
    planes = _rand(1, 3, 4, 4, 8).requires_grad_(True)
    coords = torch.from_numpy(np.random.RandomState(1).uniform(-0.3, 0.3, (1, 5, 3))).float()
    dec = [_rand(64, 8, seed=2).requires_grad_(True), _rand(64, seed=3).requires_grad_(True),
           _rand(33, 64, seed=4).requires_grad_(True), _rand(33, seed=5).requires_grad_(True)]
    rgb, sigma = vr.TriplaneDecode.apply(planes, coords, *dec, (1.0, False, 0.7,
                                         vr.generate_plane_axes(True), vr.DensityFilters()))
    return [planes, *dec], rgb.sum() + sigma.sum()


def _k2_wiring():
    d = torch.sort(torch.rand(1, 2, 4, 1, generator=torch.Generator().manual_seed(0)), 2)[0]
    c, s = _rand(1, 2, 4, 8).requires_grad_(True), _rand(1, 2, 4, 1, seed=1).requires_grad_(True)
    x = _rand(1, 2, 4, 3, seed=2)
    comp, depth, wsum = vr.RayComposite.apply(d, c, s, x, d + 0.01, c, s, x, True)
    return [c, s], comp.sum() + depth.sum() + wsum.sum()


def _k4_wiring():
    x = _rand(1, 2, 8, 8).requires_grad_(True)
    f = setup_filter([1, 3, 3, 1])
    return [x], UpFirDn2d.apply(x, f, (1, 1), (2, 2), (1, 1, 1, 1)).square().sum()


def _k5_wiring():
    x, b = _rand(2, 4, 3, 3).requires_grad_(True), _rand(4, seed=1).requires_grad_(True)
    return [x, b], ModconvEpilogue.apply(x, None, None, None, b, ("lrelu", None, None, 1.0)).sum()


def _k5_grad_wiring():   # the backward form differentiated again (R1)
    x, b = _rand(2, 4, 3, 3).requires_grad_(True), _rand(4, seed=1).requires_grad_(True)
    y = ModconvEpilogue.apply(x, None, None, None, b, ("lrelu", None, None, 1.0))
    (gx,) = torch.autograd.grad(y.square().sum(), x, create_graph=True)
    assert gx.requires_grad
    dz = EpilogueGrad.apply(gx, y, ("lrelu", None, None, 1.0))
    return [x, b], gx.square().sum() + dz.sum()


def _k14_wiring():
    x = _rand(1, 2, 6, 6).requires_grad_(True)
    grid = torch.from_numpy(np.random.RandomState(1).uniform(-1.2, 1.2, (1, 4, 5, 2))).float()
    return [x], GridSample2d.apply(x, grid, ("zeros", False)).square().sum()


def _k14_grad_wiring():   # the backward form differentiated again (R1 through ADA)
    x = _rand(1, 2, 6, 6).requires_grad_(True)
    grid = torch.from_numpy(np.random.RandomState(1).uniform(-1.2, 1.2, (1, 4, 5, 2))).float()
    y = GridSample2d.apply(x, grid, ("border", True))
    (gx,) = torch.autograd.grad(y.square().sum(), x, create_graph=True)
    assert gx.requires_grad
    return [x], gx.square().sum() + GridSample2dGrad.apply(y, grid, (1, 2, 6, 6),
                                                           ("border", True)).sum()


# the kernels with a backward form, and their backward entry points: the
# Function's wiring on CPU tensors
BACKWARD = {
    "triplane_decode": _k1_wiring,
    "triplane_decode_grad": _k1_wiring,
    "ray_composite": _k2_wiring,
    "ray_composite_grad": _k2_wiring,
    "upfirdn2d": _k4_wiring,
    "modconv_epilogue": _k5_wiring,
    "modconv_epilogue_grad": _k5_grad_wiring,
    "grid_sample_2d": _k14_wiring,
    "grid_sample_2d_grad": _k14_grad_wiring,
}


@pytest.mark.parametrize("name", list(BACKWARD))
def test_backward_wiring(name):
    leaves, value = BACKWARD[name]()
    grads = torch.autograd.grad(value, leaves)
    for g, t in zip(grads, leaves):
        assert g.shape == t.shape and bool(torch.isfinite(g).all()) and g.abs().sum() > 0
    assert sum(launch_counts().values()) == 0


def test_every_kernel_has_a_case():
    assert set(WRAPPERS) | set(BACKWARD) == set(KERNELS)
    assert not set(WRAPPERS) & set(BACKWARD)


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_wrapper_raises_under_grad_mode(name):
    with pytest.raises(RuntimeError, match=f"^{name}: the CUDA kernel has no backward"):
        WRAPPERS[name]()
    assert sum(launch_counts().values()) == 0


def test_plain_forward_backpropagates():
    torch.manual_seed(0)
    G = tcfg.tiny(device="cpu").init_weights(0)
    r = np.random.RandomState(0)
    x = {"z": torch.from_numpy(r.randn(1, G.z_dim).astype(np.float32)),
         "elevations": torch.zeros(1), "azimuths": torch.tensor([30.0]),
         "cond": {"image_ortho_front": torch.from_numpy(r.rand(1, 3, 64, 64)).float(),
                  "resnet_chonk": torch.from_numpy(r.randn(1, 16, 8, 8)).float()}}
    assert torch.is_grad_enabled()
    out = G.f(x)
    (out["image"].square().mean() + out["image_depth"].mean()).backward()
    for name in ("decoder.net.0.weight", "decoder.net.2.bias"):
        grad = dict(G.named_parameters())[name].grad
        assert grad is not None and bool(torch.isfinite(grad).all()) and grad.abs().sum() > 0
    touched = [n for n, p in G.named_parameters() if p.grad is not None and p.grad.abs().sum() > 0]
    assert any(n.startswith("backbone.mapping.fc") for n in touched)
    assert any(n.startswith("backbone.synthesis.") for n in touched)
    assert any(n.startswith("superresolution.") for n in touched)
    assert sum(launch_counts().values()) == 0
