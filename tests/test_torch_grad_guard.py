"""The port's CUDA kernels have no backward pass, so every kernel wrapper
refuses an input that requires grad under grad mode
(kernels/__init__.py:require_no_grad), on the CPU:

- the helper raises only with grad mode on and a tensor that requires grad,
  found in nested tuples (the decoder's NamedTuple), lists and dicts;
- each of the 18 kernel wrappers raises at its first statement when one of
  its tensor inputs requires grad, before it checks the device or launches;
  so do the keyed forms' new inputs (K3's u, K5's per-sample noise, K6b's
  per-ray bounds and jitter);
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
from panic3d_tpu_torch.ops.bias_act import modconv_epilogue_kernel
from panic3d_tpu_torch.ops.filtered_lrelu import filtered_lrelu_kernel
from panic3d_tpu_torch.ops.gather_dot import gather_dot_kernel
from panic3d_tpu_torch.ops.upfirdn2d import upfirdn2d_kernel


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
    "triplane_decode": lambda: vr.triplane_decode_kernel(
        leaf(1, 3, 4, 4, 8), leaf(1, 5, 3, grad=True), _decoder(False), 0.7,
        vr.generate_plane_axes(True), vr.DensityFilters()),
    "volume_density": lambda: vol.density_grid_kernel(
        leaf(1, 3, 8, 4, 4), _decoder(True), 16, 0.7, vr.generate_plane_axes(True),
        vr.DensityFilters()),
    "ray_composite": lambda: vr.ray_composite_kernel(
        leaf(1, 2, 4, 1), leaf(1, 2, 4, 4, grad=True), leaf(1, 2, 4, 1), leaf(1, 2, 4, 3),
        leaf(1, 2, 4, 1), leaf(1, 2, 4, 4), leaf(1, 2, 4, 1), leaf(1, 2, 4, 3), True),
    "importance_sample": lambda: vr.importance_sample_kernel(
        leaf(1, 2, 8, 1), leaf(1, 2, 8, 1, grad=True), 4),
    "upfirdn2d": lambda: upfirdn2d_kernel(leaf(1, 2, 4, 4, grad=True), leaf(4, 4), (2, 2),
                                          (1, 1), (1, 1, 1, 1)),
    "modconv_epilogue": lambda: modconv_epilogue_kernel(leaf(2, 4), bias=leaf(4, grad=True),
                                                        act="lrelu"),
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


# the keyed forms: the input each form adds requires grad
FORMS = {
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
}


@pytest.mark.parametrize("name", list(FORMS))
def test_keyed_form_raises_under_grad_mode(name):
    kernel = name.split("[")[0]
    with pytest.raises(RuntimeError, match=f"^{kernel}: the CUDA kernel has no backward"):
        FORMS[name]()
    assert sum(launch_counts().values()) == 0


def test_every_kernel_has_a_case():
    assert set(WRAPPERS) == set(KERNELS)


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
