"""Registry of the hand-written CUDA kernels and their launch counts.

Each wrapper adds one to its kernel's ``launches`` where it launches the
kernel, and nowhere else (the plain PyTorch path on CPU tensors does not
count). A source with more than one kernel behind one entry point (K4's
polyphase and generic kernels) also counts each launch under the variant it
ran, in ``variants``. ``chip_smoke.py`` zeroes the counts before it drives
the main path and reads them after, to show the path went through every
kernel.

Seven kernels have a backward form, each run by an autograd.Function
around the forward launch: K1 (``triplane_decode_grad``, to the planes and
the decoder's weights), K2 (``ray_composite_grad``, to the colours and
sigmas), K4 (the transposed upfirdn2d, K4's own entry point, counted under
``grad_<variant>``), K5 (``modconv_epilogue_grad``, differentiable again
for R1), K8 (``paste_front_grad``, both entries: to the rendered image and
image_xyz), K10 (``triplane_decode_deep_grad``, to the deep volumes and
the decoder's weights) and K14 (``grid_sample_2d_grad``, to the sampled
image, differentiable again through K14's forward). Their wrappers still
refuse, through ``require_no_grad``, the inputs they give no gradient:
K1's, K10's and K2's sample coordinates and depths, K4's filter, K5's
noise, K8's front image and front-weight mask, and K14's grid; K8's other
maps (the weights, occlusion and discrepancy) are masks, stop-gradiented
as in the JAX package, and take none without a refusal.
Every other wrapper calls ``require_no_grad`` on all its inputs before it
launches: under grad mode an input that requires grad would otherwise leave
the outputs cut off from it without an error.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch


@dataclass
class Kernel:
    name: str        # the C entry point (one source may hold two)
    source: str      # CUDA source, relative to the repository root
    replaces: str    # the JAX op it stands in for, file:line
    launches: int = 0
    variants: dict = field(default_factory=dict)   # launches by kernel variant


KERNELS = {
    k.name: k
    for k in (
        Kernel(
            "triplane_decode",
            "panic3d_tpu_torch/csrc/triplane_decode.cu",
            "panic3d_tpu/models/volumetric/renderer.py:778",
        ),
        Kernel(
            "volume_density",
            "panic3d_tpu_torch/csrc/triplane_decode.cu",
            "panic3d_tpu/eval/volume.py:285",
        ),
        Kernel(
            "triplane_decode_grad",
            "panic3d_tpu_torch/csrc/triplane_decode_grad.cu",
            "panic3d_tpu/models/volumetric/renderer.py:778",
        ),
        Kernel(
            "ray_composite_grad",
            "panic3d_tpu_torch/csrc/ray_composite.cu",
            "panic3d_tpu/models/volumetric/renderer.py:567",
        ),
        Kernel(
            "modconv_epilogue_grad",
            "panic3d_tpu_torch/csrc/modconv_epilogue.cu",
            "panic3d_tpu/ops/bias_act.py:40",
        ),
        Kernel(
            "ray_composite",
            "panic3d_tpu_torch/csrc/ray_composite.cu",
            "panic3d_tpu/models/volumetric/renderer.py:567",
        ),
        Kernel(
            "importance_sample",
            "panic3d_tpu_torch/csrc/importance_sample.cu",
            "panic3d_tpu/models/volumetric/renderer.py:548",
        ),
        Kernel(
            "upfirdn2d",
            "panic3d_tpu_torch/csrc/upfirdn2d.cu",
            "panic3d_tpu/ops/upfirdn2d.py:238",
        ),
        Kernel(
            "modconv_epilogue",
            "panic3d_tpu_torch/csrc/modconv_epilogue.cu",
            "panic3d_tpu/ops/bias_act.py:40",
        ),
        Kernel(
            "ess_occupancy",
            "panic3d_tpu_torch/csrc/ess.cu",
            "panic3d_tpu/models/volumetric/renderer.py:303",
        ),
        Kernel(
            "ess_narrow",
            "panic3d_tpu_torch/csrc/ess.cu",
            "panic3d_tpu/models/volumetric/renderer.py:378",
        ),
        Kernel(
            "occlusion_volume",
            "panic3d_tpu_torch/csrc/front_occlusion.cu",
            "panic3d_tpu/models/volumetric/lattice.py:239",
        ),
        Kernel(
            "occlusion_sample",
            "panic3d_tpu_torch/csrc/front_occlusion.cu",
            "panic3d_tpu/models/volumetric/lattice.py:303",
        ),
        Kernel(
            "paste_front",
            "panic3d_tpu_torch/csrc/paste_front.cu",
            "panic3d_tpu/models/triplane.py:730",
        ),
        Kernel(
            "paste_front_occ",
            "panic3d_tpu_torch/csrc/paste_front.cu",
            "panic3d_tpu/models/triplane.py:730",
        ),
        Kernel(
            "paste_front_grad",
            "panic3d_tpu_torch/csrc/paste_front.cu",
            "panic3d_tpu/models/triplane.py:730",
        ),
        Kernel(
            "point_mesh_distance",
            "panic3d_tpu_torch/csrc/mesh_distance.cu",
            "panic3d_tpu/eval/mesh_metrics.py:61",
        ),
        Kernel(
            "winding_number",
            "panic3d_tpu_torch/csrc/winding_number.cu",
            "panic3d_tpu/eval/gltf.py:77",
        ),
        Kernel(
            "triplane_decode_deep",
            "panic3d_tpu_torch/csrc/triplane_decode.cu",
            "panic3d_tpu/ops/grid_sample.py:266",
        ),
        Kernel(
            "triplane_decode_deep_grad",
            "panic3d_tpu_torch/csrc/triplane_decode_grad.cu",
            "panic3d_tpu/ops/grid_sample.py:266",
        ),
        Kernel(
            "volume_density_deep",
            "panic3d_tpu_torch/csrc/triplane_decode.cu",
            "panic3d_tpu/ops/grid_sample.py:266",
        ),
        Kernel(
            "filtered_lrelu",
            "panic3d_tpu_torch/csrc/filtered_lrelu.cu",
            "panic3d_tpu/ops/filtered_lrelu.py:22",
        ),
        Kernel(
            "grid_sample_2d",
            "panic3d_tpu_torch/csrc/grid_sample.cu",
            "panic3d_tpu/ops/grid_sample.py:256",
        ),
        Kernel(
            "grid_sample_2d_grad",
            "panic3d_tpu_torch/csrc/grid_sample.cu",
            "panic3d_tpu/ops/grid_sample.py:256",
        ),
        Kernel(
            "gather_dot",
            "panic3d_tpu_torch/csrc/gather_dot.cu",
            "scripts/bench_pallas_gather.py:43",
        ),
    )
}

# C entry points that launch no kernel of a path and are not counted (a
# check for chip_smoke.py, or a launch parameter a wrapper asks for):
# entry point -> the kernel whose source holds it
CHECK_ENTRIES = {"volume_lattice": "volume_density", "winding_number_splits": "winding_number",
                 "grid_sample_2d_grad_counted": "grid_sample_2d_grad"}


def _tensors(obj):
    """The tensors in ``obj``: a tensor, or tuples (named ones included),
    lists and dicts of them, at any depth."""
    if torch.is_tensor(obj):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            yield from _tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _tensors(o)


def require_no_grad(name: str, *inputs) -> None:
    """Raise if grad mode is on and a tensor among ``inputs`` requires grad:
    kernel ``name`` has no backward, so autograd would lose the path from
    its outputs to that input. Run the call under ``torch.no_grad()``, or
    on the CPU, whose plain versions differentiate."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in _tensors(inputs)):
        raise RuntimeError(f"{name}: the CUDA kernel has no backward, and an input requires "
                           "grad under grad mode; call it under torch.no_grad(), or on the "
                           "CPU for gradients")


def sources() -> list:
    """The CUDA sources to build, one per file, in registry order."""
    return list(dict.fromkeys(k.source for k in KERNELS.values()))


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
        k.variants.clear()


def launch_counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


def variant_counts() -> dict:
    """Launches by variant, for the entry points that have variants."""
    return {name: dict(k.variants) for name, k in KERNELS.items() if k.variants}
