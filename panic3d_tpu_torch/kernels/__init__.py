"""Registry of the hand-written CUDA kernels and their launch counts.

Each wrapper adds one to its kernel's ``launches`` where it launches the
kernel, and nowhere else (the plain PyTorch path on CPU tensors does not
count). ``chip_smoke.py`` zeroes the counts before it drives the main path
and reads them after, to show the path went through every kernel.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Kernel:
    name: str
    source: str      # CUDA source, relative to the repository root
    replaces: str    # the JAX op it stands in for, file:line
    launches: int = 0


KERNELS = {
    k.name: k
    for k in (
        Kernel(
            "triplane_decode",
            "panic3d_tpu_torch/csrc/triplane_decode.cu",
            "panic3d_tpu/models/volumetric/renderer.py:778",
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
    )
}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}
