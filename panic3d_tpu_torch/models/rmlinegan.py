"""The line filler (panic3d_tpu/models/rmlinegan.py): rmlineganA's generator
and the inference wrapper of the reference's
`_train/img2img/util/rmline_wrapper.py` (a DoG line mask minus the face
hull of the portrait's keypoints -> the generator -> a lerp by the mask).

RMLineGenerator is 6 valid 3x3 convolutions of width 32, leaky ReLU (0.01)
and inference BatchNorm (eps 1e-5, running statistics) between them, tanh
out. Its parameters carry the flax names (``conv{i}_w``, ``conv{i}_b``,
``bn{i}.scale`` / ``.bias``, the running statistics as ``bn{i}.mean`` /
``.var`` buffers), so the JAX package's variables, and a checkpoint
directory ``rmline/``, load through
runtime/checkpoint.py:module_state_from_flax. The convolutions stay with
cuDNN. The discriminator belongs to training and is not here.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..configs import resolve_device
from ..runtime.checkpoint import module_state_from_flax
from ..utils.device import to_device
from ..utils.imageops import dilation
from ..utils.sketchers import batch_dog

# 28-keypoint groups of the anime-face-detector (rmline_wrapper.py:65-88)
KEYPOINT_GROUPS = dict(
    chin=[0, 1, 2, 3, 4],
    eyelash_right=[5, 6, 7],
    eyelash_left=[8, 9, 10],
    eye_right=[11, 12, 13, 14, 15, 16],
    eye_left=[17, 18, 19, 20, 21, 22],
    nose=[23],
    mouth=[24, 25, 26, 27],
)


class _BN(nn.Module):
    """Inference BatchNorm over channels with flax's names."""

    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x):
        return F.batch_norm(x, self.mean, self.var, self.scale, self.bias, False, 0.0, 1e-5)


class RMLineGenerator(nn.Module):
    """6 valid 3x3 convs, width 32, lrelu + BatchNorm between, tanh out."""

    def __init__(self, depth: int = 6, width: int = 32, use_hull: bool = True,
                 batchnorm: bool = True, device=None):
        super().__init__()
        self.depth, self.use_hull = depth, use_hull
        cin = 4 if use_hull else 3
        for i in range(depth):
            cout = width if i != depth - 1 else 3
            self.register_parameter(f"conv{i}_w", nn.Parameter(torch.zeros(cout, cin, 3, 3)))
            self.register_parameter(f"conv{i}_b", nn.Parameter(torch.zeros(cout)))
            if batchnorm and i != depth - 1:
                self.add_module(f"bn{i}", _BN(cout))
            cin = width
        self.to(resolve_device(device))

    def init_weights(self, seed: int = 0) -> "RMLineGenerator":
        """He-normal convolutions and zero biases (the flax init's
        distributions), unit BatchNorms with zero mean and unit variance:
        drawn on the CPU from ``seed``."""
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("_w"):
                    fan_in = p.shape[1] * p.shape[2] * p.shape[3]
                    p.copy_(torch.randn(p.shape, generator=gen) * np.sqrt(2.0 / fan_in))
                else:
                    p.fill_(1.0 if name.endswith("scale") else 0.0)
            for name, b in self.named_buffers():
                b.fill_(1.0 if name.endswith("var") else 0.0)
        return self

    def load_variables(self, variables) -> "RMLineGenerator":
        """The JAX package's RMLineGenerator variables ('params', 'batch_stats')."""
        self.load_state_dict(module_state_from_flax(variables), strict=True)
        return self

    def forward(self, x):
        for i in range(self.depth):
            x = F.conv2d(x, getattr(self, f"conv{i}_w"), getattr(self, f"conv{i}_b"))
            if i != self.depth - 1:
                x = F.leaky_relu(x, 0.01)
                bn = getattr(self, f"bn{i}", None)
                if bn is not None:
                    x = bn(x)
        return torch.tanh(x)


def generator_forward(gen: RMLineGenerator, image, line_mask, face_hull):
    """rmlineganA.forward (rmlineganA.py:108-143) as the wrapper calls it:
    mask the lines out, stack the hull, replicate-pad by the depth (each
    valid conv takes one pixel a side)."""
    img = image * (1 - line_mask)
    stackin = torch.cat([img, face_hull], dim=1) if gen.use_hull else img
    d = gen.depth
    with torch.no_grad():
        return gen(F.pad(stackin, (d, d, d, d), mode="replicate"))


def lerp_output(image, out, line_mask):
    """Composite the generator's output into the input through the line mask."""
    return image + (out - image) * line_mask


def facehull(shape_hw, kpts, dilate: int = 5, device="cpu") -> torch.Tensor:
    """The rasterised face hull of 28 keypoints (rmline_wrapper.py:88-120):
    the convex hulls of the eyes and the mouth, the nose point and the
    eyelash polylines, rasterised on the host, then dilated on ``device``.
    kpts: [28, 2] in (row, col) pixels. -> [1,1,H,W] float32."""
    import scipy.spatial

    H, W = shape_hw
    v = np.zeros((H, W), dtype=np.float32)
    ys, xs = np.mgrid[0:H, 0:W]
    grid = np.stack([ys.ravel(), xs.ravel()], axis=1)

    def fill_hull(points):
        pts = np.asarray(points, dtype=np.float64)
        if len(pts) < 3:
            for a, b in pts.astype(int):
                if 0 <= a < H and 0 <= b < W:
                    v[a, b] = 1
            return
        try:
            hull = scipy.spatial.ConvexHull(pts)
        except (scipy.spatial.QhullError, ValueError):   # degenerate or non-finite points
            return
        eq = hull.equations  # [F, 3]: normal + offset
        inside = np.all(grid @ eq[:, :2].T + eq[:, 2] <= 1e-9, axis=1)
        v[inside.reshape(H, W)] = 1

    fill_hull(kpts[KEYPOINT_GROUPS["eye_right"]])
    fill_hull(kpts[KEYPOINT_GROUPS["eye_left"]])
    fill_hull(kpts[KEYPOINT_GROUPS["mouth"]])
    a, b = kpts[KEYPOINT_GROUPS["nose"][0]].astype(int)
    if 0 <= a < H and 0 <= b < W:
        v[a, b] = 1

    for grp in ("eyelash_left", "eyelash_right"):
        g = kpts[KEYPOINT_GROUPS[grp]]
        for p0, p1 in zip(g[:-1], g[1:]):
            n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]))) * 2 + 2
            t = np.linspace(0, 1, n)[:, None]
            li = np.round(p0[None] + t * (p1 - p0)[None]).astype(int)
            ok = (li[:, 0] >= 0) & (li[:, 0] < H) & (li[:, 1] >= 0) & (li[:, 1] < W)
            v[li[ok, 0], li[ok, 1]] = 1

    return dilation(to_device(v[None, None], device), dilate)


class RMLineWrapper:
    """The inference pipeline (rmline_wrapper.py:22-50): DoG lines minus the
    face hull -> the generator -> the lerp; the caller restores alpha."""

    def __init__(self, gen: RMLineGenerator):
        self.gen = gen.eval()

    def __call__(self, image_rgb, kpts):
        """image_rgb: [1,3,H,W] float in [0,1], composited on white, on the
        generator's device; kpts [28,2]. -> (filled image, line mask, face
        hull), each [1,C,H,W] on that device."""
        H, W = image_rgb.shape[-2:]
        fhull = facehull((H, W), np.asarray(kpts), device=image_rgb.device)
        with torch.no_grad():
            dog = batch_dog(image_rgb, t=1.0, sigma=0.5, k=1.6, epsilon=0.01,
                            kernel_factor=4) > 0.5
            dog = dilation(dog.float(), 2) > 0.5
            line_mask = (dog & ~(fhull > 0.5)).float()
            out = generator_forward(self.gen, image_rgb, line_mask, fhull)
            return lerp_output(image_rgb, out, line_mask), line_mask, fhull
