"""InceptionV3, the FID / KID / PR / IS detector (panic3d_tpu/eval/inception.py).

The reference's detector is NVIDIA's ``inception-2015-12-05.pkl``
(src/metrics/metric_utils.py:209-263, frechet_inception_distance.py:23-24):
the pytorch-fid / torchvision ``inception_v3`` graph with the three FID
patches (the pool branches average with count_include_pad=False, Mixed_7c's
pool branch takes the max, the fc has 1008 classes). Each BatchNorm is
folded into its conv when the weights are converted
(runtime/convert.py:convert_inception_v3), so a layer is one conv + bias +
ReLU; the convs and the fc stay with cuDNN and cuBLAS.

The parameters carry the JAX package's flax names and shapes
(``Conv2d_1a_3x3.w``, ``Mixed_5b.branch1x1.b``, ``fc_w``, ...), so
``load_variables`` takes the JAX tree of numpy arrays as it is. Without
converted weights the net is seeded (``init_weights``): exact in
architecture, its values are comparable only with each other.

Contract (metric_utils.py's feature flow): [N,3,299,299] in [-1, 1] ->
[N,2048] pool features (FID, KID, PR), or the 1008-way softmax (IS, with
``no_output_bias`` as inception_score.py:23). ``preprocess`` maps any size
and range to that input.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..configs import resolve_device
from ..ops.resize import resize
from ..runtime.checkpoint import module_state_from_flax


class FConv(nn.Module):
    """BasicConv2d with its BatchNorm folded: conv + bias + ReLU."""

    def __init__(self, cout: int, cin: int, kernel, stride: int = 1, padding=(0, 0)):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(cout, cin, *kernel))
        self.b = nn.Parameter(torch.zeros(cout))
        self.stride, self.padding = stride, tuple(padding)

    def forward(self, x):
        return F.relu(F.conv2d(x, self.w, self.b, self.stride, self.padding))


def _max_pool_3x3_s2(x):
    return F.max_pool2d(x, 3, 2)


def _pool_branch(x, max_pool: bool = False):
    """The 3x3 stride-1 pad-1 pool branch: an average over the real taps
    only (count_include_pad=False), or in Mixed_7c a max (padding -inf)."""
    if max_pool:
        return F.max_pool2d(x, 3, 1, 1)
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, c: int, pool_features: int):
        super().__init__()
        self.branch1x1 = FConv(64, c, (1, 1))
        self.branch5x5_1 = FConv(48, c, (1, 1))
        self.branch5x5_2 = FConv(64, 48, (5, 5), padding=(2, 2))
        self.branch3x3dbl_1 = FConv(64, c, (1, 1))
        self.branch3x3dbl_2 = FConv(96, 64, (3, 3), padding=(1, 1))
        self.branch3x3dbl_3 = FConv(96, 96, (3, 3), padding=(1, 1))
        self.branch_pool = FConv(pool_features, c, (1, 1))

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(_pool_branch(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.branch3x3 = FConv(384, c, (3, 3), stride=2)
        self.branch3x3dbl_1 = FConv(64, c, (1, 1))
        self.branch3x3dbl_2 = FConv(96, 64, (3, 3), padding=(1, 1))
        self.branch3x3dbl_3 = FConv(96, 96, (3, 3), stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _max_pool_3x3_s2(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, c: int, c7: int):
        super().__init__()
        self.branch1x1 = FConv(192, c, (1, 1))
        self.branch7x7_1 = FConv(c7, c, (1, 1))
        self.branch7x7_2 = FConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = FConv(192, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = FConv(c7, c, (1, 1))
        self.branch7x7dbl_2 = FConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = FConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = FConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = FConv(192, c7, (1, 7), padding=(0, 3))
        self.branch_pool = FConv(192, c, (1, 1))

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_pool_branch(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.branch3x3_1 = FConv(192, c, (1, 1))
        self.branch3x3_2 = FConv(320, 192, (3, 3), stride=2)
        self.branch7x7x3_1 = FConv(192, c, (1, 1))
        self.branch7x7x3_2 = FConv(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = FConv(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = FConv(192, 192, (3, 3), stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, _max_pool_3x3_s2(x)], 1)


class InceptionE(nn.Module):
    def __init__(self, c: int, pool_max: bool = False):
        super().__init__()
        self.pool_max = pool_max   # Mixed_7c's FIDInceptionE_2 patch
        self.branch1x1 = FConv(320, c, (1, 1))
        self.branch3x3_1 = FConv(384, c, (1, 1))
        self.branch3x3_2a = FConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = FConv(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = FConv(448, c, (1, 1))
        self.branch3x3dbl_2 = FConv(384, 448, (3, 3), padding=(1, 1))
        self.branch3x3dbl_3a = FConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = FConv(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = FConv(192, c, (1, 1))

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        bp = self.branch_pool(_pool_branch(x, max_pool=self.pool_max))
        return torch.cat([self.branch1x1(x), b3, bd, bp], 1)


class InceptionV3(nn.Module):
    """The FID detector graph; the module names are torchvision's, so the
    converter maps them one to one."""

    def __init__(self, num_classes: int = 1008, device=None):
        super().__init__()
        self.Conv2d_1a_3x3 = FConv(32, 3, (3, 3), stride=2)
        self.Conv2d_2a_3x3 = FConv(32, 32, (3, 3))
        self.Conv2d_2b_3x3 = FConv(64, 32, (3, 3), padding=(1, 1))
        self.Conv2d_3b_1x1 = FConv(80, 64, (1, 1))
        self.Conv2d_4a_3x3 = FConv(192, 80, (3, 3))
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048, pool_max=True)
        self.fc_w = nn.Parameter(torch.zeros(num_classes, 2048))
        self.fc_b = nn.Parameter(torch.zeros(num_classes))
        self.to(resolve_device(device))

    def init_weights(self, seed: int = 0) -> "InceptionV3":
        """The flax init's distributions, drawn on the CPU from ``seed``:
        conv weights N(0, 0.2 / fan_in), fc N(0, 0.01^2), zero biases."""
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith(".w"):
                    fan_in = p[0].numel()
                    p.copy_(torch.randn(p.shape, generator=gen) * np.sqrt(0.2 / fan_in))
                elif name == "fc_w":
                    p.copy_(torch.randn(p.shape, generator=gen) * 0.01)
                else:
                    p.zero_()
        return self

    def load_variables(self, variables) -> "InceptionV3":
        """The JAX package's InceptionV3 variables (convert_inception_v3's
        output: a nested mapping of arrays)."""
        self.load_state_dict(module_state_from_flax(variables), strict=True)
        return self

    def forward(self, x, return_features: bool = True, no_output_bias: bool = False):
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(_max_pool_3x3_s2(x)))
        x = _max_pool_3x3_s2(x)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        feat = x.mean((2, 3))   # the adaptive average pool -> [N, 2048]
        if return_features:
            return feat
        logits = feat @ self.fc_w.T
        if not no_output_bias:
            logits = logits + self.fc_b
        return torch.softmax(logits, dim=-1)

    @staticmethod
    def preprocess(images, in_range=(-1.0, 1.0)):
        """Any-size NCHW -> 299x299 in the net's [-1, 1]: bilinear with
        half-pixel centres and no antialiasing, as jax.image.resize(...,
        'linear', antialias=False) and the pytorch-fid pipe's F.interpolate
        (the flagship's 512^2 images are shrunk without widening the kernel)."""
        lo, hi = in_range
        x = (images - lo) * (2.0 / (hi - lo)) - 1.0
        if tuple(x.shape[-2:]) != (299, 299):
            x = resize(x, tuple(x.shape[:-2]) + (299, 299), method="bilinear", antialias=False)
        return x


def seeded_state_dict(seed: int = 0, num_classes: int = 1008, aux_logits: bool = False) -> dict:
    """A torchvision-named inception_v3 state_dict of numpy arrays drawn
    from ``seed``: each BasicConv2d's ``conv.weight`` (N(0, 2 / fan_in)) and
    ``bn.{weight, bias, running_mean, running_var}``, ``fc.{weight, bias}``,
    and with ``aux_logits`` an ``AuxLogits.*`` entry (which the converter
    drops). Activations keep their scale through the depth, so the features
    of seeded weights are not vanishingly small."""
    rng = np.random.RandomState(seed)
    sd = {}
    net = InceptionV3(num_classes=num_classes, device="meta")
    for name, mod in net.named_modules():
        if not isinstance(mod, FConv):
            continue
        shape = tuple(mod.w.shape)
        c = shape[0]
        fan_in = int(np.prod(shape[1:]))
        sd[f"{name}.conv.weight"] = (rng.randn(*shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
        sd[f"{name}.bn.weight"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        sd[f"{name}.bn.bias"] = (0.1 * rng.randn(c)).astype(np.float32)
        sd[f"{name}.bn.running_mean"] = (0.1 * rng.randn(c)).astype(np.float32)
        sd[f"{name}.bn.running_var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
    sd["fc.weight"] = (rng.randn(num_classes, 2048) * 0.01).astype(np.float32)
    sd["fc.bias"] = (0.1 * rng.randn(num_classes)).astype(np.float32)
    if aux_logits:
        sd["AuxLogits.conv0.conv.weight"] = rng.randn(128, 768, 1, 1).astype(np.float32)
        sd["AuxLogits.fc.weight"] = rng.randn(num_classes, 768).astype(np.float32)
    return sd
