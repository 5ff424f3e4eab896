"""ResNet50 trunk (the danbooru tagger's backbone) and the PCA feature
extractor (panic3d_tpu/models/resnet.py).

torchvision resnet50 with stage taps conv1 .. layer4 (64 / 256 / 512 / 1024
/ 2048 channels), and the PCA projection that makes ``resnet_chonk``
(per-pixel 2048 -> 512 on the 8x8 layer4 map, the image and its h-flip
stacked) and ``resnet_feats``. The parameters carry the JAX package's flax
names and shapes (``stem.w``, ``layer1_0.conv1.bn.scale``, the running
statistics as ``...bn.mean`` / ``...bn.var`` buffers, ``fc_w``), so a flax
variable tree loads through ``runtime/checkpoint.py:module_state_from_flax``.
The convolutions stay with cuDNN.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..configs import resolve_device
from ..ops.resize import resize
from ..runtime.checkpoint import load_checkpoint, module_state_from_flax

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], dtype=np.float32)
CHANNELS = [64, 256, 512, 1024, 2048]
_LAYOUT = [(64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)]   # width, blocks, stride


class _BN(nn.Module):
    """Inference BatchNorm with flax's names: scale, bias and the running
    mean and var."""

    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x):
        return F.batch_norm(x, self.mean, self.var, self.scale, self.bias, False, 0.0, 1e-5)


class _ConvBN(nn.Module):
    def __init__(self, cout: int, cin: int, k: int, stride: int = 1, padding: int = 0):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.w = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.bn = _BN(cout)

    def forward(self, x):
        return self.bn(F.conv2d(x, self.w, stride=self.stride, padding=self.padding))


class Bottleneck(nn.Module):
    def __init__(self, cin: int, width: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = _ConvBN(width, cin, 1)
        self.conv2 = _ConvBN(width, width, 3, stride, 1)
        self.conv3 = _ConvBN(width * 4, width, 1)
        self.downsample = _ConvBN(width * 4, cin, 1, stride) if downsample else None

    def forward(self, x):
        out = F.relu(self.conv1(x))
        out = F.relu(self.conv2(out))
        out = self.conv3(out)
        identity = self.downsample(x) if self.downsample is not None else x
        return F.relu(out + identity)


class ResNet50(nn.Module):
    """torchvision resnet50 trunk with stage taps."""

    def __init__(self, num_classes: int = 1000, device=None):
        super().__init__()
        self.stem = _ConvBN(64, 3, 7, 2, 3)
        cin = 64
        self.blocks = []
        for li, (width, blocks, stride) in enumerate(_LAYOUT, start=1):
            for bi in range(blocks):
                name = f"layer{li}_{bi}"
                self.add_module(name, Bottleneck(cin, width, stride if bi == 0 else 1, bi == 0))
                self.blocks.append((li, name))
                cin = width * 4
        self.fc_w = nn.Parameter(torch.zeros(num_classes, 2048))
        self.fc_b = nn.Parameter(torch.zeros(num_classes))
        self.to(resolve_device(device))

    def init_weights(self, seed: int = 0) -> "ResNet50":
        """He-normal convolutions, unit BatchNorms with zero running mean
        and unit variance, fc N(0, 0.01), zero biases: drawn on the CPU from
        ``seed`` (the flax init's distributions)."""
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith(".w"):
                    fan_in = p.shape[1] * p.shape[2] * p.shape[3]
                    p.copy_(torch.randn(p.shape, generator=gen) * np.sqrt(2.0 / fan_in))
                elif name == "fc_w":
                    p.copy_(torch.randn(p.shape, generator=gen) * 0.01)
                elif name.endswith("scale"):
                    p.fill_(1.0)
                else:
                    p.zero_()
            for name, b in self.named_buffers():
                b.fill_(1.0 if name.endswith("var") else 0.0)
        return self

    def load_variables(self, variables) -> "ResNet50":
        """The JAX package's ResNet50 variables ('params' and 'batch_stats')."""
        self.load_state_dict(module_state_from_flax(variables), strict=True)
        return self

    def forward(self, x, return_taps: bool = True):
        taps = {}
        x = F.relu(self.stem(x))
        taps["conv1"] = x
        x = F.max_pool2d(x, 3, 2, padding=1)
        for i, (li, name) in enumerate(self.blocks):
            x = getattr(self, name)(x)
            if i + 1 == len(self.blocks) or self.blocks[i + 1][0] != li:
                taps[f"layer{li}"] = x
        x = x.mean((2, 3))
        taps["avgpool"] = x
        logits = x @ self.fc_w.T + self.fc_b
        taps["fc"] = logits
        return taps if return_taps else logits


class ResnetFeatureExtractorPCA:
    """katepca.py:6-28: image (+ h-flip) -> layer4 8x8 -> per-pixel PCA.

    pca_components: [dim_out, 2048]; pca_mean: [2048]. Input image:
    [3,H,W] float in [0,1], composited on BLACK (katepca uses .bg('k')),
    resized to 256^2 and ImageNet-normalised by ``preprocess``.
    """

    def __init__(self, resnet: ResNet50, pca_components, pca_mean, dim_out: int = 512):
        self.resnet = resnet.eval()
        dev = resnet.fc_w.device
        self.pw = torch.as_tensor(np.asarray(pca_components[:dim_out], np.float32)).to(dev)
        self.pb = torch.as_tensor(np.asarray(pca_mean, np.float32)).to(dev)
        self.mean = torch.from_numpy(IMAGENET_MEAN)[:, None, None].to(dev)
        self.std = torch.from_numpy(IMAGENET_STD)[:, None, None].to(dev)

    def preprocess(self, img):
        # the reference extractor resizes to 256 internally
        # (katebackbone.py: tv.transforms.Resize), so layer4 is always 8x8
        if img.shape[-1] != 256 or img.shape[-2] != 256:
            img = resize(img, tuple(img.shape[:-2]) + (256, 256), method="bilinear",
                         antialias=img.shape[-1] > 256)
        return (img - self.mean) / self.std

    def _taps(self, img):
        x = self.preprocess(torch.as_tensor(img, dtype=torch.float32).to(self.pw.device))
        with torch.no_grad():
            return self.resnet(torch.stack([x, torch.flip(x, dims=(-1,))]), return_taps=True)

    def __call__(self, img):
        """img: [3,H,W] in [0,1] -> chonk [2, D, 8, 8] (original, flipped)."""
        feats = self._taps(img)["layer4"]   # [2, 2048, 8, 8]
        return torch.einsum("dc,nchw->ndhw", self.pw, feats - self.pb[None, :, None, None])

    def global_feats(self, img):
        """resnet_feats: PCA of the pooled layer4 vector, original + flip."""
        pooled = self._taps(img)["avgpool"]   # [2, 2048]
        return (pooled - self.pb[None]) @ self.pw.T


def random_feature_extractor(seed: int = 0, device=None) -> ResnetFeatureExtractorPCA:
    """The extractor eval generate builds without a ResNet checkpoint
    (generate.py:393-412): a seeded ResNet50 and a N(0, 1) PCA basis from
    numpy's RandomState(seed) (as the JAX CLI draws it) with a zero mean."""
    rng = np.random.RandomState(seed)
    return ResnetFeatureExtractorPCA(
        ResNet50(device=device).init_weights(seed), rng.randn(512, 2048).astype(np.float32),
        np.zeros(2048, np.float32), 512)


def load_pca_extractor(path: str, dim_out: int = 512, device=None) -> ResnetFeatureExtractorPCA:
    """A converted ResNet + PCA checkpoint directory (``state.msgpack`` of the
    ResNet50 variables and ``pca.npz`` with 'components' [D, 2048] and
    'mean' [2048], as panic3d_tpu/models/resnet.py:168-181 reads it) -> the
    extractor, on ``device`` (CUDA by default)."""
    import os

    variables, _ = load_checkpoint(path)
    pca = np.load(os.path.join(path, "pca.npz"))
    return ResnetFeatureExtractorPCA(ResNet50(device=device).load_variables(variables),
                                     pca["components"], pca["mean"], dim_out)
