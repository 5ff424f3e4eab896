"""2-D eval metrics: PSNR and the CLIP image-image cosine similarity
(panic3d_tpu/eval/metrics2d.py).

CLIP is the openai ViT-B/32 image tower with its preprocessing (a bicubic,
antialiased resize to 224^2 with jax.image.resize's arithmetic, then the
CLIP mean and std). Its parameters carry the JAX package's flax names and
shapes (``block0.attn.in_proj_w``, ``block0.mlp_fc.kernel`` as [in, out],
...), so one ``.npz`` drives both packages. Without weights the tower is
seeded at random: structurally right, not comparable with the paper.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..configs import resolve_device
from ..ops.resize import resize
from ..runtime.checkpoint import load_flax_npz, module_state_from_flax

CLIP_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)


def psnr(pred, target, data_range: float = 1.0):
    """torchmetrics PeakSignalNoiseRatio: 10 log10(range^2 / mse) over the batch."""
    mse = torch.mean((pred - target) ** 2)
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp(mse, min=1e-12))


class _LayerNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return F.layer_norm(x, self.scale.shape, self.scale, self.bias, 1e-5)


class _Dense(nn.Module):
    def __init__(self, din: int, dout: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(din, dout))   # flax layout [in, out]
        self.bias = nn.Parameter(torch.zeros(dout))

    def forward(self, x):
        return x @ self.kernel + self.bias


class _MHA(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_w = nn.Parameter(torch.zeros(3 * dim, dim))
        self.in_proj_b = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj_w = nn.Parameter(torch.zeros(dim, dim))
        self.out_proj_b = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        B, N, D = x.shape
        H = self.heads
        hd = D // H
        q, k, v = (x @ self.in_proj_w.T + self.in_proj_b).chunk(3, dim=-1)

        def heads_split(t):
            return t.reshape(B, N, H, hd).permute(0, 2, 1, 3)

        q, k, v = map(heads_split, (q, k, v))
        att = torch.softmax(q @ k.transpose(-1, -2) / np.sqrt(hd), dim=-1)
        out = (att @ v).permute(0, 2, 1, 3).reshape(B, N, D)
        return out @ self.out_proj_w.T + self.out_proj_b


class _Block(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.ln_1 = _LayerNorm(dim)
        self.attn = _MHA(dim, heads)
        self.ln_2 = _LayerNorm(dim)
        self.mlp_fc = _Dense(dim, 4 * dim)
        self.mlp_proj = _Dense(4 * dim, dim)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        h = self.mlp_fc(self.ln_2(x))
        h = h * torch.sigmoid(1.702 * h)   # QuickGELU
        return x + self.mlp_proj(h)


class CLIPImageViT(nn.Module):
    """openai CLIP ViT-B/32 visual tower: [N,3,224,224] CLIP-normalised
    images -> [N,512] embeddings."""

    def __init__(self, dim: int = 768, layers: int = 12, heads: int = 12, patch: int = 32,
                 out_dim: int = 512, input_res: int = 224, device=None):
        super().__init__()
        self.dim, self.patch, self.layers = dim, patch, layers
        self.patch_embed = nn.Parameter(torch.zeros(dim, 3, patch, patch))
        self.class_embedding = nn.Parameter(torch.zeros(dim))
        self.positional_embedding = nn.Parameter(torch.zeros((input_res // patch) ** 2 + 1, dim))
        self.ln_pre = _LayerNorm(dim)
        for i in range(layers):
            self.add_module(f"block{i}", _Block(dim, heads))
        self.ln_post = _LayerNorm(dim)
        self.proj = nn.Parameter(torch.zeros(dim, out_dim))
        self.to(resolve_device(device))

    def init_weights(self, seed: int = 0) -> "CLIPImageViT":
        """N(0, 0.02) embeddings, attention weights and projection, Dense
        kernels N(0, 1 / fan_in), unit LayerNorms, zero biases, drawn on the
        CPU from ``seed`` (the flax init's distributions)."""
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for name, p in self.named_parameters():
                leaf = name.split(".")[-1]
                if leaf == "scale":
                    p.fill_(1.0)
                elif leaf.endswith("bias") or leaf.endswith("_b"):
                    p.zero_()
                elif leaf == "kernel":
                    p.copy_(torch.randn(p.shape, generator=gen) / np.sqrt(p.shape[0]))
                else:
                    p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
        return self

    def load_variables(self, variables) -> "CLIPImageViT":
        """The JAX package's CLIPImageViT variables (a nested mapping)."""
        self.load_state_dict(module_state_from_flax(variables), strict=True)
        return self

    def forward(self, img):
        N = img.shape[0]
        x = F.conv2d(img, self.patch_embed, stride=self.patch)
        x = x.reshape(N, self.dim, -1).transpose(1, 2)   # [N, L, D]
        x = torch.cat([self.class_embedding.expand(N, 1, self.dim), x], dim=1)
        x = self.ln_pre(x + self.positional_embedding)
        for i in range(self.layers):
            x = getattr(self, f"block{i}")(x)
        return self.ln_post(x[:, 0]) @ self.proj


class CLIPSimilarity:
    """measure.py:34-43: resize to 224, normalise, cosine similarity. With
    ``variables`` None the tower is seeded at random (``seed``)."""

    def __init__(self, variables=None, device=None, seed: int = 0):
        self.module = CLIPImageViT(device=device).eval()
        if variables is None:
            self.module.init_weights(seed)
            self.pretrained = False
        else:
            self.module.load_variables(variables)
            self.pretrained = True
        dev = self.module.proj.device
        self.mean = torch.from_numpy(CLIP_MEAN)[:, None, None].to(dev)
        self.std = torch.from_numpy(CLIP_STD)[:, None, None].to(dev)

    def embed(self, img):
        """img: [N,3,H,W] in [0,1] -> unit [N,512] embeddings."""
        img = resize(img, tuple(img.shape[:2]) + (224, 224), method="bicubic", antialias=True)
        with torch.no_grad():
            z = self.module((img - self.mean) / self.std)
        return z / torch.linalg.norm(z, dim=-1, keepdim=True)

    def __call__(self, a, b):
        za, zb = self.embed(a), self.embed(b)
        return torch.sum(za * zb, dim=-1)


def load_clip_params(path: str) -> dict:
    """Converted weights (.npz keyed by flax paths, runtime/convert.py) ->
    the variables tree {'params': ...} of numpy arrays."""
    return load_flax_npz(path)
