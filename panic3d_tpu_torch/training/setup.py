"""Wiring: the port's modules -> OrthoCondLoss callables
(panic3d_tpu/training/setup.py:21,101)."""

from __future__ import annotations

import torch

from ..eval.lpips import LPIPS
from ..models.dual_discriminator import DualDiscriminator
from ..models.triplane import TriPlaneGenerator
from .loss import LossConfig, OrthoCondLoss


def make_loss(G: TriPlaneGenerator, D: DualDiscriminator, lpips: LPIPS, cfg: LossConfig,
              noise_mode: str = "random", deterministic: bool = False) -> OrthoCondLoss:
    """The loss phases over G, D and the LPIPS net (whose weights take no
    gradient). ``noise_mode`` is the backbone's; the render and the noise
    draw from each phase's generator, unless ``deterministic`` pins the
    render to its key-free quadrature (midpoint depths, linspace u), which
    takes a noise mode that draws nothing. ``sample_mixed`` (the density
    regulariser) draws its noise from a generator seeded 0 at every call,
    as the JAX package keys it with PRNGKey(0)."""
    if deterministic and noise_mode == "random":
        raise NotImplementedError("deterministic=True takes noise_mode 'const' or 'none': the "
                                  "port's generator keys the noise and the render together")
    lpips.requires_grad_(False)

    def G_f(xin, generator):
        return G.f(xin, noise_mode=noise_mode, generator=None if deterministic else generator)

    def G_mapping(z, c, cond):
        return G.mapping(z, c, cond)

    def G_sample_mixed(coords, dirs, ws, cond):
        gen = (torch.Generator(device=G.device).manual_seed(0) if noise_mode == "random"
               else None)
        return G.sample_mixed(coords, dirs, ws, cond, noise_mode=noise_mode, generator=gen)

    def D_apply(img, c, cond, generator):
        return D(img, c, cond, generator=generator)

    return OrthoCondLoss(cfg, G_f, G_mapping, G_sample_mixed, D_apply, lpips)


def init_lpips(seed: int = 0, device=None) -> LPIPS:
    """A random-init LPIPS net (load converted weights with
    ``LPIPS.load_variables`` for real ones)."""
    return LPIPS(device=device).init_weights(seed)
