"""Model configurations (panic3d_tpu/configs.py): ``flagship`` is the
ecrutileE_eclustrousC 512^2 generator, ``tiny`` the CPU-sized test config,
``from_snapshot_config`` the generator a trainer snapshot's config names.

Both build on the CUDA device unless the caller passes ``device="cpu"``
(or another device); without a CUDA device and without that argument they
raise, so nothing falls back to the CPU silently. Seeded weights
(``init_weights``) are drawn on the CPU and copied, so they are the same on
either device."""

from __future__ import annotations

import torch

from .models.triplane import TriPlaneGenerator


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else CUDA; raises when CUDA is asked for (or
    defaulted to) and no CUDA device is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU; pass device='cpu' to "
            "build the model on the CPU (plain PyTorch versions of the kernels)")
    return dev

FLAGSHIP_RENDERING_KWARGS = dict(
    image_resolution=512,
    disparity_space_sampling=False,
    clamp_mode="softplus",
    superresolution_module="training.superresolution.SuperresolutionHybrid8XDC",
    c_gen_conditioning_zero=True,
    gpc_reg_prob=None,
    c_scale=1.0,
    superresolution_noise_mode="none",
    density_reg=0.25,
    density_reg_p_dist=0.004,
    reg_type="l1",
    decoder_lr_mul=1.0,
    sr_antialias=True,
    white_back=True,
    triplane_depth=1,
    use_triplane=True,
    tanh_rgb_output=False,
    box_warp=0.7,
    ray_start=0.5,
    ray_end=1.5,
    depth_resolution=48,
    depth_resolution_importance=48,
)


def flagship(eval_mode: bool = False, ess: bool = False, device=None,
             **overrides) -> TriPlaneGenerator:
    """The ecrutileE_eclustrousC 512^2 generator; eval_mode=True doubles the
    ray samples (96+96) and sets force_sigmoid (eg3dc_v0.py:30-31,55-56).
    ess=True turns on empty-space skipping: a 32^3 occupancy grid narrows
    each ray to its occupied span, with 48+48 samples."""
    dev = resolve_device(device)
    return TriPlaneGenerator(**flagship_kwargs(eval_mode, ess, **overrides)).to(dev)


def flagship_kwargs(eval_mode: bool = False, ess: bool = False, **overrides) -> dict:
    """The flagship's TriPlaneGenerator constructor kwargs (see flagship)."""
    rk = dict(FLAGSHIP_RENDERING_KWARGS)
    if eval_mode:
        rk["depth_resolution"] = 96
        rk["depth_resolution_importance"] = 96
    if ess:
        rk["ess"] = dict(grid=32, taps=64, thresh=0.01, margin=1.0)
        rk["depth_resolution"] = 48
        rk["depth_resolution_importance"] = 48
    rk.update(overrides.pop("rendering_kwargs", {}))
    kwargs = dict(
        z_dim=512,
        c_dim=25,
        w_dim=512,
        img_resolution=512,
        img_channels=3,
        backbone_resolution=256,
        triplane_width=32,
        sr_channels_hidden=256,
        cond_mode="ortho_front.add_shuffle2_4.reschonk_add_512",
        mapping_kwargs=dict(num_layers=2),
        synthesis_kwargs=dict(channel_base=32768, channel_max=512),
        rendering_kwargs=rk,
        neural_rendering_resolution=64,
        force_sigmoid=eval_mode,
        sr_num_fp16_res=4,
    )
    kwargs.update(overrides)
    return kwargs


def from_snapshot_config(config, eval_mode: bool = False, ess: bool = False,
                         device=None) -> TriPlaneGenerator:
    """The generator a trainer snapshot was trained with
    (panic3d_tpu/configs.py:92-126): the snapshot config's ``model_kwargs``
    dict (family 'tiny' or 'flagship'), else the flat trainer args of older
    snapshots (``tiny``, or ``cond_mode`` with triplane_width,
    triplane_depth, backbone_resolution and resolution), else the default
    flagship; on ``device`` (CUDA by default)."""
    config = dict(config or {})
    mk = dict(config.get("model_kwargs") or {})
    family = mk.pop("family", "flagship")
    if config.get("model_kwargs") is not None:
        if family == "tiny":
            mk.setdefault("force_sigmoid", eval_mode)
            return tiny(device=device, **mk)
        return flagship(eval_mode=eval_mode, ess=ess, device=device, **mk)
    if config.get("tiny"):
        return tiny(cond_mode="ortho_front.add_4.reschonk_add_16", force_sigmoid=eval_mode,
                    device=device)
    if "cond_mode" in config:
        return flagship(
            eval_mode=eval_mode, ess=ess, device=device,
            cond_mode=config["cond_mode"],
            triplane_width=config.get("triplane_width", 32),
            backbone_resolution=config.get("backbone_resolution", 256),
            img_resolution=config.get("resolution", 512),
            rendering_kwargs=dict(triplane_depth=config.get("triplane_depth", 1)),
        )
    return flagship(eval_mode=eval_mode, ess=ess, device=device)


def tiny(device=None, **overrides) -> TriPlaneGenerator:
    """Small config for tests and dry-runs (CPU-friendly)."""
    dev = resolve_device(device)
    return TriPlaneGenerator(**tiny_kwargs(**overrides)).to(dev)


def tiny_kwargs(**overrides) -> dict:
    """The tiny config's TriPlaneGenerator constructor kwargs (see tiny)."""
    kwargs = dict(
        z_dim=64,
        c_dim=25,
        w_dim=64,
        img_resolution=128,
        img_channels=3,
        backbone_resolution=64,
        triplane_width=8,
        sr_channels_hidden=32,
        cond_mode="ortho_front.add_shuffle2_4.reschonk_add_16",
        mapping_kwargs=dict(num_layers=2),
        synthesis_kwargs=dict(channel_base=2048, channel_max=64),
        rendering_kwargs=dict(
            superresolution_module="training.superresolution.SuperresolutionHybrid2X",
            depth_resolution=8,
            depth_resolution_importance=8,
            box_warp=0.7,
            ray_start=0.5,
            ray_end=1.5,
            white_back=True,
            use_triplane=True,
        ),
        neural_rendering_resolution=16,
    )
    kwargs.update(overrides)
    return kwargs
