"""Model configurations (panic3d_tpu/configs.py): ``flagship`` is the
ecrutileE_eclustrousC 512^2 generator, ``tiny`` the CPU-sized test config.
Empty-space skipping (``ess=True``) is not ported yet; the flagship here
runs the reference's 96+96 quadrature in eval mode."""

from __future__ import annotations

from .models.triplane import TriPlaneGenerator

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


def flagship(eval_mode: bool = False, ess: bool = False, **overrides) -> TriPlaneGenerator:
    """The ecrutileE_eclustrousC 512^2 generator; eval_mode=True doubles the
    ray samples (96+96) and sets force_sigmoid (eg3dc_v0.py:30-31,55-56)."""
    if ess:
        raise NotImplementedError("empty-space skipping (ess=True) is not ported yet")
    rk = dict(FLAGSHIP_RENDERING_KWARGS)
    if eval_mode:
        rk["depth_resolution"] = 96
        rk["depth_resolution_importance"] = 96
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
    return TriPlaneGenerator(**kwargs)


def tiny(**overrides) -> TriPlaneGenerator:
    """Small config for tests and dry-runs (CPU-friendly)."""
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
    return TriPlaneGenerator(**kwargs)
