"""ADA augmentation pipeline (panic3d_tpu/training/augment.py).

Role of `src/training/augment.py` (StyleGAN2-ADA's AugmentPipe): the
probability-gated geometric, colour, image-filter, noise and cutout
augmentations of the discriminator's inputs, at a strength ``p`` that the
ADA heuristic tunes (training/loop.py:ada_update). The shipped PAniC-3D run
trains without it (--aug noaug); the trainer's --aug ada|fixed runs it.

The geometric warp is the reference's sym6-filtered stack (reflect pad ->
2x upsample through K4 -> the affine bilinear sample through K14 at 2x ->
2x downsample through K4, augment.py:273-308), with the JAX package's one
deviation: a static pad margin. ``AugmentConfig(filtered=False)`` takes one
bilinear resample (K14, align_corners=True) instead. The colour matrix,
the image filter (the sym2 filter bank, augment.py:176-185,382-411), the
noise and the cutout are exact.

Each draw comes from ``generator`` (a torch.Generator on the images'
device, or a utils/draws.Replay), one after the other in the JAX package's
order of calls, every gate and magnitude a draw of its own as in
StyleGAN2-ADA. The JAX package draws some from one key twice (ROADMAP F17:
the hue gate and angle share the scale's keys, saturation rotate's, each
colour gate its magnitude's, the noise gate its sigma's); replayed, its
draws give its outputs.
"""

from __future__ import annotations

import dataclasses
import math
import numpy as np
import torch
import torch.nn.functional as F

from ..ops.grid_sample import grid_sample_2d
from ..ops.upfirdn2d import downsample2d, setup_filter, upsample2d
from ..utils import draws
from ..utils.device import constant


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    xflip: float = 0.0
    rotate90: float = 0.0
    xint: float = 0.0
    xint_max: float = 0.125
    scale: float = 0.0
    rotate: float = 0.0
    aniso: float = 0.0
    xfrac: float = 0.0
    scale_std: float = 0.2
    rotate_max: float = 1.0
    aniso_std: float = 0.2
    xfrac_std: float = 0.125
    brightness: float = 0.0
    contrast: float = 0.0
    lumaflip: float = 0.0
    hue: float = 0.0
    saturation: float = 0.0
    brightness_std: float = 0.2
    contrast_std: float = 0.5
    hue_max: float = 1.0
    saturation_std: float = 1.0
    # the sym6 wavelet-filtered geometric warp (the reference's); False
    # takes one bilinear resample
    filtered: bool = True
    imgfilter: float = 0.0
    imgfilter_bands: tuple = (1.0, 1.0, 1.0, 1.0)
    imgfilter_std: float = 1.0
    noise: float = 0.0
    cutout: float = 0.0
    noise_std: float = 0.1
    cutout_size: float = 0.5

    @staticmethod
    def bgc():
        """The 'bgc' preset: blit + geometric + colour, all at strength 1."""
        return AugmentConfig(xflip=1, rotate90=1, xint=1, scale=1, rotate=1, aniso=1, xfrac=1,
                             brightness=1, contrast=1, lumaflip=1, hue=1, saturation=1)

    @staticmethod
    def bgcfnc():
        """The 'bgcfnc' preset: bgc + imgfilter + noise + cutout."""
        return dataclasses.replace(AugmentConfig.bgc(), imgfilter=1, noise=1, cutout=1)


# sym6 orthogonal-wavelet low-pass, the geometric warp's antialiasing filter
# (augment.py:42,174)
WAVELET_SYM6 = np.asarray([
    0.015404109327027373, 0.0034907120842174702, -0.11799011114819057,
    -0.048311742585633, 0.4910559419267466, 0.787641141030194,
    0.3379294217276218, -0.07263752278646252, -0.021060292512300564,
    0.04472490177066578, 0.0017677118642428036, -0.007800708325034148,
], dtype=np.float32)

# sym2 wavelet, the basis of the image-space filter bank (augment.py:38,176-185)
WAVELET_SYM2 = np.asarray([
    -0.12940952255092145, 0.22414386804185735, 0.836516303737469, 0.48296291314469025,
], dtype=np.float64)


def _make_fbank(num_bands: int = 4) -> np.ndarray:
    """The 4-band bandpass bank of the image filter (augment.py:176-185):
    band 0 the low-pass, bands 1..3 successive octaves through the
    quadrature-mirror high-pass."""
    hz_lo = WAVELET_SYM2
    hz_hi = hz_lo * ((-1.0) ** np.arange(hz_lo.size))
    hz_lo2 = np.convolve(hz_lo, hz_lo[::-1]) / 2
    hz_hi2 = np.convolve(hz_hi, hz_hi[::-1]) / 2
    fb = np.eye(num_bands, 1)
    for i in range(1, num_bands):
        # zero-interleave (upsample the band layout by 2), then refine
        fb = np.dstack([fb, np.zeros_like(fb)]).reshape(fb.shape[0], -1)[:, :-1]
        fb = np.stack([np.convolve(row, hz_lo2) for row in fb])
        lo = (fb.shape[1] - hz_hi2.size) // 2
        fb[i, lo:lo + hz_hi2.size] += hz_hi2
    return fb.astype(np.float32)


HZ_FBANK = _make_fbank()
# the expected 1/f power of each band (augment.py:385)
IMGFILTER_EXPECTED_POWER = np.asarray([10, 1, 1, 1], np.float32) / 13


def apply_imgfilter(images, gains):
    """The per-sample separable band-amplification filter (augment.py:400-411):
    gains [N,4] -> the 1-D filter gains @ HZ_FBANK, correlated along x and
    then y over the reflect-padded image, one filter a (sample, channel):
    grouped conv2d, as the JAX package's conv_general_dilated."""
    N, C, H, W = images.shape
    hz = gains @ _const(HZ_FBANK, images.device)                          # [N, taps]
    taps = HZ_FBANK.shape[1]
    pad = taps // 2
    w_h = hz[:, None, :].expand(N, C, taps).reshape(N * C, 1, 1, taps)
    x = F.pad(images, (pad, pad, pad, pad), mode="reflect")
    x = x.reshape(1, N * C, H + 2 * pad, W + 2 * pad)
    x = F.conv2d(x, w_h, groups=N * C)
    x = F.conv2d(x, w_h.reshape(N * C, 1, taps, 1), groups=N * C)
    return x.reshape(N, C, H, W)


def imgfilter_gains(generator, N: int, p: float, cfg: AugmentConfig, device):
    """The [N,4] band gains (augment.py:387-398): each band amplified by
    exp2(N(0, std)) with probability imgfilter * p * band, normalised
    against the expected 1/f spectrum."""
    power = _const(IMGFILTER_EXPECTED_POWER, device)
    gains = torch.ones((N, 4), device=device)
    for i, band_strength in enumerate(cfg.imgfilter_bands):
        t_i = torch.exp2(draws.normal((N,), generator, device, "imgfilter gain")
                         * cfg.imgfilter_std)
        on = draws.uniform((N,), generator, device, "imgfilter gate") < (
            cfg.imgfilter * p * band_strength)
        t = torch.ones((N, 4), device=device)
        t[:, i] = torch.where(on, t_i, torch.ones_like(t_i))
        gains = gains * (t / torch.sqrt((power * t ** 2).sum(-1, keepdim=True)))
    return gains


def _mat3(rows):
    """[N] entries (tensors or numbers) in rows -> [N,3,3]."""
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def _rot2(theta):
    c, s = torch.cos(theta), torch.sin(theta)
    z, o = torch.zeros_like(theta), torch.ones_like(theta)
    return _mat3([[c, -s, z], [s, c, z], [z, z, o]])


def _translate2(tx, ty):
    z, o = torch.zeros_like(tx), torch.ones_like(tx)
    return _mat3([[o, z, tx], [z, o, ty], [z, z, o]])


def _scale2(sx, sy):
    z, o = torch.zeros_like(sx), torch.ones_like(sx)
    return _mat3([[sx, z, z], [z, sy, z], [z, z, o]])


def _const(m, device):
    """An f32 constant on ``device``, made once per value (utils/device.py:
    a copy from the host would make it wait for the card)."""
    m = np.asarray(m)
    return constant(m.ravel(), device).reshape(m.shape)


def _affine_grid(G, ys, xs):
    """The sample points of the rows ``ys`` and columns ``xs`` through the
    [N,3,3] matrices G -> [N,len(ys),len(xs),2] (x, y)."""
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    grid = torch.stack([xx, yy, torch.ones_like(xx)], -1)
    return torch.einsum("nij,hwj->nhwi", G, grid)[..., :2]


def geometric_margin(W: int) -> int:
    """The static reflect-pad margin: min(W - 1, W / 4 + 2 Hz_pad) with
    Hz_pad = 3, the sym6 filter's quarter length (augment.py:214)."""
    return min(W - 1, W // 4 + (WAVELET_SYM6.shape[0] // 4) * 2)


def execute_geometric_filtered(images, Ginv_norm):
    """The reference's antialiased geometric warp (augment.py:273-308):
    reflect pad -> sym6-filtered 2x upsample -> the affine bilinear sample
    at 2x -> sym6-filtered 2x downsample with the crop. The pad margin is
    static (the JAX package's one deviation: points beyond it sample zeros,
    as the reference's clipped case does). ``Ginv_norm`` [N,3,3] maps the
    output to the input in align_corners=True normalised coordinates."""
    N, C, H, W = images.shape
    dev = images.device
    hz = setup_filter(WAVELET_SYM6)    # 1-D, separable (12 taps); on the host, as K4 reads it
    hz_pad = WAVELET_SYM6.shape[0] // 4                # = 3 (augment.py:284)
    m = geometric_margin(W)

    # normalised (align_corners=True) -> centred pixel units
    D = np.diag([(W - 1) / 2.0, (H - 1) / 2.0, 1.0])
    G = _const(D, dev) @ Ginv_norm @ _const(np.linalg.inv(D), dev)
    images = F.pad(images, (m, m, m, m), mode="reflect")

    # upsample (augment.py:297-300), the pixel-coordinate corrections as the
    # reference composes them
    images = upsample2d(images, hz, up=2)
    G = _const(np.diag([2.0, 2.0, 1.0]), dev) @ G @ _const(np.diag([0.5, 0.5, 1.0]), dev)
    T = np.eye(3)
    T[0, 2] = T[1, 2] = -0.5
    G = _const(T, dev) @ G @ _const(np.linalg.inv(T), dev)

    # the affine sample at 2x over the (H + 2 Hz_pad) target (augment.py:302-305)
    sh, sw = (H + hz_pad * 2) * 2, (W + hz_pad * 2) * 2
    h_up, w_up = images.shape[2], images.shape[3]
    G = (_const(np.diag([2.0 / w_up, 2.0 / h_up, 1.0]), dev) @ G
         @ _const(np.diag([sw / 2.0, sh / 2.0, 1.0]), dev))
    # torch affine_grid(align_corners=False)'s output coordinates: (2i + 1) / S - 1
    ys = (torch.arange(sh, dtype=torch.float32, device=dev) + 0.5) * 2 / sh - 1
    xs = (torch.arange(sw, dtype=torch.float32, device=dev) + 0.5) * 2 / sw - 1
    images = grid_sample_2d(images, _affine_grid(G, ys, xs), padding_mode="zeros",
                            align_corners=False)

    # downsample and crop (augment.py:308)
    return downsample2d(images, hz, down=2, padding=-hz_pad * 2, flip_filter=True)


def augment_pipe(images, generator, p: float, cfg: AugmentConfig = AugmentConfig.bgc()):
    """Apply the probability-``p`` augmentations of ``cfg`` to NCHW images
    in [-1, 1] (f32; C = 1 or a multiple of 3: a 6-channel joint pair takes
    the colour matrix on each triple), drawing from ``generator``."""
    N, C, H, W = images.shape
    dev = images.device
    G = torch.eye(3, device=dev).expand(N, 3, 3)

    def gate(prob, what):
        return draws.uniform((N,), generator, dev, f"{what} gate") < (prob * p)

    def normal(shape, what):
        return draws.normal(shape, generator, dev, what)

    def uniform(shape, what, minval=0.0, maxval=1.0):
        return draws.uniform(shape, generator, dev, what, minval, maxval)

    ones, zeros = torch.ones(N, device=dev), torch.zeros(N, device=dev)
    # geometric (accumulated into one affine)
    if cfg.xflip > 0:
        flip = gate(cfg.xflip, "xflip")
        G = _scale2(torch.where(flip, -ones, ones), ones) @ G
    if cfg.rotate90 > 0:
        on = gate(cfg.rotate90, "rotate90")
        quarter = draws.randint((N,), generator, dev, "rotate90 quarter", 0, 4)
        G = _rot2(torch.where(on, quarter.to(torch.float32) * (math.pi / 2), zeros)) @ G
    if cfg.xint > 0:
        on = gate(cfg.xint, "xint")[:, None]
        t = uniform((N, 2), "xint", -cfg.xint_max, cfg.xint_max)
        wh = _const([W, H], dev)
        t = torch.where(on, torch.round(t * wh) * 2 / wh, torch.zeros_like(t))
        G = _translate2(t[:, 0], t[:, 1]) @ G
    if cfg.scale > 0:
        on = gate(cfg.scale, "scale")
        s = torch.where(on, torch.exp2(normal((N,), "scale") * cfg.scale_std), ones)
        G = _scale2(s, s) @ G
    if cfg.rotate > 0:
        on = gate(cfg.rotate, "rotate")
        theta = uniform((N,), "rotate", -math.pi * cfg.rotate_max, math.pi * cfg.rotate_max)
        G = _rot2(torch.where(on, theta, zeros)) @ G
    if cfg.aniso > 0:
        on = gate(cfg.aniso, "aniso")
        s = torch.where(on, torch.exp2(normal((N,), "aniso") * cfg.aniso_std), ones)
        G = _scale2(s, 1 / s) @ G
    if cfg.xfrac > 0:
        on = gate(cfg.xfrac, "xfrac")[:, None]
        t = normal((N, 2), "xfrac") * cfg.xfrac_std
        t = torch.where(on, t, torch.zeros_like(t))
        G = _translate2(t[:, 0], t[:, 1]) @ G

    # resample through the inverse affine
    if cfg.xflip + cfg.rotate90 + cfg.xint + cfg.scale + cfg.rotate + cfg.aniso + cfg.xfrac > 0:
        Ginv = torch.linalg.inv_ex(G)[0]   # no check of the info: no wait for the card
        if cfg.filtered:
            images = execute_geometric_filtered(images, Ginv)
        else:
            # a corner-aligned grid (linspace(-1, 1)): align_corners=True
            warped = _affine_grid(Ginv, torch.linspace(-1, 1, H, device=dev),
                                  torch.linspace(-1, 1, W, device=dev))
            images = grid_sample_2d(images, warped, padding_mode="zeros", align_corners=True)

    # colour transforms (a 4x4 homogeneous colour matrix)
    eye4 = torch.eye(4, device=dev)
    Cm = eye4.expand(N, 4, 4)
    v = _const([1.0, 1.0, 1.0, 0.0], dev) / np.float32(np.sqrt(3))
    vv = torch.outer(v, v)
    if cfg.brightness > 0:
        on = gate(cfg.brightness, "brightness")
        b = torch.where(on, normal((N,), "brightness") * cfg.brightness_std, zeros)
        T = eye4.repeat(N, 1, 1)
        T[:, :3, 3] = b[:, None]
        Cm = T @ Cm
    if cfg.contrast > 0:
        on = gate(cfg.contrast, "contrast")
        c = torch.where(on, torch.exp2(normal((N,), "contrast") * cfg.contrast_std), ones)
        Cm = (eye4[None] * torch.stack([c, c, c, ones], -1)[:, :, None]) @ Cm
    if cfg.lumaflip > 0:
        on = gate(cfg.lumaflip, "lumaflip").to(torch.float32)[:, None, None]
        Cm = (eye4[None] * (1 - on) + (eye4 - 2 * vv)[None] * on) @ Cm
    if cfg.hue > 0:
        on = gate(cfg.hue, "hue")
        theta = uniform((N,), "hue", -math.pi * cfg.hue_max, math.pi * cfg.hue_max)
        theta = torch.where(on, theta, zeros)[:, None, None]
        # Rodrigues' rotation about the luma axis
        z = torch.zeros((), device=dev)
        K = torch.stack([torch.stack([z, -v[2], v[1], z]), torch.stack([v[2], z, -v[0], z]),
                         torch.stack([-v[1], v[0], z, z]), torch.stack([z, z, z, z])])
        Cm = (eye4[None] + torch.sin(theta) * K[None] + (1 - torch.cos(theta)) * (K @ K)[None]) @ Cm
    if cfg.saturation > 0:
        on = gate(cfg.saturation, "saturation")
        s = torch.where(on, torch.exp2(normal((N,), "saturation") * cfg.saturation_std), ones)
        Cm = (vv[None] + (eye4[None] - vv[None]) * s[:, None, None]) @ Cm

    if cfg.brightness + cfg.contrast + cfg.lumaflip + cfg.hue + cfg.saturation > 0:
        # the 3x3 + offset colour matrix on each RGB triple; a 6-channel
        # joint pair takes it on each triple (augment.py:364-376)
        flat = images.reshape(N, C, H * W)
        A, b = Cm[:, :3, :3], Cm[:, :3, 3:]
        if C == 3:
            out = A @ flat + b
        elif C == 1:
            cm1 = Cm[:, :3, :].mean(1, keepdim=True)
            out = flat * cm1[:, :, :3].sum(2, keepdim=True) + cm1[:, :, 3:]
        elif C % 3 == 0:
            out = torch.cat([A @ flat[:, i:i + 3] + b for i in range(0, C, 3)], 1)
        else:
            raise ValueError(f"the colour transforms take C = 1 or a multiple of 3, got {C}")
        images = out.reshape(N, C, H, W)

    # image-space filtering (frequency-band amplification, augment.py:382-411)
    if cfg.imgfilter > 0:
        images = apply_imgfilter(images, imgfilter_gains(generator, N, p, cfg, dev))

    # noise and cutout
    if cfg.noise > 0:
        on = gate(cfg.noise, "noise").to(torch.float32)[:, None, None, None]
        sigma = normal((N, 1, 1, 1), "noise sigma").abs() * cfg.noise_std
        images = images + normal(tuple(images.shape), "noise") * sigma * on
    if cfg.cutout > 0:
        on = gate(cfg.cutout, "cutout").to(torch.float32)[:, None, None, None]
        center = uniform((N, 2, 1, 1), "cutout centre")
        ys = torch.linspace(0, 1, H, device=dev)[None, :, None]
        xs = torch.linspace(0, 1, W, device=dev)[None, None, :]
        mask = (((ys - center[:, 0]).abs() < cfg.cutout_size / 2)
                & ((xs - center[:, 1]).abs() < cfg.cutout_size / 2)).to(torch.float32)[:, None]
        images = images * (1 - mask * on)
    return images
