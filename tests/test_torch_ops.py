"""panic3d_tpu_torch ops vs their panic3d_tpu (JAX) counterparts on the CPU.

Same numpy-seeded inputs through both; the port takes its plain PyTorch
paths on CPU tensors. Tolerances, with their reasons, sit beside each check.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panic3d_tpu import ops as jops
from panic3d_tpu.models import stylegan2 as jsg
from panic3d_tpu.ops.grid_sample import grid_sample_2d_points as j_grid_sample
from panic3d_tpu_torch import ops as tops
from panic3d_tpu_torch.models import stylegan2 as tsg

torch.backends.cudnn.allow_tf32 = False

# the two sides run different conv algorithms (XLA vs ATen), so sums are
# taken in another order: 1e-4 abs/rel
OPS_TOL = dict(rtol=1e-4, atol=1e-4)
# elementwise or gather-and-lerp ops with the same formula on both sides
EXACT_TOL = dict(rtol=1e-5, atol=1e-6)


def rng(seed=0):
    return np.random.RandomState(seed)


def t(a):
    return torch.from_numpy(np.asarray(a))


def close(got, want, **tol):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize("act,gain,clamp", [
    ("linear", None, None),
    ("lrelu", None, 256.0),
    ("lrelu", 1.0, None),
    ("relu", None, None),
    ("tanh", None, None),
    ("sigmoid", None, None),
    ("softplus", None, None),
])
def test_bias_act(act, gain, clamp):
    r = rng(1)
    x = (r.randn(2, 5, 4, 4) * 100).astype(np.float32)
    b = r.randn(5).astype(np.float32)
    want = jops.bias_act(jnp.asarray(x), jnp.asarray(b), act=act, gain=gain, clamp=clamp)
    close(tops.bias_act(t(x), t(b), act=act, gain=gain, clamp=clamp), want, **EXACT_TOL)


# the parametrized cases of tests/test_ops.py:74-84
@pytest.mark.parametrize("up,down,padding", [
    (1, 1, 0),
    (2, 1, 1),
    (1, 2, 1),
    (2, 1, [2, 1, 1, 2]),
    (1, 2, [1, 2, 2, 1]),
    (1, 1, [-1, 2, 0, -1]),
    (2, 2, 3),
])
@pytest.mark.parametrize("flip_filter", [False, True])
def test_upfirdn2d(up, down, padding, flip_filter):
    x = rng(2).randn(2, 3, 8, 8).astype(np.float32)
    f = [1, 3, 3, 1]
    want = jops.upfirdn2d(jnp.asarray(x), jops.setup_filter(f), up=up, down=down,
                          padding=padding, flip_filter=flip_filter, gain=1.5)
    got = tops.upfirdn2d(t(x), tops.setup_filter(f), up=up, down=down, padding=padding,
                         flip_filter=flip_filter, gain=1.5)
    close(got, want, **OPS_TOL)


def test_upfirdn2d_separable_and_resample_helpers():
    x = rng(3).randn(1, 2, 10, 10).astype(np.float32)
    f1 = np.hanning(8)
    close(tops.upfirdn2d(t(x), tops.setup_filter(f1, separable=True), up=2, padding=3),
          jops.upfirdn2d(jnp.asarray(x), jops.setup_filter(f1, separable=True), up=2,
                         padding=3), **OPS_TOL)
    f = [1, 3, 3, 1]
    close(tops.upsample2d(t(x), tops.setup_filter(f)),
          jops.upsample2d(jnp.asarray(x), jops.setup_filter(f)), **OPS_TOL)
    close(tops.downsample2d(t(x), tops.setup_filter(f)),
          jops.downsample2d(jnp.asarray(x), jops.setup_filter(f)), **OPS_TOL)
    close(tops.filter2d(t(x), tops.setup_filter(f)),
          jops.filter2d(jnp.asarray(x), jops.setup_filter(f)), **OPS_TOL)


# conv2d_resample's padding arithmetic (conv.py:69-92): the 3x3 conv with
# up=2 and flip_weight=False is every upsampling SynthesisLayer's conv0
@pytest.mark.parametrize("k,up,down,padding,flip_weight", [
    (3, 1, 1, 1, True),
    (3, 2, 1, 1, False),
    (1, 1, 1, 0, True),
    (3, 1, 2, 1, True),
    (3, 2, 1, [1, 0, 2, 1], False),
])
def test_conv2d_resample(k, up, down, padding, flip_weight):
    r = rng(4)
    x = r.randn(2, 4, 8, 8).astype(np.float32)
    w = r.randn(5, 4, k, k).astype(np.float32)
    f = [1, 3, 3, 1]
    want = jops.conv2d_resample(jnp.asarray(x), jnp.asarray(w), f=jops.setup_filter(f),
                                up=up, down=down, padding=padding, flip_weight=flip_weight)
    got = tops.conv2d_resample(t(x), t(w), f=tops.setup_filter(f), up=up, down=down,
                               padding=padding, flip_weight=flip_weight)
    close(got, want, **OPS_TOL)


@pytest.mark.parametrize("up,demodulate,noise", [
    (1, True, True),
    (2, True, False),
    (1, False, False),
])
def test_modulated_conv2d(up, demodulate, noise):
    r = rng(5)
    x = r.randn(2, 4, 8, 8).astype(np.float32)
    w = r.randn(6, 4, 3, 3).astype(np.float32)
    s = (r.randn(2, 4) + 1).astype(np.float32)
    nz = r.randn(8 * up, 8 * up).astype(np.float32) * 0.3 if noise else None
    f = [1, 3, 3, 1]
    want = jops.modulated_conv2d(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(s),
        noise=None if nz is None else jnp.asarray(nz), up=up, padding=1,
        resample_filter=jops.setup_filter(f), demodulate=demodulate,
        flip_weight=(up == 1))
    got = tops.modulated_conv2d(
        t(x), t(w), t(s), noise=None if nz is None else t(nz), up=up, padding=1,
        resample_filter=tops.setup_filter(f), demodulate=demodulate,
        flip_weight=(up == 1))
    close(got, want, **OPS_TOL)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_grid_sample_2d_points(dtype):
    r = rng(6)
    planes = r.randn(3, 5, 9, 7).astype(np.float32)
    pts = r.uniform(-1.2, 1.2, (3, 50, 2)).astype(dtype)   # some points off the plane
    want = j_grid_sample(jnp.asarray(planes), jnp.asarray(pts), padding_mode="zeros")
    close(tops.grid_sample_2d_points(t(planes), t(pts)), want, **EXACT_TOL)


# resize_bilinear is jax.image.resize in the JAX package and F.interpolate
# here: the cond-image downsample 512 -> 4..64 (stylegan2.py:601, no
# antialias), the flagship SR upsample 64 -> 128 (superresolution.py:91-94)
# and the tiny SR upsample 16 -> 64 with antialias=True
@pytest.mark.parametrize("src,dst,antialias", [
    (512, 4, False), (512, 16, False), (512, 32, False), (512, 64, False),
    (64, 128, False), (16, 64, True),
])
def test_resize_bilinear(src, dst, antialias):
    x = rng(7).rand(1, 3, src, src).astype(np.float32)
    want = jsg.resize_bilinear(jnp.asarray(x), dst, antialias=antialias)
    close(tsg.resize_bilinear(t(x), dst, antialias=antialias), want, **EXACT_TOL)


# _apply_cond, including add_shuffle2_4's pixel-shuffle order
# (stylegan2.py:604-610) at fold factors 2 and 4, against the JAX method
@pytest.mark.parametrize("cond_size", [64, 128])
@pytest.mark.parametrize("res,lvl", [(8, 1), (16, 2), (32, 3), (64, 4)])
def test_apply_cond(cond_size, res, lvl):
    cm = "ortho_front.add_shuffle2_4.reschonk_add_16"
    base = 8192
    r = rng(8 + lvl)
    ch = min(base // res, 512)
    x = r.randn(2, ch, res, res).astype(np.float32)
    cond = {"image_ortho_front": r.rand(2, 3, cond_size, cond_size).astype(np.float32),
            "resnet_chonk": r.randn(2, 16, 8, 8).astype(np.float32)}
    jnet = jsg.SynthesisNetwork(w_dim=8, img_resolution=64, img_channels=6, cond_mode=cm,
                                channel_base=base)
    want, _ = jnet._apply_cond(jnp.asarray(x), None,
                               jax.tree_util.tree_map(jnp.asarray, cond),
                               set(cm.split(".")), 16, res, lvl, 5)
    tnet = tsg.SynthesisNetwork(w_dim=8, img_resolution=64, img_channels=6, cond_mode=cm,
                                channel_base=base)
    got = tnet._apply_cond(t(x), {k: t(v) for k, v in cond.items()}, res, lvl, 5)
    close(got, want, **EXACT_TOL)


def test_pixel_shuffle_fold_order():
    img = torch.arange(2 * 3 * 4 * 4, dtype=torch.float32).reshape(2, 3, 4, 4)
    out = tsg.pixel_shuffle_fold(img, 2)
    # channel (dy*2 + dx)*C + c of block (i, j) holds pixel (2i+dy, 2j+dx) of channel c
    for dy in range(2):
        for dx in range(2):
            for c in range(3):
                assert torch.equal(out[:, (dy * 2 + dx) * 3 + c], img[:, c, dy::2, dx::2])
