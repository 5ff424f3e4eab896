"""K1's tensor-core arithmetic, emulated on the CPU.

csrc/triplane_decode.cu runs the OSGDecoder's two layers on the tensor cores
in TF32 with the 3xTF32 split: each f32 operand v becomes hi = v rounded to
TF32 (cvt.rna: nearest, ties away from zero, 10 mantissa bits) and
lo = (v - hi) rounded to TF32, and a product is a_lo*w_hi + a_hi*w_lo +
a_hi*w_hi with f32 accumulation. Here the same rounding is done on the f32
bits and the three products are f32 matmuls; the emulated decode must stay
within the card's tolerances for K1 (sigma 1e-4, rgb 2^-8 in bf16, 1e-4 in
f32) of the f32 osg_decode and of the JAX OSGDecoder, and one TF32 pass
alone must not: that is why the kernel splits.

Flagship widths (C=32, 64 hidden, 33 outputs), one seeded set of weights at
the seeded flagship's scale (N(0,1) raw weights, lr_mul 1, zero biases but
the +2.5 sigma bias of chip_smoke.py), features N(0, 0.5^2) per plane (the
planes of chip_smoke.py's K1 check).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panic3d_tpu.models.triplane import OSGDecoder as JDecoder
from panic3d_tpu_torch.models.volumetric import renderer as tvr

C, HIDDEN, OUT = 32, 64, 33
SIGMA_TOL, RGB_BF16_TOL, RGB_F32_TOL = 1e-4, 2.0 ** -8, 1e-4


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value, ties away from zero (cvt.rna.tf32.f32):
    add half of the 13 dropped bits' weight to the magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    return ((bits & -0x80000000) | mag).view(torch.float32)


def matmul_3xtf32(a, w):
    a_hi = tf32_rna(a)
    a_lo = tf32_rna(a - a_hi)
    w_hi = tf32_rna(w)
    w_lo = tf32_rna(w - w_hi)
    return a_lo @ w_hi + a_hi @ w_lo + a_hi @ w_hi


def matmul_tf32(a, w):
    return tf32_rna(a) @ tf32_rna(w)


def decode(feats, dec, matmul):
    """osg_decode (renderer.py) with its two products replaced by ``matmul``."""
    x = feats.mean(dim=1)
    w0 = dec.w0 * (dec.lr_mul / np.sqrt(C))
    w1 = dec.w1 * (dec.lr_mul / np.sqrt(HIDDEN))
    x = tvr.softplus(matmul(x, w0.T) + dec.b0 * dec.lr_mul)
    x = matmul(x, w1.T) + dec.b1 * dec.lr_mul
    rgb = torch.sigmoid(x[..., 1:])
    if not dec.force_sigmoid:
        rgb = rgb * (1 + 2 * 0.001) - 0.001
    return rgb, x[..., 0:1]


@pytest.fixture(scope="module")
def case():
    r = np.random.RandomState(0)
    p = {"net0": {"weight": r.randn(HIDDEN, C).astype(np.float32),
                  "bias": np.zeros(HIDDEN, np.float32)},
         "net2": {"weight": r.randn(OUT, HIDDEN).astype(np.float32),
                  "bias": (np.eye(OUT)[0] * 2.5).astype(np.float32)}}
    feats = (r.randn(1, 3, 4096, C) * 0.5).astype(np.float32)
    return p, feats


def torch_decoder(p, force_sigmoid):
    t = torch.from_numpy
    return tvr.Decoder(t(p["net0"]["weight"]), t(p["net0"]["bias"]), t(p["net2"]["weight"]),
                       t(p["net2"]["bias"]), 1.0, force_sigmoid)


def errors(got, want):
    (rgb, sig), (rgb_w, sig_w) = got, want
    return (float((rgb - torch.as_tensor(np.array(rgb_w))).abs().max()),
            float((sig - torch.as_tensor(np.array(sig_w))).abs().max()))


def test_tf32_rounding_matches_cvt_rna():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -11 + 2.0 ** -20,
                      1.0 + 3 * 2.0 ** -11, -(1.0 + 2.0 ** -11), 3.0e-3, -7.25e5])
    # ties (the 2nd, 4th and 5th) round away from zero
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9,
                         -(1.0 + 2.0 ** -10)])
    hi = tf32_rna(x)
    assert torch.equal(hi[:5], want)
    assert (hi.view(torch.int32) & 0x1FFF).eq(0).all()
    assert float(((hi - x).abs() / x.abs()).max()) <= 2.0 ** -11
    lo = tf32_rna(x - hi)
    assert float(((hi + lo - x).abs() / x.abs()).max()) <= 2.0 ** -21


@pytest.mark.parametrize("force_sigmoid", [True, False], ids=["eval", "train_clamp"])
def test_3xtf32_decode_within_card_tolerances(case, force_sigmoid):
    p, feats_np = case
    dec = torch_decoder(p, force_sigmoid)
    feats = torch.from_numpy(feats_np)
    got = decode(feats, dec, matmul_3xtf32)
    f32 = tvr.osg_decode(feats, dec)
    jdec = JDecoder(C)
    params = {"params": jax.tree_util.tree_map(jnp.asarray, p)}
    jax_out = jdec.apply(params, jnp.asarray(feats_np), force_sigmoid=force_sigmoid)
    for want in (f32, jax_out):
        e_rgb, e_sig = errors(got, want)
        assert e_sig <= SIGMA_TOL, e_sig
        assert e_rgb <= RGB_F32_TOL, e_rgb
        # and the bf16 render form: the same rgb rounded to bf16 on both sides
        e_rgb16 = float((got[0].bfloat16().float()
                         - torch.as_tensor(np.array(want[0])).bfloat16().float()).abs().max())
        assert e_rgb16 <= RGB_BF16_TOL, e_rgb16


def test_one_tf32_pass_is_not_enough(case):
    p, feats_np = case
    dec = torch_decoder(p, True)
    feats = torch.from_numpy(feats_np)
    e_rgb, e_sig = errors(decode(feats, dec, matmul_tf32), tvr.osg_decode(feats, dec))
    assert e_sig > SIGMA_TOL, e_sig     # sigma leaves the card's tolerance
    e3_rgb, e3_sig = errors(decode(feats, dec, matmul_3xtf32), tvr.osg_decode(feats, dec))
    assert e3_sig < e_sig / 50, (e3_sig, e_sig)
