"""K4's 1-D polyphase forms and its small 2-D form (csrc/upfirdn2d.cu)
emulated on the CPU.

A filter of one row at up or down 2 on x (y unscaled) runs the row form
("row_up2" / "row_down2"), a filter of one column at up or down 2 on y the
column form ("column_up2" / "column_down2"): at up 2 output 2m + r of the
scaled axis sums the taps of its parity, f[b0_r + 2i] x[m + s_r + i]
(b0_r = (p0 - r) mod 2, s_r from the host's phase table, make_poly), at
down 2 output o sums f[b] x[2o + b - p0]. Another 2-D filter of at most 4x4
at up = down = 1 runs the 4x4 form at its size ("fir_small"), a then b. Each
sums an output's nonzero taps in order with fmaf from 0, as the generic
kernel does, so the emulation of each form (an f32 product is exact in f64,
so each fmaf is the f64 sum rounded to f32) must equal the emulated generic
kernel bit for bit, on numpy-seeded images with odd sizes and crops. Both
must match the port's upfirdn2d_plain and the JAX package's upfirdn2d
(panic3d_tpu/ops/upfirdn2d.py:238) within 1e-6 x max|out| (a dozen
products an output, summed in another order). ops/upfirdn2d.py:k4_plan must
send the unfused K11 composition's 1x12 up=2 pass and its transpose, ADA's
sym6 passes (panic3d_tpu/training/augment.py:226,250) and a 3x3 to the new
forms, each form's transposed pass to a new form, and a 5x5 at up=2 to the
generic kernel.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jup = importlib.import_module("panic3d_tpu.ops.upfirdn2d")
jaug = importlib.import_module("panic3d_tpu.training.augment")
tup = importlib.import_module("panic3d_tpu_torch.ops.upfirdn2d")

SYM6 = jaug.WAVELET_SYM6
NEW_FORMS = {"row_up2", "row_down2", "column_up2", "column_down2", "fir_small"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def fma(a, b, c):
    """fmaf in f32: the product exact in f64, one rounding of the sum."""
    return (a.double() * b.double() + c.double()).float()


def taken(x, rows, cols):
    """x[..., rows, cols] (1-D index tensors), 0 where an index leaves the image."""
    h, w = x.shape[-2:]
    rin, cin = (rows >= 0) & (rows < h), (cols >= 0) & (cols < w)
    v = x.index_select(-2, rows.clamp(0, h - 1)).index_select(-1, cols.clamp(0, w - 1))
    return v * (rin[:, None] & cin[None, :]).to(x.dtype)


def out_size(x, f2d, up, down, pad):
    (upx, upy), (downx, downy), (px0, px1, py0, py1) = up, down, pad
    fh, fw = f2d.shape
    h, w = x.shape[-2:]
    return (h * upy + py0 + py1 - fh) // downy + 1, (w * upx + px0 + px1 - fw) // downx + 1


def generic_order(x, f2d, up, down, pad):
    """upfirdn2d_kernel: each output sums the taps a (rows) then b (columns)
    ascending that meet an input (not an inserted zero), fmaf from 0."""
    (upx, upy), (downx, downy), (px0, _, py0, _) = up, down, pad
    oh, ow = out_size(x, f2d, up, down, pad)
    oy, ox = torch.arange(oh), torch.arange(ow)
    acc = torch.zeros(x.shape[:-2] + (oh, ow))
    for a in range(f2d.shape[0]):
        Y = oy * downy + a - py0
        for b in range(f2d.shape[1]):
            X = ox * downx + b - px0
            use = ((Y % upy == 0)[:, None] & (X % upx == 0)[None, :])
            v = taken(x, torch.div(Y, upy, rounding_mode="floor"),
                      torch.div(X, upx, rounding_mode="floor"))
            acc = torch.where(use, fma(f2d[a, b], v, acc), acc)
    return acc


def make_poly(taps, p0, up2):
    """csrc/upfirdn2d.cu:make_poly: ([phase taps], s0, DS) at up 2, the taps
    in order at down 2."""
    n = len(taps)
    if not up2:
        return [list(taps)], 0, 0
    phases, s = [], []
    for r in (0, 1):
        b0 = (p0 - r) % 2
        phases.append([taps[b0 + 2 * i] for i in range((n - b0 + 1) // 2)] if b0 < n else [])
        s.append((r + b0 - p0) // 2)
    return phases, s[0], s[1] - s[0]


def poly_order(x, f2d, up, down, pad):
    """upfirdn2d_rows2_kernel / upfirdn2d_cols2_kernel, emulated on the
    scaled axis (the image transposed for the column form)."""
    rows = f2d.shape[0] == 1
    (upx, upy), (downx, downy), (px0, px1, py0, py1) = up, down, pad
    if not rows:   # the column form is the row form on the transposed image
        xt = x.transpose(-1, -2)
        out = poly_order(xt, f2d.T, (upy, upx), (downy, downx), (py0, py1, px0, px1))
        return out.transpose(-1, -2)
    taps = f2d[0].tolist()
    up2 = upx == 2
    phases, s0, ds = make_poly(taps, px0, up2)
    oh, ow = out_size(x, f2d, up, down, pad)
    iy = torch.arange(oh) - py0
    if up2:
        out = torch.zeros(x.shape[:-2] + (oh, ow))
        m = torch.arange((ow + 1) // 2)
        for r in (0, 1):
            acc = torch.zeros(x.shape[:-2] + (oh, len(m)))
            for i, tap in enumerate(phases[r]):
                acc = fma(torch.tensor(tap), taken(x, iy, m + s0 + r * ds + i), acc)
            cols = 2 * m + r
            keep = cols < ow
            out[..., cols[keep]] = acc[..., keep]
        return out
    acc = torch.zeros(x.shape[:-2] + (oh, ow))
    o = torch.arange(ow)
    for b, tap in enumerate(phases[0]):
        acc = fma(torch.tensor(tap), taken(x, iy, 2 * o + b - px0), acc)
    return acc


def small_order(x, f2d, up, down, pad):
    """upfirdn2d_fir4_kernel at FH x FW, up = down = 1: a then b, fmaf from 0."""
    px0, _, py0, _ = pad
    oh, ow = out_size(x, f2d, up, down, pad)
    oy, ox = torch.arange(oh), torch.arange(ow)
    acc = torch.zeros(x.shape[:-2] + (oh, ow))
    for a in range(f2d.shape[0]):
        for b in range(f2d.shape[1]):
            acc = fma(f2d[a, b], taken(x, oy + a - py0, ox + b - px0), acc)
    return acc


def k11_up_pass():
    k12 = np.kaiser(12, 8.0).astype(np.float32)
    return tup.fir_passes(torch.from_numpy(k12 / k12.sum()), up=2,
                          padding=[11, 10, 11, 10], gain=4)[0]


def ada_passes():
    """ADA's two sym6 calls (augment.py:226, :250) as their 1-D passes."""
    hz = tup.setup_filter(SYM6)
    return (tup.fir_passes(hz, up=2, padding=[6, 5, 6, 5], gain=4)
            + tup.fir_passes(hz, down=2, padding=[-1, -1, -1, -1], flip_filter=True))


def test_calls_take_the_new_forms():
    up = k11_up_pass()
    assert tup.k4_plan(*up).variant == "row_up2"
    assert tup.k4_plan(*tup.transposed_pass(*up, (276, 276), (276, 562))).variant == "row_down2"
    assert [tup.k4_plan(*spec).variant for spec in ada_passes()] == [
        "row_up2", "column_up2", "row_down2", "column_down2"]
    f3 = tup.setup_filter([1, 2, 1])
    assert tup.k4_plan(f3, (1, 1), (1, 1), (1, 1, 1, 1)).variant == "fir_small"
    assert tup.k4_plan(f3[:2], (1, 1), (1, 1), (0, 1, 1, 0)).variant == "fir_small"
    f5 = tup.setup_filter([1, 4, 6, 4, 1])
    assert tup.k4_plan(f5, (2, 2), (1, 1), (4, 3, 4, 3)).variant == "generic"
    # more than POLY_MAX_TAPS taps, and a 1-D pass scaled on its other axis
    f40 = torch.ones(1, 40) / 40
    assert tup.k4_plan(f40, (2, 1), (1, 1), (20, 19, 0, 0)).variant == "generic"
    assert tup.k4_plan(up[0], (1, 2), (1, 1), (5, 6, 1, 0)).variant == "generic"


@pytest.mark.parametrize("which", range(5))
def test_transposed_pass_takes_a_new_form(which):
    f3 = tup.setup_filter([1, 2, 1])
    spec = [k11_up_pass(), *ada_passes()[1:4:2], ada_passes()[2],
            (f3, (1, 1), (1, 1), (1, 1, 1, 1))][which]
    x = torch.zeros(1, 1, 23, 29)
    y = tup.upfirdn2d_plain(x, *spec)
    back = tup.transposed_pass(*spec, tuple(x.shape[2:]), tuple(y.shape[2:]))
    assert tup.k4_plan(*spec).variant in NEW_FORMS
    assert tup.k4_plan(*back).variant in NEW_FORMS
    assert tuple(tup.upfirdn2d_plain(y, *back).shape) == tuple(x.shape)


def cases():
    up = k11_up_pass()
    ada = ada_passes()
    f8 = torch.from_numpy(np.random.RandomState(3).randn(8).astype(np.float32))
    f3 = tup.setup_filter([1, 2, 1])
    return {
        "k11_up2": up,
        "k11_down2": tup.transposed_pass(*up, (37, 41), (37, 2 * 41 + 10)),
        "ada_up_x": ada[0], "ada_up_y": ada[1], "ada_down_x": ada[2], "ada_down_y": ada[3],
        "fir7_up2_odd_pad": (f8[None, :7], (2, 1), (1, 1), (3, -2, 0, 0)),
        "fir8_down2_crop": (f8[:, None], (1, 1), (1, 2), (0, 0, -3, 5)),
        "fir_small_3x3": (f3, (1, 1), (1, 1), (1, 1, 1, 1)),
        "fir_small_2x3": (f3[:2] * 2, (1, 1), (1, 1), (2, -1, 0, 1)),
    }


@pytest.mark.parametrize("case", list(cases()))
def test_form_order_equals_the_generic_kernel_and_matches_plain_and_jax(case):
    f2d, up, down, pad = cases()[case]
    x_np = np.random.RandomState(1).randn(2, 3, 37, 41).astype(np.float32)
    if case == "k11_down2":
        x_np = np.random.RandomState(1).randn(2, 3, 37, 2 * 41 + 10).astype(np.float32)
    x = torch.from_numpy(x_np)
    variant = tup.k4_plan(f2d, up, down, pad).variant
    assert variant in NEW_FORMS
    form = small_order if variant == "fir_small" else poly_order
    got = form(x, f2d, up, down, pad)
    assert torch.equal(got, generic_order(x, f2d, up, down, pad))
    plain = tup.upfirdn2d_plain(x, f2d, up, down, pad)
    # JAX's upfirdn2d takes the unflipped filter (it flips) and the pad list
    (upx, upy), (downx, downy), (px0, px1, py0, py1) = up, down, pad
    fj = jnp.asarray(f2d.flip([0, 1]).numpy())
    want = np.asarray(jax.jit(lambda v: jup.upfirdn2d(v, fj, up=(upx, upy), down=(downx, downy),
                                                      padding=[px0, px1, py0, py1]))(
        jnp.asarray(x_np)))
    assert got.shape == plain.shape == want.shape
    tol = 1e-6 * float(plain.abs().max())
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=tol)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


def test_ada_up_then_down_plain_matches_jax():
    """ADA's sym6 up=2 call then its down=2 call (with the flipped filter and
    the -6 crop, no warp between) on a small image: the port's plain passes
    against JAX's upsample2d / downsample2d within 1e-6 x max|out|."""
    x_np = np.random.RandomState(2).randn(2, 6, 24, 24).astype(np.float32)
    x = torch.from_numpy(x_np)
    y = tup.downsample2d(tup.upsample2d(x, tup.setup_filter(SYM6), up=2),
                         tup.setup_filter(SYM6), down=2, padding=-6, flip_filter=True)
    hz = jup.setup_filter(SYM6)
    want = np.asarray(jax.jit(lambda v: jup.downsample2d(jup.upsample2d(v, hz, up=2), hz, down=2,
                                                         padding=-6, flip_filter=True))(
        jnp.asarray(x_np)))
    assert tuple(y.shape) == want.shape == (2, 6, 18, 18)
    np.testing.assert_allclose(y.numpy(), want, rtol=0, atol=1e-6 * float(np.abs(want).max()))
