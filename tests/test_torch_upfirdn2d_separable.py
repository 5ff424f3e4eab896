"""K4's row and column forms (csrc/upfirdn2d.cu) emulated on the CPU.

A filter of one row or one column at up = down = 1 (the equivariance
metrics' EQ-T_frac passes, eval/equivariance.py:apply_fractional_translation)
runs the row form (fh == 1: a warp stages a run of 128 outputs' inputs, zero
outside the image, and each lane sums its 4 outputs' taps from the staged
run) or the column form (fw == 1: a lane loads a strip of 16 output rows'
window, zero outside the image, and each output row sums its window). Both
sum an output's taps in order with fmaf from 0, as the generic kernel does.
Here that order runs in plain torch (an f32 product is exact in f64, so
each fmaf is the f64 sum rounded to f32) on numpy-seeded [2,3,37,41]
images, at the windowed sincs of a (0.3, 0.7) pixel shift and at a 1x8
filter (and its 8x1), and must match the port's upfirdn2d_plain and the JAX
package's filter2d within 1e-6 x max|out| (six to eight products an output,
summed in another order). And ops/upfirdn2d.py:k4_plan must send the
EQ-T_frac passes to these forms, keep every call of a tiny-config forward
(at triplane_depth 1 and 2) on the polyphase kernel, a 4x4 down=2 call on
the 4x4 form and a 3x3 filter on the generic kernel.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panic3d_tpu_torch import configs
from panic3d_tpu_torch.eval import equivariance as eqt

# the modules (the ops packages re-export their functions of the same name)
jup = importlib.import_module("panic3d_tpu.ops.upfirdn2d")
tup = importlib.import_module("panic3d_tpu_torch.ops.upfirdn2d")

ROW_RUN = 128    # outputs a warp of the row form (csrc/upfirdn2d.cu:ROW_RUN)
STRIP = 16       # output rows a lane of the column form (its scalar instantiation)


def fma(a, b, c):
    """fmaf in f32: the product exact in f64, one rounding of the sum."""
    return (a.double() * b.double() + c.double()).float()


def zero_padded(x, rows, cols):
    """x[..., rows, cols] (1-D index tensors), 0 where an index leaves the image."""
    h, w = x.shape[-2:]
    rin, cin = (rows >= 0) & (rows < h), (cols >= 0) & (cols < w)
    v = x.index_select(-2, rows.clamp(0, h - 1)).index_select(-1, cols.clamp(0, w - 1))
    return v * (rin[:, None] & cin[None, :]).to(x.dtype)


def row_form(x, f2d, pad):
    """upfirdn2d_rows_kernel: a run of ROW_RUN outputs of a row from its
    staged inputs s[j] = x[oy - py0, ox0 - px0 + j], each output's taps in
    order."""
    px0, px1, py0, py1 = pad
    fw = f2d.shape[1]
    h, w = x.shape[-2:]
    oh, ow = h + py0 + py1, w + px0 + px1 - fw + 1
    out = torch.empty(x.shape[:2] + (oh, ow))
    for ox0 in range(0, ow, ROW_RUN):
        run = min(ROW_RUN, ow - ox0)
        s = zero_padded(x, torch.arange(oh) - py0, ox0 - px0 + torch.arange(run + fw - 1))
        acc = torch.zeros(x.shape[:2] + (oh, run))
        for b in range(fw):
            acc = fma(f2d[0, b], s[..., b:b + run], acc)
        out[..., ox0:ox0 + run] = acc
    return out


def column_form(x, f2d, pad):
    """upfirdn2d_cols_kernel: a strip of STRIP output rows from its window
    of STRIP + fh - 1 input rows (each loaded once), each output row's taps
    in order."""
    px0, px1, py0, py1 = pad
    fh = f2d.shape[0]
    h, w = x.shape[-2:]
    oh, ow = h + py0 + py1 - fh + 1, w + px0 + px1
    out = torch.empty(x.shape[:2] + (oh, ow))
    for oy0 in range(0, oh, STRIP):
        rows = min(STRIP, oh - oy0)
        win = zero_padded(x, oy0 - py0 + torch.arange(rows + fh - 1), torch.arange(ow) - px0)
        for r in range(rows):
            acc = torch.zeros(x.shape[:2] + (ow,))
            for a in range(fh):
                acc = fma(f2d[a, 0], win[..., r + a, :], acc)
            out[..., oy0 + r, :] = acc
    return out


def windowed_sincs(fx, fy, a=3):
    """apply_fractional_translation's normalised 1x6 and 6x1 filters."""
    taps = torch.arange(a * 2, dtype=torch.float32) - (a - 1)
    fil_x = eqt.sinc(taps - fx) * eqt.sinc((taps - fx) / a)
    fil_y = eqt.sinc(taps - fy) * eqt.sinc((taps - fy) / a)
    return (fil_x / fil_x.sum())[None, :], (fil_y / fil_y.sum())[:, None]


def captured_passes(monkeypatch, fn):
    """The (x, f2d, up, down, pad) of every K4 call fn makes, by a spy on the
    function every upfirdn2d call goes through."""
    calls, fir = [], tup._fir

    def spy(x, f2d, up, down, pad):
        calls.append((x.clone(), f2d.clone(), tuple(up), tuple(down), tuple(pad)))
        return fir(x, f2d, up, down, pad)

    monkeypatch.setattr(tup, "_fir", spy)
    out = fn()
    monkeypatch.setattr(tup, "_fir", fir)
    return calls, out


def test_eq_t_frac_passes_take_the_row_and_column_forms(monkeypatch):
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 3, 37, 41).astype(np.float32))
    calls, _ = captured_passes(
        monkeypatch, lambda: eqt.apply_fractional_translation(x, 0.3 / 41, 0.7 / 37))
    assert [(tuple(f.shape), up, down) for _, f, up, down, _ in calls] == [
        ((1, 6), (1, 1), (1, 1)), ((6, 1), (1, 1), (1, 1))]
    assert [tup.k4_plan(f, up, down, pad).variant for _, f, up, down, pad in calls] == [
        "row", "column"]


def test_other_calls_keep_their_kernels():
    f = tup.setup_filter([1, 3, 3, 1])
    assert tup.k4_plan(f, (1, 1), (2, 2), (1, 1, 1, 1)).variant == "down2"   # the 4x4 form
    assert tup.k4_plan(f, (2, 2), (1, 1), (2, 1, 2, 1)).variant == "up2"
    # a 1-D pass that up- or downsamples, and a 2-D filter at up = down = 1
    f8 = tup.setup_filter(np.ones(8))
    for spec in tup.fir_passes(f8, up=2, padding=4) + tup.fir_passes(f8, down=2, padding=3):
        assert tup.k4_plan(*spec).variant == "generic", spec[1:]
    assert tup.k4_plan(f, (1, 1), (1, 1), (1, 2, 1, 2)).variant == "fir4"
    assert tup.k4_plan(f[:3, :3], (1, 1), (1, 1), (1, 1, 1, 1)).variant == "generic"


def tiny_forward_variants(monkeypatch, depth):
    """The K4 variants of every call of a tiny-config forward at
    triplane_depth ``depth``."""
    G = configs.tiny(device="cpu")
    if depth > 1:
        G = configs.tiny(device="cpu", rendering_kwargs=dict(G.rk, triplane_depth=depth))
    G = G.init_weights(0).eval()
    r = np.random.RandomState(0)
    x = {"z": torch.from_numpy(r.randn(1, G.z_dim).astype(np.float32)),
         "elevations": torch.zeros(1), "azimuths": torch.zeros(1),
         "cond": {"image_ortho_front": torch.from_numpy(r.rand(1, 3, 64, 64)).float(),
                  "resnet_chonk": torch.from_numpy(r.randn(1, 16, 8, 8)).float()}}
    with torch.no_grad():
        calls, _ = captured_passes(monkeypatch, lambda: G.f(x))
    assert len(calls) >= 8
    return {tup.k4_plan(f, up, down, pad).variant for _, f, up, down, pad in calls}


def test_every_tiny_forward_call_is_still_up2(monkeypatch):
    assert tiny_forward_variants(monkeypatch, 1) == {"up2"}


def test_every_tiny_deep_forward_call_is_still_up2(monkeypatch):
    assert tiny_forward_variants(monkeypatch, 2) == {"up2"}


F8 = np.random.RandomState(3).randn(8).astype(np.float32)


@pytest.mark.parametrize("case", ["sinc_x", "sinc_y", "fir8_row", "fir8_column", "fir8_crop"])
def test_form_order_matches_plain_and_jax(case):
    x_np = np.random.RandomState(1).randn(2, 3, 37, 41).astype(np.float32)
    fil_x, fil_y = windowed_sincs(0.3, 0.7)
    f, padding = {"sinc_x": (fil_x, [2, 3, 0, 0]), "sinc_y": (fil_y, [0, 0, 2, 3]),
                  "fir8_row": (torch.from_numpy(F8)[None, :], [3, 4, 0, 0]),
                  "fir8_column": (torch.from_numpy(F8)[:, None], [0, 0, 3, 4]),
                  "fir8_crop": (torch.from_numpy(F8)[None, :], [-2, 5, 1, -1])}[case]
    x = torch.from_numpy(x_np)
    (f2d, up, down, pad), = tup.fir_passes(
        f, padding=[padding[0] + f.shape[1] // 2, padding[1] + (f.shape[1] - 1) // 2,
                    padding[2] + f.shape[0] // 2, padding[3] + (f.shape[0] - 1) // 2])
    variant = tup.k4_plan(f2d, up, down, pad).variant
    assert variant == ("row" if f.shape[0] == 1 else "column")
    got = (row_form if variant == "row" else column_form)(x, f2d, pad)
    plain = tup.filter2d(x, f, padding=padding)
    want = np.asarray(jax.jit(lambda v: jup.filter2d(v, jnp.asarray(f.numpy()),
                                                     padding=padding))(jnp.asarray(x_np)))
    assert got.shape == plain.shape == want.shape
    tol = 1e-6 * float(plain.abs().max())
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=tol)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
