"""K4's 4x4 form (csrc/upfirdn2d.cu:upfirdn2d_fir4_kernel) emulated on the CPU.

A 4x4 filter at up 1 and down 2 on both axes (the discriminator's
downsample2d: models/stylegan2.py's skip images at padding 0, the dual
discriminator's image resize at padding -1) runs the "down2" form, and at
up = down = 1 (conv2d_resample's filter pass before a conv of stride 2)
the "fir4" form. tests/torch_fir4_form.py emulates the kernel's block plan
(ops/upfirdn2d.py:fir4_block_plan: the planes plan below 33 output columns,
else tiles whose windows are staged as 16-byte chunks of the flat tensor,
zero outside the image), with each lane summing its output's 16 taps from
its window in order, a then b, with fmaf from 0, as the generic kernel
does (an f32 product is exact in f64, so each fmaf is the f64 sum rounded
to f32), on numpy-seeded images, and must match the port's upfirdn2d_plain
and the JAX package's downsample2d / upfirdn2d within 1e-6 x max|out| in f32
(sixteen products an output, summed in another order), and in bf16 the
port's plain version within one bf16 ulp of max|out| (the f32 sums round to
bf16 at different sides of a tie). And ops/upfirdn2d.py:k4_plan must name
"down2" for the discriminator's downsample2d calls and "fir4" for
conv2d_resample's filter passes (tests/test_torch_upfirdn2d_separable.py
checks that every call of a tiny forward stays "up2").
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panic3d_tpu_torch.ops.conv import conv2d_resample
from torch_fir4_form import fir4_emulate

jup = importlib.import_module("panic3d_tpu.ops.upfirdn2d")
tup = importlib.import_module("panic3d_tpu_torch.ops.upfirdn2d")

def captured(monkeypatch, fn):
    """The (f2d, up, down, pad) of every K4 call fn makes, by a spy on the
    function every upfirdn2d call goes through, and fn's output."""
    calls, fir = [], tup._fir

    def spy(x, f2d, up, down, pad):
        calls.append((x.dtype, f2d.clone(), tuple(up), tuple(down), tuple(pad)))
        return fir(x, f2d, up, down, pad)

    monkeypatch.setattr(tup, "_fir", spy)
    out = fn()
    monkeypatch.setattr(tup, "_fir", fir)
    return calls, out


def fir4_form(x, f2d, down, pad):
    """The 4x4 form's outputs under its block plan (torch_fir4_form)."""
    return fir4_emulate(x, f2d, down, pad)[0]


FILT = [1, 3, 3, 1]


def discriminator_calls(monkeypatch, x):
    """K4's passes of the discriminator's downsample2d (padding 0, then the
    dual discriminator's padding -1 with the flipped filter) on x."""
    f = tup.setup_filter(FILT)
    calls, _ = captured(monkeypatch, lambda: (tup.downsample2d(x, f),
                                              tup.downsample2d(x, f, padding=-1,
                                                               flip_filter=True)))
    return calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_discriminator_downsamples_take_down2(monkeypatch, dtype):
    x = torch.zeros(2, 3, 42, 42, dtype=dtype)
    calls = discriminator_calls(monkeypatch, x)
    assert [(dt, tuple(f.shape), up, down, pad) for dt, f, up, down, pad in calls] == [
        (dtype, (4, 4), (1, 1), (2, 2), (1, 1, 1, 1)),
        (dtype, (4, 4), (1, 1), (2, 2), (0, 0, 0, 0))]
    assert {tup.k4_plan(f, up, down, pad).variant for _, f, up, down, pad in calls} == {"down2"}


def test_conv2d_resample_filter_passes_take_fir4(monkeypatch):
    """conv2d_resample at down 2: the 3x3 conv's filter pass (padding 2)
    and the 1x1 skip conv's (padding 1) run at up = down = 1."""
    x = torch.zeros(1, 4, 16, 16)
    calls, _ = captured(monkeypatch, lambda: (
        conv2d_resample(x, torch.zeros(4, 4, 3, 3), tup.setup_filter(FILT), down=2, padding=1),
        conv2d_resample(x, torch.zeros(4, 4, 1, 1), tup.setup_filter(FILT), down=2)))
    assert [(up, down, pad) for _, _, up, down, pad in calls] == [
        ((1, 1), (1, 1), (2, 2, 2, 2)), ((1, 1), (1, 1), (1, 1, 1, 1))]
    assert {tup.k4_plan(f, up, down, pad).variant for _, f, up, down, pad in calls} == {"fir4"}


CASES = {
    # (image, down, padding of the public call): the discriminator's skip
    # downsample (64-wide rows, 16-byte staging), the dual discriminator's
    # resize (2 x 20 + 2 wide rows: scalar staging), an odd width, and
    # conv2d_resample's filter passes
    "down2_pad0": ((2, 3, 64, 64), 2, 0),
    "down2_resize": ((2, 3, 42, 42), 2, -1),
    "down2_odd": ((1, 2, 37, 45), 2, 0),
    "fir4_pad2": ((2, 3, 40, 36), 1, 2),
    "fir4_pad1": ((1, 2, 33, 28), 1, 1),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_form_order_matches_plain_and_jax(case, dtype):
    shape, down, padding = CASES[case]
    x_np = np.random.RandomState(7).randn(*shape).astype(np.float32)
    x = torch.from_numpy(x_np).to(dtype)
    f = tup.setup_filter(FILT)
    flip = case == "down2_resize"
    if down == 2:
        public = lambda v: tup.downsample2d(v, f, padding=padding, flip_filter=flip)  # noqa: E731
        jax_fn = lambda v: jup.downsample2d(  # noqa: E731
            v, jup.setup_filter(FILT), padding=padding, flip_filter=flip)
    else:
        public = lambda v: tup.upfirdn2d(v, f, padding=padding)  # noqa: E731
        jax_fn = lambda v: jup.upfirdn2d(v, jup.setup_filter(FILT), padding=padding)  # noqa: E731
    (f2d, up, dn, pad), = [s for s in tup.fir_passes(
        f, down=down, flip_filter=flip,
        padding=[padding + (4 - down + 1) // 2, padding + (4 - down) // 2] * 2
        if down == 2 else padding)]
    assert tup.k4_plan(f2d, up, dn, pad).variant == ("down2" if down == 2 else "fir4")
    got = fir4_form(x, f2d, down, pad)
    plain = public(x)
    assert got.shape == plain.shape and got.dtype == plain.dtype == dtype
    top = float(plain.float().abs().max())
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=1e-6 * top)
        want = np.asarray(jax.jit(jax_fn)(jnp.asarray(x_np)))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * top)
    else:
        np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(), rtol=0,
                                   atol=2.0 ** -7 * top)
