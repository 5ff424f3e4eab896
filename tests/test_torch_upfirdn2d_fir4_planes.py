"""K4's 4x4 form's block plans (ops/upfirdn2d.py:fir4_block_plan) emulated on the CPU.

Training's 4x4-form calls at 512 channels have outputs of 4^2 to 16^2 (the
transposed passes of the generator's up=2 calls and of the discriminator's
filter passes at b8, and those filter passes themselves): the "planes"
plan, a thread a column of a strip of one plane, many planes a block. Its
large calls (the SR's [8,256,514,514] down=2 transposed pass, b512's
[8,64,513,513] and [8,64,511,511] filter passes), whose rows are not
16-byte aligned, take the "flat" plan, windows staged as 16-byte chunks of
the flat tensor, so rows of any width stage vector-wise; aligned rows take
"rows", and unaligned rows of few tiles "rows_scalar" (the rows plan's
tiles staged element by element). tests/torch_fir4_form.py emulates each plan thread by thread (every
output written once, every tap inside its window) in the
kernel's tap order, and the outputs must match the port's upfirdn2d_plain
and the JAX package's upfirdn2d within 1e-6 x max|out| in f32 and one bf16
ulp of max|out| in bf16 (sixteen products an output, summed in another
order; bf16 ties round to either side). The small calls run at 2 x 3
planes under the plan of the same call at training's 8 x 512 (a plan
covers each plane alike).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_fir4_form import fir4_emulate
from torch_one_thread import torch_one_thread  # noqa: F401  (autouse)

jup = importlib.import_module("panic3d_tpu.ops.upfirdn2d")
tup = importlib.import_module("panic3d_tpu_torch.ops.upfirdn2d")

FILT = [1, 3, 3, 1]
TRAIN_NC = 8 * 512   # training's batch x channels at the discriminator's and generator's 4^2..16^2


def forward_spec(kind, hw, pad):
    """(f2d, up, down, pad) of a forward call: the generator's up=2
    (conv2d_resample, 3x3 conv: padding (3, 2, 3, 2), gain 4) or the
    discriminator's filter pass (padding 2: 3x3 conv, 1: 1x1 skip)."""
    f = tup.setup_filter(FILT)
    if kind == "up2":
        return tup.fir_passes(f, up=2, padding=[3, 2, 3, 2], gain=4)[0]
    return tup.fir_passes(f, padding=pad)[0]


def transposed(kind, hw, pad=0):
    """The transposed pass of a forward call on hw x hw -> (input hw, spec)."""
    spec = forward_spec(kind, hw, pad)
    f2d, up, down, p = spec
    oh, ow = tup._out_size(hw, hw, 4, 4, up, down, p)
    return (oh, ow), tup.transposed_pass(f2d, up, down, p, (hw, hw), (oh, ow))


CASES = {
    # training's small calls at 512 channels (bf16 at the generator's 32^2
    # block, f32 below): the transposed passes of the up=2 calls on 16^2,
    # 8^2, 4^2 (34^2 -> 16^2, 18^2 -> 8^2, 10^2 -> 4^2) and of b8's filter
    # passes (9^2 -> 8^2, 7^2 -> 8^2), and those filter passes forward
    "grad_down2_34": ("grad", "up2", 16, 0, torch.bfloat16),
    "grad_down2_18": ("grad", "up2", 8, 0, torch.float32),
    "grad_down2_10": ("grad", "up2", 4, 0, torch.float32),
    "grad_fir4_9": ("grad", "fir4", 8, 2, torch.float32),
    "grad_fir4_7": ("grad", "fir4", 8, 1, torch.float32),
    "fir4_8_pad2": ("forward", "fir4", 8, 2, torch.float32),
    "fir4_8_pad1": ("forward", "fir4", 8, 1, torch.float32),
}


def jax_upfirdn2d(x_np, f2d, down, pad):
    """The JAX package's upfirdn2d at the same correlation (f2d already
    flipped and gained, so flip_filter=True), jitted once per shape."""
    fn = jax.jit(lambda v: jup.upfirdn2d(v, jnp.asarray(f2d.numpy()), down=down,
                                         padding=list(pad), flip_filter=True))
    return np.asarray(fn(jnp.asarray(x_np)))


def hold(got, x, spec, x_np):
    """got against upfirdn2d_plain and JAX's upfirdn2d (tolerances above)."""
    f2d, up, down, pad = spec
    plain = tup.upfirdn2d_plain(x, *spec)
    assert got.shape == plain.shape and got.dtype == plain.dtype == x.dtype
    top = float(plain.float().abs().max())
    tol = 1e-6 * top if x.dtype == torch.float32 else 2.0 ** -7 * top
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(), rtol=0, atol=tol)
    want = jax_upfirdn2d(x.float().numpy(), f2d, down[0], pad)
    if x.dtype == torch.bfloat16:
        want = torch.from_numpy(np.array(want)).to(torch.bfloat16).float().numpy()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("case", list(CASES))
def test_small_plane_calls(case):
    direction, kind, hw, pad, dtype = CASES[case]
    if direction == "grad":
        (h, w), spec = transposed(kind, hw, pad)
    else:
        (h, w), spec = (hw, hw), forward_spec(kind, hw, pad)
    f2d, up, down, p = spec
    assert up == (1, 1) and tup.k4_plan(*spec).variant == ("down2" if down == (2, 2) else "fir4")
    oh, ow = tup._out_size(h, w, 4, 4, up, down, p)
    plan = tup.fir4_block_plan(TRAIN_NC, h, w, oh, ow, down[0], dtype)
    assert plan.plan == "planes"
    x_np = np.random.RandomState(11).randn(2, 3, h, w).astype(np.float32)
    x = torch.from_numpy(x_np).to(dtype)
    got, _ = fir4_emulate(x, f2d, down[0], p, plan)
    hold(got, x, spec, x_np)


LARGE = {
    # planes larger than a tile: several tiles across and down, edge tiles;
    # widths whose rows start at every chunk offset (134 = 6 mod 8, 131 odd,
    # 150 = 2 mod 4), so each staged row has its own offset; a 3x3
    # ("fir_small"); and inputs whose data lies 1 or 3 elements past a
    # 16-byte boundary (a view into a larger storage)
    "grad_down2_bf16": ((1, 2, 70, 134), "grad", torch.bfloat16, 0),
    "grad_down2_bf16_tall": ((1, 2, 70, 134), "grad", torch.bfloat16, "tall"),
    "grad_fir4_bf16_pad1": ((1, 2, 67, 131), "grad1", torch.bfloat16, 0),
    "grad_fir4_bf16_pad2": ((1, 2, 65, 129), "grad2", torch.bfloat16, 0),
    "down2_f32_pad1": ((1, 2, 66, 150), "down2", torch.float32, 0),
    "fir_small_3x3_f32": ((1, 2, 40, 70), "3x3", torch.float32, 0),
    "grad_down2_bf16_shift1": ((1, 2, 70, 134), "grad", torch.bfloat16, 1),
    "grad_fir4_f32_shift3": ((1, 2, 67, 131), "grad1", torch.float32, 3),
    # 16-byte aligned rows: the rows plan
    "down2_bf16_aligned": ((1, 2, 66, 128), "down2", torch.bfloat16, 0),
    "grad_fir4_f32_aligned": ((1, 2, 65, 132), "grad2", torch.float32, 0),
}


def large_spec(kind, h, w):
    f = tup.setup_filter(FILT)
    if kind == "grad":       # the transposed pass of an up=2 call on (h - 2) / 2
        f2d, up, down, p = tup.fir_passes(f, up=2, padding=[3, 2, 3, 2], gain=4)[0]
        hh, ww = (h - 2) // 2, (w - 2) // 2
        return tup.transposed_pass(f2d, up, down, p, (hh, ww), (h, w))
    if kind in ("grad1", "grad2"):   # the transposed filter pass: pad 1 of (h + 1), pad 2 of (h - 1)
        pf = 2 if kind == "grad1" else 1
        hh, ww = (h - 1, w - 1) if pf == 2 else (h + 1, w + 1)
        f2d, up, down, p = tup.fir_passes(f, padding=pf)[0]
        return tup.transposed_pass(f2d, up, down, p, (hh, ww), (h, w))
    if kind == "down2":      # the discriminator's downsample2d (padding 1)
        return tup.fir_passes(f, down=2, padding=1)[0]
    return tup.fir_passes(tup.setup_filter([1, 2, 1]), padding=1)[0]


@pytest.mark.parametrize("case", list(LARGE))
def test_tiled_calls(case):
    """Each call under its own plan ("rows" on aligned rows, else
    "rows_scalar": few tiles) and, on unaligned rows, under the plan of the
    same call at training's channel count ("flat", 64-row tiles)."""
    shape, kind, dtype, shift = LARGE[case]
    spec = large_spec(kind, *shape[2:])
    f2d, up, down, p = spec
    assert up == (1, 1) and tup.k4_plan(*spec).variant in ("down2", "fir4", "fir_small")
    x_np = np.random.RandomState(5).randn(*shape).astype(np.float32)
    x = torch.from_numpy(x_np).to(dtype)
    oh, ow = tup._out_size(*shape[2:], *f2d.shape, up, down, p)
    if shift == "tall":   # the plan of the same call at training's channels: 64-row tiles
        plan = tup.fir4_block_plan(TRAIN_NC, *shape[2:], oh, ow, down[0], dtype)
        assert plan.plan == "flat" and plan.tile == (64, 64)
        got, _ = fir4_emulate(x, f2d, down[0], p, plan)
        hold(got, x, spec, x_np)
        return
    got, plan = fir4_emulate(x, f2d, down[0], p, shift=shift)
    aligned = shift == 0 and shape[3] % (16 // x.element_size()) == 0
    assert plan.plan == ("rows" if aligned else "rows_scalar") and plan.blocks > shape[1]
    hold(got, x, spec, x_np)
    if not aligned:
        flat = tup.fir4_block_plan(TRAIN_NC, *shape[2:], oh, ow, down[0], dtype,
                                   *f2d.shape, shift)
        assert flat.plan == "flat" and flat.tile == (64, 64)
        got, _ = fir4_emulate(x, f2d, down[0], p, flat)
        hold(got, x, spec, x_np)


def test_plans_of_training_calls():
    """The five small transposed calls take "planes" with 4, 2, 1, 2, 2
    rows a thread (4 to 16 planes a block); the SR's and b512's large
    calls, whose rows are not 16-byte aligned, "flat" (64 x 64 outputs, 2
    columns a lane); aligned rows "rows" (32 x 64, a column a lane); the
    planes plan ends at 32 output columns."""
    bf, f32 = torch.bfloat16, torch.float32
    small = [((34, 34, 16, 16, 2, bf), 4, 4.0), ((18, 18, 8, 8, 2, f32), 2, 8.0),
             ((10, 10, 4, 4, 2, f32), 1, 16.0), ((9, 9, 8, 8, 1, f32), 2, 8.0),
             ((7, 7, 8, 8, 1, f32), 2, 8.0)]
    for args, rows, planes in small:
        plan = tup.fir4_block_plan(TRAIN_NC, *args)
        assert (plan.plan, plan.rows, plan.planes_a_block) == ("planes", rows, planes), args
        assert plan.blocks * tup.F4_THREADS >= TRAIN_NC * args[3] * -(-args[2] // rows)
    sr = tup.fir4_block_plan(8 * 256, 514, 514, 256, 256, 2, bf)
    assert (sr.plan, sr.tile, sr.window, sr.stage_w, sr.rows, sr.lanes) == (
        "flat", (64, 64), (130, 130), 144, 8, (2, 1))
    for h in (513, 511):
        b512 = tup.fir4_block_plan(8 * 64, h, h, 512, 512, 1, bf)
        assert (b512.plan, b512.tile, b512.window, b512.stage_w, b512.rows) == (
            "flat", (64, 64), (67, 67), 80, 8)
        assert b512.blocks == 8 * 64 * 8 * 8
    view = tup.fir4_block_plan(2 * 256, 256, 256, 128, 128, 2, bf)
    assert (view.plan, view.tile, view.rows, view.lanes) == ("rows", (32, 64), 8, (1, 2))
    assert tup.fir4_block_plan(2 * 256, 256, 256, 128, 128, 2, bf, shift=1).plan == "flat"
    assert tup.fir4_block_plan(16, 66, 66, 32, 32, 2, f32).plan == "planes"
    assert tup.fir4_block_plan(16, 68, 68, 33, 33, 2, f32).plan == "rows"
    # aligned rows take "planes" only up to 16 output columns
    assert tup.fir4_block_plan(TRAIN_NC, 32, 32, 31, 31, 1, f32).plan == "rows"
    assert tup.fir4_block_plan(TRAIN_NC, 16, 16, 15, 15, 1, f32).plan == "planes"
    # unaligned rows of fewer than 528 64-row tiles: the rows plan's tiles,
    # staged element by element; from 528 tiles on, "flat"
    few = tup.fir4_block_plan(2 * 3, 258, 258, 128, 128, 2, f32)
    assert (few.plan, few.tile, few.stage_w) == ("rows_scalar", (32, 64), 130)
    assert tup.fir4_block_plan(2 * 64, 102, 102, 103, 103, 1, f32).plan == "rows_scalar"
    assert tup.fir4_block_plan(132, 258, 258, 128, 128, 2, f32).plan == "flat"
