"""K11 filtered_lrelu on the CPU: the port's plain version against the JAX
package's filtered_lrelu, and K11's host plan (ops/filtered_lrelu.py:k11_plan)
against the plain version.

The cases are StyleGAN3's: up 2 / down 2 with 12-tap filters, up 4 / down 2
with 24 / 12 taps, the 12x12 radial down filter, the critically sampled
layer's negative padding (-11 / -12: a crop), the toRGB layer's bias and
clamp alone, and a clamp that is hit, in f32 and bf16. Tolerances, against
the largest |value| of the JAX output: f32 2e-6 (the same operations, the
FIR sums in another order: 12-24 products of values ~1-10); bf16 2^-6
(4 bf16 ulps: JAX rounds lrelu's slope and the gain to bf16 and each
primitive rounds where XLA fuses, the port rounds each op's result; both
round after the bias, each 1-D pass and the activation).

The plan check rebuilds, in plain torch, what the CUDA kernel computes from
the plan alone: each 32x32 output tile from its input window (bias added,
zeros outside), the polyphase up pass by the window's phase table, the
activation, and the down pass, in f32; it must equal the plain f32 version
within 2e-6 x max|out| (the same products, summed in another order), and
every intermediate position must meet exactly the inputs the zero-inserted
image puts under its taps.

The strip check does the same for the strip form (StyleGAN3's geometries:
up 2 and 4 at their paddings' phases, the separable and the radial down
filter, the tile the plan picks at a 36^2, 52^2 and 84^2 output and tiles
it does not pick, the last one partial): each pass strip by strip as the
kernel walks it (pass 1: 4 x up columns from a window at 4q; pass 2: 8
rows from h row 8q / up; the down passes at stride 2), its buffers the
layout's sizes and strides, filled with NaN before each pass writes them,
so an output that reads a value no pass wrote comes out NaN.
"""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from panic3d_tpu_torch.kernels import launch_counts
from panic3d_tpu_torch.models.stylegan3 import design_lowpass_filter
from panic3d_tpu_torch.ops.filtered_lrelu import (
    STRIP_PHASE, TILE, filtered_lrelu, filtered_lrelu_plain, k11_plan, strip_layout)

SQRT2 = math.sqrt(2)
# the module (panic3d_tpu.ops re-exports its function of the same name)
jfl = importlib.import_module("panic3d_tpu.ops.filtered_lrelu")


def _filters(up_taps, down_taps, radial=False):
    fu = design_lowpass_filter(up_taps, cutoff=10.0, width=6.0, fs=64.0)
    fd = design_lowpass_filter(down_taps, cutoff=9.0, width=7.0, fs=64.0, radial=radial)
    return fu, fd


# name: (C, size, up, down, up taps, down taps, radial, padding, scale, clamp, torgb)
CASES = {
    "up2_down2_12_12": (4, 21, 2, 2, 12, 12, False, [10, 11, 10, 11], 1.0, 256.0, False),
    "up4_down2_24_12": (3, 14, 4, 2, 24, 12, False, [21, 22, 21, 22], 1.0, 256.0, False),
    "radial_12x12": (3, 20, 2, 2, 12, 12, True, [10, 11, 10, 11], 1.0, 256.0, False),
    "negative_padding": (2, 37, 2, 2, 12, 12, False, [-11, -12, -11, -12], 1.0, 256.0, False),
    "torgb_identity": (3, 18, 1, 1, 1, 1, False, [0, 0, 0, 0], 200.0, 256.0, True),
    "clamp_hit": (3, 21, 2, 2, 12, 12, False, [10, 11, 10, 11], 300.0, 256.0, False),
}


def _case(name, seed=0):
    C, size, up, down, ut, dt, radial, pad, scale, clamp, torgb = CASES[name]
    r = np.random.RandomState(seed)
    x = (r.randn(2, C, size, size) * scale).astype(np.float32)
    b = (r.randn(C) * 0.5).astype(np.float32)
    fu, fd = _filters(ut, dt, radial)
    kw = dict(up=up, down=down, padding=pad, clamp=clamp,
              gain=1.0 if torgb else SQRT2, slope=1.0 if torgb else 0.2)
    return x, b, fu, fd, kw


def _torch(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_jax(name, dtype):
    x, b, fu, fd, kw = _case(name)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def jax_fn(x, b, fu, fd):
        return jfl.filtered_lrelu(x.astype(jdt), fu, fd, b.astype(jdt), **kw)

    want = np.asarray(jax.jit(jax_fn)(x, b, fu, fd).astype(jnp.float32))
    got = filtered_lrelu(torch.from_numpy(x).to(tdt), _torch(fu), _torch(fd),
                         torch.from_numpy(b).to(tdt), **kw)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    tol = (2e-6 if dtype == "float32" else 2.0 ** -6) * float(np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)
    if name == "clamp_hit":
        # the clamp acts on the up-sampled intermediate: hit there, and the
        # output stays within clamp x sum|fd| of the separable down filter
        mid = filtered_lrelu_plain(torch.from_numpy(x), _torch(fu), None,
                                   torch.from_numpy(b), **dict(kw, down=1))
        assert float((mid.abs() == kw["clamp"]).float().mean()) > 0.01
        assert float(got.float().abs().max()) <= kw["clamp"] * float(np.abs(fd).sum()) ** 2
    if name == "torgb_identity":   # bias and clamp alone
        assert float(got.float().abs().max()) == kw["clamp"]
        if dtype == "float32":
            np.testing.assert_array_equal(
                got.numpy(), np.clip(x + b[:, None, None], -kw["clamp"], kw["clamp"]))
    assert sum(launch_counts().values()) == 0


def kernel_from_plan(x, b, plan, clamp, gain, slope):
    """What csrc/filtered_lrelu.cu computes, from the plan alone, in f32."""
    N, C, H, W = x.shape
    fu = torch.tensor(plan.fu, dtype=torch.float32)
    fd = torch.tensor(plan.fd, dtype=torch.float32)
    up, down, ti, tin = plan.up, plan.down, plan.ti, plan.tin
    fdn = math.isqrt(len(plan.fd)) if plan.fd2d else len(plan.fd)
    xb = x.float() + b.float()[:, None, None]
    # each window position's taps as (input index, weight), zero-padded
    width = max(len(range(k, len(plan.fu), up)) for k in set(plan.k0[0] + plan.k0[1]))

    def table(a):
        idx = torch.zeros(ti, max(width, 1), dtype=torch.int64)
        wt = torch.zeros(ti, max(width, 1))
        for i in range(ti):
            for m, k in enumerate(range(plan.k0[a][i], len(plan.fu), up)):
                idx[i, m], wt[i, m] = plan.src[a][i] + m, fu[k]
        return idx, wt

    (iy_idx, iy_w), (ix_idx, ix_w) = table(0), table(1)
    assert int(iy_idx.max()) < tin and int(ix_idx.max()) < tin
    out = torch.zeros((N, C) + plan.out)
    for ty, iy0 in enumerate(plan.in0[0]):
        for tx, ix0 in enumerate(plan.in0[1]):
            win = torch.zeros(N, C, tin, tin)
            r0, r1 = max(iy0, 0), min(iy0 + tin, H)
            c0, c1 = max(ix0, 0), min(ix0 + tin, W)
            win[:, :, r0 - iy0:r1 - iy0, c0 - ix0:c1 - ix0] = xb[:, :, r0:r1, c0:c1]
            h = (win[:, :, :, ix_idx] * ix_w).sum(-1)                    # [N,C,tin,ti]
            mid = (h[:, :, iy_idx, :] * iy_w[:, :, None]).sum(-2)        # [N,C,ti,ti]
            mid = torch.where(mid >= 0, mid, mid * slope) * gain
            if clamp is not None:
                mid = mid.clamp(-clamp, clamp)
            if plan.fd2d:
                y = F.conv2d(mid.reshape(N * C, 1, ti, ti), fd.reshape(1, 1, fdn, fdn),
                             stride=down)
            else:
                y = F.conv2d(mid.reshape(N * C, 1, ti, ti), fd.reshape(1, 1, 1, fdn),
                             stride=(1, down))
                y = F.conv2d(y, fd.reshape(1, 1, fdn, 1), stride=(down, 1))
            y = y.reshape(N, C, TILE, TILE)
            oy, ox = ty * TILE, tx * TILE
            hh, ww = min(TILE, plan.out[0] - oy), min(TILE, plan.out[1] - ox)
            out[:, :, oy:oy + hh, ox:ox + ww] = y[:, :, :hh, :ww]
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_plan_rebuilds_plain(name):
    x, b, fu, fd, kw = _case(name, seed=1)
    if name != "torgb_identity":   # two tiles a side at least
        C, size, up = CASES[name][:3]
        x = np.random.RandomState(2).randn(1, C, size * 2 + 7, size * 2 + 3).astype(np.float32)
    xt, bt = torch.from_numpy(x), torch.from_numpy(b)
    plan = k11_plan(xt.shape, _torch(fu), _torch(fd), kw["up"], kw["down"], kw["padding"],
                    kw["gain"], kw["slope"], kw["clamp"])
    assert plan.c_plan is not None
    assert plan is k11_plan(xt.shape, _torch(fu), _torch(fd), kw["up"], kw["down"],
                            kw["padding"], kw["gain"], kw["slope"], kw["clamp"])   # cached
    want = filtered_lrelu_plain(xt, _torch(fu), _torch(fd), bt, **kw)
    assert plan.out == tuple(want.shape[2:])
    got = kernel_from_plan(xt, bt, plan, kw["clamp"], kw["gain"], kw["slope"])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=2e-6 * float(want.abs().max()))
    if plan.strip is not None:   # the strip form (StyleGAN3's phase: the crop) too
        assert plan.form.startswith("strip")
        got = strip_from_layout(xt, bt, plan, plan.strip, kw["clamp"], kw["gain"], kw["slope"])
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=2e-6 * float(want.abs().max()))
    else:
        assert plan.form.startswith("tile")
    # each tile's intermediate window starts at tile * TILE * down, a multiple
    # of up, and its first position's tap meets input in0 + src
    up = kw["up"]
    px0, _, py0, _ = kw["padding"]
    for a, p0 in ((0, py0), (1, px0)):
        for t, (m0, i0) in enumerate(zip(plan.mid0[a], plan.in0[a])):
            assert m0 == t * TILE * kw["down"] and m0 % up == 0
            for i in range(plan.ti):
                q = m0 + i + plan.k0[a][i] - p0    # zero-inserted index the tap meets
                assert q % up == 0 and q // up == i0 + plan.src[a][i]


def test_kernel_refuses_what_it_does_not_take():
    fu, fd = _filters(12, 12)
    with pytest.raises(NotImplementedError, match="1-D"):
        k11_plan((1, 1, 8, 8), torch.ones(3, 3), None, 2, 2, 0)
    with pytest.raises(NotImplementedError, match="same up and down"):
        k11_plan((1, 1, 8, 8), torch.from_numpy(fu), None, [2, 1], 1, 0)
    # an output of more than 64 tiles a side is outside the kernel's plan
    assert k11_plan((1, 1, 1100, 1100), torch.from_numpy(fu), torch.from_numpy(fd), 2, 1,
                    10).c_plan is None


# name: (C, size, up, down taps radial, padding, t): StyleGAN3's geometries
# (stylegan3-t L0 / L3 / L4 / L5 / L7, stylegan3-r L0 / L2 / L4), at the
# plan's tile (t None) or a forced one
STRIP_CASES = {
    "t_L0_up2_36": (2, 38, 2, False, [9, 8, 9, 8], None),
    "t_L3_up2_52": (2, 54, 2, False, [9, 8, 9, 8], None),
    "t_L4_up4_84": (2, 54, 4, False, [-6, -9, -6, -9], None),
    "t_L5_up2_84_t40": (1, 86, 2, False, [9, 8, 9, 8], (40, 40)),
    "t_L13_up2_crop_t30": (1, 70, 2, False, [-11, -12, -11, -12], (30, 30)),
    "r_L0_radial_up2_36": (2, 36, 2, True, [11, 10, 11, 10], None),
    "r_L2_radial_up4_52": (1, 36, 4, True, [-2, -5, -2, -5], None),
    "r_L4_radial_up4_84_t32": (1, 52, 4, True, [-2, -5, -2, -5], (32, 32)),
}


def strip_from_layout(x, b, plan, lay, clamp, gain, slope):
    """What the strip form (csrc/filtered_lrelu.cu:filtered_lrelu_strip_kernel)
    computes from the plan and its layout ``lay``, in f32, strip by strip,
    each buffer NaN where its pass did not write."""
    N, C, H, W = x.shape
    up, s = plan.up, STRIP_PHASE[plan.up]
    fu = torch.tensor(plan.fu, dtype=torch.float32)
    fd = torch.tensor(plan.fd, dtype=torch.float32)
    xb = x.float() + b.float()[:, None, None]
    n_a, n_b = lay.off_b, lay.smem // 4 - lay.off_b
    u1 = 4 * up

    def src(u):
        return -(-(u - s) // up)

    def k0(u):
        return (s - u) % up

    def buf(n, rows, stride):
        assert stride % 8 == 4 and rows * stride <= n
        return torch.full((N, C, rows, stride), float("nan"))

    out = torch.full((N, C) + plan.out, float("nan"))
    for ty, iy0 in enumerate(lay.in0[0]):
        for tx, ix0 in enumerate(lay.in0[1]):
            s_in = buf(n_a, lay.rh, lay.si)
            r0, r1 = max(iy0, 0), min(iy0 + lay.rh, H)
            c0, c1 = max(ix0, 0), min(ix0 + lay.in_cols, W)
            s_in[..., :lay.in_cols] = 0.0
            s_in[:, :, r0 - iy0:r1 - iy0, c0 - ix0:c1 - ix0] = xb[:, :, r0:r1, c0:c1]
            s_h = buf(n_b, lay.rh, lay.sh)                 # pass 1
            for q in range(lay.nq1):
                for u in range(u1):
                    acc = torch.zeros(N, C, lay.rh)
                    for m in range(6):
                        assert 4 * q + src(u) + m < 4 * q + 12
                        acc = acc + fu[k0(u) + m * up] * s_in[..., 4 * q + src(u) + m]
                    s_h[..., u1 * q + u] = acc
            s_mid = buf(n_a, 8 * lay.nqi, lay.sm)          # pass 2
            for qi in range(lay.nqi):
                for u in range(8):
                    acc = torch.zeros(N, C, 4 * lay.nqj)
                    for m in range(6):
                        acc = acc + fu[k0(u) + m * up] * s_h[:, :, 8 * qi // up + src(u) + m,
                                                             :4 * lay.nqj]
                    acc = torch.where(acc >= 0, acc, acc * slope) * gain
                    s_mid[:, :, 8 * qi + u, :4 * lay.nqj] = acc.clamp(-clamp, clamp)
            if plan.fd2d:                                  # pass 3'
                rows, cols = 8 * (lay.nq4 - 1) + 18, 4 * (lay.nqo - 1) + 16
                assert cols <= lay.sm
                y = F.conv2d(s_mid[:, :, :rows, :cols].reshape(N * C, 1, rows, cols),
                             fd.reshape(1, 1, 12, 12), stride=2)
            else:                                          # passes 3 and 4
                cols = 16 * (lay.nqo - 1) + 28
                assert cols <= lay.sm and 8 * lay.nqo <= lay.sd
                s_d = buf(n_b, 16 * (lay.nq4 - 1) + 26, lay.sd)
                d = F.conv2d(s_mid[:, :, :lay.ti_y, :cols].reshape(N * C, 1, lay.ti_y, cols),
                             fd.reshape(1, 1, 1, 12), stride=(1, 2))
                s_d[:, :, :lay.ti_y, :8 * lay.nqo] = d[..., :8 * lay.nqo].reshape(
                    N, C, lay.ti_y, 8 * lay.nqo)
                y = F.conv2d(s_d[..., :lay.t[1]].reshape(N * C, 1, -1, lay.t[1]),
                             fd.reshape(1, 1, 12, 1), stride=(2, 1))
            y = y.reshape(N, C, y.shape[-2], y.shape[-1])
            oy, ox = ty * lay.t[0], tx * lay.t[1]
            hh, ww = min(lay.t[0], plan.out[0] - oy), min(lay.t[1], plan.out[1] - ox)
            assert y.shape[-2] >= hh and y.shape[-1] >= ww
            out[:, :, oy:oy + hh, ox:ox + ww] = y[:, :, :hh, :ww]
    return out


@pytest.mark.parametrize("name", list(STRIP_CASES))
def test_strip_plan_rebuilds_plain(name):
    C, size, up, radial, pad, t = STRIP_CASES[name]
    r = np.random.RandomState(3)
    x = (r.randn(1, C, size, size) * 40.0).astype(np.float32)   # x sqrt(2): the clamp is hit
    b = (r.randn(C) * 0.5).astype(np.float32)
    fu, fd = _filters(6 * up, 12, radial)
    kw = dict(up=up, down=2, padding=pad, clamp=256.0, gain=SQRT2, slope=0.2)
    xt, bt = torch.from_numpy(x), torch.from_numpy(b)
    plan = k11_plan(xt.shape, _torch(fu), _torch(fd), up, 2, pad, SQRT2, 0.2, 256.0)
    assert plan.form == f"strip_up{up}{'_radial' if radial else ''}" and plan.c_plan is not None
    lay = plan.strip
    assert plan.c_plan.form == {"strip_up2": 2, "strip_up2_radial": 3, "strip_up4": 4,
                                "strip_up4_radial": 5}[plan.form]
    assert (plan.c_plan.st.t_y, plan.c_plan.st.smem) == (lay.t[0], lay.smem)
    if t is None:   # the plan's tile: the whole output up to 36^2, 42^2 at 84^2
        n = plan.out[0]
        assert lay.t[0] == {36: 36, 52: 26 if up == 2 and not radial else 52, 84: 42}[n]
    else:
        lay = strip_layout(t, up, radial, (pad[2], pad[0]), plan.out)
    assert lay.smem <= 74 * 1024
    want = filtered_lrelu_plain(xt, _torch(fu), _torch(fd), bt, **kw)
    got = strip_from_layout(xt, bt, plan, lay, 256.0, SQRT2, 0.2)
    assert bool(torch.isfinite(got).all())
    tol = 2e-6 * float(want.abs().max())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=tol)
    # every window position's first tap meets the input the zero-inserted
    # image puts under it
    s = STRIP_PHASE[up]
    for a, p0 in ((0, pad[2]), (1, pad[0])):
        assert p0 % up == s
        for k, i0 in enumerate(lay.in0[a]):
            m0 = k * lay.t[a] * 2
            assert m0 % up == 0
            for u in range(2 * lay.t[a] + 10):
                q = m0 + u + (s - u) % up - p0
                assert q % up == 0 and q // up == i0 + -(-(u - s) // up)
    # the JAX filtered_lrelu at the same geometry
    ref = np.asarray(jax.jit(lambda x, b: jfl.filtered_lrelu(x, fu, fd, b, **kw))(x, b))
    np.testing.assert_allclose(want.numpy(), ref, rtol=0, atol=tol)
