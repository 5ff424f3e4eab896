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
    TILE, filtered_lrelu, filtered_lrelu_plain, k11_plan)

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
