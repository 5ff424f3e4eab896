"""K4's polyphase table (ops/upfirdn2d.py:k4_plan) against upfirdn2d (CPU).

The CUDA kernel for up=2, down=1 and a 4x4 filter computes each output pixel
(2m+ry, 2n+rx) as the 2x2 correlation of the original image at rows
m+sy[ry]+{0,1} and columns n+sx[rx]+{0,1} with the phase's four taps, all
read from the wrapper's cached plan. Here the same sum runs in plain torch
from that plan and must equal the port's upfirdn2d_plain and the JAX
package's upfirdn2d at f32 (1e-6: four products against sixteen, summed in
another order; the outputs are convex combinations of inputs of size ~3).
And every upfirdn2d call of a tiny-config forward must fall in that family.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from panic3d_tpu import ops as jops
from panic3d_tpu_torch import configs

# the module (panic3d_tpu_torch.ops re-exports its function of the same name)
tup = importlib.import_module("panic3d_tpu_torch.ops.upfirdn2d")

TOL = dict(rtol=0, atol=1e-6)


def polyphase_from_plan(x, plan, oh, ow):
    """y[2m+ry, 2n+rx] = sum_ji taps[ry][rx][j][i] * x[m+sy[ry]+j, n+sx[rx]+i],
    zero outside the image."""
    sy0, sy1, sx0, sx1 = plan.phase_src
    my, mx = (oh + 1) // 2, (ow + 1) // 2
    h, w = x.shape[-2:]
    lo_y, lo_x = max(0, -min(sy0, sy1)), max(0, -min(sx0, sx1))
    hi_y = max(0, my + max(sy0, sy1) + 1 - h)
    hi_x = max(0, mx + max(sx0, sx1) + 1 - w)
    xp = F.pad(x, [lo_x, hi_x, lo_y, hi_y])
    y = torch.zeros(x.shape[:2] + (2 * my, 2 * mx), dtype=x.dtype)
    for ry, sy in ((0, sy0), (1, sy1)):
        for rx, sx in ((0, sx0), (1, sx1)):
            acc = torch.zeros(x.shape[:2] + (my, mx), dtype=x.dtype)
            for j in (0, 1):
                for i in (0, 1):
                    r0, c0 = lo_y + sy + j, lo_x + sx + i
                    acc = acc + plan.phase_taps[ry][rx][j][i] * xp[..., r0:r0 + my, c0:c0 + mx]
            y[..., ry::2, rx::2] = acc
    return y[..., :oh, :ow]


@pytest.mark.parametrize("flip_filter", [False, True])
@pytest.mark.parametrize("size", [12, 13, 16])
@pytest.mark.parametrize("padding", [(3, 2, 3, 2), (2, 1, 2, 1)],
                         ids=["conv2d_resample", "upsample2d"])
def test_phase_table_rebuilds_upfirdn2d(padding, size, flip_filter):
    r = np.random.RandomState(size)
    x = r.randn(2, 3, size, size - 1).astype(np.float32)   # odd and even widths too
    f = tup.setup_filter([1, 3, 3, 1])
    # upfirdn2d's own preparation of the filter: gain up^2, flipped unless flip_filter
    f2d = f * 4.0 if flip_filter else (f * 4.0).flip([0, 1])
    plan = tup.k4_plan(f2d, (2, 2), (1, 1), padding)
    assert plan.variant == "up2"
    assert plan is tup.k4_plan(f2d.clone(), (2, 2), (1, 1), padding)    # cached by value
    oh, ow = tup._out_size(size, size - 1, 4, 4, (2, 2), (1, 1), padding)
    got = polyphase_from_plan(torch.from_numpy(x), plan, oh, ow)
    plain = tup.upfirdn2d_plain(torch.from_numpy(x), f2d, (2, 2), (1, 1), padding)
    want = jops.upfirdn2d(jnp.asarray(x), jops.setup_filter([1, 3, 3, 1]), up=2,
                          padding=list(padding), flip_filter=flip_filter, gain=4)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # each phase's taps carry a quarter of the filter's gain
    for ry in (0, 1):
        for rx in (0, 1):
            assert abs(sum(sum(row) for row in plan.phase_taps[ry][rx]) - 1.0) < 1e-6


def test_other_calls_take_the_generic_kernel():
    f = tup.setup_filter([1, 3, 3, 1])
    # a 4x4 filter at up 1 (down 2, or 1) takes the 4x4 form
    assert tup.k4_plan(f, (1, 1), (2, 2), (1, 1, 1, 1)).variant == "down2"
    assert tup.k4_plan(f, (1, 1), (1, 1), (1, 2, 1, 2)).variant == "fir4"
    assert tup.k4_plan(f[1:3, 1:3], (2, 2), (1, 1), (1, 0, 1, 0)).variant == "generic"


def test_every_forward_call_is_up2_4x4(monkeypatch):
    """A tiny-config forward on the CPU, with a spy on the function every
    upfirdn2d call goes through."""
    calls = []
    fir = tup._fir

    def spy(x, f2d, up, down, pad):
        calls.append((tuple(x.shape), tuple(f2d.shape), tuple(up), tuple(down), tuple(pad),
                      tup.k4_plan(f2d, up, down, pad).variant))
        return fir(x, f2d, up, down, pad)

    monkeypatch.setattr(tup, "_fir", spy)
    G = configs.tiny(device="cpu").init_weights(0).eval()
    r = np.random.RandomState(0)
    x = {"z": torch.from_numpy(r.randn(1, G.z_dim).astype(np.float32)),
         "elevations": torch.zeros(1), "azimuths": torch.zeros(1),
         "cond": {"image_ortho_front": torch.from_numpy(r.rand(1, 3, 64, 64)).float(),
                  "resnet_chonk": torch.from_numpy(r.randn(1, 16, 8, 8)).float()}}
    with torch.no_grad():
        G.f(x)
    assert len(calls) >= 8, calls
    for shape, fshape, up, down, pad, variant in calls:
        assert (fshape, up, down, variant) == ((4, 4), (2, 2), (1, 1), "up2"), calls
        assert pad in ((3, 2, 3, 2), (2, 1, 2, 1)), pad
