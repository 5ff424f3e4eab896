"""K4's large-filter kernels (csrc/upfirdn2d.cu) emulated on the CPU.

A filter of more than 64 taps at down 1 runs upfirdn2d_large_phase_kernel:
the block stages the taps phase-major, [upy][upx][nJ][4 nch] (output phase
(py, px) reads f[a0 + upy j][b0 + upx i], a0 = (py0 - py) mod upy, b0 =
(px0 - px) mod upx, zeros past the filter), and each output of a phase
sums its nJ x nI taps against the inputs its phase's window steps over,
rows then columns ascending, with fmaf from 0 in f32. Here that table is
built and that order run in plain torch (an f32 product is exact in f64,
so each fmaf is the f64 sum rounded to f32) on numpy-seeded [1,2,24,24]
images, and must match the port's upfirdn2d_plain within 1e-6 x max|out|
(up to 144 products an output, summed in another order) and the JAX
package's upfirdn2d within 1e-5 x max|out|: at EQ-R's 47x47 filter at up 4
(construct_affine_bandlimit_filter, upsample2d's padding), the pseudo-
rotation's 11x11 at up 1 (filter2d's), and a 13x13 filter at up 3. A large
filter at down 2 (the unfused K11 composition's radial down pass), or one
with fewer than 4 tap rows in a phase (a 9x9 at up 3), runs the tiled
kernel, upfirdn2d_large_kernel, whose outputs walk their phase's taps in
the same order; those cases are emulated the same way. ops/upfirdn2d.py:k4_plan names "large" and "large_tiled" as the entry
point decides (csrc/upfirdn2d.cu:large_phase).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panic3d_tpu_torch.eval import equivariance as eqt

jup = importlib.import_module("panic3d_tpu.ops.upfirdn2d")
tup = importlib.import_module("panic3d_tpu_torch.ops.upfirdn2d")


def fma(a, b, c):
    """fmaf in f32: the product exact in f64, one rounding of the sum."""
    return (a.double() * b.double() + c.double()).float()


def phase_table(f2d, up, pad):
    """The taps as the phase-blocked kernel stages them: [upy][upx][nJ][4 nch]
    with output phase (py, px)'s sub-filter f[a0 + upy j][b0 + upx i] at its
    top left, zeros elsewhere; and each phase's (nJ, nI)."""
    fh, fw = f2d.shape
    upx, upy = up
    px0, _, py0, _ = pad
    nj, ni = -(-fh // upy), -(-fw // upx)
    table = torch.zeros((upy, upx, nj, 4 * -(-ni // 4)))
    counts = {}
    for py in range(upy):
        for px in range(upx):
            sub = f2d[(py0 - py) % upy::upy, (px0 - px) % upx::upx]
            table[py, px, :sub.shape[0], :sub.shape[1]] = sub
            counts[py, px] = tuple(sub.shape)
    return table, counts


def phase_order(x, f2d, up, down, pad):
    """Each output's taps of its phase, a0 = (py0 - oy down) mod up (rows) and
    b0 likewise (columns), summed rows then columns ascending with fmaf from
    0, against input ((oy down + a - py0) / up, (ox down + b - px0) / up),
    zero outside the image; outputs sharing (a0, b0) are summed together.
    At down 1 the groups are the output phases, and their taps are read from
    phase_table. -> x's dtype."""
    n, c, h, w = x.shape
    fh, fw = f2d.shape
    upx, upy = up
    dx, dy = down
    px0, _, py0, _ = pad
    oh, ow = tup._out_size(h, w, fh, fw, up, down, pad)
    xf = torch.nn.functional.pad(x.float(), (1, 1, 1, 1))   # index -1 and h / w read 0
    out = torch.zeros((n, c, oh, ow))
    table, counts = phase_table(f2d, up, pad) if down == (1, 1) else (None, None)
    oy, ox = torch.arange(oh), torch.arange(ow)
    ay, ax = (py0 - oy * dy) % upy, (px0 - ox * dx) % upx
    for a0 in range(upy):
        rows = oy[ay == a0]
        for b0 in range(upx):
            cols = ox[ax == b0]
            if not len(rows) or not len(cols):
                continue
            taps = f2d[a0::upy, b0::upx]
            if table is not None:   # the staged table holds this group's taps
                py, px = int(rows[0]) % upy, int(cols[0]) % upx
                assert counts[py, px] == tuple(taps.shape)
                assert torch.equal(table[py, px, :taps.shape[0], :taps.shape[1]], taps)
                assert not table[py, px].count_nonzero() > taps.count_nonzero()
            iy = (rows * dy + a0 - py0) // upy
            ix = (cols * dx + b0 - px0) // upx
            acc = torch.zeros((n, c, len(rows), len(cols)))
            for j in range(taps.shape[0]):
                r = (iy + j).clamp(-1, h) + 1
                for i in range(taps.shape[1]):
                    v = xf[:, :, r][:, :, :, (ix + i).clamp(-1, w) + 1]
                    acc = fma(taps[j, i], v, acc)
            out[:, :, rows[:, None], cols[None, :]] = acc
    return out.to(x.dtype)


def _image(seed, shape=(1, 2, 24, 24)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _bandlimit(up):
    return eqt.construct_affine_bandlimit_filter(eqt.rotation_matrix(0.3), a=3, amax=6, up=up)


def _cases():
    f47 = _bandlimit(4)
    p = f47.shape[0] // 2
    f11 = _bandlimit(1)
    f9 = torch.from_numpy(np.random.RandomState(3).rand(9, 9).astype(np.float32) - 0.3)
    f13 = torch.from_numpy(np.random.RandomState(4).rand(13, 13).astype(np.float32) - 0.3)
    f12 = torch.from_numpy(np.outer(np.kaiser(12, 8.0), np.kaiser(12, 8.0)).astype(np.float32))
    # (label, 2-D filter, up, down, upfirdn2d padding, gain, variant)
    return [("EQ-R 47x47 at up 4", f47, 4, 1,
             [p + (47 + 4 - 1) // 2, p + (47 - 4) // 2] * 2, 16, "large"),
            ("pseudo-rotation 11x11", f11, 1, 1, [11 // 2, (11 - 1) // 2] * 2, 1, "large"),
            ("13x13 at up 3", f13, 3, 1, [7, 5, 8, 4], 9, "large"),
            ("9x9 at up 3 (3 tap rows in a phase)", f9, 3, 1, [5, 4, 6, 3], 9, "large_tiled"),
            ("12x12 at down 2", f12 / f12.sum(), 1, 2, [5, 5, 5, 5], 1, "large_tiled")]


@pytest.mark.parametrize("case", range(5))
def test_large_filter_order_matches_plain_and_jax(case):
    label, f, up, down, padding, gain, variant = _cases()[case]
    x = _image(seed=20 + case)
    (f2d, upp, downp, pad), = tup.fir_passes(f, up=up, down=down, padding=padding, gain=gain)
    assert tup.k4_plan(f2d, upp, downp, pad).variant == variant, label
    assert (tup.large_phase_geometry(*f2d.shape, upp, downp) is not None) == (variant == "large")
    got = phase_order(torch.from_numpy(x), f2d, upp, downp, pad)
    plain = tup.upfirdn2d_plain(torch.from_numpy(x), f2d, upp, downp, pad)
    want = np.asarray(jax.jit(lambda x, f: jup.upfirdn2d(
        x, f, up=up, down=down, padding=padding, gain=gain))(jnp.asarray(x),
                                                             jnp.asarray(f.numpy())))
    assert got.shape == plain.shape == want.shape, label
    scale = float(plain.abs().max())
    assert scale > 0
    assert float((got - plain).abs().max()) <= 1e-6 * scale, label
    assert float(np.abs(got.numpy() - want).max()) <= 1e-5 * scale, label


def test_large_phase_geometry_of_the_metrics_calls():
    # EQ-R's 47x47 at up 4: 16 phases of 11-12 x 11-12 taps, 3 chunks of 4,
    # one band of 16 phase rows a warp; the 11x11 at up 1: four bands
    f47 = torch.zeros((47, 47))
    g = tup.large_phase_geometry(47, 47, (4, 4), (1, 1))
    assert g == tup.LargePhase(3, 1, 4 * (16 * 12 * 12 + 2 * 28 * 44 + 4 * 16 * 129))
    _, counts = phase_table(f47, (4, 4), (23 + 25, 23 + 21, 23 + 25, 23 + 21))
    assert sorted(set(counts.values())) == [(11, 11), (11, 12), (12, 11), (12, 12)]
    assert tup.large_phase_geometry(11, 11, (1, 1), (1, 1)) == tup.LargePhase(
        3, 4, 4 * (11 * 12 + 75 * 44 + 4 * 16 * 33))
    # beyond its reach: down 2, up 5 on x, 17 taps in a phase's row, 3 rows
    for fh, fw, up, down in ((12, 12, (1, 1), (2, 2)), (47, 47, (5, 5), (1, 1)),
                             (9, 17, (1, 1), (1, 1)), (11, 47, (4, 4), (1, 1))):
        assert tup.large_phase_geometry(fh, fw, up, down) is None
        assert tup.k4_plan(torch.zeros((fh, fw)), up, down, (0, 0, 0, 0)).variant == \
            "large_tiled"
