"""The port's 2-D grid sample (ops/grid_sample.py), K14's plain forms,
against the JAX package on the CPU:

- ``grid_sample_2d`` (the plain version on CPU tensors) against JAX's
  ``grid_sample_2d`` at both paddings and both ``align_corners``, with points
  off the image, the borders' edges and far outside: within 1e-6 (XLA may
  fuse the unnormalisation and the lerp its own way; torch rounds each op);
- its input gradient (autograd of the plain composition) and K14's plain
  backward form (``grid_sample_2d_grad_plain``) against ``jax.vjp``, within
  1e-6 x the largest gradient (the corner terms are summed in another
  order);
- K14's arithmetic emulated in numpy f32 (the kernel's unnormalisation,
  floors held within [-2, size + 1], the clamped corners and the lerp in
  its order) bit-equal to the plain version, far points included;
- the wiring of ``GridSample2d`` and ``GridSample2dGrad`` on their plain
  forms, by gradcheck and gradgradcheck in f64, and their double backward
  equal to the sample of the incoming gradient;
- ``grid_sample_2d_kernel`` refuses a grid that requires grad under grad
  mode (the grid takes no gradient on any path), and runs only on CUDA
  tensors; nothing on the CPU counts a launch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panic3d_tpu.ops import grid_sample as jgs
from panic3d_tpu_torch.kernels import launch_counts
from panic3d_tpu_torch.ops import grid_sample as tgs

MODES = [(p, a) for p in ("zeros", "border") for a in (False, True)]
IDS = [f"{p}-{'ac' if a else 'noac'}" for p, a in MODES]
TOL = 1e-6


def _case(seed=0, n=2, c=3, h=7, w=9, gh=5, gw=6, reach=1.4):
    r = np.random.RandomState(seed)
    x = r.randn(n, c, h, w).astype(np.float32)
    grid = r.uniform(-reach, reach, (n, gh, gw, 2)).astype(np.float32)
    # the image's corners exactly, and points far outside
    grid[0, 0, :4] = [(-1, -1), (1, 1), (-1, 1), (1, -1)]
    grid[-1, -1, :3] = [(5e3, 0.2), (-3e7, -0.4), (0.1, 1e9)]
    return x, grid


@pytest.mark.parametrize("padding,align", MODES, ids=IDS)
def test_plain_forward_matches_jax(padding, align):
    x, grid = _case()
    want = jax.jit(lambda a, b: jgs.grid_sample_2d(a, b, padding, align))(x, grid)
    got = tgs.grid_sample_2d(torch.from_numpy(x), torch.from_numpy(grid), padding, align)
    assert got.shape == (2, 3, 5, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    # points off the image sample zeros (zeros) or the edge (border)
    far = got.numpy()[-1, :, -1, :3]
    if padding == "zeros":
        assert (far == 0).all()
    else:
        assert np.abs(far).max() > 0


@pytest.mark.parametrize("padding,align", MODES, ids=IDS)
def test_input_gradient_matches_jax_vjp(padding, align):
    x, grid = _case(seed=1)
    g = np.random.RandomState(2).randn(2, 3, 5, 6).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jgs.grid_sample_2d(a, jnp.asarray(grid), padding, align),
                     jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    want = np.asarray(want)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tgs.grid_sample_2d(xt, torch.from_numpy(grid), padding, align)
    (got,) = torch.autograd.grad(y, xt, torch.from_numpy(g))
    plain = tgs.grid_sample_2d_grad_plain(torch.from_numpy(g), torch.from_numpy(grid), x.shape,
                                          padding, align)
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL * scale)
    np.testing.assert_allclose(plain.numpy(), want, rtol=0, atol=TOL * scale)
    # the backward form is the transpose of the sample: <S x, g> = <x, S^T g>
    lhs = float((y.detach().double() * torch.from_numpy(g).double()).sum())
    rhs = float((torch.from_numpy(x).double() * plain.double()).sum())
    assert abs(lhs - rhs) <= 1e-5 * max(abs(lhs), 1.0)


def _k14_emulated(x, grid, padding, align):
    """csrc/grid_sample.cu's forward, step for step in numpy f32."""
    f32 = np.float32
    n, c, h, w = x.shape
    pts = grid.reshape(n, -1, 2)
    out = np.zeros((n, c, pts.shape[1]), f32)

    def unnorm(v, size):
        if align:
            return f32(f32(f32(v + f32(1)) / f32(2)) * f32(size - 1))
        return f32(f32(f32(f32(v + f32(1)) * f32(size)) - f32(1)) / f32(2))

    for b in range(n):
        for p in range(pts.shape[1]):
            ix, iy = unnorm(pts[b, p, 0], w), unnorm(pts[b, p, 1], h)
            fx, fy = np.floor(ix), np.floor(iy)
            wx, wy = f32(ix - fx), f32(iy - fy)
            x0 = int(min(max(fx, f32(-2)), f32(w + 1)))
            y0 = int(min(max(fy, f32(-2)), f32(h + 1)))
            v = []
            for k in range(4):
                xs, ys = x0 + (k & 1), y0 + (k >> 1)
                ok = padding == "border" or (0 <= xs < w and 0 <= ys < h)
                xc, yc = min(max(xs, 0), w - 1), min(max(ys, 0), h - 1)
                v.append(x[b, :, yc, xc] if ok else np.zeros(c, f32))
            top = (v[0] + (v[1] - v[0]) * wx).astype(f32)
            bot = (v[2] + (v[3] - v[2]) * wx).astype(f32)
            out[b, :, p] = top + (bot - top) * wy
    return out.reshape((n, c) + grid.shape[1:3])


@pytest.mark.parametrize("padding,align", MODES, ids=IDS)
def test_kernel_arithmetic_emulated_equals_plain(padding, align):
    x, grid = _case(seed=3, gh=6, gw=7, reach=1.3)
    want = tgs.grid_sample_2d_plain(torch.from_numpy(x), torch.from_numpy(grid), padding, align)
    np.testing.assert_array_equal(_k14_emulated(x, grid, padding, align), want.numpy())


@pytest.mark.parametrize("padding,align", MODES, ids=IDS)
def test_function_wiring_gradcheck(padding, align):
    x, grid = _case(seed=4, n=1, c=2, h=4, w=5, gh=3, gw=4, reach=1.2)
    xt = torch.from_numpy(x).double().requires_grad_(True)
    gt = torch.from_numpy(grid).double()
    cfg = (padding, align)
    fn = lambda a: tgs.GridSample2d.apply(a, gt, cfg)   # noqa: E731
    assert torch.autograd.gradcheck(fn, (xt,))
    assert torch.autograd.gradgradcheck(fn, (xt,))
    # the forward on CPU tensors is the plain version, bit for bit
    xf, gf = torch.from_numpy(x), torch.from_numpy(grid)
    np.testing.assert_array_equal(tgs.GridSample2d.apply(xf, gf, cfg).numpy(),
                                  tgs.grid_sample_2d_plain(xf, gf, *cfg).numpy())
    # the backward form's own backward is the sample of its incoming gradient
    dy = torch.from_numpy(np.random.RandomState(5).randn(1, 2, 3, 4)).requires_grad_(True)
    dx = tgs.GridSample2dGrad.apply(dy, gt, tuple(x.shape), cfg)
    ddx = torch.from_numpy(np.random.RandomState(6).randn(*x.shape))
    (ddy,) = torch.autograd.grad(dx, dy, ddx)
    np.testing.assert_array_equal(ddy.numpy(), tgs.grid_sample_2d_plain(ddx, gt, *cfg).numpy())
    assert sum(launch_counts().values()) == 0


def test_kernel_wrapper_refuses_a_grid_that_requires_grad():
    x, grid = _case()
    gt = torch.from_numpy(grid).requires_grad_(True)
    with pytest.raises(RuntimeError, match="^grid_sample_2d: the CUDA kernel has no backward"):
        tgs.grid_sample_2d_kernel(torch.from_numpy(x), gt)
    with torch.no_grad():
        with pytest.raises(ValueError, match="K14 runs on CUDA tensors"):
            tgs.grid_sample_2d_kernel(torch.from_numpy(x), gt)
    with pytest.raises(ValueError, match="padding_mode"):
        tgs.grid_sample_2d(torch.from_numpy(x), torch.from_numpy(grid), "reflection")
    assert sum(launch_counts().values()) == 0
