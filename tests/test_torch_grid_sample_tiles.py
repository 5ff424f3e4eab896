"""K14's tiles (csrc/grid_sample.cu) on the CPU: the footprint model and the
backward's tile accumulation and flush.

- ``k14_tile_plan`` (ops/grid_sample.py), the kernels' footprint test in
  PyTorch, puts every valid corner of every point (under border padding
  every clamped corner) inside its tile's box, after the box's x-start is
  rounded down to a multiple of 4 and its width up to one, and with a row's
  copy stopped at the image's width; on an ADA-like affine grid (rotation,
  anisotropic scale, about a texel a point: staged), an EQ-R-like 4x
  minification (direct), the loss mask's nearest-centre grid (staged) and
  chip_smoke.py's two-branch grid (both), at partial tiles and at widths
  that are and are not multiples of 4;
- the backward form's order of sums emulated in f32 (a staged tile's terms
  added into its zeroed box, the box then added into the image's gradient;
  a direct tile's terms added one by one) equals
  ``grid_sample_2d_grad_plain`` within GRAD_TOL of the largest gradient
  (the sums' order differs: chip_smoke.py's K14_GRAD_TOL), and, in one
  case, ``jax.vjp`` of the JAX package's ``grid_sample_2d``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panic3d_tpu.ops import grid_sample as jgs
from panic3d_tpu_torch.ops import grid_sample as tgs

GRAD_TOL = 1e-5   # of the largest gradient: only the order of the f32 sums differs


def _to_grid(ix, iy, H, W):
    """Texel coordinates -> align_corners=False's [-1, 1] grid [N,Hg,Wg,2] (f32)."""
    return torch.from_numpy(np.stack([(2 * ix + 1) / W - 1, (2 * iy + 1) / H - 1],
                                     -1).astype(np.float32))


def _affine(N, Hg, Wg, H, W, theta, sx, sy, seed):
    """ADA-like: each image's grid rotated by theta and scaled by (sx, sy)
    texels a point about the image's centre, with a random shift."""
    r = np.random.RandomState(seed)
    py, px = np.meshgrid(np.arange(Hg) - Hg / 2, np.arange(Wg) - Wg / 2, indexing="ij")
    ix, iy = [], []
    for n in range(N):
        t = theta + 0.4 * n
        c, s = math.cos(t), math.sin(t)
        dx, dy = r.uniform(-3, 3, 2)
        ix.append(c * sx * px - s * sy * py + W / 2 + dx)
        iy.append(s * sx * px + c * sy * py + H / 2 + dy)
    return _to_grid(np.stack(ix), np.stack(iy), H, W)


def _loss_mask(N, S, seed):
    """The loss mask's nearest-centre grid (training/loss.py:
    mask_view_orthofront) of a smooth view: texel centres of an S x S front."""
    r = np.random.RandomState(seed)
    v, u = np.meshgrid(np.linspace(-1, 1, S), np.linspace(-1, 1, S), indexing="ij")
    grids = []
    for _ in range(N):
        a, b = r.uniform(-0.15, 0.15, 2)
        gx = u * (0.9 + 0.1 * v) + a * np.sin(2 * v)
        gy = v * (0.95 + 0.05 * u) + b * np.cos(2 * u)
        grids.append(np.stack([gx, gy], -1))
    grid = torch.from_numpy(np.stack(grids).astype(np.float32))
    return (torch.round((grid + 1) * S / 2 - 0.5) + 0.5) * 2 / S - 1


def _two_branch(N, S, H, W):
    """chip_smoke.py's two-branch call at a small size: the left half of the
    output sheared at about a texel a point (staged), the right half at 4
    texels a point (direct)."""
    py, px = np.meshgrid(np.arange(S, dtype=np.float64), np.arange(S, dtype=np.float64),
                         indexing="ij")
    left = px < S // 2
    ix = np.where(left, px + 0.2 * py + 0.3, (px - S // 2) * 4 + 0.7)
    iy = np.where(left, py + 0.15 * px + 0.3, py * 4 + 0.7)
    shift = np.array([[0.0, 0.0], [5.25, 3.5]])[:N]
    return _to_grid(ix[None] + shift[:, 0, None, None], iy[None] + shift[:, 1, None, None], H, W)


CASES = {
    # name: (N, C, H, W, grid, padding, expected staged share: (lo, hi))
    "ada": lambda: (2, 3, 120, 124, _affine(2, 70, 90, 120, 124, 0.7, 1.25, 0.8, 0), "zeros",
                    (0.9, 1.0)),
    "ada_border": lambda: (2, 3, 120, 122, _affine(2, 70, 90, 120, 122, 2.2, 1.1, 0.9, 1),
                           "border", (0.9, 1.0)),
    "eqr": lambda: (2, 3, 262, 258, _affine(2, 64, 64, 262, 258, 0.35, 4.0, 4.0, 2), "zeros",
                    (0.0, 0.1)),
    "loss_mask": lambda: (2, 2, 64, 64, _loss_mask(2, 64, 3), "zeros", (0.9, 1.0)),
    "two_branch": lambda: (2, 2, 260, 142, _two_branch(2, 64, 260, 142), "zeros", (0.4, 0.6)),
}


def _plan_per_point(plan, N, Hg, Wg):
    """The plan's [N,Ty,Tx] tensors read at each point's tile -> [N,Hg,Wg]."""
    T = tgs.K14_TILE
    ty = torch.arange(Hg) // T
    tx = torch.arange(Wg) // T
    return {k: v[:, ty][:, :, tx] for k, v in plan.items()}


def _point_corners(grid, H, W, padding):
    """Each point's corners: [(xc, yc, valid)] in the order 00, 01, 10, 11,
    the corners clamped into the image (border padding's reads)."""
    ix0, _ = tgs._setup(grid[..., 0], W, torch.float32, torch.float32)
    iy0, _ = tgs._setup(grid[..., 1], H, torch.float32, torch.float32)
    out = []
    for dy in (0, 1):
        for dx in (0, 1):
            xs, ys = ix0 + dx, iy0 + dy
            valid = (torch.ones_like(xs, dtype=torch.bool) if padding == "border"
                     else (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H))
            out.append((xs.clamp(0, W - 1), ys.clamp(0, H - 1), valid))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_footprint_holds_every_corner(name):
    N, C, H, W, grid, padding, (lo, hi) = CASES[name]()
    Hg, Wg = grid.shape[1:3]
    plan = tgs.k14_tile_plan(grid, H, W, padding)
    share = float(plan["staged"].float().mean())
    assert lo <= share <= hi, f"{name}: staged share {share}"
    # the box's shape: 16-byte row starts, whole quads, inside the image
    ok = ~plan["empty"]
    assert bool((plan["x"][ok] % 4 == 0).all() and (plan["w"][ok] % 4 == 0).all())
    assert bool((plan["x"] >= 0).all() and (plan["y"] >= 0).all())
    assert bool((plan["x"][ok] < W).all() and (plan["y"] + plan["h"] <= H).all())
    assert bool((plan["x"] + plan["w"] <= -(-W // 4) * 4).all())
    assert bool((plan["staged"] == ok & (plan["w"] * plan["h"] <= tgs.K14_STAGE_TEXELS)).all())
    per = _plan_per_point(plan, N, Hg, Wg)
    x_end = torch.minimum(per["x"] + per["w"], torch.tensor(W))   # a row's copy stops at W
    n_valid = 0
    for xc, yc, valid in _point_corners(grid, H, W, padding):
        inside = ((xc >= per["x"]) & (xc < x_end) & (yc >= per["y"])
                  & (yc < per["y"] + per["h"]))
        assert bool(inside[valid].all()), f"{name}: a valid corner outside its tile's box"
        assert not bool(per["empty"][valid].any())
        n_valid += int(valid.sum())
    assert n_valid > 0


def _emulated_grad(grad, grid, in_shape, padding):
    """K14's backward form's sums in f32: a staged tile's corner terms added
    point by point into its zeroed box, the box then added into the image's
    gradient (the flush); a direct tile's terms added corner by corner. The
    terms are the plain backward's (grid_sample_2d_grad_plain)."""
    N, C, H, W = in_shape
    Hg, Wg = grid.shape[1:3]
    plan = tgs.k14_tile_plan(grid, H, W, padding)
    per = {k: v.reshape(N, -1) for k, v in _plan_per_point(plan, N, Hg, Wg).items()}
    Ty, Tx = plan["staged"].shape[1:]
    T = tgs.K14_TILE
    tile = ((torch.arange(N)[:, None, None] * Ty + (torch.arange(Hg) // T)[None, :, None]) * Tx
            + (torch.arange(Wg) // T)[None, None, :]).reshape(N, -1)
    _, wx1, wy1 = tgs._corners(N, H, W, grid.reshape(N, -1, 2), padding, False, grad.dtype)
    g = grad.reshape(N, C, -1).transpose(1, 2)
    g_top, g_bot = g - g * wy1, g * wy1
    terms = (g_top - g_top * wx1, g_top * wx1, g_bot - g_bot * wx1, g_bot * wx1)
    S = tgs.K14_STAGE_TEXELS
    boxes = torch.zeros((N * Ty * Tx * S, C), dtype=torch.float32)
    out = torch.zeros((N * H * W, C), dtype=torch.float32)
    base = torch.arange(N)[:, None] * (H * W)
    staged = per["staged"]
    for (xc, yc, valid), v in zip(_point_corners(grid.reshape(N, -1, 2), H, W, padding), terms):
        s, d = valid & staged, valid & ~staged
        slot = tile * S + (yc - per["y"]) * per["w"] + (xc - per["x"])
        boxes.index_add_(0, slot[s], v[s])
        out.index_add_(0, (base + yc * W + xc)[d], v[d])
    # the flush: every slot of a staged tile's box into the image's gradient
    t_ids = torch.nonzero(plan["staged"].reshape(-1))[:, 0]
    bx, by, bw, bh = (plan[k].reshape(-1)[t_ids] for k in ("x", "y", "w", "h"))
    k = torch.arange(S)
    r, col = k[None] // bw[:, None], k[None] % bw[:, None]
    keep = (k[None] < (bw * bh)[:, None]) & (bx[:, None] + col < W)
    n_img = t_ids // (Ty * Tx)
    dst = n_img[:, None] * (H * W) + (by[:, None] + r) * W + bx[:, None] + col
    src = t_ids[:, None] * S + k[None]
    out.index_add_(0, dst[keep], boxes[src[keep]])
    return out.reshape(N, H * W, C).transpose(1, 2).reshape(N, C, H, W)


@pytest.mark.parametrize("name", list(CASES))
def test_backward_tile_emulation(name):
    N, C, H, W, grid, padding, _ = CASES[name]()
    r = np.random.RandomState(7)
    grad = torch.from_numpy(r.randn(N, C, *grid.shape[1:3]).astype(np.float32))
    got = _emulated_grad(grad, grid, (N, C, H, W), padding)
    want = tgs.grid_sample_2d_grad_plain(grad, grid, (N, C, H, W), padding)
    tol = GRAD_TOL * float(want.abs().max())
    assert float((got - want).abs().max()) <= tol
    if name == "ada":   # and JAX's gradient of its grid_sample_2d
        x = jnp.zeros((N, C, H, W), jnp.float32)
        _, vjp = jax.vjp(lambda v: jgs.grid_sample_2d(v, jnp.asarray(grid.numpy()), padding), x)
        (gj,) = jax.jit(vjp)(jnp.asarray(grad.numpy()))
        assert float(np.abs(got.numpy() - np.asarray(gj)).max()) <= tol
