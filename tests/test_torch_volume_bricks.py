"""K1v's brick decomposition (csrc/triplane_decode.cu:volume_density_kernel),
proved on the CPU with eval/volume.py's mirror of it.

- Every corner of every point lies in its brick's plane windows, and the
  three windows fit the K1V_POOL_TEXELS that the kernel stages, on the whole
  N = 256 sheared lattice with 256^2 planes, at box_warp 0.7 and 1.0; the
  corners are grid_sample_2d_points' own (ops/grid_sample.py:_setup on
  sample_from_planes' projection).
- The brick crop classes (all out, straddling, all in) agree with the
  per-point crop test everywhere.
- Decoding bricks through their windows (density_bricks_plain) gives
  sample_from_planes' plane-mean features bit for bit, density_grid_plain's
  densities within 1e-6 (the CPU matmul's blocking depends on the batch)
  and the JAX package's decode of the same lattice points within 1e-5, with
  and without eval generate's filters: on a slab of the N = 64 lattice of
  the tiny config's planes, and on bricks of the N = 256 lattice that cross
  the crop box's edge.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panic3d_tpu.eval import volume as jv
from panic3d_tpu_torch.eval import volume as tv
from panic3d_tpu_torch.models.volumetric import renderer as vr
from panic3d_tpu_torch.ops.grid_sample import _setup

from test_torch_volume import tiny  # noqa: F401  (the module-scoped tiny model fixture)

AXES = vr.generate_plane_axes(True)
CROP = 0.1


def all_bricks(N, bx):
    BX, BY, BZ = tv.K1V_BRICK
    by, bz = torch.meshgrid(torch.arange(N // BY), torch.arange(N // BZ), indexing="ij")
    return torch.stack([torch.full_like(by, bx), by, bz], -1).reshape(-1, 3)


@pytest.fixture
def one_thread():
    """torch on one thread for the whole-lattice loop: its many small ops
    run no faster on more, and many-fold slower beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("box_warp", [0.7, 1.0])
def test_windows_hold_every_corner(box_warp, one_thread):
    N, H, W = 256, 256, 256
    BX = tv.K1V_BRICK[0]
    lim = box_warp / 2 - CROP
    classes, largest = torch.zeros(3, dtype=torch.int64), 0
    for bx in range(N // BX):
        bricks = all_bricks(N, bx)
        xi, yi, zi = tv.k1v_bricks(N, bricks)
        coords = tv.lattice_coords((xi * N + yi) * N + zi, N, box_warp)
        x0, y0, _, _ = tv.k1v_corners(coords, box_warp, H, W, AXES)
        win = tv.k1v_windows(x0, y0)
        # the plain version's corners of the same points
        g = vr.project_onto_planes(AXES, (2.0 / box_warp) * coords.reshape(1, -1, 3))[0]
        for p in range(3):
            px, _ = _setup(g[p, :, 0], W, torch.float32, torch.float32)
            py, _ = _setup(g[p, :, 1], H, torch.float32, torch.float32)
            px, py = px.reshape(x0.shape[:2]), py.reshape(x0.shape[:2])
            assert torch.equal(px, x0[..., p]) and torch.equal(py, y0[..., p])
            assert bool((px >= win[:, None, p, 0]).all() and (px + 1 <= win[:, None, p, 2]).all()
                        and (py >= win[:, None, p, 1]).all()
                        and (py + 1 <= win[:, None, p, 3]).all())
        texels = ((win[..., 2] - win[..., 0] + 1) * (win[..., 3] - win[..., 1] + 1)).sum(1)
        largest = max(largest, int(texels.max()))
        kept = ~vr.triplane_crop_mask(coords, CROP, box_warp)[..., 0]
        cls = tv.k1v_crop_class(kept)
        # the class against each point's test: all out, all in, else straddling
        x, z = coords[..., 0].abs() <= lim, coords[..., 2].abs() <= lim
        assert torch.equal(cls == 0, ~(x & z).any(1))
        assert torch.equal(cls == 2, (x & z).all(1))
        classes += torch.bincount(cls, minlength=3)
    assert largest <= tv.K1V_POOL_TEXELS
    BX, BY, BZ = tv.K1V_BRICK
    assert int(classes.sum()) == (N // BX) * (N // BY) * (N // BZ)
    print(f"box_warp {box_warp}: largest windows {largest} texels; bricks all out / straddling "
          f"/ all in: {classes.tolist()}")
    assert classes.min() > 0


def jax_density(g, variables, planes, coords, filters):
    """The JAX package's density of lattice points coords [M, 3]: its
    sample_mixed_planes' sigma, sigma2density, the crop and the cull (the
    body of panic3d_tpu/eval/volume.py's density_grid)."""
    out = g.apply(variables, jnp.asarray(planes.numpy()), jnp.asarray(coords.numpy())[None],
                  method=type(g).sample_mixed_planes)
    d = jv.sigma2density(out["sigma"])
    crop, cull, _ = filters
    if crop:
        d = jnp.where(jv.triplane_crop_mask(jnp.asarray(coords.numpy())[None], crop, 0.7),
                      -1e3, d)
    if cull:
        d = jnp.where(jv.cull_clouds_mask(d, cull), -1e3, d)
    return np.asarray(d)[0, :, 0]


@pytest.mark.parametrize("filtered", [False, True], ids=["no-filters", "eval-filters"])
def test_bricks_decode_like_plain_and_jax(tiny, filtered):  # noqa: F811
    g, variables, G, _, xt = tiny
    _, planes = tv.portrait_planes(G, xt)
    dec = G._decoder()
    filters = vr.DensityFilters(CROP, 0.5) if filtered else vr.DensityFilters()
    N, bw = 64, 0.7
    bx = 8                                   # x-slices 32-35: through the middle of the box
    bricks = all_bricks(N, bx)
    d, feats, win = tv.density_bricks_plain(planes, dec, N, bw, AXES, filters, bricks)
    xi, yi, zi = tv.k1v_bricks(N, bricks)
    flat = (xi * N + yi) * N + zi
    coords = tv.lattice_coords(flat, N, bw)
    want_f = vr.sample_from_planes(AXES, planes, coords.reshape(1, -1, 3), bw).mean(1)
    assert torch.equal(feats.reshape(-1, feats.shape[-1]), want_f[0])
    start = bx * 4 * N * N
    plain = tv.density_grid_plain(planes, dec, N, bw, AXES, filters, torch.float32,
                                  start=start, stop=start + 4 * N * N)
    np.testing.assert_allclose(d.numpy(), plain[flat - start].numpy(), rtol=0, atol=1e-6)
    want = jax_density(g, variables, planes, coords.reshape(-1, 3), filters)
    np.testing.assert_allclose(d.reshape(-1).numpy(), want, rtol=0, atol=1e-5)
    if filtered:
        cls = tv.k1v_crop_class(d > -1e3)
        assert (cls == 0).any()


def test_bricks_at_full_size_cross_the_crop_edge():
    """Flagship-sized random planes [1,3,32,256,256] at N = 256: the bricks
    of x-slices 36-39 (x-brick 9, across the crop box's edge x = -0.25 at
    box_warp 0.7) in 2 y-bricks, every z: their windows fit, and their
    densities are density_grid_plain's."""
    N, bw = 256, 0.7
    r = np.random.RandomState(0)
    planes = torch.from_numpy(r.randn(1, 3, 32, 256, 256).astype(np.float32) * 0.5)
    gen = torch.Generator().manual_seed(0)
    dec = vr.Decoder(w0=torch.randn(64, 32, generator=gen), b0=torch.randn(64, generator=gen),
                     w1=torch.randn(33, 64, generator=gen), b1=torch.randn(33, generator=gen),
                     lr_mul=1.0, force_sigmoid=False)
    filters = vr.DensityFilters(CROP, None)
    bricks = all_bricks(N, 9)
    bricks = bricks[(bricks[:, 1] >= 15) & (bricks[:, 1] < 17)]
    d, _, win = tv.density_bricks_plain(planes, dec, N, bw, AXES, filters, bricks)
    texels = ((win[..., 2] - win[..., 0] + 1) * (win[..., 3] - win[..., 1] + 1)).sum(1)
    assert int(texels.max()) <= tv.K1V_POOL_TEXELS
    xi, yi, zi = tv.k1v_bricks(N, bricks)
    flat = (xi * N + yi) * N + zi
    lo, hi = int(flat.min()), int(flat.max()) + 1
    plain = tv.density_grid_plain(planes, dec, N, bw, AXES, filters, torch.float32,
                                  start=lo, stop=hi)
    np.testing.assert_allclose(d.numpy(), plain[flat - lo].numpy(), rtol=0, atol=1e-6)
    cls = tv.k1v_crop_class(d > -1e3)
    assert (cls == 1).any() and (cls == 2).any()
