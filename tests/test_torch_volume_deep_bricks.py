"""K10's lattice form (csrc/triplane_decode.cu:volume_density_kernel at depth),
proved on the CPU with eval/volume.py's mirror of it.

K10's lattice form is K1v's brick kernel on the deep planes: K1v's bricks
of 4 x 8 x 16 lattice points, and per plane a window of the texels its corners
touch in (x, y) times the depth slices its corners' z0 .. z0 + 1 touch
inside the volume, staged in shared memory.

- At N = 256 over random flagship-sized deep planes (C = 32, D = 2,
  256^2), box_warp 0.7: every trilinear corner of every lattice point is
  grid_sample_3d_points' own (ops/grid_sample.py:_setup on
  sample_from_planes' projection), lies in its brick's window (x, y and
  the slices inside the volume; a corner's z0 is -1, 0 or 1), the three
  windows fit the K10V_POOL_TEXELS texel slices the kernel stages, and the
  brick crop classes agree with the per-point crop test; the features of
  bricks across the crop box's edge, read through their windows, are
  sample_from_planes' plane means bit for bit.
- Decoding bricks through their windows (density_bricks_plain at depth 2)
  gives sample_from_planes' plane-mean features bit for bit,
  density_grid_plain's densities within 1e-6 (the CPU matmul's blocking
  depends on the batch) and the JAX package's deep density grid (its
  sample_mixed_planes' sigma, sigma2density, the crop and the cull: the
  body of panic3d_tpu/eval/volume.py's density_grid) within 1e-5, with and
  without eval generate's filters, on a slab of the N = 32 lattice of the
  tiny depth-2 config's planes (net2's sigma bias raised by SIGMA_BIAS so
  that some voxels survive the cull).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panic3d_tpu import configs as jcfg
from panic3d_tpu.eval import volume as jv
from panic3d_tpu.models.triplane import TriPlaneGenerator as JG
from panic3d_tpu_torch import configs as tcfg
from panic3d_tpu_torch.eval import volume as tv
from panic3d_tpu_torch.models.volumetric import renderer as vr
from panic3d_tpu_torch.ops.grid_sample import _setup
from panic3d_tpu_torch.runtime.checkpoint import state_dict_from_flax

from test_torch_generator import F32, seeded_variables

AXES = vr.generate_plane_axes(True)
CROP = 0.1
DEPTH = 2
SIGMA_BIAS = 14.0   # added to net2's sigma bias so that some voxels survive the cull


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


def test_windows_hold_every_corner(one_thread):
    N, C, H, W, bw = 256, 32, 256, 256, 0.7
    BX, BY, BZ = tv.K1V_BRICK
    lim = bw / 2 - CROP
    classes, largest, z_seen = torch.zeros(3, dtype=torch.int64), 0, set()
    for bx in range(N // BX):
        bricks = all_bricks(N, bx)
        xi, yi, zi = tv.k1v_bricks(N, bricks)
        coords = tv.lattice_coords((xi * N + yi) * N + zi, N, bw)
        x0, y0, z0, _, _, _ = tv.k1v_corners(coords, bw, H, W, AXES, DEPTH)
        win = tv.k1v_windows(x0, y0, z0, DEPTH)
        # the plain version's corners of the same points
        g = vr.project_onto_planes(AXES, (2.0 / bw) * coords.reshape(1, -1, 3))[0]
        for p in range(3):
            px, _ = _setup(g[p, :, 0], W, torch.float32, torch.float32)
            py, _ = _setup(g[p, :, 1], H, torch.float32, torch.float32)
            pz, _ = _setup(g[p, :, 2], DEPTH, torch.float32, torch.float32)
            px, py, pz = (v.reshape(x0.shape[:2]) for v in (px, py, pz))
            assert torch.equal(px, x0[..., p]) and torch.equal(py, y0[..., p])
            assert torch.equal(pz, z0[..., p])
            assert bool((px >= win[:, None, p, 0]).all() and (px + 1 <= win[:, None, p, 3]).all()
                        and (py >= win[:, None, p, 1]).all()
                        and (py + 1 <= win[:, None, p, 4]).all())
            # each corner slice inside the volume is a slice of the window
            for dz in (0, 1):
                z = pz + dz
                inside = (z >= 0) & (z < DEPTH)
                assert bool(((z >= win[:, None, p, 2]) & (z <= win[:, None, p, 5]))[inside].all())
            z_seen |= set(pz.unique().tolist())
        largest = max(largest, int(tv.k1v_window_texels(win).max()))
        kept = ~vr.triplane_crop_mask(coords, CROP, bw)[..., 0]
        cls = tv.k1v_crop_class(kept)
        x, z = coords[..., 0].abs() <= lim, coords[..., 2].abs() <= lim
        assert torch.equal(cls == 0, ~(x & z).any(1))
        assert torch.equal(cls == 2, (x & z).all(1))
        classes += torch.bincount(cls, minlength=3)
    assert z_seen == {-1, 0, 1}
    assert largest <= tv.K10V_POOL_TEXELS
    assert int(classes.sum()) == (N // BX) * (N // BY) * (N // BZ)
    assert classes.min() > 0
    print(f"largest windows {largest} texel slices; bricks all out / straddling / all in: "
          f"{classes.tolist()}")

    # random deep planes: the features of the bricks of x-slices 36-39
    # (across the crop box's edge x = -0.25) in 2 y-bricks, every z, read
    # through their windows, are the plain trilinear sampler's plane means
    r = np.random.RandomState(0)
    planes = torch.from_numpy(r.randn(1, 3, C * DEPTH, H, W).astype(np.float32) * 0.5)
    bricks = all_bricks(N, 9)
    bricks = bricks[(bricks[:, 1] >= 30) & (bricks[:, 1] < 32)]
    gen = torch.Generator().manual_seed(0)
    dec = vr.Decoder(w0=torch.randn(64, C, generator=gen), b0=torch.randn(64, generator=gen),
                     w1=torch.randn(33, 64, generator=gen), b1=torch.randn(33, generator=gen),
                     lr_mul=1.0, force_sigmoid=False)
    d, feats, win = tv.density_bricks_plain(planes, dec, N, bw, AXES,
                                            vr.DensityFilters(CROP, None), bricks, DEPTH)
    assert int(tv.k1v_window_texels(win).max()) <= tv.K10V_POOL_TEXELS
    xi, yi, zi = tv.k1v_bricks(N, bricks)
    coords = tv.lattice_coords((xi * N + yi) * N + zi, N, bw)
    want = vr.sample_from_planes(AXES, planes, coords.reshape(1, -1, 3), bw, DEPTH).mean(1)
    assert torch.equal(feats.reshape(-1, C), want[0])
    cls = tv.k1v_crop_class(d > -1e3)
    assert (cls == 1).any() and (cls == 2).any()


@pytest.fixture(scope="module")
def tiny_deep():
    r = np.random.RandomState(3)
    z = r.randn(1, 64).astype(np.float32)
    cond = {"image_ortho_front": r.rand(1, 3, 64, 64).astype(np.float32),
            "resnet_chonk": r.randn(1, 16, 8, 8).astype(np.float32)}
    kw = dict(F32, rendering_kwargs=dict(F32["rendering_kwargs"], triplane_depth=DEPTH))
    g = jcfg.tiny(**kw)
    xj = {"z": jnp.asarray(z), "elevations": jnp.zeros(1), "azimuths": jnp.zeros(1),
          "cond": {k: jnp.asarray(v) for k, v in cond.items()}}
    variables = seeded_variables(g, xj)
    variables["params"]["decoder"]["net2"]["bias"][0] += SIGMA_BIAS
    G = tcfg.tiny(device="cpu", **kw).eval()
    G.load_state_dict(state_dict_from_flax(variables), strict=True)
    _, planes = tv.portrait_planes(G, {"z": z, "cond": {k: torch.from_numpy(v)
                                                        for k, v in cond.items()}})
    return g, variables, G, planes


def jax_density(g, variables, planes, coords, filters, bw):
    """The JAX package's density of lattice points coords [M, 3] on the
    given deep planes: its sample_mixed_planes' sigma, sigma2density, the
    crop and the cull (the body of panic3d_tpu/eval/volume.py's
    density_grid)."""
    crop, cull, _ = filters

    @jax.jit
    def density(v, p, c):
        out = g.apply(v, p, c[None], method=JG.sample_mixed_planes)
        d = jv.sigma2density(out["sigma"])
        if crop:
            d = jnp.where(jv.triplane_crop_mask(c[None], crop, bw), -1e3, d)
        if cull:
            d = jnp.where(jv.cull_clouds_mask(d, cull), -1e3, d)
        return d[0, :, 0]

    return np.asarray(density(variables, jnp.asarray(planes.numpy()),
                              jnp.asarray(coords.numpy())))


@pytest.mark.parametrize("filtered", [False, True], ids=["no-filters", "eval-filters"])
def test_deep_bricks_decode_like_plain_and_jax(tiny_deep, filtered):
    g, variables, G, planes = tiny_deep
    dec, bw = G._decoder(), G.rk["box_warp"]
    filters = vr.DensityFilters(CROP, 0.5) if filtered else vr.DensityFilters()
    N = 32
    # x-slices 0-7: outside the crop box, then across its edge x = -0.25
    bricks = torch.cat([all_bricks(N, 0), all_bricks(N, 1)])
    d, feats, win = tv.density_bricks_plain(planes, dec, N, bw, AXES, filters, bricks, DEPTH)
    xi, yi, zi = tv.k1v_bricks(N, bricks)
    flat = (xi * N + yi) * N + zi
    coords = tv.lattice_coords(flat, N, bw)
    C = planes.shape[2] // DEPTH
    want_f = vr.sample_from_planes(AXES, planes, coords.reshape(1, -1, 3), bw, DEPTH).mean(1)
    assert torch.equal(feats.reshape(-1, C), want_f[0])
    plain = tv.density_grid_plain(planes, dec, N, bw, AXES, filters, torch.float32,
                                  stop=2 * tv.K1V_BRICK[0] * N * N, triplane_depth=DEPTH)
    np.testing.assert_allclose(d.numpy(), plain[flat].numpy(), rtol=0, atol=1e-6)
    want = jax_density(g, variables, planes, coords.reshape(-1, 3), filters, bw)
    np.testing.assert_allclose(d.reshape(-1).numpy(), want, rtol=0, atol=1e-5)
    if filtered:
        # bricks all cropped, and bricks across the edge where the cull keeps some
        assert set(tv.k1v_crop_class(d > -1e3).tolist()) == {0, 1}
