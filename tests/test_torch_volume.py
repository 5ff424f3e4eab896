"""The port's volume and mesh path (eval/volume.py) vs the JAX package's, on
the tiny config on the CPU, in f32.

One numpy-seeded set of weights (test_torch_generator.seeded_variables) is
loaded into both packages, the port's through state_dict_from_flax. Checked:

- the lattice: create_samples and create_samples_device are bit-identical
  to the JAX package's, at N=16 and on a slab of the N=256 lattice;
- get_volume at resolution 16, chunk 1024: coordinates equal; sigmas, rgbs
  and densities within 1e-5 (f32 decode, summation order);
- extract_mesh without filters, with an f32 grid and with the fp16 grid:
  identical faces, verts within 1e-5 (index interpolation of grids that
  agree to ~1e-7), vertex colours within 1e-4 (decoded at those verts);
- extract_mesh with eval generate's filters (crop 0.1, cull 0.5) and the
  decoder's sigma bias raised so that voxels survive the density cull: no
  cull decision differs at this seeded configuration (a density within f32
  rounding of 1.0 decides the cull, so a flip is reported before the
  assertion fails), densities within 1e-5, and identical faces;
- K1v's plain version (density_grid_plain) on a slab against the same
  lattice decoded by the JAX package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panic3d_tpu import configs as jcfg
from panic3d_tpu.eval import volume as jv
from panic3d_tpu_torch import configs as tcfg
from panic3d_tpu_torch.eval import volume as tv
from panic3d_tpu_torch.kernels import launch_counts
from panic3d_tpu_torch.models.volumetric import renderer as vr
from panic3d_tpu_torch.runtime.checkpoint import state_dict_from_flax

from test_torch_generator import F32, seeded_variables
from torch_one_thread import torch_one_thread  # noqa: F401  (autouse)

RES, CHUNK = 16, 1024
FILTERS = dict(triplane_crop=0.1, cull_clouds=0.5)
SIGMA_BIAS = 12.0   # added to net2's sigma bias for the filtered mesh


def _models(variables):
    G = tcfg.tiny(device="cpu", **F32).eval()
    G.load_state_dict(state_dict_from_flax(variables), strict=True)
    return G


@pytest.fixture(scope="module")
def tiny():
    r = np.random.RandomState(3)
    cond = {"image_ortho_front": r.rand(1, 3, 64, 64).astype(np.float32),
            "resnet_chonk": r.randn(1, 16, 8, 8).astype(np.float32)}
    z = r.randn(1, 64).astype(np.float32)
    g = jcfg.tiny(**F32)
    xj = {"z": jnp.asarray(z), "elevations": jnp.zeros(1), "azimuths": jnp.zeros(1),
          "cond": {k: jnp.asarray(v) for k, v in cond.items()}}
    variables = seeded_variables(g, dict(xj, fovs=jnp.full((1,), 30.0)))
    xt = {"z": z, "cond": {k: torch.from_numpy(v) for k, v in cond.items()}}
    return g, variables, _models(variables), xj, xt


@pytest.fixture(scope="module")
def volumes(tiny):
    g, variables, G, xj, xt = tiny
    return (jv.get_volume(g, variables, xj, resolution=RES, chunk=CHUNK),
            tv.get_volume(G, xt, resolution=RES, chunk=CHUNK))


@pytest.mark.parametrize("N,start,stop", [(16, 0, 16**3), (256, 5_000_000, 5_000_000 + 2**16),
                                          (256, 2**24 - 2**16, 2**24)],
                         ids=["16", "256-slab", "256-last-slab"])
def test_create_samples_bit_identical(N, start, stop):
    jd = np.asarray(jv.create_samples_device(N, 0.7, 2**12 if N == 16 else 2**16))
    td = tv.create_samples_device(N, 0.7, start, stop, device="cpu").numpy()
    np.testing.assert_array_equal(td, jd.reshape(-1, 3)[start:stop])
    if N == 16:
        np.testing.assert_array_equal(tv.create_samples(N, 0.7), jv.create_samples(N, 0.7))
        np.testing.assert_array_equal(tv.create_samples(N, 0.7), td)


def test_get_volume_matches_jax(volumes):
    vj, vt = volumes
    assert set(vt) == {"coordinates", "sigmas", "rgbs", "densities"}
    np.testing.assert_array_equal(vt["coordinates"], vj.coordinates)
    for k in ("sigmas", "rgbs", "densities"):
        assert vt[k].shape == vj[k].shape, k
        np.testing.assert_allclose(vt[k], vj[k], rtol=0, atol=1e-5, err_msg=k)
    assert sum(launch_counts().values()) == 0


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_extract_mesh_matches_jax(tiny, volumes, dtype):
    g, variables, G, xj, xt = tiny
    level = float(np.quantile(volumes[0].densities, 0.7))     # a surface through the grid
    mj = jv.extract_mesh(g, variables, xj, resolution=RES, chunk=CHUNK, level=level,
                         density_dtype=getattr(jnp, dtype))
    mt = tv.extract_mesh(G, xt, resolution=RES, chunk=CHUNK, level=level,
                         density_dtype=getattr(torch, dtype))
    assert len(mt["faces"]) > 100
    np.testing.assert_array_equal(mt["faces"], mj.faces)
    np.testing.assert_allclose(mt["verts"], mj.verts, rtol=0, atol=1e-5)
    np.testing.assert_allclose(mt["colors"], mj.colors, rtol=0, atol=1e-4)
    assert mt["colors"].min() >= 0 and mt["colors"].max() <= 1


def test_extract_mesh_with_filters_matches_jax(tiny):
    g, variables, _, xj, xt = tiny
    v2 = jax.tree_util.tree_map(np.array, variables)
    v2["params"]["decoder"]["net2"]["bias"][0] += SIGMA_BIAS
    G2 = _models(v2)
    # the filtered density grids, in the layout marching tetrahedra reads
    dj = jv.get_volume(g, v2, dict(xj, **FILTERS), resolution=RES, chunk=CHUNK).densities[0, 0]
    _, planes = tv.portrait_planes(G2, xt)
    dt = tv.density_grid(planes, G2._decoder(), RES, 0.7, vr.generate_plane_axes(True),
                         vr.DensityFilters(**FILTERS), torch.float32).numpy()
    kept_j, kept_t = dj > -1e3, dt > -1e3
    flips = int((kept_j != kept_t).sum())
    print(f"cull decisions that differ: {flips} of {dt.size}; kept {int(kept_t.sum())}")
    assert flips == 0
    assert 0 < kept_t.sum() < dt.size // 2                 # something survives, not all
    np.testing.assert_allclose(dt, dj, rtol=0, atol=1e-5)
    mj = jv.extract_mesh(g, v2, dict(xj, **FILTERS), resolution=RES, chunk=CHUNK,
                         density_dtype=jnp.float32)
    mt = tv.extract_mesh(G2, dict(xt, **FILTERS), resolution=RES, chunk=CHUNK,
                         density_dtype=torch.float32)
    assert len(mt["faces"]) > 0
    np.testing.assert_array_equal(mt["faces"], mj.faces)
    np.testing.assert_allclose(mt["verts"], mj.verts, rtol=0, atol=1e-5)


def test_density_grid_plain_slab_matches_jax_decode(tiny):
    """K1v's plain version on a slab of flat indices (as chip_smoke.py
    checks the kernel) against the JAX package's sigma decode of the same
    lattice points, then sigma2density: within 1e-5."""
    g, variables, G, xj, xt = tiny
    _, planes = tv.portrait_planes(G, xt)
    start, stop = 1000, 3000
    got = tv.density_grid_plain(planes, G._decoder(), RES, 0.7, vr.generate_plane_axes(True),
                                vr.DensityFilters(), torch.float32, chunk=512,
                                start=start, stop=stop)
    pj = g.apply(variables, jnp.asarray(planes.numpy()),
                 jnp.asarray(jv.create_samples(RES, 0.7)[None, start:stop]),
                 method=type(g).sample_mixed_planes)
    want = np.asarray(jv.sigma2density(pj["sigma"]))[0, :, 0]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    full = tv.density_grid(planes, G._decoder(), RES, 0.7, vr.generate_plane_axes(True),
                           vr.DensityFilters(), torch.float32, chunk=700)
    # the flipped layout holds the same lattice points (the CPU matmul's
    # blocking depends on the chunk, hence 1e-6)
    np.testing.assert_allclose(full.flip(0).reshape(-1)[start:stop], got, rtol=0, atol=1e-6)


def test_marching_cubes_matches_jax(volumes):
    vj, vt = volumes
    level = float(np.quantile(vt["densities"], 0.6))
    want = jv.marching_cubes(vj.densities[0, 0], vj.rgbs[0, :3], 0.7, level=level)
    got = tv.marching_cubes(vt["densities"][0, 0], vt["rgbs"][0, :3], 0.7, level=level)
    np.testing.assert_array_equal(got["faces"], want.faces)
    np.testing.assert_allclose(got["verts"], want.verts, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["colors"], want.colors, rtol=0, atol=1e-5)
