"""Empty-space skipping in the port vs the JAX package (CPU, f32).

K6's plain versions -- the factorised lattice decode, the occupancy grid,
the interval narrowing with the per-ray stratified depths -- and the ESS
render, each against the JAX function on the same numpy inputs and
decoder weights. The occupancy is a threshold of a decoded density, so it
is compared cell by cell and the differing cells are counted (0 expected
at f32 on these inputs); everything downstream is fed the SAME occupancy,
so the narrowing is compared at 1e-6 and the render at the render
tolerance (importance resampling amplifies f32 rounding, ROADMAP F2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panic3d_tpu.models.volumetric import lattice as jlat
from panic3d_tpu.models.volumetric import renderer as jvr
from panic3d_tpu_torch.kernels import launch_counts
from panic3d_tpu_torch.models.volumetric import lattice as tlat
from panic3d_tpu_torch.models.volumetric import renderer as tvr

from test_torch_render import BW, RENDER_TOL, close, decoder_params, jax_decode_fn, t, \
    torch_decoder
from torch_one_thread import torch_one_thread  # noqa: F401  (autouse)

ESS = dict(grid=8, taps=16, thresh=0.01, margin=1.0)
FILTERS = (0.1, 0.5, None)                  # the eval path: crop 0.1, cull 0.5
# lattice decode: f32 on both sides, the same formulas; the two resample
# products and the MLP sum in different orders
LAT_TOL = dict(rtol=1e-5, atol=2e-5)
NARROW_TOL = dict(rtol=0, atol=1e-6)


def sparse_decoder(C, seed=0):
    """Decoder weights whose sigma straddles the cull threshold, so the
    occupancy is a mix of empty and occupied cells."""
    p = decoder_params(C, seed)
    p["net2"]["bias"][0] = 1.8
    return p


def planes_np(C=8, N=2, H=16, seed=1):
    return (3 * np.random.RandomState(seed).randn(N, 3, C, H, H)).astype(np.float32)


def test_resample_matrix_1d_matches_jax():
    coords = np.linspace(-1.3, 1.3, 41).astype(np.float32)
    for size in (13, 16):
        np.testing.assert_array_equal(tlat.resample_matrix_1d(coords, size),
                                      jlat.resample_matrix_1d(coords, size))
    for grid in ((8, 12, 16), (64, 64, 64)):
        for got, want in zip(tlat.lattice_axis_coords(grid, BW),
                             jlat.lattice_axis_coords(grid, BW)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("plane_reduce", ["stack", "mean"])
@pytest.mark.parametrize("use_triplane", [True, False])
def test_decode_lattice_matches_jax(plane_reduce, use_triplane):
    C = 8
    planes = planes_np(C)
    p = decoder_params(C, seed=3)
    grid = (8, 12, 10)
    want_s, want_rgb = jlat.decode_lattice(
        jnp.asarray(planes), jax_decode_fn(p, C, True), BW, grid, use_triplane=use_triplane,
        chunk_points=300, with_rgb=True, plane_reduce=plane_reduce)
    dec = torch_decoder(p, True)
    got_s, got_rgb = tlat.decode_lattice(
        t(planes), lambda f: tvr.osg_decode(f, dec), BW, grid, use_triplane=use_triplane,
        chunk_points=300, with_rgb=True, plane_reduce=plane_reduce)
    close(got_s, want_s, **LAT_TOL)
    close(got_rgb, want_rgb, **LAT_TOL)
    # the sigma-only decode the density consumers use gives the same sigma
    # (a one-row product: only the summation order differs)
    sig_only = tlat.decode_lattice(t(planes), lambda f: tvr.osg_decode(f, dec, sigma_only=True),
                                   BW, grid, use_triplane=use_triplane,
                                   plane_reduce=plane_reduce)
    close(sig_only, got_s, rtol=1e-6, atol=1e-6)


def occupancy_pair(C=8, seed=1):
    planes = planes_np(C, seed=seed)
    p = sparse_decoder(C)
    axes = jvr.generate_plane_axes(True)
    sigma_fn = lambda f: jax_decode_fn(p, C, True)(f, sigma_only=True)   # noqa: E731
    occ_j, out_j = jvr.ess_occupancy(
        axes, jnp.asarray(planes), sigma_fn, BW,
        dict(ess=ESS, use_triplane=True, decoder_mean_linear=True), *FILTERS, 2)
    occ_t, out_t = tvr.ess_occupancy(tvr.generate_plane_axes(True), t(planes),
                                     torch_decoder(p, True), BW, dict(ess=ESS),
                                     tvr.DensityFilters(*FILTERS))
    return planes, p, (np.asarray(occ_j), np.asarray(out_j)), (occ_t, out_t)


def test_ess_occupancy_matches_jax():
    _, _, (occ_j, out_j), (occ_t, out_t) = occupancy_pair()
    assert occ_t.shape == occ_j.shape == (2, 8, 8, 8)
    differ = int((occ_t.numpy() != occ_j).sum())
    assert differ == 0, f"{differ} occupancy cells differ"
    assert 0.05 < float(occ_t.mean()) < 0.95          # a mix, so the narrowing matters
    assert float(out_t) == float(out_j)
    assert sum(launch_counts().values()) == 0         # CPU tensors: plain versions only


def rays(N=2, R=64, seed=6):
    """Pinhole-like rays from z=1 looking -z through the box."""
    r = np.random.RandomState(seed)
    ro = np.tile(np.asarray([0.0, 0.0, 1.0], np.float32), (N, R, 1))
    rd = np.concatenate([r.uniform(-0.3, 0.3, (N, R, 2)), -np.ones((N, R, 1))], -1)
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    return ro, rd


def test_ess_narrowing_and_stratified_depths_match_jax():
    _, _, (occ_j, out_j), _ = occupancy_pair()
    ro, rd = rays()
    opts = dict(ess=ESS)
    t0_j, t1_j = jvr.ess_narrow_intervals(jnp.asarray(occ_j), jnp.asarray(out_j),
                                          jnp.asarray(ro), jnp.asarray(rd), 0.5, 1.5, BW, opts)
    d_j = jvr.sample_stratified(jnp.asarray(ro), t0_j, t1_j, 12)
    t0_t, t1_t, d_t = tvr.ess_narrow(t(occ_j), t(out_j), t(ro), t(rd), 0.5, 1.5, BW, opts, 12)
    close(t0_t, t0_j, **NARROW_TOL)
    close(t1_t, t1_j, **NARROW_TOL)
    close(d_t, d_j, **NARROW_TOL)
    span = (t1_t - t0_t).numpy()
    assert (span < 1.0 - 1e-6).any() and (span > 0).all()   # some rays were narrowed
    # the per-ray form of sample_stratified on its own
    close(tvr.sample_stratified(t(ro), t0_t, t1_t, 7),
          jvr.sample_stratified(jnp.asarray(ro), t0_j, t1_j, 7), **NARROW_TOL)


def test_ess_narrowing_rejects_step_over():
    occ = torch.zeros(1, 8, 8, 8)
    ro = torch.zeros(1, 2, 3)
    with pytest.raises(ValueError):
        tvr.ess_narrow(occ, torch.tensor(0.0), ro, ro, 0.5, 1.5, BW,
                       dict(ess=dict(grid=8, taps=8)), 4)


@pytest.mark.parametrize("n_importance", [0, 6])
def test_render_ess_vs_jax_with_injected_occupancy(n_importance):
    planes, p, (occ_j, out_j), _ = occupancy_pair()
    C, N = 8, 2
    ro, rd = rays(N, 36)
    opts = dict(box_warp=BW, ray_start=0.5, ray_end=1.5, depth_resolution=8,
                depth_resolution_importance=n_importance, white_back=True,
                use_triplane=True, render_dtype="float32", ess=ESS)
    ref = jvr.render(jnp.asarray(planes), jax_decode_fn(p, C, True), jnp.asarray(ro),
                       jnp.asarray(rd),
                       dict(opts, ray_chunk=None,
                            _ess_occ=(jnp.asarray(occ_j), jnp.asarray(out_j))),
                       triplane_crop=0.1, cull_clouds=0.5)
    out_t = tvr.render(t(planes), torch_decoder(p, True), t(ro), t(rd),
                       dict(opts, _ess_occ=(t(occ_j), t(out_j))),
                       triplane_crop=0.1, cull_clouds=0.5)
    for a, b in zip(out_t, ref):
        close(a, b, **RENDER_TOL)
    # without a pre-seeded occupancy the render computes the same one
    out_self = tvr.render(t(planes), torch_decoder(p, True), t(ro), t(rd), opts,
                          triplane_crop=0.1, cull_clouds=0.5)
    for a, b in zip(out_self, out_t):
        close(a, b, rtol=0, atol=0)
