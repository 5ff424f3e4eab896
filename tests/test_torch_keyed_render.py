"""The keyed render (the JAX package's render_key) and the 'auto' ray
bounds in the port, against the JAX package on the CPU.

The JAX functions draw their jitter and u with jax.random.uniform; the tests
record those draws (a spy on jax.random.uniform, inside the jitted JAX
function, returns them beside its outputs) and feed the same numbers to the
port as ``jitter=`` and ``u=``. Held: get_ray_limits_box and the 'auto'
fill exactly; the stratified depths (fixed, per-ray and disparity-space)
within one f32 rounding of the value (a few in disparity space: XLA rounds
its linspace and fuses the multiply-adds its own way) and sample_pdf within
1e-5 (its cumsum's order); K3's and K6b's keyed
orders of operations (importance_sample_warp_order with u,
ess_narrow_warp_order with per-ray bounds and a jitter) against their plain
versions, K6b's bit for bit and reducing to its fixed-bound, midpoint form
exactly; and the tiny render with a key, ESS off and on and with 'auto'
bounds, against the JAX render at the render tolerance (ROADMAP F2).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panic3d_tpu.models.volumetric import renderer as jvr
from panic3d_tpu_torch.kernels import launch_counts
from panic3d_tpu_torch.models.volumetric import renderer as tvr
from panic3d_tpu_torch.utils import draws

from test_torch_ess import ESS, rays
from test_torch_ess import occupancy_pair as _occupancy_pair
from test_torch_importance_scan import rays as coarse_rays
from test_torch_render import BW, RENDER_TOL, close, jax_decode_fn, t, torch_decoder

ULP_TOL = dict(rtol=0, atol=2.5e-7)     # one f32 rounding of values below 2
DISP_TOL = dict(rtol=5e-7, atol=0)      # a reciprocal of a sum: a few roundings
occupancy_pair = functools.lru_cache(maxsize=1)(_occupancy_pair)   # one JAX compile
IMP_TOL = dict(rtol=0, atol=1e-5)       # the cdf's cumsum in another order


@pytest.fixture
def recorded(monkeypatch):
    """A spy on jax.random.uniform: the draws made while a JAX function is
    traced, in order (return them from the jitted function)."""
    rec = []
    real = jax.random.uniform

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        rec.append(out)
        return out

    monkeypatch.setattr(jax.random, "uniform", spy)
    return rec


def keyed(fn, rec):
    """jit(fn) returning (fn's output, the draws recorded while tracing)."""
    def run(*args):
        rec.clear()
        out = fn(*args)
        return out, list(rec)
    return jax.jit(run)


def test_ray_limits_and_auto_fill_match_jax():
    r = np.random.RandomState(3)
    ro = np.tile(np.asarray([0.0, 0.0, 1.0], np.float32), (2, 50, 1))
    rd = np.concatenate([r.uniform(-1.2, 1.2, (2, 50, 2)), -np.ones((2, 50, 1))], -1)
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    rd[0, 0] = (1.0, 0.0, 0.0)            # parallel to two faces, outside the box
    got = tvr.get_ray_limits_box(t(ro), t(rd), BW)
    want = jvr.get_ray_limits_box(jnp.asarray(ro), jnp.asarray(rd), BW)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    valid = got[2].numpy()
    assert 0 < valid.sum() < valid.size and not valid[0, 0, 0]
    # the fill of renderer.py:980-989: the batch's least and greatest valid start
    rs, re = tvr.auto_ray_limits(t(ro), t(rd), BW)
    js, je, jv = want
    big, small = jnp.where(jv, js, jnp.inf), jnp.where(jv, js, -jnp.inf)
    np.testing.assert_array_equal(rs.numpy(), np.asarray(jnp.where(jv, js, jnp.min(big))))
    np.testing.assert_array_equal(re.numpy(), np.asarray(jnp.where(jv, je, jnp.max(small))))
    assert np.all(rs.numpy()[~valid] == np.asarray(big).min())


@pytest.mark.parametrize("form", ["fixed", "per_ray", "disparity"])
def test_sample_stratified_with_jax_draws(recorded, form):
    N, M, S = 2, 40, 12
    ro = jnp.zeros((N, M, 3))
    r = np.random.RandomState(5)
    if form == "per_ray":
        rs = r.uniform(0.4, 0.8, (N, M, 1)).astype(np.float32)
        bounds = (rs, rs + r.uniform(0.2, 0.9, (N, M, 1)).astype(np.float32))
    else:
        bounds = (0.5, 1.5)
    disp = form == "disparity"
    jb = tuple(jnp.asarray(b) if isinstance(b, np.ndarray) else b for b in bounds)
    tb = tuple(t(b) if isinstance(b, np.ndarray) else b for b in bounds)
    fn = keyed(lambda key: jvr.sample_stratified(ro, *jb, S, key=key,
                                                 disparity_space_sampling=disp), recorded)
    want, (jitter,) = fn(jax.random.PRNGKey(7))
    assert jitter.shape == (N, M, S, 1)
    got = tvr.sample_stratified(t(np.asarray(ro)), *tb, S, jitter=t(np.asarray(jitter)),
                                disparity_space_sampling=disp)
    close(got, want, **(DISP_TOL if disp else ULP_TOL))
    assert (np.diff(got.numpy()[..., 0], axis=-1) > 0).all()   # strata stay in order
    # a generator draws a jitter of the same shape; without one, the midpoints
    g = torch.Generator().manual_seed(0)
    a = tvr.sample_stratified(t(np.asarray(ro)), *tb, S, generator=g,
                              disparity_space_sampling=disp)
    mid = tvr.sample_stratified(t(np.asarray(ro)), *tb, S, disparity_space_sampling=disp)
    half = tvr.sample_stratified(t(np.asarray(ro)), *tb, S, jitter=torch.full((N, M, S, 1), 0.5),
                                 disparity_space_sampling=disp)
    assert a.shape == mid.shape == (N, M, S, 1) and not torch.equal(a, mid)
    close(half, mid, **(DISP_TOL if disp else ULP_TOL))


def test_sample_pdf_with_jax_draws(recorded):
    r = np.random.RandomState(9)
    R, B, K = 30, 13, 16
    bins = np.sort(r.uniform(0.5, 1.5, (R, B)), -1).astype(np.float32)
    w = r.uniform(0, 1, (R, B - 3)).astype(np.float32)
    w[0] = 0.0                                    # an empty ray: a flat pdf
    fn = keyed(lambda key: jvr.sample_pdf(jnp.asarray(bins), jnp.asarray(w), K, key=key),
               recorded)
    want, (u,) = fn(jax.random.PRNGKey(3))
    assert u.shape == (R, K)
    got = tvr.sample_pdf(t(bins), t(w), K, u=t(np.asarray(u)))
    close(got, want, **IMP_TOL)
    # the fine depths follow u, not the ray's order
    assert (np.diff(got.numpy(), axis=-1) < 0).any()
    with pytest.raises(ValueError, match="u must be"):
        tvr.sample_pdf(t(bins), t(w), K, u=torch.zeros(R, K + 1))


@pytest.mark.parametrize("S,K", [(8, 8), (48, 48), (96, 96), (37, 20)])
def test_k3_u_form_against_plain(S, K):
    depths, sigmas = coarse_rays(S, seed=S + 1)
    d, s = torch.from_numpy(depths), torch.from_numpy(sigmas)
    u = torch.rand((d.shape[0] * d.shape[1], K), generator=torch.Generator().manual_seed(S))
    u[0, 0], u[1, -1] = 0.0, 1.0 - 2.0 ** -24     # the ends of [0, 1)
    got, searched, counted = tvr.importance_sample_warp_order(d, s, K, u=u)
    assert torch.equal(searched, counted)
    plain = tvr.importance_sample_plain(d, s, K, u=u)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=1e-4)
    assert (np.diff(got.numpy()[..., 0], axis=-1) < 0).any()   # unsorted along the ray
    # without u: linspace, as before
    lin = torch.linspace(0, 1, K).expand(u.shape).contiguous()
    assert torch.equal(tvr.importance_sample_warp_order(d, s, K)[0],
                       tvr.importance_sample_warp_order(d, s, K, u=lin)[0])


@pytest.mark.parametrize("bounds", ["fixed", "per_ray"])
def test_k6b_per_ray_and_jitter_against_plain(bounds):
    _, _, (occ_j, out_j), _ = occupancy_pair()
    ro, rd = (t(a) for a in rays())
    N, R, S = ro.shape[0], ro.shape[1], 12
    occ, out = t(occ_j), t(out_j)
    opts = dict(ess=ESS)
    if bounds == "per_ray":
        rs, re = tvr.auto_ray_limits(ro, rd, BW)
        rs, re = rs.contiguous(), re.contiguous()
    else:
        rs, re = 0.5, 1.5
    jitter = torch.rand((N, R, S, 1), generator=torch.Generator().manual_seed(1))
    got = tvr.ess_narrow_warp_order(occ, out, ro, rd, rs, re, BW, opts, S, jitter=jitter)
    want = tvr.ess_narrow_plain(occ, out, ro, rd, rs, re, BW, opts, S, jitter=jitter)
    for g, w, name in zip(got, want, ("t0", "t1", "depths")):
        assert torch.equal(g, w), f"{name}: max diff {float((g - w).abs().max())}"
    # jitter 0.5 and bounds filled from the floats are the eval form exactly
    base = tvr.ess_narrow_warp_order(occ, out, ro, rd, 0.5, 1.5, BW, opts, S)
    filled = tvr.ess_narrow_warp_order(occ, out, ro, rd, torch.full((N, R, 1), 0.5),
                                       torch.full((N, R, 1), 1.5), BW, opts, S,
                                       jitter=torch.full((N, R, S, 1), 0.5))
    for g, w in zip(filled, base):
        assert torch.equal(g, w)
    assert torch.equal(base[2], tvr.ess_narrow_plain(occ, out, ro, rd, 0.5, 1.5, BW, opts, S)[2])
    # per-ray spans take the no-step-over check at the box diagonal
    with pytest.raises(ValueError, match="cannot cover"):
        tvr.ess_narrow_plain(occ, out, ro, rd, rs if bounds == "per_ray" else torch.full(
            (N, R, 1), 0.5), torch.full((N, R, 1), 1.5), BW, dict(ess=dict(ESS, taps=13)), S)


@pytest.mark.parametrize("case", ["ess_off", "ess_on", "auto"])
def test_keyed_render_against_jax(recorded, case):
    planes, p, (occ_j, out_j), _ = occupancy_pair()
    C, N = 8, 2
    ro, rd = rays(N, 36)
    opts = dict(box_warp=BW, ray_start=0.5, ray_end=1.5, depth_resolution=8,
                depth_resolution_importance=6, white_back=True, use_triplane=True,
                render_dtype="float32")
    if case != "ess_off":
        opts["ess"] = ESS
    if case == "auto":
        opts.update(ray_start="auto", ray_end="auto")
    crop = None if case == "auto" else 0.1      # see test_torch_generator (F2 at the crop edge)
    seeded = {} if case == "ess_off" else dict(_ess_occ=(jnp.asarray(occ_j), jnp.asarray(out_j)))
    fn = keyed(lambda pl, o, d, key: jvr.render(
        pl, jax_decode_fn(p, C, True), o, d, dict(opts, ray_chunk=None, **seeded), key=key,
        triplane_crop=crop, cull_clouds=0.5), recorded)
    ref, (jitter, u) = fn(jnp.asarray(planes), jnp.asarray(ro), jnp.asarray(rd),
                          jax.random.PRNGKey(11))
    assert jitter.shape == (N, 36, 8, 1) and u.shape == (N * 36, 6)
    tseed = {} if case == "ess_off" else dict(_ess_occ=(t(occ_j), t(out_j)))
    kw = dict(triplane_crop=crop, cull_clouds=0.5)
    args = (t(planes), torch_decoder(p, True), t(ro), t(rd), dict(opts, **tseed))
    out = tvr.render(*args, jitter=t(np.asarray(jitter)), u=t(np.asarray(u)), **kw)
    for a, b in zip(out, ref):
        close(a, b, **RENDER_TOL)
    # the same draws through a Replay, and a generator's draws: a keyed
    # render that differs from the midpoint one
    rep = draws.Replay(uniform=[np.asarray(jitter), np.asarray(u)])
    again = tvr.render(*args, generator=rep, **kw)
    assert all(torch.equal(a, b) for a, b in zip(out, again)) and rep.left()["uniform"] == 0
    mid = tvr.render(*args, **kw)
    assert not torch.equal(out.depth, mid.depth)
    assert sum(launch_counts().values()) == 0
