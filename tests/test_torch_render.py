"""Kernels K1-K3's plain PyTorch versions vs the JAX ops they replace (CPU).

K1 triplane_decode   vs renderer.run_model + OSGDecoder + _apply_density_filters
K2 ray_composite     vs ray_march(unify_samples(...)) and merge_composite
K3 importance_sample vs ray_march -> sample_importance
plus the port's render() against the JAX render at f32.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panic3d_tpu.models.triplane import OSGDecoder as JDecoder
from panic3d_tpu.models.volumetric import renderer as jvr
from panic3d_tpu_torch.kernels import launch_counts
from panic3d_tpu_torch.models.volumetric import renderer as tvr
from torch_one_thread import torch_one_thread  # noqa: F401  (autouse)

BW = 0.7
# f32 on both sides, the same formulas; only summation order differs
TOL = dict(rtol=1e-5, atol=1e-5)
# the searchsorted bracket edges: jnp.linspace and torch.linspace may round
# u differently in the last place, which moves a depth inside its bracket
IMP_TOL = dict(rtol=1e-4, atol=1e-4)
# the whole render: importance resampling amplifies f32 rounding (ROADMAP F2)
RENDER_TOL = dict(rtol=2e-3, atol=2e-3)


def t(a):
    return torch.from_numpy(np.asarray(a))


def close(got, want, **tol):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, **tol)


def decoder_params(C, seed=0):
    r = np.random.RandomState(seed)
    return {"net0": {"weight": r.randn(64, C).astype(np.float32),
                     "bias": (r.randn(64) * 0.1).astype(np.float32)},
            "net2": {"weight": r.randn(33, 64).astype(np.float32),
                     "bias": (r.randn(33) * 0.1 + np.eye(33)[0] * 2.5).astype(np.float32)}}


def torch_decoder(p, force_sigmoid):
    return tvr.Decoder(t(p["net0"]["weight"]), t(p["net0"]["bias"]), t(p["net2"]["weight"]),
                       t(p["net2"]["bias"]), 1.0, force_sigmoid)


def jax_decode_fn(p, C, force_sigmoid):
    params = {"params": jax.tree_util.tree_map(jnp.asarray, p)}
    dec = JDecoder(C)
    return lambda feats, **kw: dec.apply(params, feats, force_sigmoid=force_sigmoid, **kw)


@pytest.mark.parametrize("C,use_triplane,force_sigmoid,filters", [
    (8, True, True, (0.1, 0.5, None)),     # the eval path: crop 0.1, cull 0.5
    (32, True, False, (None, None, None)),
    (8, False, True, (0.1, None, 0.5)),    # binarize_clouds
])
def test_k1_triplane_decode_plain_vs_jax(C, use_triplane, force_sigmoid, filters):
    r = np.random.RandomState(1)
    planes = r.randn(2, 3, C, 16, 16).astype(np.float32)
    coords = r.uniform(-0.45, 0.45, (2, 500, 3)).astype(np.float32)
    p = decoder_params(C)
    axes = jvr.generate_plane_axes(use_triplane)
    rgb_j, sig_j = jvr.run_model(axes, jnp.asarray(planes), jax_decode_fn(p, C, force_sigmoid),
                                 jnp.asarray(coords), BW)
    sig_j = jvr._apply_density_filters(sig_j, jnp.asarray(coords), BW, *filters)
    planes_cl = t(planes).permute(0, 1, 3, 4, 2).contiguous()
    rgb_t, sig_t = tvr.triplane_decode(planes_cl, t(coords), torch_decoder(p, force_sigmoid),
                                       BW, tvr.generate_plane_axes(use_triplane),
                                       tvr.DensityFilters(*filters))
    close(rgb_t, rgb_j, **TOL)
    close(sig_t, sig_j, **TOL)
    if filters[0]:
        assert (sig_t.numpy() == -1e3).any()     # the crop did cull something


def ray_samples(seed, B=2, R=24, S1=12, S2=10, C=32):
    """Coarse (stratified) and fine (sorted, with ties to coarse depths)
    samples of B x R rays."""
    r = np.random.RandomState(seed)
    d1 = np.broadcast_to(np.linspace(0.5, 1.5, S1, dtype=np.float32)
                         + 0.5 / (S1 - 1), (B, R, S1))[..., None].astype(np.float32)
    d2 = np.sort(r.uniform(0.5, 1.5, (B, R, S2)), -1).astype(np.float32)[..., None]
    d2[:, :, 3] = d1[:, :, 4]                    # exact ties: coarse must come first
    d2 = np.sort(d2, axis=2)

    def half(S):
        s = (r.randn(B, R, S, 1) * 3).astype(np.float32)
        s[r.rand(B, R, S, 1) < 0.3] = -1e3       # culled samples
        s[0, 0] = -1e3                           # a ray with nothing: depth -> max
        return (r.rand(B, R, S, C).astype(np.float32), s,
                r.uniform(-0.35, 0.35, (B, R, S, 3)).astype(np.float32))

    c1, s1, x1 = half(S1)
    c2, s2, x2 = half(S2)
    return d1, c1, s1, x1, d2, c2, s2, x2


@functools.lru_cache(maxsize=None)
def jax_composites(white_back):
    """K2's function in the JAX package, jitted once per white_back (eager
    dispatch would compile every primitive on its first use, seconds per
    test): ray_march(unify_samples(...)) over colors | xyz -> (composite,
    depth, weight total), and merge_composite, its re-associated form."""
    def reference(*a):
        d, c, s, x = jvr.unify_samples(*a)
        comp, depth, w = jvr.ray_march(jnp.concatenate([c, x], -1), s, d, white_back)
        return comp, depth, jnp.sum(w, axis=2)

    return (jax.jit(reference),
            jax.jit(functools.partial(jvr.merge_composite, white_back=white_back)))


@pytest.mark.parametrize("white_back", [True, False])
def test_k2_ray_composite_plain_vs_jax(white_back):
    d1, c1, s1, x1, d2, c2, s2, x2 = ray_samples(2)
    rgb, depth, wsum, xyz = tvr.ray_composite(*map(t, (d1, c1, s1, x1, d2, c2, s2, x2)),
                                              white_back)
    J = [jnp.asarray(a) for a in (d1, c1, s1, x1, d2, c2, s2, x2)]
    reference, merged = jax_composites(white_back)
    comp, depth_j, wsum_j = reference(*J)
    close(rgb, comp[..., :-3], **TOL)
    close(xyz, comp[..., -3:], **TOL)
    close(depth, depth_j, **TOL)
    close(wsum, wsum_j, **TOL)
    # the JAX eval path's re-associated form of the same composite
    comp_m, depth_m, wsum_m = merged(*J)
    close(rgb, comp_m[..., :-3], **TOL)
    close(xyz, comp_m[..., -3:], **TOL)
    close(depth, depth_m, **TOL)
    close(wsum, wsum_m, **TOL)
    assert float(depth[0, 0, 0]) == float(np.max(np.concatenate([d1, d2], 2)))


@pytest.mark.parametrize("S,K", [(12, 10), (96, 96)])
def test_k3_importance_sample_plain_vs_jax(S, K):
    d1, _, s1, _, _, _, _, _ = ray_samples(3, R=16, S1=S, S2=4)
    got = tvr.importance_sample(t(d1), t(s1), K)
    _, _, w = jvr.ray_march(jnp.zeros(d1.shape), jnp.asarray(s1), jnp.asarray(d1), True)
    want = jvr.sample_importance(jnp.asarray(d1), w, K)
    close(got, want, **IMP_TOL)
    assert (np.diff(got.numpy()[..., 0], axis=-1) >= 0).all()   # monotone in u


@pytest.mark.parametrize("n_importance", [0, 6])
def test_render_vs_jax(n_importance):
    r = np.random.RandomState(4)
    C, N, res = 8, 2, 6
    planes = r.randn(N, 3, C, 16, 16).astype(np.float32)
    p = decoder_params(C, seed=5)
    ro = np.tile(np.asarray([0.0, 0.0, 1.0], np.float32), (N, res * res, 1))
    rd = np.concatenate([r.uniform(-0.3, 0.3, (N, res * res, 2)),
                         -np.ones((N, res * res, 1))], -1).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    opts = dict(box_warp=BW, ray_start=0.5, ray_end=1.5, depth_resolution=8,
                depth_resolution_importance=n_importance, white_back=True,
                use_triplane=True, render_dtype="float32")
    out_j = jvr.render(jnp.asarray(planes), jax_decode_fn(p, C, True), jnp.asarray(ro),
                       jnp.asarray(rd), opts, triplane_crop=0.1, cull_clouds=0.5)
    out_t = tvr.render(t(planes), torch_decoder(p, True), t(ro), t(rd), opts,
                       triplane_crop=0.1, cull_clouds=0.5)
    for a, b in zip(out_t, out_j):
        close(a, b, **RENDER_TOL)
    assert sum(launch_counts().values()) == 0     # CPU tensors: plain versions only


def test_render_rejects_unported_options():
    """The options render once refused, disparity-space sampling and
    ray_start = ray_end = 'auto' (rays that miss the box filled from the
    batch's valid starts), against the JAX render."""
    r = np.random.RandomState(6)
    C, N, res = 8, 2, 6
    planes = r.randn(N, 3, C, 16, 16).astype(np.float32)
    p = decoder_params(C, seed=7)
    ro = np.tile(np.asarray([0.0, 0.0, 1.0], np.float32), (N, res * res, 1))
    rd = np.concatenate([r.uniform(-1.2, 1.2, (N, res * res, 2)),
                         -np.ones((N, res * res, 1))], -1).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    base = dict(box_warp=BW, ray_start=0.5, ray_end=1.5, depth_resolution=8,
                depth_resolution_importance=6, white_back=True, use_triplane=True,
                render_dtype="float32")
    _, _, valid = tvr.get_ray_limits_box(t(ro), t(rd), BW)
    assert 0 < int(valid.sum()) < valid.numel()        # some rays miss the box
    for extra in (dict(disparity_space_sampling=True), dict(ray_start="auto", ray_end="auto")):
        opts = dict(base, **extra)
        out_j = jvr.render(jnp.asarray(planes), jax_decode_fn(p, C, True), jnp.asarray(ro),
                           jnp.asarray(rd), opts)
        out_t = tvr.render(t(planes), torch_decoder(p, True), t(ro), t(rd), opts)
        for a, b in zip(out_t, out_j):
            close(a, b, **RENDER_TOL)
    assert sum(launch_counts().values()) == 0
