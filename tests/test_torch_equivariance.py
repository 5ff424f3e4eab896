"""The port's equivariance metrics (eval/equivariance.py) and GAN metric
statistics (eval/gan_metrics.py) on the CPU against the JAX package's.

- Each operator and construct_affine_bandlimit_filter at the shifts and
  angles tests/test_equivariance.py parametrises: the masks equal, the
  values within f32 tolerances (the same formulas; sums and FFTs in
  another order).
- The per-batch step with the same draws as the JAX loop's step (written
  here with the JAX package's operators, since its step is a closure of
  compute_equivariance_metrics), on the toy generator of
  tests/test_equivariance.py in both frameworks.
- The three registry entries on the toy generator, above the JAX test's
  thresholds (> 55 / > 40 / > 30 dB).
- K4's large-filter arithmetic (csrc/upfirdn2d.cu:upfirdn2d_large_kernel:
  each output visits only its phase's taps, 12x12 of the 47x47 at up 4)
  rebuilt in plain torch against the JAX package's upsample2d, and the
  plan of a filter of more than 64 taps: no cache entry, no taps on the
  host.
- gan_metrics' FID, KID, precision/recall and IS equal to the JAX module's
  on the same features (the same numpy and scipy code).
"""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panic3d_tpu.eval import equivariance as eqj
from panic3d_tpu.eval import gan_metrics as gmj
from panic3d_tpu_torch.eval import equivariance as eqt
from panic3d_tpu_torch.eval import gan_metrics as gmt
from panic3d_tpu_torch.kernels import launch_counts

# the modules (the ops packages re-export their functions of the same name)
jup = importlib.import_module("panic3d_tpu.ops.upfirdn2d")
tup = importlib.import_module("panic3d_tpu_torch.ops.upfirdn2d")

RES = 64


def _x(n=2, c=3, h=32, w=32, seed=0):
    return np.random.RandomState(seed).randn(n, c, h, w).astype(np.float32)


@pytest.mark.parametrize("tx,ty", [(0.1, -0.07), (0.0, 0.0), (0.45, 0.3), (-0.2, 0.499)])
def test_integer_translation(tx, ty):
    x = _x()
    zj, mj = jax.jit(eqj.apply_integer_translation)(jnp.asarray(x), tx, ty)
    zt, mt = eqt.apply_integer_translation(torch.from_numpy(x), tx, ty)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_array_equal(zt.numpy(), np.asarray(zj))


@pytest.mark.parametrize("tx,ty", [(0.063, -0.041), (0.3, 0.26), (-0.12, 0.0), (0.009, 0.009)])
def test_fractional_translation(tx, ty):
    x = _x(seed=1)
    zj, mj = jax.jit(eqj.apply_fractional_translation)(jnp.asarray(x), tx, ty)
    zt, mt = eqt.apply_fractional_translation(torch.from_numpy(x), tx, ty)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    # six-tap sums of values ~1-4 in another order
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=0, atol=2e-6)


@pytest.mark.parametrize("angle", [0.3, -1.1, 2.7])
@pytest.mark.parametrize("up", [4, 1])
def test_bandlimit_filter(angle, up):
    fj = jax.jit(lambda m: eqj.construct_affine_bandlimit_filter(m, a=3, amax=6, up=up))(
        eqj.rotation_matrix(angle))
    ft = eqt.construct_affine_bandlimit_filter(eqt.rotation_matrix(angle), a=3, amax=6, up=up)
    assert tuple(ft.shape) == fj.shape == ((47, 47) if up == 4 else (11, 11))
    # the port's FFTs in f64, rounded once; JAX's six 511^2 (up 4) or 127^2
    # FFTs in complex64 (taps up to ~0.3)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(eqt.rotation_matrix(angle).numpy(),
                               np.asarray(eqj.rotation_matrix(angle)), rtol=0, atol=1e-7)


@pytest.mark.parametrize("angle", [0.3, -1.1])
def test_fractional_rotation(angle):
    x = _x(seed=2)
    zj, mj = jax.jit(eqj.apply_fractional_rotation)(jnp.asarray(x), angle)
    zt, mt = eqt.apply_fractional_rotation(torch.from_numpy(x), angle)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    # the filter's ~1e-7 differences (FFTs) through 144 taps of values ~1-4
    # and a bilinear lerp
    np.testing.assert_allclose((zt * mt).numpy(), np.asarray(zj * mj), rtol=0, atol=3e-5)


@pytest.mark.parametrize("angle", [0.3, -1.1])
def test_pseudo_rotation(angle):
    x = _x(seed=3)
    zj, mj = jax.jit(eqj.apply_fractional_pseudo_rotation)(jnp.asarray(x), angle)
    zt, mt = eqt.apply_fractional_pseudo_rotation(torch.from_numpy(x), angle)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=0, atol=1e-5)


def test_grid_helpers():
    r = np.random.RandomState(4)
    theta = r.randn(2, 2, 3).astype(np.float32) * 0.7
    gj = eqj._affine_grid(jnp.asarray(theta), 2, 9, 11)
    gt = eqt._affine_grid(torch.from_numpy(theta), 2, 9, 11)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=0, atol=1e-6)
    x = _x(seed=5, h=9, w=11)
    np.testing.assert_array_equal(eqt._grid_sample_nearest(torch.from_numpy(x), gt).numpy(),
                                  np.asarray(eqj._grid_sample_nearest(jnp.asarray(x), gj)))


# ---------------------------------------------------------------------------
# the toy generator of tests/test_equivariance.py, in both frameworks

def blob_jax(ws, transform):
    xs = -0.5 + (jnp.arange(RES, dtype=jnp.float32) + 0.5) / RES
    gy, gx = jnp.meshgrid(xs, xs, indexing="ij")
    pts = jnp.stack([gx, gy, jnp.ones_like(gx)], -1) @ transform.T

    def one(w):
        cx, cy, sg = w[0] * 0.2, w[1] * 0.2, 0.06 + 0.025 * jax.nn.sigmoid(w[2])
        d2 = (pts[..., 0] - cx) ** 2 + (pts[..., 1] - cy) ** 2
        img = jnp.exp(-d2 / (2 * sg ** 2))
        return jnp.stack([img, 0.5 * img, img * img], 0)

    return jax.vmap(one)(ws)


def blob_torch(ws, transform):
    xs = -0.5 + (torch.arange(RES, dtype=torch.float32, device=ws.device) + 0.5) / RES
    gy, gx = torch.meshgrid(xs, xs, indexing="ij")
    pts = torch.stack([gx, gy, torch.ones_like(gx)], -1) @ transform.T
    cx, cy = ws[:, 0, None, None] * 0.2, ws[:, 1, None, None] * 0.2
    sg = 0.06 + 0.025 * torch.sigmoid(ws[:, 2, None, None])
    d2 = (pts[..., 0] - cx) ** 2 + (pts[..., 1] - cy) ** 2
    img = torch.exp(-d2 / (2 * sg ** 2))
    return torch.stack([img, 0.5 * img, img * img], 1)


def jax_step(ws, t_int, t_frac, angle):
    """The JAX loop's step (panic3d_tpu/eval/equivariance.py:229-256) with
    its draws as arguments."""
    I3 = jnp.eye(3)
    orig = blob_jax(ws, I3)
    s = []
    for t, op in ((t_int, eqj.apply_integer_translation),
                  (t_frac, eqj.apply_fractional_translation)):
        t = jnp.asarray(t, jnp.float32)
        img = blob_jax(ws, I3.at[:2, 2].set(-t))
        ref, mask = op(orig, t[0], t[1])
        s += [jnp.square(ref - img) * mask, mask]
    img = blob_jax(ws, eqj.rotation_matrix(-angle))
    ref, ref_mask = eqj.apply_fractional_rotation(orig, angle)
    pseudo, pseudo_mask = eqj.apply_fractional_pseudo_rotation(img, angle)
    mask = ref_mask * pseudo_mask
    s += [jnp.square(ref - pseudo) * mask, mask]
    return jnp.stack([v.sum() for v in s])


def test_step_with_the_same_draws():
    gen = torch.Generator().manual_seed(7)
    ws = np.random.RandomState(6).randn(4, 3).astype(np.float32)
    step_j = jax.jit(jax_step)
    for _ in range(2):
        d = eqt.draw(gen, RES, compute_eqt_int=True, compute_eqt_frac=True, compute_eqr=True)
        assert d["t_int"][0] * RES == round(d["t_int"][0] * RES)
        got = eqt.equivariance_step(blob_torch, torch.from_numpy(ws), **d).numpy()
        want = np.asarray(step_j(jnp.asarray(ws), jnp.asarray(d["t_int"]),
                                 jnp.asarray(d["t_frac"]), d["angle"]))
        # the masks' sums are counts, equal; the squared errors' sums are
        # the operators' interpolation error (0 for whole pixels, ~1e-9 a
        # pixel for the rotation), held as the PSNRs they give: within 0.01 dB
        np.testing.assert_array_equal(got[1::2], want[1::2])
        assert (got[0::2] == 0).tolist() == (want[0::2] == 0).tolist()
        nz = want[0::2] > 0
        db = 10 * np.log10(got[0::2][nz] / want[0::2][nz])
        assert np.abs(db).max() <= 0.01, db


def _ws_iter(bs=4):
    gen = torch.Generator().manual_seed(5)
    while True:
        yield torch.randn((bs, 3), generator=gen)


def test_registry_entries_on_the_toy_generator():
    vals = {}
    for name in ("eqt50k_int", "eqt50k_frac", "eqr50k"):
        r = gmt.calc_metric(name, synthesis_fn=blob_torch, ws_iter=_ws_iter(), num_samples=8,
                            img_resolution=RES, generator=torch.Generator().manual_seed(0))
        assert r["metric"] == name
        vals[name] = r["results"][name]
    assert vals["eqt50k_int"] > 55, vals
    assert vals["eqt50k_frac"] > 40, vals
    assert vals["eqr50k"] > 30, vals
    assert sum(launch_counts().values()) == 0


# ---------------------------------------------------------------------------
# K4's large-filter form

def large_kernel_arithmetic(x, f2d, up, pad):
    """upfirdn2d_large_kernel's sum, down 1: output (oy, ox) visits the taps
    a = a0(oy) + m * up, b = b0(ox) + n * up of its phase, each meeting
    input ((oy + a - py0) / up, (ox + b - px0) / up)."""
    N, C, H, W = x.shape
    fh, fw = f2d.shape
    px0, px1, py0, py1 = pad
    oh, ow = H * up + py0 + py1 - fh + 1, W * up + px0 + px1 - fw + 1

    def axis(n_out, p0, ftaps, n_in):
        o = torch.arange(n_out)[:, None]
        a = (p0 - o) % up + torch.arange(-(-ftaps // up))[None, :] * up
        i = torch.div(o + a - p0, up, rounding_mode="floor")
        valid = (a < ftaps) & (i >= 0) & (i < n_in)
        return a.clamp(max=ftaps - 1), i.clamp(0, n_in - 1), valid

    ay, iy, vy = axis(oh, py0, fh, H)
    ax, ix, vx = axis(ow, px0, fw, W)
    taps = f2d[ay[:, :, None, None], ax[None, None]] * (vy[:, :, None, None] & vx[None, None])
    vals = x[:, :, iy[:, :, None, None], ix[None, None]]              # [N,C,oh,M,ow,K]
    return (vals * taps).sum(dim=(3, 5))


def test_k4_large_filter_arithmetic():
    x = _x(seed=8, h=24, w=20)
    f = eqt.construct_affine_bandlimit_filter(eqt.rotation_matrix(0.3), a=3, amax=6, up=4)
    p = f.shape[0] // 2
    want = np.asarray(jax.jit(lambda x, f: jup.upsample2d(x=x, f=f, up=4, padding=p))(
        jnp.asarray(x), jnp.asarray(f.numpy())))
    got_plain = tup.upsample2d(torch.from_numpy(x), f, up=4, padding=p)
    # upsample2d's padding and gain for a 47x47 filter at up 4
    pads = [p + (47 + 4 - 1) // 2, p + (47 - 4) // 2] * 2
    (f2d, up, down, pad), = tup.fir_passes(f, up=4, padding=pads, gain=16)
    assert up == (4, 4) and down == (1, 1)
    got_kernel = large_kernel_arithmetic(torch.from_numpy(x), f2d, 4, pad)
    assert tuple(got_kernel.shape) == want.shape == tuple(got_plain.shape)
    # 144 products of values ~1-4 in another order (and the plain version's 2,209)
    np.testing.assert_allclose(got_plain.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_kernel.numpy(), want, rtol=0, atol=1e-5)
    # the plan of a filter beyond 64 taps: a large-filter kernel, its taps
    # neither cached nor copied to the host (the phase-blocked one at 47x47;
    # an 11x11 at up 4 has 2-3 tap rows a phase, below its 4: the tiled one)
    before = tup._plan.cache_info().currsize
    assert tup.k4_plan(f2d, up, down, pad).variant == "large"
    assert tup.k4_plan(f2d[:11, :11], up, down, pad).variant == "large_tiled"
    assert tup._plan.cache_info().currsize == before
    assert tup.k4_plan(f2d[:8, :8], up, down, pad).variant == "generic"


# ---------------------------------------------------------------------------
# the GAN metric statistics

def test_gan_metric_statistics_equal_jax():
    r = np.random.RandomState(9)
    real = r.randn(300, 16)
    gen = r.randn(260, 16) * 1.1 + 0.2
    assert gmt.list_valid_metrics() == gmj.list_valid_metrics()
    for name in ("fid50k_full", "kid50k_full", "pr50k3_full"):
        got = gmt.calc_metric(name, gen_features=gen, real_features=real)["results"]
        want = gmj.calc_metric(name, gen_features=gen, real_features=real)["results"]
        assert got.keys() == want.keys()
        for k in got:
            assert got[k] == want[k], (name, k)
    probs = r.dirichlet(np.ones(10), size=200)
    assert gmt.is50k(gen_probs=probs) == gmj.is50k(gen_probs=probs)
    st_t, st_j = gmt.FeatureStats(max_items=250), gmj.FeatureStats(max_items=250)
    for chunk in np.array_split(real, 4):
        st_t.append(chunk)
        st_j.append(chunk)
    for a, b in zip(st_t.get_mean_cov(), st_j.get_mean_cov()):
        np.testing.assert_array_equal(a, b)
    assert st_t.is_full and st_t.num_items == 250
    d = r.rand(500)
    assert gmt.ppl2_wend(ppl_distances=d) == gmj.ppl2_wend(ppl_distances=d)
    assert math.isfinite(gmt.frechet_distance(*st_t.get_mean_cov(), *st_j.get_mean_cov()))
