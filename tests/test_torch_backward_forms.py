"""The backward forms of K1, K2, K4 and K5 (their autograd.Functions), on
the CPU, where each Function runs its kernel's plain version:

- gradcheck in f64 of TriplaneDecode (to the planes and the decoder's four
  tensors), RayComposite (to the colours and sigmas of both halves, with
  ties between the halves), UpFirDn2d (at the discriminator's down2 and
  fir4 calls and the generator's up2 calls) and ModconvEpilogue (to x, the
  demodulation coefficients, noise_strength and the bias, with a clamp
  that binds), and gradgradcheck of UpFirDn2d and ModconvEpilogue (R1's
  second order);
- K4's transposed passes land on K4's forward forms (k4_plan): down2 ->
  up2, fir4 -> fir4, up2 -> down2, the generator's modulated up=2 call ->
  down2;
- K5's backward form in bf16: epilogue_grad_plain, what the kernel
  computes, equals autograd of modconv_epilogue_plain bit for bit;
- the arithmetic of K1's and K2's backward kernels, emulated in f64 numpy
  point by point and ray by ray as csrc/triplane_decode_grad.cu and
  csrc/ray_composite.cu order it (K2's reverse recurrence for the alphas,
  its merge slots, the clipped depth), within 1e-9 of autograd of the
  plain versions;
- the drawn noise and the filter still take no gradient (they raise), and
  a wrapper launches on CUDA tensors only.
"""

import importlib
import math

import numpy as np
import pytest
import torch

from panic3d_tpu_torch.models.volumetric import renderer as vr
from panic3d_tpu_torch.ops.conv import conv2d_resample

# the modules (panic3d_tpu_torch.ops exports functions of the same names)
ba = importlib.import_module("panic3d_tpu_torch.ops.bias_act")
uf = importlib.import_module("panic3d_tpu_torch.ops.upfirdn2d")

F64 = torch.float64


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small f64 ops (gradcheck): one torch thread beside the other
    test workers (ROADMAP "Tier-1 time")."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def rnd(*shape, seed=0, scale=1.0):
    return torch.from_numpy(np.asarray(np.random.RandomState(seed).randn(*shape) * scale)).to(F64)


def f4():
    return uf.setup_filter([1, 3, 3, 1]).to(F64)


def upfirdn_calls():
    """(name, x shape, f2d, up, down, pad) of the path's K4 passes."""
    f = f4().flip([0, 1])
    return [("down2", (1, 2, 8, 8), f, (1, 1), (2, 2), (1, 1, 1, 1)),
            ("fir4", (1, 2, 7, 7), f, (1, 1), (1, 1), (2, 2, 2, 2)),
            ("up2", (1, 2, 5, 5), f * 4, (2, 2), (1, 1), (2, 1, 2, 1)),
            ("up2_conv", (1, 2, 5, 5), f * 4, (2, 2), (1, 1), (3, 2, 3, 2))]


@pytest.mark.parametrize("call", upfirdn_calls(), ids=lambda c: c[0])
def test_upfirdn2d_backward(call):
    _, shape, f2d, up, down, pad = call
    x = rnd(*shape).requires_grad_(True)
    fn = lambda t: uf.UpFirDn2d.apply(t, f2d, up, down, pad)   # noqa: E731
    assert torch.autograd.gradcheck(fn, (x,))
    assert torch.autograd.gradgradcheck(fn, (x,))
    # the Function's forward is the plain pass; its backward autograd's
    y = fn(x)
    dy = rnd(*y.shape, seed=1)
    (want,) = torch.autograd.grad(uf.upfirdn2d_plain(x, f2d, up, down, pad), x, dy)
    (got,) = torch.autograd.grad(y, x, dy)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_transposed_passes_take_forward_forms():
    want = {"down2": "up2", "fir4": "fir4", "up2": "down2", "up2_conv": "down2"}
    for name, shape, f2d, up, down, pad in upfirdn_calls():
        f2d = f2d.float()
        assert uf.k4_plan(f2d, up, down, pad).variant == name.split("_")[0]
        h, w = shape[2:]
        out = uf._out_size(h, w, 4, 4, up, down, pad)
        ft, upt, downt, padt = uf.transposed_pass(f2d, up, down, pad, (h, w), out)
        assert uf.k4_plan(ft, upt, downt, padt).variant == want[name]
        assert uf._out_size(*out, 4, 4, upt, downt, padt) == (h, w)
    # the discriminator's and the generator's calls, through conv2d_resample
    x = rnd(1, 2, 8, 8).float().requires_grad_(True)
    w = rnd(3, 2, 3, 3).float()
    for up, down in ((1, 2), (2, 1)):
        y = conv2d_resample(x, w, f=uf.setup_filter([1, 3, 3, 1]), up=up, down=down, padding=1,
                            flip_weight=up == 1)
        assert torch.isfinite(torch.autograd.grad(y.sum(), x)[0]).all()


def test_upfirdn2d_filter_takes_no_gradient():
    f = uf.setup_filter([1, 3, 3, 1]).requires_grad_(True)
    with pytest.raises(RuntimeError, match="^upfirdn2d: the CUDA kernel has no backward"):
        uf.upfirdn2d_kernel(torch.zeros(1, 1, 4, 4), f, (1, 1), (2, 2), (1, 1, 1, 1))
    with pytest.raises(ValueError, match="CUDA tensors"):
        uf.upfirdn2d_kernel(torch.zeros(1, 1, 4, 4), f.detach(), (1, 1), (2, 2), (1, 1, 1, 1))


EPI = ("lrelu", 0.2, math.sqrt(2), 0.6)


@pytest.mark.parametrize("noise_shape", [(5, 5), (2, 1, 5, 5)], ids=["const", "per_sample"])
def test_modconv_epilogue_backward(noise_shape):
    x = rnd(2, 3, 5, 5, seed=1).requires_grad_(True)
    dcoef = rnd(2, 3, seed=2, scale=0.5).requires_grad_(True)
    noise = rnd(*noise_shape, seed=3)
    ns = rnd(seed=4, scale=0.3).reshape(()).requires_grad_(True)
    bias = rnd(3, seed=5, scale=0.1).requires_grad_(True)
    y = ba.ModconvEpilogue.apply(x, dcoef, noise, ns, bias, EPI)
    y0 = ba.modconv_epilogue_plain(x, dcoef, noise, ns, bias, *EPI)
    assert torch.equal(y, y0) and 0 < int((y.abs() == EPI[3]).sum()) < y.numel() // 2
    # gradcheck avoids the kinks: the clamp's and the slope's boundaries
    fn = lambda a, d, s, b: ba.ModconvEpilogue.apply(a, d, noise, s, b, EPI)  # noqa: E731
    assert torch.autograd.gradcheck(fn, (x, dcoef, ns, bias))
    assert torch.autograd.gradgradcheck(fn, (x, dcoef, ns, bias))


def test_epilogue_grad_plain_is_autograd_in_bf16():
    r = np.random.RandomState(7)
    for act, clamp in (("lrelu", 0.5), ("linear", 0.5), ("lrelu", None)):
        x = torch.from_numpy(r.randn(3, 4, 6, 6)).to(torch.bfloat16).requires_grad_(True)
        bias = torch.from_numpy(r.randn(4) * 0.1).to(torch.bfloat16)
        y = ba.modconv_epilogue_plain(x, bias=bias, act=act, clamp=clamp)
        dy = torch.from_numpy(r.randn(*y.shape)).to(torch.bfloat16)
        (want,) = torch.autograd.grad(y, x, dy)
        got = ba.epilogue_grad_plain(dy, y.detach(), act, clamp=clamp)
        hit = (y.detach().abs() == clamp) if clamp else torch.zeros_like(y, dtype=torch.bool)
        # an output exactly at the clamp: autograd passes it, the form does not
        assert torch.equal(got[~hit], want[~hit]) and (got[hit] == 0).all()


def test_epilogue_noise_takes_no_gradient():
    with pytest.raises(RuntimeError, match="^modconv_epilogue: the CUDA kernel has no backward"):
        ba.modconv_epilogue_kernel(torch.zeros(2, 4, 3, 3),
                                   noise=torch.zeros(2, 1, 3, 3, requires_grad=True))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ba.modconv_epilogue_kernel(torch.zeros(2, 4), bias=torch.zeros(4, requires_grad=True))


def decoder(C, seed=10):
    return vr.Decoder(rnd(64, C, seed=seed), rnd(64, seed=seed + 1, scale=0.1),
                      rnd(33, 64, seed=seed + 2), rnd(33, seed=seed + 3, scale=0.1), 1.0, False)


def k1_inputs(C=8, M=9, H=6):
    planes = rnd(1, 3, H, H, C, seed=20, scale=0.5)
    coords = torch.from_numpy(np.random.RandomState(21).uniform(-0.4, 0.4, (1, M, 3)))
    return planes, coords.to(F64)


AXES = vr.generate_plane_axes(True)
FILTERS = vr.DensityFilters(triplane_crop=0.1)


def test_triplane_decode_backward():
    planes, coords = k1_inputs()
    dec = decoder(8)
    leaves = [t.clone().requires_grad_(True) for t in (planes, *dec[:4])]
    meta = (1.0, False, 0.7, AXES, FILTERS)
    fn = lambda p, a, b, c, d: vr.TriplaneDecode.apply(p, coords, a, b, c, d, meta)  # noqa: E731
    assert torch.autograd.gradcheck(fn, tuple(leaves), fast_mode=True)
    with pytest.raises(RuntimeError, match="^triplane_decode: the CUDA kernel has no backward"):
        vr.triplane_decode_kernel(planes, coords.clone().requires_grad_(True), dec, 0.7, AXES,
                                  FILTERS)


def _softplus(x):
    return np.maximum(x, 0) + np.log1p(np.exp(-np.abs(x)))


def _sigmoid(x):
    return 1 / (1 + np.exp(-x))


def k1_grad_emulated(planes, coords, dec, box_warp, g_rgb, g_sigma, crop):
    """csrc/triplane_decode_grad.cu point by point, in f64 numpy."""
    P = planes[0]                        # [3,H,W,C]
    _, H, W, C = P.shape
    proj = np.linalg.inv(AXES)[:, :, :2]
    scale = 2.0 / box_warp
    w0 = dec.w0.numpy() / math.sqrt(C)
    w1 = dec.w1.numpy() / math.sqrt(64)
    b0, b1 = dec.b0.numpy(), dec.b1.numpy()
    gp_planes = np.zeros_like(P)
    gw0, gb0, gw1, gb1 = (np.zeros_like(w0), np.zeros_like(b0), np.zeros_like(w1),
                          np.zeros_like(b1))
    for m, xyz in enumerate(coords[0]):
        corners = []
        f = np.zeros(C)
        for p in range(3):
            u, v = (xyz * scale) @ proj[p]
            ix, iy = ((u + 1) * W - 1) / 2, ((v + 1) * H - 1) / 2
            x0, y0 = math.floor(ix), math.floor(iy)
            wx, wy = ix - x0, iy - y0
            for k in range(4):
                xx, yy = x0 + (k & 1), y0 + (k >> 1)
                w = (wx if k & 1 else 1 - wx) * (wy if k >> 1 else 1 - wy)
                if 0 <= xx < W and 0 <= yy < H:
                    corners.append((p, yy, xx, w))
                    f += w * P[p, yy, xx]
        f /= 3
        h = _softplus(w0 @ f + b0)
        o = w1 @ h + b1
        passed = not (abs(xyz[0]) > box_warp / 2 - crop or abs(xyz[2]) > box_warp / 2 - crop)
        go = np.empty(33)
        go[0] = g_sigma[0, m, 0] if passed else 0.0
        s = _sigmoid(o[1:])
        go[1:] = g_rgb[0, m] * s * (1 - s) * 1.002
        gpre = (w1.T @ go) * -np.expm1(-h)
        gf = w0.T @ gpre
        for p, yy, xx, w in corners:
            gp_planes[p, yy, xx] += gf * w / 3
        gw0 += np.outer(gpre, f) / math.sqrt(C)
        gb0 += gpre
        gw1 += np.outer(go, h) / math.sqrt(64)
        gb1 += go
    return gp_planes[None], gw0, gb0, gw1, gb1


def test_k1_backward_kernel_arithmetic():
    planes, coords = k1_inputs(C=8, M=12)
    coords[0, 0, 0] = 0.33        # cropped: sigma passes no gradient
    dec = decoder(8)
    r = np.random.RandomState(22)
    g_rgb, g_sigma = torch.from_numpy(r.randn(1, 12, 32)), torch.from_numpy(r.randn(1, 12, 1))
    want = vr.triplane_decode_grad_plain(planes, coords, dec, 0.7, AXES, FILTERS, g_rgb, g_sigma)
    got = k1_grad_emulated(planes.numpy(), coords.numpy(), dec, 0.7, g_rgb.numpy(),
                           g_sigma.numpy(), FILTERS.triplane_crop)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w.numpy(), rtol=1e-9, atol=1e-12)


def k2_inputs(B=1, R=3, S1=6, S2=5, C=4, seed=30):
    r = np.random.RandomState(seed)
    d1 = np.sort(r.uniform(0.5, 1.5, (B, R, S1, 1)), 2)
    d2 = np.sort(r.uniform(0.5, 1.5, (B, R, S2, 1)), 2)
    d2[0, 0, 1, 0] = d1[0, 0, 2, 0]          # a tie across the halves: coarse first
    d2[0, 1] = d2[0, 1, ::-1]                # an unsorted half: the full rank count
    t = [torch.from_numpy(a) for a in (d1, r.randn(B, R, S1, C), r.randn(B, R, S1, 1) * 3,
                                       r.randn(B, R, S1, 3), d2, r.randn(B, R, S2, C),
                                       r.randn(B, R, S2, 1) * 3, r.randn(B, R, S2, 3))]
    return t


def test_ray_composite_backward():
    d1, c1, s1, x1, d2, c2, s2, x2 = k2_inputs()
    leaves = [t.clone().requires_grad_(True) for t in (c1, s1, c2, s2)]

    def fn(a, b, c, d):
        return vr.RayComposite.apply(d1, a, b, x1, d2, c, d, x2, True)

    assert torch.autograd.gradcheck(fn, tuple(leaves))
    with pytest.raises(RuntimeError, match="^ray_composite: the CUDA kernel has no backward"):
        vr.ray_composite_kernel(d1.clone().requires_grad_(True), c1, s1, x1, d2, c2, s2, x2,
                                True)


def k2_grad_emulated(d1, c1, s1, x1, d2, c2, s2, x2, white_back, depth, g_comp, g_depth,
                     g_wsum):
    """csrc/ray_composite.cu's backward ray by ray, in f64 numpy."""
    B, R, S1, C = c1.shape
    S2 = c2.shape[2]
    S = S1 + S2
    out = [np.zeros_like(c1), np.zeros_like(s1), np.zeros_like(c2), np.zeros_like(s2)]
    for b in range(B):
        for r in range(R):
            d = np.concatenate([d1[b, r, :, 0], d2[b, r, :, 0]])
            sg = np.concatenate([s1[b, r, :, 0], s2[b, r, :, 0]])
            c = np.concatenate([c1[b, r], c2[b, r]])
            x = np.concatenate([x1[b, r], x2[b, r]])
            slot = np.array([sum((d[j] < d[i]) or (d[j] == d[i] and j < i) for j in range(S))
                             for i in range(S)])
            ds, ss = np.empty(S), np.empty(S)
            ds[slot], ss[slot] = d, sg
            delta = ds[1:] - ds[:-1]
            arg = (ss[:-1] + ss[1:]) / 2 - 1
            dens = _softplus(arg)
            alpha = 1 - np.exp(-dens * delta)
            f = 1 - alpha + 1e-10
            T = np.concatenate([[1.0], np.cumprod(f)[:-1]])
            w = np.append(alpha * T, 0.0)
            wsum = w.sum()
            dep = (w[:-1] * (ds[:-1] + ds[1:]) / 2).sum() / wsum
            v = (np.where(slot > 0, w[np.maximum(slot - 1, 0)], 0) + w[slot]) / 2
            gc = g_comp[b, r]
            gcol = 2 * v[:, None] * gc[None, :C]
            gv = 2 * (c @ gc[:C] + x @ gc[C:])
            g_tot = g_wsum[b, r, 0] - (2 * gc.sum() if white_back else 0)
            # the kernel redoes the forward's sum in its order and so finds its
            # depth bit for bit where it was not clipped; here, within rounding
            g_dep = g_depth[b, r, 0] / wsum if abs(dep - depth[b, r, 0]) < 1e-12 else 0.0
            gvs = np.empty(S)
            gvs[slot] = gv
            gw = (gvs[:-1] + gvs[1:]) / 2 + g_tot + g_dep * ((ds[:-1] + ds[1:]) / 2 - dep)
            ga, Rr = np.empty(S - 1), 0.0
            for k in range(S - 2, -1, -1):
                ga[k] = T[k] * (gw[k] - Rr)
                Rr = gw[k] * alpha[k] + f[k] * Rr
            garg = ga * delta * np.exp(-dens * delta) * _sigmoid(arg)
            gss = 0.5 * (np.append(0.0, garg) + np.append(garg, 0.0))
            gs = gss[slot]
            out[0][b, r], out[2][b, r] = gcol[:S1], gcol[S1:]
            out[1][b, r, :, 0], out[3][b, r, :, 0] = gs[:S1], gs[S1:]
    return out


@pytest.mark.parametrize("clip", [False, True], ids=["free", "clipped"])
def test_k2_backward_kernel_arithmetic(clip):
    d1, c1, s1, x1, d2, c2, s2, x2 = k2_inputs(seed=31)
    if clip:   # a ray that sees nothing but its last interval's far end: its depth is clipped
        s1[0, 2] = -40.0
        s2[0, 2] = -40.0
        s2[0, 2, -1] = 40.0
        d2[0, 2, -1] = 1.5
    rgb, depth, wsum, xyz = vr.ray_composite_plain(d1, c1, s1, x1, d2, c2, s2, x2, True)
    r = np.random.RandomState(32)
    g_comp = torch.from_numpy(r.randn(*rgb.shape[:-1], rgb.shape[-1] + 3))
    g_depth = torch.from_numpy(r.randn(*depth.shape))
    g_wsum = torch.from_numpy(r.randn(*wsum.shape))
    want = vr.ray_composite_grad_plain(d1, c1, s1, x1, d2, c2, s2, x2, True, depth, g_comp,
                                       g_depth, g_wsum)
    got = k2_grad_emulated(*(t.numpy() for t in (d1, c1, s1, x1, d2, c2, s2, x2)), True,
                           depth.numpy(), g_comp.numpy(), g_depth.numpy(), g_wsum.numpy())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w.numpy(), rtol=1e-9, atol=1e-12)


def test_plain_softplus_derivative_matches_jax():
    """The plain decoder's and composite's softplus differentiates as
    jax.nn.softplus does, sigmoid(x), at 0 too: at initialisation the
    decoder's first-layer bias is 0, and every point outside the planes has
    a pre-activation of exactly 0 (K1's backward form takes sigmoid(0) =
    0.5 there, as JAX; autograd of max(x, 0) + log1p(e^-|x|) takes 1)."""
    import jax

    x = torch.tensor([-30.0, -2.0, 0.0, 0.0, 1e-8, 3.0, 40.0], dtype=F64, requires_grad=True)
    (got,) = torch.autograd.grad(vr.softplus(x).sum(), x)
    want = np.asarray(jax.vmap(jax.grad(jax.nn.softplus))(x.detach().numpy()))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-30)   # JAX in f32
    np.testing.assert_array_equal(vr.softplus(x).detach().numpy(),
                                  (x.clamp_min(0) + torch.log1p(torch.exp(-x.abs()))).detach())
