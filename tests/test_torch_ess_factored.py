"""K6a's factored occupancy decode (csrc/ess.cu) emulated on the CPU.

The kernel decodes the ESS lattice without forming a point's feature: the
first layer is linear and the feature is the broadcast sum
((F_0 + F_1) + F_2) / 3 of three planar terms, so a first launch
(lattice_decode.cuh:factor_terms_kernel, shared with K7a) computes
P_t = g0 W0 F_t / 3 per term row, b0 added to the (x, y) term's rows, and a
point's hidden layer is h = (P_xy + P_a) + P_b (P_a, P_b the other two
terms in plane order). Net2's sigma row is summed in four partial sums
(j mod 4) and then ((s0 + s1) + (s2 + s3)) + b1. Points the triplane crop
removes are not decoded (sigma -1e3 whatever the decoder gives); the
density filters, the threshold, the supersample max-pool and the 3^3
dilation follow. The kernel's softplus of the hidden layer runs on the SFU
(ex2/lg2.approx, within ~2e-7 of the libm form); the emulation uses the
libm form, which the CPU has.

On numpy-seeded planes and decoders (C = 8 and 32; the filters off, crop +
cull, crop + binarize; supersample 1 and 2; both EG3D plane bases) the
emulated grid may differ from ess_occupancy_plain's and the JAX
ess_occupancy's in at most numel // 10000 cells, and every lattice point
whose decision differs from the plain decode's must have a sigma within
1e-4 of the cull's or the occupancy's threshold. And the terms reach the
kernels as lattice_features makes them (permuted views, no copy): the
factor kernel's row address from their strides must find every row.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from panic3d_tpu.models.volumetric import renderer as jvr
from panic3d_tpu_torch.models.volumetric import lattice as tlat
from panic3d_tpu_torch.models.volumetric import renderer as tvr

from test_torch_render import BW, decoder_params, jax_decode_fn, t, torch_decoder

GRID = 8
THRESH = 0.01
THIRD = np.float32(1.0 / 3.0)


def cull(sigma, cull_mode, thresh):
    """density_filters without the crop (lattice_decode.cuh)."""
    if cull_mode == 0:
        return sigma
    low = 1 - torch.exp(-tvr.softplus(sigma - 1)) < thresh
    other = torch.full_like(sigma, 1e3) if cull_mode == 2 else sigma
    return torch.where(low, torch.full_like(sigma, -1e3), other)


def factored_sigma(terms, dec, Gs):
    """The decode kernel's sigma at every lattice point [N,Gs,Gs,Gs]."""
    N, C = terms[0][0].shape[0], terms[0][0].shape[-1]
    w0 = dec.w0 * np.float32(dec.lr_mul / math.sqrt(C))
    b0 = dec.b0 * np.float32(dec.lr_mul)
    col = next(i for i, (_, aa, ab) in enumerate(terms) if (aa, ab) == (0, 1))
    P = [((F_ @ w0.T) * THIRD + (b0 if i == col else 0), aa, ab)     # the first launch
         for i, (F_, aa, ab) in enumerate(terms)]
    order = [P[col]] + [p for i, p in enumerate(P) if i != col]
    parts = [tlat._broadcast_term(p, aa, ab) for p, aa, ab in order]
    h = (parts[0] + parts[1]) + parts[2]                                # [N,Gs,Gs,Gs,64]
    w1 = dec.w1[0] * np.float32(dec.lr_mul / 8)
    b1 = dec.b1[0] * np.float32(dec.lr_mul)
    prod = (w1 * tvr.softplus(h)).reshape(h.shape[:4] + (16, 4))
    s = torch.zeros(h.shape[:4] + (4,))
    for j4 in range(16):
        s = s + prod[..., j4, :]
    sigma = ((s[..., 0] + s[..., 1]) + (s[..., 2] + s[..., 3])) + b1
    return sigma.expand(N, Gs, Gs, Gs)


def occupancy_emulated(terms, dec, box_warp, ss, filters):
    """K6a's order of operations -> (occ [N,G,G,G], the decoded sigma, the
    crop's kept points [Gs,Gs,Gs])."""
    Gs = GRID * ss
    use_crop, crop_lim, cull_mode, thresh = tvr._filter_args(filters, box_warp)
    xyz = tlat.lattice_world_coords((Gs,) * 3, box_warp)
    lim = torch.tensor(crop_lim, dtype=torch.float32)
    kept = ((xyz[..., 0].abs() <= lim) & (xyz[..., 2].abs() <= lim) if use_crop
            else torch.ones((Gs,) * 3, dtype=torch.bool))
    decoded = factored_sigma(terms, dec, Gs)
    sigma = cull(torch.where(kept, decoded, torch.full_like(decoded, -1e3)), cull_mode, thresh)
    occ = (tvr.softplus(sigma - 1) > THRESH).to(torch.float32)[:, None]
    occ = F.max_pool3d(F.max_pool3d(occ, ss, ss), 3, 1, 1)[:, 0]
    return occ, decoded, kept


def sigma_thresholds(filters):
    """The sigmas at which the cull (or binarize) and the occupancy flip."""
    out = [1 + math.log(math.expm1(THRESH))]
    c = filters[2] or filters[1]
    if c:
        out.append(1 + math.log(math.expm1(-math.log1p(-c))))
    return out


@pytest.mark.parametrize("C,filters,ss,use_triplane", [
    (8, (None, None, None), 2, True),
    (8, (0.1, 0.5, None), 2, True),        # the eval path: crop 0.1, cull 0.5
    (8, (0.1, None, 0.5), 2, True),        # binarize_clouds
    (32, (None, None, None), 2, True),
    (32, (0.1, 0.5, None), 2, True),
    (32, (0.1, None, 0.5), 2, True),
    (8, (0.1, 0.5, None), 1, True),
    (32, (None, None, None), 1, True),
    (8, (0.1, 0.5, None), 2, False),       # the other plane basis: two (x, z) terms
])
def test_factored_occupancy_matches_plain_and_jax(C, filters, ss, use_triplane):
    r = np.random.RandomState(5)
    planes = (3 * r.randn(2, 3, C, 16, 16)).astype(np.float32)
    axes = tvr.generate_plane_axes(use_triplane)
    Gs = GRID * ss
    terms = tlat.lattice_features(t(planes), axes, (Gs,) * 3, BW)
    # sigma's bias puts a few points a cell's 3^3 neighbourhood above the
    # last threshold, so that the grid is a mix of empty and occupied cells
    p = decoder_params(C, seed=C + ss)
    p["net2"]["bias"][0] = 0.0
    s0 = factored_sigma(terms, torch_decoder(p, True), Gs)
    p["net2"]["bias"][0] = (max(sigma_thresholds(filters))
                            - float(s0.quantile(1 - 0.02 / ss ** 3)))
    dec = torch_decoder(p, True)
    occ_e, sig_e, kept = occupancy_emulated(terms, dec, BW, ss, tvr.DensityFilters(*filters))
    occ_p = tvr.ess_occupancy_plain(terms, dec, BW, GRID, ss, THRESH,
                                    tvr.DensityFilters(*filters))
    sigma_fn = lambda f: jax_decode_fn(p, C, True)(f, sigma_only=True)   # noqa: E731
    opts = dict(ess=dict(grid=GRID, supersample=ss, thresh=THRESH), use_triplane=use_triplane,
                decoder_mean_linear=True)
    occ_j = np.asarray(jax.jit(lambda pl: jvr.ess_occupancy(
        jnp.asarray(axes), pl, sigma_fn, BW, opts, *filters, 2)[0])(jnp.asarray(planes)))
    assert occ_e.shape == occ_p.shape == occ_j.shape == (2, GRID, GRID, GRID)
    limit = occ_e.numel() // 10000
    assert int((occ_e != occ_p).sum()) <= limit
    assert int((occ_e.numpy() != occ_j).sum()) <= limit
    # the points whose decision differs from the plain decode's lie within
    # 1e-4 of a threshold
    sig_p = tlat.decode_lattice_terms(
        terms, lambda f: tvr.osg_decode(f, dec, sigma_only=True), (Gs,) * 3,
        plane_reduce="mean").reshape(sig_e.shape)
    np.testing.assert_allclose(sig_e.numpy(), sig_p.numpy(), rtol=0, atol=1e-4)
    _, _, cull_mode, cthresh = tvr._filter_args(tvr.DensityFilters(*filters), BW)

    def decide(sig):
        return tvr.softplus(cull(sig, cull_mode, cthresh) - 1) > THRESH

    flips = kept.expand_as(sig_e) & (decide(sig_e) != decide(sig_p))
    near = torch.stack([(sig_p - s_).abs() for s_ in sigma_thresholds(filters)]).amin(0)
    assert bool((near[flips] < 1e-4).all())
    assert 0.05 < float(occ_p.mean()) < 0.95


@pytest.mark.parametrize("grid", [(16, 16, 16), (8, 12, 20)])
def test_term_rows_address_the_lattice_views_in_place(grid):
    """lattice_term_args hands the kernels lattice_features' permuted views
    as they are (no copy) with their strides, and factor_terms_kernel's row
    address (lattice_decode.cuh:term_row) finds every row's channels there."""
    r = np.random.RandomState(2)
    planes = t(r.randn(2, 3, 8, 16, 16).astype(np.float32))
    terms = tlat.lattice_features(planes, tvr.generate_plane_axes(True), grid, BW)
    args, keep = tvr.lattice_term_args(terms, planes.device)
    for k, (F_, aa, ab) in enumerate(terms):
        ptr, a, b, sn, sa, sb = args[6 * k:6 * k + 6]
        assert (a, b) == (aa, ab) and keep[k] is F_ and ptr == F_.data_ptr()
        N, ga, gb, C = F_.shape
        flat = torch.as_strided(F_, (F_.untyped_storage().nbytes() // 4 - F_.storage_offset(),),
                                (1,))
        rows = torch.arange(N * ga * gb)
        base = (rows // (ga * gb)) * sn + (rows // gb % ga) * sa + (rows % gb) * sb
        got = flat[base[:, None] + torch.arange(C)[None, :]]
        assert torch.equal(got, F_.reshape(-1, C))
