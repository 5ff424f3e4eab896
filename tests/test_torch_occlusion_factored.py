"""K7a's factored decode, crop skip and slab suffix, emulated on the CPU.

csrc/front_occlusion.cu computes the occlusion volume without forming a
lattice point's feature: the first layer is linear and the feature is the
broadcast sum ((F_0 + F_1) + F_2) / 3 of three planar terms, so a first
launch computes P_t = g0 W0 F_t / 3 per term, the bias b0 added to the
(x, y) term's rows, and each point adds three rows of P:
h = (P_xy + P_a) + P_b (P_a, P_b the two z-dependent terms in plane
order). Cells that the triplane crop removes are not decoded: their sigma
is -1e3 whatever the decoder gives, so their density is the constant the
cull makes of -1e3. Each (x, y) column is walked from the top of the box
down with the suffix sum carried from cell to cell (the kernel stages its
rows a slab of cells at a time), and A = (suffix - density / 2) dz. Net2's
sigma row is summed in four partial sums (j mod 4), as the kernel does. The kernel's softplus of the hidden
layer runs on the SFU (ex2/lg2.approx, within ~2e-7 of the libm form); the
emulation uses the libm form, which the CPU has.

The emulation must match occlusion_volume_plain and the JAX
front_occlusion_volume (plane_reduce='mean') within 1e-5 x max|A| on
numpy-seeded planes and decoders, at a 16 x 16 x 64 lattice, C = 8 and 32,
with the filters off, with crop and cull, with crop and binarize, and on
both EG3D plane bases; every cell with no kept cell at or above it must be
exactly the plain version's, and every cropped cell's density exactly the
plain density.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panic3d_tpu.models.volumetric import lattice as jlat
from panic3d_tpu_torch.models.volumetric import lattice as tlat
from panic3d_tpu_torch.models.volumetric import renderer as tvr

from test_torch_render import BW, decoder_params, jax_decode_fn, t, torch_decoder
from torch_one_thread import torch_one_thread  # noqa: F401  (autouse)

GRID = (16, 16, 64)
THIRD = np.float32(1.0 / 3.0)


def cull(sigma, cull_mode, thresh):
    """density_filters without the crop (lattice_decode.cuh)."""
    if cull_mode == 0:
        return sigma
    low = 1 - torch.exp(-tvr.softplus(sigma - 1)) < thresh
    other = torch.full_like(sigma, 1e3) if cull_mode == 2 else sigma
    return torch.where(low, torch.full_like(sigma, -1e3), other)


def occlusion_emulated(terms, dec, box_warp, grid, filters):
    """K7a's order of operations -> (A [N,Gx,Gy,Gz], density, kept [Gx,Gz])."""
    Gx, Gy, Gz = grid
    N, C = terms[0][0].shape[0], terms[0][0].shape[-1]
    w0 = dec.w0 * np.float32(dec.lr_mul / math.sqrt(C))
    b0 = dec.b0 * np.float32(dec.lr_mul)
    P = [((F @ w0.T) * THIRD + (b0 if (aa, ab) == (0, 1) else 0), aa, ab)
         for F, aa, ab in terms]                               # the first launch
    col = next(p for p, aa, ab in P if (aa, ab) == (0, 1))     # [N,Gx,Gy,64]
    slabs = [(p, aa) for p, aa, ab in P if ab == 2]            # [N,G_a,Gz,64], plane order
    w1 = dec.w1[0] * np.float32(dec.lr_mul / 8)
    b1 = dec.b1[0] * np.float32(dec.lr_mul)
    use_crop, crop_lim, cull_mode, thresh = tvr._filter_args(filters, box_warp)
    xc, _, zc = (torch.as_tensor(c, dtype=torch.float32)
                 for c in tlat.lattice_axis_coords(grid, box_warp))
    lim = torch.tensor(crop_lim, dtype=torch.float32)
    x_kept = (xc.abs() <= lim) if use_crop else torch.ones(Gx, dtype=torch.bool)
    z_kept = (zc.abs() <= lim) if use_crop else torch.ones(Gz, dtype=torch.bool)
    d_crop = tvr.softplus(cull(torch.tensor(-1e3), cull_mode, thresh) - 1)
    dz = torch.tensor(box_warp / Gz, dtype=torch.float32)

    def slab_row(p, axis, z):          # [N,Gx,Gy,64] broadcast view of P at z
        return p[:, :, z, None, :] if axis == 0 else p[:, None, :, z, :]

    A = torch.empty((N, Gx, Gy, Gz))
    density = torch.empty((N, Gx, Gy, Gz))
    run = torch.zeros((N, Gx, Gy))
    for z in range(Gz - 1, -1, -1):
        dens = d_crop.expand(N, Gx, Gy)
        if bool(z_kept[z]) and bool(x_kept.any()):
            (pa, aa), (pb, ab) = slabs
            h = (col + slab_row(pa, aa, z)) + slab_row(pb, ab, z)
            prod = (w1 * tvr.softplus(h)).reshape(N, Gx, Gy, 16, 4)
            s = torch.zeros((N, Gx, Gy, 4))
            for j4 in range(16):
                s = s + prod[..., j4, :]
            sigma = ((s[..., 0] + s[..., 1]) + (s[..., 2] + s[..., 3])) + b1
            decoded = tvr.softplus(cull(sigma, cull_mode, thresh) - 1)
            dens = torch.where(x_kept[None, :, None], decoded, dens)
        run = run + dens
        A[..., z] = (run - 0.5 * dens) * dz
        density[..., z] = dens
    return A, density, x_kept[:, None] & z_kept[None, :]


def plain_density(terms, dec, box_warp, grid, filters):
    """occlusion_volume_plain's density, before the suffix sum."""
    N = terms[0][0].shape[0]
    sigma = tlat.decode_lattice_terms(terms, lambda f: tvr.osg_decode(f, dec, sigma_only=True),
                                      grid, plane_reduce="mean")
    xyz = tlat.lattice_world_coords(grid, box_warp)
    sigma = tvr._apply_density_filters(sigma.reshape(N, -1, 1),
                                       xyz.reshape(1, -1, 3).expand(N, -1, 3), box_warp,
                                       *filters).reshape(N, *grid)
    return tvr.softplus(sigma - 1)


def case_inputs(C, seed):
    r = np.random.RandomState(seed)
    planes = (2 * r.randn(2, 3, C, 16, 16)).astype(np.float32)
    p = decoder_params(C, seed)
    p["net2"]["bias"][0] = 1.5
    return planes, p


@pytest.mark.parametrize("C,filters,use_triplane", [
    (8, (None, None, None), True),
    (8, (0.1, 0.5, None), True),       # the eval path: crop 0.1, cull 0.5
    (8, (0.1, None, 0.5), True),       # binarize_clouds
    (32, (None, None, None), True),
    (32, (0.1, 0.5, None), True),
    (32, (0.1, None, 0.5), True),
    (8, (0.1, 0.5, None), False),      # the other plane basis: two (x, z) terms
])
def test_factored_occlusion_matches_plain_and_jax(C, filters, use_triplane):
    planes, p = case_inputs(C, seed=11)
    dec = torch_decoder(p, True)
    axes = tvr.generate_plane_axes(use_triplane)
    terms = tlat.lattice_features(t(planes), axes, GRID, BW)
    A_e, dens_e, kept = occlusion_emulated(terms, dec, BW, GRID, tvr.DensityFilters(*filters))
    A_p = tlat.occlusion_volume_plain(terms, dec, BW, GRID, tvr.DensityFilters(*filters))
    sigma_fn = lambda f: jax_decode_fn(p, C, True)(f, sigma_only=True)   # noqa: E731
    A_j = np.asarray(jax.jit(lambda pl: jlat.front_occlusion_volume(
        pl, sigma_fn, BW, dict(use_triplane=use_triplane), *filters, grid=GRID,
        plane_reduce="mean")["A"])(jnp.asarray(planes)))
    tol = 1e-5 * float(A_p.abs().max())
    np.testing.assert_allclose(A_e.numpy(), A_p.numpy(), rtol=0, atol=tol)
    np.testing.assert_allclose(A_e.numpy(), A_j, rtol=0, atol=tol)
    if filters[0]:
        cropped = ~kept[None, :, None, :].expand_as(A_e)
        assert 0 < int(cropped.sum()) < A_e.numel()
        # no kept cell at or above: A is exactly the plain version's (0)
        above = torch.flip(torch.cumsum(torch.flip(kept.int(), (1,)), 1), (1,))
        exact = (above == 0)[None, :, None, :].expand_as(A_e)
        assert torch.equal(A_e[exact], A_p[exact])
        dens_p = plain_density(terms, dec, BW, GRID, tvr.DensityFilters(*filters))
        assert torch.equal(dens_e[cropped], dens_p[cropped])
