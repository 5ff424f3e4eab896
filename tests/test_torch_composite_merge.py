"""K2's merge by rank and per-sample coefficients, emulated on the CPU.

csrc/ray_composite.cu does not sort a ray's samples. When each half is
non-decreasing (every eval path: midpoint linspace coarse depths,
inverse-CDF fine depths at a linspace u) coarse sample i goes to slot
i + #{fine < d_i} and fine sample j to j + #{coarse <= d_j}: the stable
argsort's order with ties coarse first. A ray with a half out of order takes
the full stable rank count. The weights are computed in slot order, the
transmittance as a prefix product over 32-interval chunks with a carry, and
the colours and xyz are not gathered: sample i at slot s(i) contributes
v_i c_i with v_i = (w_{s(i)-1} + w_{s(i)}) / 2 (w_{-1} = w_{S-1} = 0), in
stored order. Here the same steps run in torch and must match
ray_composite_plain, the JAX merge_composite and ray_march(unify_samples)
within the render tests' TOL (f32, only summation order differs), on
test_torch_render's ray samples (exact cross-half ties, an empty ray) plus
rays whose halves are out of order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panic3d_tpu_torch.models.volumetric import renderer as tvr

from test_torch_render import TOL, close, jax_composites, ray_samples, t

CHUNK = 32   # intervals per warp step of the kernel's prefix product


def merge_slots(d1, d2):
    """Each sample's slot in the merged order, [B,R,S1+S2] int64: by binary
    search where both halves of a ray are non-decreasing, else the stable
    rank count (smaller depths, then equal ones stored before)."""
    S1 = d1.shape[-1]
    d = torch.cat([d1, d2], -1)
    sorted_rays = (d1[..., 1:] >= d1[..., :-1]).all(-1) & (d2[..., 1:] >= d2[..., :-1]).all(-1)
    ar1 = torch.arange(S1)
    ar2 = torch.arange(d2.shape[-1])
    by_search = torch.cat([
        ar1 + torch.searchsorted(d2.contiguous(), d1.contiguous(), right=False),
        ar2 + torch.searchsorted(d1.contiguous(), d2.contiguous(), right=True)], -1)
    idx = torch.arange(d.shape[-1])
    earlier = idx[None, :] < idx[:, None]                             # [i, j]: j before i
    di, dj = d[..., :, None], d[..., None, :]
    by_rank = ((dj < di) | ((dj == di) & earlier)).sum(-1)
    return torch.where(sorted_rays[..., None], by_search, by_rank), sorted_rays


def composite_emulated(d1, c1, s1, x1, d2, c2, s2, x2, white_back):
    """K2's order of operations on [B,R,S,*] halves -> (rgb, depth, weight
    total, xyz) and the slots."""
    d1, d2, s1, s2 = d1[..., 0], d2[..., 0], s1[..., 0], s2[..., 0]
    slot, _ = merge_slots(d1, d2)
    d, s = torch.cat([d1, d2], -1), torch.cat([s1, s2], -1)
    S = d.shape[-1]
    ds = torch.empty_like(d).scatter_(-1, slot, d)
    ss = torch.empty_like(s).scatter_(-1, slot, s)
    delta = ds[..., 1:] - ds[..., :-1]
    alpha = 1 - torch.exp(-(tvr.softplus((ss[..., :-1] + ss[..., 1:]) / 2 - 1) * delta))
    f = (1 - alpha) + 1e-10
    w = torch.empty_like(alpha)
    carry = torch.ones_like(d[..., 0])
    for k0 in range(0, S - 1, CHUNK):
        p = torch.cumprod(f[..., k0:k0 + CHUNK], -1)
        excl = torch.cat([torch.ones_like(p[..., :1]), p[..., :-1]], -1)
        w[..., k0:k0 + CHUNK] = alpha[..., k0:k0 + CHUNK] * (carry[..., None] * excl)
        carry = carry * p[..., -1]
    wsum = w.sum(-1, keepdim=True)
    depth = (w * ((ds[..., :-1] + ds[..., 1:]) / 2)).sum(-1, keepdim=True) / wsum
    depth = torch.nan_to_num(depth, nan=float("inf")).clamp(d.min(), d.max())
    wpad = torch.nn.functional.pad(w, (0, 1))                          # w_{S-1} = 0
    below = torch.where(slot > 0, wpad.gather(-1, (slot - 1).clamp_min(0)),
                        torch.zeros_like(d))
    v = (below + wpad.gather(-1, slot)) / 2
    cx = torch.cat([torch.cat([c1, x1], -1), torch.cat([c2, x2], -1)], -2)
    comp = (v[..., None] * cx).sum(-2)
    if white_back:
        comp = comp + 1 - wsum
    comp = comp * 2 - 1
    return (comp[..., :-3], depth, wsum, comp[..., -3:]), slot


def samples_with_unsorted_rays(seed):
    """ray_samples plus two rays whose halves are out of order: ray (1, 0)'s
    fine half reversed, ray (1, 1)'s coarse half with two samples swapped."""
    arrays = [a.copy() for a in ray_samples(seed)]
    d1, d2 = arrays[0], arrays[4]
    d2[1, 0] = d2[1, 0, ::-1]
    d1[1, 1, [2, 7]] = d1[1, 1, [7, 2]]
    return arrays


def test_merge_slots_are_the_stable_argsort_order():
    d1, _, _, _, d2, _, _, _ = map(t, samples_with_unsorted_rays(5))
    slot, sorted_rays = merge_slots(d1[..., 0], d2[..., 0])
    assert not bool(sorted_rays[1, 0]) and not bool(sorted_rays[1, 1])
    assert bool(sorted_rays[0].all())
    order = torch.argsort(torch.cat([d1, d2], 2)[..., 0], dim=-1, stable=True)
    # slot is the inverse permutation of the stable argsort, exactly
    assert torch.equal(torch.argsort(order, dim=-1), slot)
    ties = (d1[..., None, 0] == d2[:, :, None, :, 0]).sum()
    assert int(ties) > 0                        # the cross-half ties are exercised


@pytest.mark.parametrize("white_back", [True, False])
def test_emulated_merge_composite_matches_plain_and_jax(white_back):
    arrays = samples_with_unsorted_rays(2)
    got, _ = composite_emulated(*map(t, arrays), white_back)
    plain = tvr.ray_composite(*map(t, arrays), white_back)
    for a, b in zip(got, plain):
        close(a, b.detach().numpy(), **TOL)
    reference, merged = jax_composites(white_back)
    J = [jnp.asarray(a) for a in arrays]
    comp, depth, wsum = reference(*J)
    comp_m, depth_m, wsum_m = merged(*J)
    for want_comp, want_depth, want_wsum in ((comp, depth, wsum), (comp_m, depth_m, wsum_m)):
        close(got[0], want_comp[..., :-3], **TOL)
        close(got[3], want_comp[..., -3:], **TOL)
        close(got[1], want_depth, **TOL)
        close(got[2], want_wsum, **TOL)
    # the empty ray's depth goes to the global maximum
    assert float(got[1][0, 0, 0]) == float(np.max(np.concatenate(arrays[0::4], 2)))


def test_emulated_merge_composite_at_the_kernel_chunk_edges():
    """More than one 32-interval chunk (96 + 96 samples), so the carry of the
    prefix product is exercised; against the plain version."""
    arrays = ray_samples(7, R=6, S1=96, S2=96)
    got, _ = composite_emulated(*map(t, arrays), True)
    for a, b in zip(got, tvr.ray_composite(*map(t, arrays), True)):
        close(a, b.detach().numpy(), **TOL)
