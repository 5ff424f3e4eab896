"""K6b's order of operations (csrc/ess.cu:ess_narrow_kernel), proved on the CPU.

The kernel gives each ray a warp: the 32 lanes share the ray's K taps
(lane l holds taps l, l + 32, ...), each chunk of 32 taps is a ballot, the
first and last occupied taps are the lowest and highest set bits of the
first and last non-zero ballots, and lane l writes depths l, l + 32, ....
``renderer.py:ess_narrow_warp_order`` does the same in PyTorch. Here it is
held bit for bit against ``ess_narrow_plain``, and within 1e-6 against the
JAX package's ``ess_narrow_intervals`` + ``sample_stratified`` (f32 on both
sides, the same formulas), on seeded occupancies and rays: the tiny
config's pinhole rays at K = 64, S = 48; a partial chunk (K = 37) and a
third one (K = 100); S = 2; an empty grid; a full grid; ``occ_outside``
set; and one grid shared by two views through a batch stride of 0 (the
turntable's form).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panic3d_tpu.models.volumetric import renderer as jvr
from panic3d_tpu_torch.cameras import camera_label, sample_rays
from panic3d_tpu_torch.models.volumetric import renderer as vr

BW, RAY_START, RAY_END = 0.7, 0.5, 1.5    # the tiny config's box and interval
TOL = 1e-6
RES = 16                                  # the tiny config's neural rendering resolution


def tiny_rays():
    """The tiny config's pinhole rays (fov 30) for two views, [2, 256, 3]."""
    n = 2
    cam = camera_label(torch.tensor([0.0, 20.0]), torch.tensor([0.0, 330.0]), torch.ones(n),
                       30 * torch.ones(n))
    ro, rd = sample_rays(cam[:, :16].reshape(-1, 4, 4), cam[:, 16:25].reshape(-1, 3, 3), RES)
    return ro.contiguous(), rd.contiguous()


# (K, S, grid, occupancy: "random" | "empty" | "full", occ_outside, shared grid)
CASES = {
    "tiny_K64_S48": (64, 48, 32, "random", 0.0, False),
    "partial_chunk_K37": (37, 12, 16, "random", 0.0, False),
    "third_chunk_K100": (100, 12, 32, "random", 0.0, False),
    "S2": (64, 2, 32, "random", 0.0, False),
    "no_occupied_tap": (64, 48, 32, "empty", 0.0, False),
    "every_tap_occupied": (64, 48, 32, "full", 0.0, False),
    "occ_outside": (64, 48, 16, "random", 1.0, False),
    "stride0_shared": (64, 48, 32, "random", 0.0, True),
}


def occupancy(kind, G, seed):
    if kind == "empty":
        return np.zeros((2, G, G, G), np.float32)
    if kind == "full":
        return np.ones((2, G, G, G), np.float32)
    # a seeded blob of occupied cells round the box centre, so rays enter
    # and leave it
    rng = np.random.RandomState(seed)
    c = (np.arange(G) + 0.5) / G - 0.5
    r2 = c[:, None, None] ** 2 + c[None, :, None] ** 2 + c[None, None, :] ** 2
    return ((r2 < 0.12) & (rng.rand(2, G, G, G) < 0.6)).astype(np.float32)


def jax_narrow(occ, occ_outside, ro, rd, opts, S):
    def f(occ, out, ro, rd):
        t0, t1 = jvr.ess_narrow_intervals(occ, out, ro, rd, RAY_START, RAY_END, BW, opts)
        return t0, t1, jvr.sample_stratified(ro, t0, t1, S)

    return [np.asarray(a) for a in jax.jit(f)(jnp.asarray(occ), jnp.asarray(occ_outside),
                                              jnp.asarray(ro), jnp.asarray(rd))]


@pytest.mark.parametrize("case", list(CASES))
def test_warp_order_against_plain_and_jax(case):
    K, S, G, kind, outside, shared = CASES[case]
    occ_np = occupancy(kind, G, seed=K + S)
    if shared:
        occ_np[1] = occ_np[0]
    ro, rd = tiny_rays()
    occ = torch.from_numpy(occ_np[:1]).expand(2, G, G, G) if shared else torch.from_numpy(occ_np)
    assert occ.stride(0) == (0 if shared else G ** 3)
    out = torch.tensor(outside)
    opts = dict(ess=dict(grid=G, taps=K, margin=1.0))
    got = vr.ess_narrow_warp_order(occ, out, ro, rd, RAY_START, RAY_END, BW, opts, S)
    want = vr.ess_narrow_plain(occ, out, ro, rd, RAY_START, RAY_END, BW, opts, S)
    for g, w, name in zip(got, want, ("t0", "t1", "depths")):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        assert torch.equal(g, w), f"{name}: max diff {float((g - w).abs().max())}"
    for g, w in zip(got, jax_narrow(occ_np, np.float32(outside), ro.numpy(), rd.numpy(), opts,
                                    S)):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=TOL)
    span = (got[1] - got[0]).numpy()
    full = RAY_END - RAY_START
    if kind == "empty":                       # no tap occupied: the full interval
        assert np.all(span == np.float32(full))
    elif kind == "full":                      # every ray crosses the box: all narrowed
        assert np.all(span < full - 1e-3)
    else:                                     # the blob narrows some rays, not all
        assert (span < full - 1e-3).any() and (span == np.float32(full)).any()
    if outside:                               # taps past the grid count: other intervals
        inside_only = vr.ess_narrow_plain(occ, torch.tensor(0.0), ro, rd, RAY_START, RAY_END,
                                          BW, opts, S)
        assert not torch.equal(got[0], inside_only[0])
