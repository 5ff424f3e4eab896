"""K3's order of operations (csrc/importance_sample.cu), proved on the CPU.

The kernel spreads each ray over the lanes of a warp (16 lanes a ray at
S = 48, 32 otherwise) and takes the transmittance's cumprod, the pdf's sum
and the cdf's cumsum as warp scans, then finds each u's bracket by a binary
search of fixed steps. ``renderer.py:importance_sample_warp_order`` does the
same in PyTorch. Here it is held against ``importance_sample_plain`` and
against the JAX package's ``sample_importance`` on ``ray_march``'s weights,
at S = 8 (the tiny config), 48 (the ESS paths), 96 (settings parity) and
37 (the generic kernel, K != S), on seeded sigmas with an all-empty ray and a
ray with one spike: fine depths within 1e-4 (f32: the scans' order of
rounding), and the binary search's cdf index equal to the count of cdf
entries <= u (searchsorted right) for every u. The JAX reference is jitted
once per case.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panic3d_tpu.models.volumetric import renderer as jr
from panic3d_tpu_torch.models.volumetric import renderer as vr

TOL = 1e-4


def rays(S, seed, B=2, R=64):
    """Sorted depths (uneven spacing, as the ESS-narrowed intervals) and
    seeded sigmas [B,R,S,1]; ray 0 is empty, ray 1 has one spike."""
    rng = np.random.RandomState(seed)
    start = rng.uniform(2.0, 2.4, (B, R, 1, 1))
    steps = rng.uniform(0.2, 1.0, (B, R, S, 1))
    depths = start + 1.0 * np.cumsum(steps, 2) / steps.sum(2, keepdims=True)
    sigmas = rng.randn(B, R, S, 1) * 4.0
    sigmas[0, 0] = -50.0
    sigmas[0, 1] = -50.0
    sigmas[0, 1, S // 2] = 60.0
    return depths.astype(np.float32), sigmas.astype(np.float32)


def jax_importance(depths, sigmas, K):
    def f(z, s):
        weights = jr.ray_march(jnp.zeros(z.shape[:3] + (3,)), s, z, False)[2]
        return jr.sample_importance(z, weights, K)

    return np.asarray(jax.jit(f)(jnp.asarray(depths), jnp.asarray(sigmas)))


@pytest.mark.parametrize("S,K", [(8, 8), (48, 48), (96, 96), (37, 20)])
def test_warp_order_against_plain_and_jax(S, K):
    depths, sigmas = rays(S, seed=S)
    d, s = torch.from_numpy(depths), torch.from_numpy(sigmas)
    got, searched, counted = vr.importance_sample_warp_order(d, s, K)
    assert got.shape == (2, 64, K, 1) and got.dtype == torch.float32
    assert torch.equal(searched, counted)
    assert int(counted.min()) >= 1 and int(counted.max()) <= S - 2
    np.testing.assert_allclose(got.numpy(), vr.importance_sample_plain(d, s, K).numpy(),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(got.numpy(), jax_importance(depths, sigmas, K), rtol=0, atol=TOL)
    # the empty ray's pdf is uniform: its fine depths spread over the whole ray
    mids = 0.5 * (depths[0, 0, 1:, 0] + depths[0, 0, :-1, 0])
    assert got[0, 0, 0, 0] == pytest.approx(mids[0], abs=TOL)
    assert got[0, 0, -1, 0] == pytest.approx(mids[S - 3], abs=TOL)
