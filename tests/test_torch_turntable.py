"""The per-portrait turntable in the port, and kernel K12's plain version.

1. eval/generate.py's planes bundle (mapping, planes, ESS occupancy,
   occlusion volume, once per portrait) + the from-planes view renders
   equal the per-call G.f in the port, as tests/test_ess.py checks the JAX
   package's cache (same function of the same inputs; 2e-5 absorbs the
   batch-size dependence of the convolution sums).
2. gather_dot_plain vs the Pallas probe's own baseline,
   jnp.dot(jnp.take(table, idx, 0), w, preferred_element_type=f32)
   (scripts/bench_pallas_gather.py:77-80). The Pallas body needs a TPU
   (pltpu) and has no interpret mode; the probe holds it against that
   baseline.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panic3d_tpu_torch import configs as tcfg
from panic3d_tpu_torch.cameras import cam60, camsubs
from panic3d_tpu_torch.eval.generate import (
    EVAL_VIEWS,
    INFERENCE_OPTS,
    plane_cache_ok,
    planes_bundle,
    render_from_planes,
)
from panic3d_tpu_torch.kernels import launch_counts
from panic3d_tpu_torch.ops.gather_dot import gather_dot, gather_dot_plain

from test_torch_generator import F32

RK = dict(F32["rendering_kwargs"], ess=dict(grid=8, taps=16, thresh=0.01, margin=1.0),
          occ_grid=(16, 16, 32))
SEED = 7


@pytest.fixture(scope="module")
def tiny_g():
    G = tcfg.tiny(device="cpu", **dict(F32, rendering_kwargs=RK, force_sigmoid=True))
    G = G.init_weights(0).eval()
    with torch.no_grad():
        G.decoder.net[2].bias[0] += 1.0
    r = np.random.RandomState(2)
    cond = {"image_ortho_front": torch.from_numpy(r.rand(1, 3, 64, 64).astype(np.float32)),
            "resnet_chonk": torch.from_numpy(r.randn(1, 16, 8, 8).astype(np.float32))}
    return G, cond


def test_turntable_views_match_per_call_f(tiny_g):
    G, cond = tiny_g
    assert plane_cache_ok(G)
    bundle = planes_bundle(G, SEED, cond, INFERENCE_OPTS)
    assert set(bundle) == {"ws", "planes", "occ", "occ_out", "occ_A", "occ_d0"}
    el, az, fovs = [10.0, 0.0], [0.0, 90.0], [30.0, -1.0]      # a pinhole and an ortho view
    cached = render_from_planes(G, INFERENCE_OPTS, bundle, el, az, fovs, cond)
    xin = {"seeds": [SEED, SEED], "elevations": torch.tensor(el), "azimuths": torch.tensor(az),
           "fovs": torch.tensor(fovs),
           "cond": {k: v.expand(2, *v.shape[1:]) for k, v in cond.items()}, **INFERENCE_OPTS}
    with torch.no_grad():
        full = G.f(xin)
    for k in cached:
        np.testing.assert_allclose(cached[k].numpy(), full[k].numpy(), atol=2e-5, rtol=1e-5,
                                   err_msg=k)
    assert sum(launch_counts().values()) == 0


def test_eval_views_and_spin12():
    spin = [(float(cam60[v][0]), float(cam60[v][1])) for v in camsubs["spin12"]]
    assert len(EVAL_VIEWS) + len(spin) == 16
    assert len(set(spin)) == 12
    from panic3d_tpu.cameras import conventions as jconv

    np.testing.assert_array_equal(cam60, jconv.cam60)
    assert camsubs == jconv.camsubs


def test_gather_dot_plain_matches_probe_baseline():
    r = np.random.RandomState(0)
    rows, C, P, hid = 512, 128, 4096, 64        # the probe's widths, fewer rows and points
    table = r.randn(rows, C).astype(np.float32)
    w = (r.randn(C, hid) * 0.1).astype(np.float32)
    idx = r.randint(0, rows, P).astype(np.int32)
    want = jnp.dot(jnp.take(jnp.asarray(table), jnp.asarray(idx), axis=0), jnp.asarray(w),
                   preferred_element_type=jnp.float32)
    got = gather_dot(torch.from_numpy(idx), torch.from_numpy(table), torch.from_numpy(w))
    assert torch.equal(got, gather_dot_plain(torch.from_numpy(idx), torch.from_numpy(table),
                                             torch.from_numpy(w)))
    # f32 dot products of length 128: only the summation order differs
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert sum(launch_counts().values()) == 0
