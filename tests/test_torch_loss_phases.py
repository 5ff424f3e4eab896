"""The port's generator loss phases against the JAX package's, on the tiny
training rig (tests/torch_train_rig.py; CPU, f32, const noise, the key-free
render): Gmain, Gcond (the ortho front view with LPIPS) and Greg (the
density regulariser), each phase's loss and its gradient to every
parameter of G against jax.value_and_grad of the JAX phase function. The
regulariser's points are the JAX package's own draws, replayed.

Tolerances: the loss within 1e-5 relative; each parameter tensor's
gradient within a relative L2 error of 1e-4 (Gmain, Greg), 1e-3 for Gcond,
whose LPIPS gradient runs back through AlexNet's convolutions, the
superresolution and the importance-resampled render, summed in another
order by XLA and by PyTorch (ROADMAP F2); a tensor whose gradient norm is
under 5 % of the phase's largest is held to 2e-4 x that largest norm
(sums that nearly cancel, such as the noise strengths, and sigma's bias in
Greg, whose terms cancel exactly).
"""

import jax
import numpy as np
import pytest
import torch

import torch_train_rig as R
from panic3d_tpu_torch.utils.draws import Replay

@pytest.fixture(scope="module", autouse=True)
def _threads():
    with R.torch_threads(2):
        yield


PHASES = {
    "Gmain": (lambda jl, vG, vD, b, z, c, k: jl.g_main_loss(vG, vD, b, z, c, k, 0),
              lambda tl, b, z, c, g: tl.g_main_loss(b, z, c, g, 0), 1e-4),
    "Gcond": (lambda jl, vG, vD, b, z, c, k: jl.g_cond_loss(vG, b, z, k),
              lambda tl, b, z, c, g: tl.g_cond_loss(b, z, g), 1e-3),
    "Greg": (lambda jl, vG, vD, b, z, c, k: jl.g_reg_loss(vG, b, z, c, k, 0, gain=4.0),
             lambda tl, b, z, c, g: tl.g_reg_loss(b, z, c, g, 0, gain=4.0), 1e-4),
}


@pytest.fixture(scope="module")
def models():
    return R.rig(), R.torch_models(), R.jax_loss()


@pytest.mark.parametrize("phase", list(PHASES))
def test_g_phase_matches_jax(models, monkeypatch, phase):
    (g, d, vG, vD, _, batch), (G, D, lp), jl = models
    jfn, tfn, rel = PHASES[phase]
    spy = R.Spy(monkeypatch)
    z = np.random.RandomState(5).randn(R.BS, g.z_dim).astype(np.float32)
    c = np.asarray(batch["camera"])

    @jax.jit
    def run(params, key):
        spy.clear()
        (value, _), grads = jax.value_and_grad(
            lambda p: jfn(jl, dict(vG, params=p), vD, batch, z, c, key), has_aux=True)(params)
        return value, grads, spy.taken()

    want, want_grads, taken = run(vG["params"], jax.random.PRNGKey(2))
    gen = Replay(normal=[np.asarray(x) for x in taken["normal"]],
                 uniform=[np.asarray(x) for x in taken["uniform"]])
    if phase == "Greg":   # the points, their perturbation and the directions
        assert [tuple(x.shape) for x in taken["uniform"]] == [(R.BS, 1000, 3)]
        assert [tuple(x.shape) for x in taken["normal"]] == [(R.BS, 1000, 3), (R.BS, 2000, 3)]
    value, _ = tfn(R.torch_loss(G, D, lp), R.torch_batch(), torch.from_numpy(z),
                   torch.from_numpy(c), gen)
    assert gen.left() == {"normal": 0, "uniform": 0}
    np.testing.assert_allclose(float(value), float(want), rtol=1e-5)
    n, floored = R.check_grads(R.torch_grads(G, value), R.flat_params(want_grads), rel=rel)
    assert n == len(dict(G.named_parameters())) and floored < n
