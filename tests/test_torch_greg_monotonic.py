"""Greg's monotonic density regulariser (--reg-type monotonic-detach and
monotonic-fixed) in the port against the JAX package's, on the tiny
training rig (tests/torch_train_rig.py; CPU, f32, const noise): the loss
and its gradient to every parameter of G against jax.value_and_grad of the
JAX phase, with the JAX phase's draws replayed into the port (2,000 points
a sample and their neighbours box_warp/256 behind along -z, their
directions, then 1,000 fresh points, their perturbation at a spread of
box_warp/256 and their directions). The JAX phase draws these with keys it
reuses; the port draws each value on its own, in the same order.

Tolerances: the loss within 1e-5 relative; each parameter tensor's
gradient within 1e-4 relative L2 (Greg's l1 tolerance in
test_torch_loss_phases.py), a tensor under 5 % of the largest gradient norm
within 2e-4 x that norm (torch_train_rig.check_grads).
"""

import jax
import numpy as np
import pytest

import torch_train_rig as R
from panic3d_tpu_torch.utils.draws import Replay
from torch_one_thread import torch_one_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("reg_type", ["monotonic-detach", "monotonic-fixed"])
def test_monotonic_greg_matches_jax(monkeypatch, reg_type):
    g, d, vG, vD, _, batch = R.rig()
    jl = R.jax_loss(reg_type=reg_type)
    spy = R.Spy(monkeypatch)
    z = np.random.RandomState(5).randn(R.BS, g.z_dim).astype(np.float32)
    c = np.asarray(batch["camera"])

    @jax.jit
    def run(params, key):
        spy.clear()
        (value, _), grads = jax.value_and_grad(
            lambda p: jl.g_reg_loss(dict(vG, params=p), batch, z, c, key, 0, gain=4.0),
            has_aux=True)(params)
        return value, grads, spy.taken()

    want, want_grads, taken = run(vG["params"], jax.random.PRNGKey(2))
    assert [tuple(x.shape) for x in taken["uniform"]] == [(R.BS, 2000, 3), (R.BS, 1000, 3)]
    assert [tuple(x.shape) for x in taken["normal"]] == [(R.BS, 4000, 3), (R.BS, 1000, 3),
                                                         (R.BS, 2000, 3)]
    gen = Replay(normal=[np.asarray(x) for x in taken["normal"]],
                 uniform=[np.asarray(x) for x in taken["uniform"]])
    G, D, lp = R.torch_models()
    value, stats = R.torch_loss(G, D, lp, reg_type=reg_type).g_reg_loss(
        R.torch_batch(), R.torch_tree(z), R.torch_tree(c), gen, 0, gain=4.0)
    assert gen.left() == {"normal": 0, "uniform": 0}
    got = float(value.detach())
    np.testing.assert_allclose(got, float(want), rtol=1e-5)
    np.testing.assert_allclose(4.0 * float(stats["Loss/G/reg"].detach()), got, rtol=1e-6)
    n, floored = R.check_grads(R.torch_grads(G, value), R.flat_params(want_grads), rel=1e-4)
    assert n == len(dict(G.named_parameters())) and floored < n
