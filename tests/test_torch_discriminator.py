"""The port's DualDiscriminator and discriminator phases against the JAX
package's, on the tiny training rig (tests/torch_train_rig.py; CPU, f32):

- the logits of one image pair, and R1's gradient to ``image`` and
  ``image_raw`` (through filtered_resizing) against jax.grad;
- the weight bridge over D: the flax tree's names are the port's
  state_dict, and back;
- the label noise (disc_c_noise) drawn from the generator: the JAX draw,
  replayed, gives the JAX logits;
- Dmain and Dreg (R1 by a gradient of the gradient): each phase's loss and
  its gradient to every parameter of D against jax.value_and_grad.

Tolerances: logits and losses within 1e-5 relative (1e-6 absolute);
R1's input gradients within a relative L2 error of 1e-4; each parameter
gradient within 1e-4 relative L2, or, where the tensor's gradient norm is
under 5 % of the phase's largest (biases whose terms nearly cancel), within
2e-4 x that largest norm.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_rig as R
from panic3d_tpu.models.dual_discriminator import DualDiscriminator as JD
from panic3d_tpu_torch.models.dual_discriminator import DualDiscriminator as TD
from panic3d_tpu_torch.runtime.checkpoint import flax_from_state_dict, state_dict_from_flax
from panic3d_tpu_torch.utils.draws import Replay

@pytest.fixture(scope="module", autouse=True)
def _threads():
    with R.torch_threads(2):
        yield



@pytest.fixture(scope="module")
def models():
    return R.rig(), R.torch_models(), R.jax_loss()


def pair_inputs():
    r = np.random.RandomState(3)
    return (r.randn(R.BS, 3, R.IMG, R.IMG).astype(np.float32),
            r.randn(R.BS, 3, R.RAW, R.RAW).astype(np.float32))


def test_logits_and_r1_input_grads(models):
    (_, d, _, vD, _, batch), (_, D, _), _ = models
    img, raw = pair_inputs()
    cam = np.asarray(batch["camera"])

    @jax.jit
    def run(a, b):
        def total(a, b):
            return jnp.sum(d.apply(vD, {"image": a, "image_raw": b}, cam))
        return d.apply(vD, {"image": a, "image_raw": b}, cam), jax.grad(total, (0, 1))(a, b)

    want, (g_img, g_raw) = run(img, raw)
    a = torch.from_numpy(img).requires_grad_(True)
    b = torch.from_numpy(raw).requires_grad_(True)
    logits = D({"image": a, "image_raw": b}, torch.from_numpy(cam))
    assert logits.shape == (R.BS, 1)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    ga, gb = torch.autograd.grad(logits.sum(), (a, b))
    assert R.rel_l2(ga.numpy(), g_img) <= 1e-4 and R.rel_l2(gb.numpy(), g_raw) <= 1e-4
    assert float(np.linalg.norm(g_raw)) > 0


def test_weight_bridge_round_trip(models):
    (_, _, _, vD, _, _), (_, D, _), _ = models
    flat = {"/".join(k.key for k in p): v for p, v in jax.tree_util.tree_leaves_with_path(vD)}
    sd = D.state_dict()
    assert len(sd) == len(flat) and all(k.startswith("disc.") for k in sd)
    back = flax_from_state_dict(sd)
    for path, leaf in jax.tree_util.tree_leaves_with_path(vD):
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))


def test_label_noise_replays_jax_draw(models, monkeypatch):
    (_, _, _, vD, _, batch), _, _ = models
    d = JD(**dict(R.D_KW, disc_c_noise=0.5))
    D = TD(**dict(R.D_KW, disc_c_noise=0.5))
    D.load_state_dict(state_dict_from_flax(vD), strict=True)
    img, raw = pair_inputs()
    cam = np.asarray(batch["camera"])
    drawn, real = [], jax.random.normal

    def spy(*args, **kwargs):   # the label noise's draw, not flax's shape checks
        out = real(*args, **kwargs)
        if sys._getframe(1).f_code.co_filename.endswith("models/dual_discriminator.py"):
            drawn.append(np.asarray(out))
        return out

    monkeypatch.setattr(jax.random, "normal", spy)
    want = d.apply(vD, {"image": img, "image_raw": raw}, cam, rngs={"noise": jax.random.PRNGKey(4)})
    (noise,) = drawn
    assert noise.shape == cam.shape
    got = D({"image": torch.from_numpy(img), "image_raw": torch.from_numpy(raw)},
            torch.from_numpy(cam), generator=Replay(normal=[noise]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="disc_c_noise"):
        D({"image": torch.from_numpy(img), "image_raw": torch.from_numpy(raw)},
          torch.from_numpy(cam))


PHASES = {
    "Dmain": (lambda jl, vD, vG, b, z, c, k: jl.d_main_loss(vD, vG, b, z, c, k, 0),
              lambda tl, b, z, c, g: tl.d_main_loss(b, z, c, g, 0)),
    "Dreg": (lambda jl, vD, vG, b, z, c, k: jl.d_reg_loss(vD, b, c, k, 0, gain=16.0),
             lambda tl, b, z, c, g: tl.d_reg_loss(b, c, g, 0, gain=16.0)),
}


@pytest.mark.parametrize("phase", list(PHASES))
def test_d_phase_matches_jax(models, phase):
    (g, _, vG, vD, _, batch), (G, D, lp), jl = models
    jfn, tfn = PHASES[phase]
    z = np.random.RandomState(5).randn(R.BS, g.z_dim).astype(np.float32)
    c = np.asarray(batch["camera"])

    @jax.jit
    def run(params, key):
        (value, _), grads = jax.value_and_grad(
            lambda p: jfn(jl, dict(vD, params=p), vG, batch, z, c, key), has_aux=True)(params)
        return value, grads

    want, want_grads = run(vD["params"], jax.random.PRNGKey(2))
    value, stats = tfn(R.torch_loss(G, D, lp), R.torch_batch(), torch.from_numpy(z),
                       torch.from_numpy(c), None)
    np.testing.assert_allclose(float(value), float(want), rtol=1e-5)
    n, _ = R.check_grads(R.torch_grads(D, value), R.flat_params(want_grads))
    assert n == len(dict(D.named_parameters()))
    if phase == "Dmain":   # G's pass took no gradient
        assert all(p.grad is None for p in G.parameters())
