"""One train step of the port against the JAX package's, on the tiny
training rig (tests/torch_train_rig.py; CPU, f32, const noise, the
key-free render), and the loop's own rules:

- build_train_step at step 0 with Greg, Gmain, Gcond, Dmain and Dreg (each
  its own lazy-reg Adam step), then the G_ema lerp: the JAX step's latents
  and regulariser points are replayed (ROADMAP F6); G's and D's Adam
  moments (mu = g with b1 = 0: the last phase's gradient, Gcond's and
  Dreg's; nu = (1 - b2) g^2 summed over the phases) within 1e-3 relative
  L2 a tensor (Gcond's tolerance in test_torch_loss_phases.py), the
  counts, cur_nimg, and the parameters and G_ema after the step, every
  element within 2.5e-2 x lr of JAX's (the moments' 1e-3,
  through lr * mu / (sqrt(nu) + eps) near |g| ~ eps).
  Adam's step with b1 = 0 is lr * g / (|g| + eps), about lr * sign(g):
  at the default eps of 1e-8 an element whose gradient is rounding-sized
  flips its step, and the next phase's gradient moves with it; so these
  tests take eps = 1e-4 (TrainConfig.eps), above the rounding of the
  gradients, where the step is a smooth function of them;
- phases_for_step against the JAX package's over 40 steps;
- accumulation over batch_gpu = 1 against the whole batch of 2, one step
  of Greg and one of Gcond (means over the samples; D's phases are not:
  the minibatch std takes its groups from the micro-batch): the gradients
  (Adam's mu)
  held as torch_train_rig.check_grads holds them (1e-4 relative L2), and
  with accum_sum twice them;
- --freezed: the pairs of d_frozen_paths equal the JAX trainer's, and the
  layers they name take no update in a D phase.
"""

import copy

import jax
import numpy as np
import pytest
import torch

import torch_train_rig as R
from panic3d_tpu.training import TrainConfig as JTrainConfig
from panic3d_tpu.training import build_train_step as j_build_train_step
from panic3d_tpu.training import init_state as j_init_state
from panic3d_tpu.training import phases_for_step as j_phases_for_step
from panic3d_tpu_torch.training import TrainConfig, build_train_step, init_state, phases_for_step
from panic3d_tpu_torch.utils.draws import Replay

@pytest.fixture(scope="module", autouse=True)
def _threads():
    with R.torch_threads(2):
        yield


# every phase; Greg first among G's, because its loss, a mean of |sigma_a -
# sigma_b| over near pairs, changes its gradient by the signs of tiny
# differences, which any earlier Adam step moves (the step's own order is
# the TrainConfig's: phases_for_step keeps it)
PHASES = ("Greg", "Gmain", "Gcond", "Dmain", "Dreg")
EPS = 1e-4   # Adam's eps, above the rounding-sized gradients (see the module docstring)


def test_phases_for_step_matches_jax():
    for kw in ({}, dict(g_reg_interval=3, d_reg_interval=5, phases=PHASES + ("Gpl",))):
        j, t = JTrainConfig(**kw), TrainConfig(**kw)
        assert [j_phases_for_step(i, j) for i in range(40)] == \
            [phases_for_step(i, t) for i in range(40)]


def _moments(opt, key):
    return {n: getattr(opt, key)[n].numpy() for n in opt.params}


def test_train_step_matches_jax(monkeypatch):
    g, d, vG, vD, _, batch = R.rig()
    spy = R.Spy(monkeypatch)
    jl = R.jax_loss()
    jcfg = JTrainConfig(batch_size=R.BS, phases=PHASES, eps=EPS)
    jstep = j_build_train_step(jl, jcfg, g.z_dim, PHASES)

    @jax.jit
    def run(state, key):
        spy.clear()
        new, _ = jstep(state, batch, key)
        return new, spy.taken()

    jstate, taken = run(j_init_state(vG, vD, jcfg), jax.random.PRNGKey(3))
    assert [x.shape for x in taken["normal"]] == [(R.BS, g.z_dim), (R.BS, 1000, 3),
                                                   (R.BS, 2000, 3)]
    G, D, lp = R.torch_models()
    before = {n: p.detach().clone() for n, p in G.named_parameters()}
    cfg = TrainConfig(batch_size=R.BS, phases=PHASES, eps=EPS)
    state = init_state(G, D, cfg)
    step = build_train_step(R.torch_loss(G, D, lp), cfg, G.z_dim, PHASES)
    gen = Replay(normal=[np.asarray(x) for x in taken["normal"]],
                 uniform=[np.asarray(x) for x in taken["uniform"]])
    stats = step(state, R.torch_batch(), gen)
    assert gen.left() == {"normal": 0, "uniform": 0}
    assert np.isfinite([float(v) for v in stats.values()]).all()
    assert state.cur_nimg == int(jstate.cur_nimg) == R.BS
    assert state.opt_G.count == 3 and state.opt_D.count == 2
    for opt, jopt in ((state.opt_G, jstate.opt_G), (state.opt_D, jstate.opt_D)):
        assert int(jopt[0].count) == opt.count
        for key in ("mu", "nu"):
            R.check_grads(_moments(opt, key), R.flat_params(getattr(jopt[0], key)), rel=1e-3)
    lr = {"G": 0.0025 * 4 / 5, "D": 0.002 * 16 / 17}
    for name, got, want in (("G", G, jstate.vars_G["params"]), ("D", D, jstate.vars_D["params"]),
                            ("G", state.G_ema, jstate.vars_Gema["params"])):
        want = R.flat_params(want)
        diffs = np.concatenate([np.abs(p.detach().numpy() - want[n]).ravel()
                                for n, p in got.named_parameters()])
        assert diffs.max() <= 2.5e-2 * lr[name], (name, diffs.max())
    moved = [float((p.detach() - before[n]).abs().max()) for n, p in G.named_parameters()]
    assert max(moved) > 0.5 * lr["G"]


@pytest.mark.parametrize("phase", ["Greg", "Gcond"])
def test_accumulation_matches_whole_batch(phase):
    r = np.random.RandomState(8)
    z = r.randn(R.BS, 64).astype(np.float32)
    pert = r.randn(R.BS, 1000, 3).astype(np.float32)
    dirs = r.randn(R.BS, 2000, 3).astype(np.float32)
    coords = r.rand(R.BS, 1000, 3).astype(np.float32)
    mus = {}
    for name, kw in (("whole", {}), ("micro", dict(batch_gpu=1)),
                     ("micro_sum", dict(batch_gpu=1, accum_sum=True))):
        G, D, lp = R.torch_models()
        cfg = TrainConfig(batch_size=R.BS, phases=(phase,), eps=EPS, **kw)
        state = init_state(G, D, cfg)
        if phase == "Gcond":
            gen = Replay(normal=[z])
        elif name == "whole":
            gen = Replay(normal=[z, pert, dirs], uniform=[coords])
        else:   # micro-batch i draws its own slices, in turn
            gen = Replay(normal=[z, pert[:1], dirs[:1], pert[1:], dirs[1:]],
                         uniform=[coords[:1], coords[1:]])
        build_train_step(R.torch_loss(G, D, lp), cfg, G.z_dim, (phase,))(state, R.torch_batch(),
                                                                         gen)
        assert gen.left() == {"normal": 0, "uniform": 0}
        mus[name] = _moments(state.opt_G, "mu")   # the phase's gradient: b1 = 0
    R.check_grads(mus["micro"], mus["whole"])
    R.check_grads({n: v / 2 for n, v in mus["micro_sum"].items()}, mus["whole"])


def test_freezed_layers_take_no_update():
    """--freezed: the first N discriminator layers (the JAX trainer's
    d_frozen_paths, the same pairs) take no update in a D phase; the
    others move."""
    from panic3d_tpu.training.trainer import d_frozen_paths as j_d_frozen_paths
    from panic3d_tpu_torch.training.trainer import d_frozen_paths

    for res, n, arch in ((128, 3, "resnet"), (512, 7, "resnet"), (128, 4, "skip"),
                         (64, 0, "resnet")):
        assert d_frozen_paths(res, n, arch) == j_d_frozen_paths(res, n, arch)
    G, D, lp = R.torch_models()
    frozen = d_frozen_paths(R.IMG, 3)
    assert frozen == (("b128", "fromrgb"), ("b128", "conv0"), ("b128", "conv1"))
    cfg = TrainConfig(batch_size=R.BS, phases=("Dmain",), d_frozen=frozen)
    state = init_state(G, D, cfg)
    before = {n: p.detach().clone() for n, p in D.named_parameters()}
    build_train_step(R.torch_loss(G, D, lp), cfg, G.z_dim, ("Dmain",))(
        state, R.torch_batch(), Replay(normal=[np.zeros((R.BS, 64), np.float32)]))
    moved = {n: not torch.equal(p.detach(), before[n]) for n, p in D.named_parameters()}
    held = [n for n in moved if n.startswith(("disc.b128.fromrgb.", "disc.b128.conv0.",
                                              "disc.b128.conv1."))]
    assert len(held) == 6 and not any(moved[n] for n in held)
    # the next block's layers move (the c mapping's gradients vanish through
    # its 8 layers at lr multiplier 0.01 and need not)
    assert all(moved[n] for n in moved if n.startswith(("disc.b128.skip.", "disc.b64.")))
