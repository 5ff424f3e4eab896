"""ADA in the port's training (training/augment.py through the loss
phases, loop.py:ada_update, the trainer's --aug ada|fixed) against the JAX
package on the CPU:

- one Gmain + Dmain + Dreg step on the tiny training rig
  (tests/torch_train_rig.py: f32, const noise, the key-free render) with
  the 'bgc' augment at aug_p = 0.7, the JAX step's latents and augment
  draws replayed (a spy on jax.random.normal / uniform / randint filtered
  to the JAX training modules): G's and D's Adam moments within 1e-3
  relative L2 a tensor, and the parameters and G_ema within 2.5e-2 x lr of
  JAX's, the tolerances of tests/test_torch_train_step.py (Adam's eps 1e-4
  there, for the same reason);
- ada_update equal to the JAX package's, the clamp at 0 included;
- aug_p across snapshots: a JAX train state with aug_p 0.37 resumes in the
  port's trainer (--aug ada, the ADA kimg of a resumed run), one step moves
  p by the heuristic's own step, and the port's snapshot loads in the JAX
  package with that p; --aug fixed sets p to --aug-p;
- the trainer CLI end to end with --aug ada and --aug fixed (slow).
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import torch_train_rig as R
from panic3d_tpu.runtime.checkpoint import load_train_state as j_load_train_state
from panic3d_tpu.runtime.checkpoint import save_checkpoint as j_save_checkpoint
from panic3d_tpu.training import LossConfig as JLossConfig
from panic3d_tpu.training import TrainConfig as JTrainConfig
from panic3d_tpu.training import build_train_step as j_build_train_step
from panic3d_tpu.training import init_state as j_init_state
from panic3d_tpu.training.loop import ada_update as j_ada_update
from panic3d_tpu.training.setup import make_loss as j_make_loss
from panic3d_tpu_torch.training import TrainConfig, ada_update, build_train_step, init_state
from panic3d_tpu_torch.training import trainer
from panic3d_tpu_torch.training.loss import LossConfig as TLossConfig
from panic3d_tpu_torch.training.setup import make_loss as t_make_loss
from panic3d_tpu_torch.utils.draws import Replay
from test_torch_train_checkpoint import jax_tiny_state

PHASES = ("Gmain", "Dmain", "Dreg")
EPS = 1e-4        # Adam's eps, as tests/test_torch_train_step.py takes it
AUG_P = 0.7
KINDS = ("normal", "uniform", "randint")
CALLERS = ("panic3d_tpu/training/loss.py", "panic3d_tpu/training/loop.py",
           "panic3d_tpu/training/augment.py")


@pytest.fixture(scope="module", autouse=True)
def _threads():
    with R.torch_threads(2):
        yield


@pytest.fixture
def spy(monkeypatch):
    """The draws of the JAX training modules, augment included, by kind."""
    rec = {k: [] for k in KINDS}
    for kind in KINDS:
        real = getattr(jax.random, kind)

        def fn(*args, _real=real, _kind=kind, **kwargs):
            out = _real(*args, **kwargs)
            if sys._getframe(1).f_code.co_filename.endswith(CALLERS):
                rec[_kind].append(out)
            return out
        monkeypatch.setattr(jax.random, kind, fn)
    return rec


def test_ada_step_matches_jax(spy):
    g, d, vG, vD, lpips_vars, batch = R.rig()
    jl = j_make_loss(g, d, lpips_vars, JLossConfig(**R.LOSS_KW), noise_mode="const",
                     deterministic=True, augment=True)
    jcfg = JTrainConfig(batch_size=R.BS, phases=PHASES, eps=EPS)
    jstep = j_build_train_step(jl, jcfg, g.z_dim, PHASES)

    @jax.jit
    def run(state, key):
        for v in spy.values():
            v.clear()
        new, _ = jstep(state, batch, key)
        return new, {k: list(v) for k, v in spy.items()}

    jstate0 = j_init_state(vG, vD, jcfg).replace(aug_p=np.float32(AUG_P))
    jstate, taken = run(jstate0, jax.random.PRNGKey(5))
    # four augment passes (Gmain's, Dmain's fake and real, Dreg's), each
    # with its rotate90 draw
    assert len(taken["randint"]) == 4
    G, D, lp = R.torch_models()
    cfg = TrainConfig(batch_size=R.BS, phases=PHASES, eps=EPS)
    state = init_state(G, D, cfg)
    state.aug_p = float(np.float32(AUG_P))
    loss = t_make_loss(G, D, lp, TLossConfig(**R.LOSS_KW), noise_mode="const",
                       deterministic=True, augment=True)
    step = build_train_step(loss, cfg, G.z_dim, PHASES)
    gen = Replay(**{k: [np.asarray(x) for x in v] for k, v in taken.items()})
    stats = step(state, R.torch_batch(), gen)
    assert gen.left() == {k: 0 for k in KINDS}
    assert np.isfinite([float(v) for v in stats.values()]).all()
    assert state.opt_G.count == 1 and state.opt_D.count == 2
    for opt, jopt in ((state.opt_G, jstate.opt_G), (state.opt_D, jstate.opt_D)):
        for key in ("mu", "nu"):
            R.check_grads({n: getattr(opt, key)[n].numpy() for n in opt.params},
                          R.flat_params(getattr(jopt[0], key)), rel=1e-3)
    lr = {"G": 0.0025 * 4 / 5, "D": 0.002 * 16 / 17}
    for name, got, want in (("G", G, jstate.vars_G["params"]), ("D", D, jstate.vars_D["params"]),
                            ("G", state.G_ema, jstate.vars_Gema["params"])):
        want = R.flat_params(want)
        diffs = np.concatenate([np.abs(p.detach().numpy() - want[n]).ravel()
                                for n, p in got.named_parameters()])
        assert diffs.max() <= 2.5e-2 * lr[name], (name, diffs.max())


@pytest.mark.parametrize("p,signs,interval,kimg", [
    (0.0, 0.9, 4, 500.0), (0.3, 0.1, 4, 500.0), (0.3, 0.6, 4, 500.0), (1e-6, -1.0, 16, 100.0),
    (0.123456, 0.61, 1, 100.0)])
def test_ada_update_matches_jax(p, signs, interval, kimg):
    jstate = j_init_state(*R.rig()[2:4], JTrainConfig(batch_size=8)).replace(
        aug_p=np.float32(p))
    want = j_ada_update(jstate, signs, 0.6, 8, interval, kimg).aug_p

    class S:
        aug_p = float(np.float32(p))
    s = S()
    ada_update(s, signs, 0.6, 8, interval, kimg)
    assert np.float32(s.aug_p) == np.asarray(want) and s.aug_p >= 0


def test_aug_p_across_snapshots(tmp_path):
    run_dir = tmp_path / "run"
    jstate = jax_tiny_state().replace(aug_p=np.float32(0.37))
    j_save_checkpoint(str(run_dir / "network-snapshot-000008"), jstate)
    args = ["--name", "run", "--outdir", str(tmp_path), "--tiny", "--synthetic", "--device",
            "cpu", "--batch", "2", "--tick-steps", "1", "--aug", "ada", "--ada-interval", "1"]
    signs = []
    out = trainer.main(args + ["--max-steps", "5"],
                       on_step=lambda i, ph, st: signs.append(float(st["Loss/signs/real"])))
    assert out["steps"] == 1 and len(signs) == 1
    # one step of the heuristic from the JAX snapshot's p, at a resumed run's ADA kimg (100)
    want = np.float32(max(np.float32(0.37) + np.float32(np.sign(signs[0] - 0.6) * 2 / 1e5), 0))
    assert np.float32(out["state"].aug_p) == want and want != np.float32(0.37)
    restored, _ = j_load_train_state(out["snapshot"], jax_tiny_state(seed=1))
    assert np.asarray(restored.aug_p) == want
    # --aug fixed holds p at --aug-p
    out = trainer.main(["--name", "fixed", "--outdir", str(tmp_path), "--tiny", "--synthetic",
                        "--device", "cpu", "--batch", "2", "--max-steps", "1", "--aug",
                        "fixed", "--aug-p", "0.6"])
    assert out["state"].aug_p == float(np.float32(0.6))
    assert np.isfinite([float(v) for v in out["stats"].values()]).all()


@pytest.mark.slow
@pytest.mark.parametrize("mode", [["ada", "--ada-interval", "1"], ["fixed", "--aug-p", "0.6"]])
def test_trainer_cli_with_aug(mode, tmp_path):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "panic3d_tpu_torch.training.trainer", "--name", "cli", "--tiny",
         "--synthetic", "--device", "cpu", "--batch", "2", "--max-steps", "2", "--tick-steps",
         "1", "--outdir", str(tmp_path), "--aug", *mode],
        cwd=root, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    ticks = [ln for ln in proc.stdout.splitlines() if ln.startswith("tick")]
    assert len(ticks) == 2 and all(" augment=" in t for t in ticks)
    assert "done; final snapshot" in proc.stdout
