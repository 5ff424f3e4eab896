"""Trainer snapshots between the packages, and the port's trainer CLI, on
the CPU with the trainer's tiny models:

- a JAX train state written by panic3d_tpu's save_checkpoint (seeded
  weights, Adam moments and counts, cur_nimg) is found by the port's
  auto-resume and loads leaf for leaf (runtime/checkpoint.py:
  load_train_state); the trainer resumes from it (``--tiny --synthetic
  --device cpu``, 2 steps from its step 4: the counts advance, every phase
  of the default list runs, the losses are finite);
- the port's final snapshot loads in panic3d_tpu.runtime.checkpoint.
  load_train_state, leaf for leaf equal to the port's state;
- --batch-gpu: the trainer's accumulation runs (batch 4 in micro-batches
  of 2);
- options outside the slice raise NotImplementedError naming their ROADMAP
  item; the options ported since (paste-front A and Agrad, the deep
  planes, Greg's monotonic terms) pass the refusals with the flagship's
  flags and are taken by the tiny trainer (a dry run).
"""

import os

import jax
import numpy as np
from flax.serialization import to_state_dict
import pytest
import torch

from panic3d_tpu import configs as jcfg
from panic3d_tpu.data.dataset import synthetic_batch
from panic3d_tpu.models.dual_discriminator import DualDiscriminator as JD
from panic3d_tpu.models.triplane import TriPlaneGenerator as JG
from panic3d_tpu.runtime.checkpoint import load_train_state as j_load_train_state
from panic3d_tpu.runtime.checkpoint import save_checkpoint as j_save_checkpoint
from panic3d_tpu.training import TrainConfig as JTrainConfig
from panic3d_tpu.training import init_state as j_init_state
from panic3d_tpu_torch.runtime.checkpoint import train_state_tree
from panic3d_tpu_torch.training import trainer

import torch_train_rig as R

@pytest.fixture(scope="module", autouse=True)
def _threads():
    with R.torch_threads(2):
        yield


BS = 2


def jax_tiny_state(seed=0):
    """The JAX trainer's tiny models (training/trainer.py:build_models) with
    seeded weights and Adam state, as a GANTrainState of numpy leaves."""
    g = jcfg.tiny(cond_mode="ortho_front.add_4.reschonk_add_16")
    d = JD(c_dim=25, img_resolution=g.img_resolution, channel_base=1024, channel_max=32,
           epilogue_kwargs=dict(mbstd_group_size=2))
    b = jax.tree_util.tree_map(np.asarray, synthetic_batch(bs=BS, size=g.img_resolution))
    xin = {"z": np.zeros((BS, g.z_dim), np.float32), "camera_params": b["camera"],
           "cond": b["cond"]}
    img = {"image": b["image"], "image_raw": np.zeros((BS, 3, 16, 16), np.float32)}
    k = jax.random.PRNGKey(0)
    sg = jax.eval_shape(lambda: g.init({"params": k}, xin, method=JG.f, noise_mode="const"))
    sd = jax.eval_shape(lambda: d.init({"params": k}, img, b["camera"], b["cond"]))
    r = np.random.RandomState(seed)

    def rand(leaf, scale=1.0, positive=False):
        a = np.asarray(r.randn(*leaf.shape), np.float32) * np.float32(scale)
        return np.abs(a) if positive else a

    vG = jax.tree_util.tree_map(lambda s: rand(s, 0.5), sg)
    vD = jax.tree_util.tree_map(lambda s: rand(s, 0.5), sd)
    state = j_init_state(vG, vD, JTrainConfig(batch_size=BS))

    def opt(o):
        adam = o[0]
        return (adam._replace(count=np.asarray(3, np.int32),
                              mu=jax.tree_util.tree_map(lambda a: rand(a, 1e-3), adam.mu),
                              nu=jax.tree_util.tree_map(lambda a: rand(a, 1e-6, True),
                                                        adam.nu)),) + tuple(o[1:])

    return state.replace(vars_Gema=jax.tree_util.tree_map(lambda a: rand(a, 0.5), vG),
                         opt_G=opt(state.opt_G), opt_D=opt(state.opt_D),
                         cur_nimg=np.asarray(4 * BS, np.int32))


def leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_snapshots_cross_the_packages(tmp_path):
    run_dir = tmp_path / "run"
    jstate = jax_tiny_state()
    j_save_checkpoint(str(run_dir / "network-snapshot-000008"), jstate)
    os.makedirs(run_dir / "network-snapshot-000016")     # a snapshot cut off mid-save
    (run_dir / "network-snapshot-000016" / "state.msgpack").write_bytes(b"")
    assert trainer.find_resume(str(run_dir)).endswith("network-snapshot-000008")

    # the port loads it leaf for leaf (the trainer's own path, before any step)
    args = ["--name", "run", "--outdir", str(tmp_path), "--tiny", "--synthetic", "--device",
            "cpu", "--batch", str(BS), "--tick-steps", "1"]
    out = trainer.main(args + ["--max-steps", "4"])    # resumed at step 4: no step to take
    assert out["steps"] == 0
    want = leaves(to_state_dict(jstate))
    got = leaves(train_state_tree(out["state"]))
    assert len(got) > 100 and set(want) == set(got)
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)

    # it resumes: two steps (step 4 runs Greg), every phase, finite losses
    out = trainer.main(args + ["--max-steps", "6"])
    st = out["state"]
    assert out["steps"] == 2 and st.cur_nimg == 6 * BS
    assert st.opt_G.count == 3 + 2 * 2 + 1 and st.opt_D.count == 3 + 2
    assert np.isfinite([float(v) for v in out["stats"].values()]).all()
    # the port's snapshot loads in the JAX package, leaf for leaf
    template = jax_tiny_state(seed=1)
    restored, _ = j_load_train_state(out["snapshot"], template)
    mine = leaves(train_state_tree(st))
    theirs = leaves(to_state_dict(restored))
    assert set(mine) == set(theirs)
    for k, v in mine.items():
        np.testing.assert_array_equal(v, theirs[k], err_msg=k)


def test_trainer_accumulates_over_batch_gpu(tmp_path):
    out = trainer.main(["--name", "acc", "--outdir", str(tmp_path), "--tiny", "--synthetic",
                        "--device", "cpu", "--batch", "4", "--batch-gpu", "2", "--max-steps",
                        "1", "--accum-sum"])
    st = out["state"]
    assert st.cur_nimg == 4 and st.opt_G.count == 3 and st.opt_D.count == 2
    assert np.isfinite([float(v) for v in out["stats"].values()]).all()


REFUSED = {
    "fuse_sum": ["--fuse-recon", "sum"], "fuse_seq": ["--fuse-recon", "seq"],
    "remat": ["--remat", "full"],
    "mesh_rays": ["--mesh-rays", "2"], "gpl": ["--pl-weight", "2"],
    "tensorboard": ["--tensorboard"],
}
# refused until their backward forms were ported (K8's, K10's), and Greg's
# monotonic term: each is now taken
PORTED = {
    "paste": ["--paste-params-mode", "A"], "paste_agrad": ["--paste-params-mode", "Agrad"],
    "depth2": ["--triplane-depth", "2"], "monotonic": ["--reg-type", "monotonic-fixed"],
    "monotonic_detach": ["--reg-type", "monotonic-detach"],
}


@pytest.mark.parametrize("name", list(REFUSED) + list(PORTED))
def test_unported_options_raise(name, tmp_path):
    argv = ["--name", "x", "--outdir", str(tmp_path), "--tiny", "--device", "cpu"]
    if name in PORTED:
        # the flagship's flags (--tiny ignores --triplane-depth) pass the
        # refusals, and the tiny trainer takes the option (a dry run)
        trainer.refuse_unported(trainer.parse_args(argv[:4] + PORTED[name]))
        assert trainer.main(argv + PORTED[name] + ["--dry-run"]) is None
        return
    with pytest.raises(NotImplementedError, match=r"ROADMAP Queue 1 item [45]"):
        trainer.main(argv + REFUSED[name])
