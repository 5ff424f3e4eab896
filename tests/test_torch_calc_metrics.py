"""The port's GAN metrics: eval/calc_metrics.py and training/metric_eval.py
against the JAX package's CLI on one tiny snapshot, and the trainer's
snapshot-time --metrics.

Both CLIs score the same snapshot (the port's seeded tiny generator in the
training rig's f32 configuration, written in the JAX package's layout)
with the same seeded InceptionV3, CLIP and LPIPS weights, on the same
synthetic batches; the z of the fakes are the JAX CLI's own, recorded by a
spy on jax.random.normal (filtered to panic3d_tpu/training/metric_eval.py)
and replayed into the port as a utils/draws.py:Replay. Ten items: is50k's
ten splits need ten to be finite. Spies record each package's features,
FID statistics and PPL distances.

Held (measured in brackets): each batch's InceptionV3 and CLIP features
within 1e-5 of the batch's largest feature [2.8e-6] (the generators' f32
images differ by roundings, the nets sum in their own orders), the FID
statistics within 1e-4 of their largest entry [1.3e-5], FID, KID,
fid_clip and IS within 1e-5 relative [3.2e-7], precision and recall
equal, and PPL's distances within 2 % [1.1 %], its metric within 1 %
[0.2 %]: LPIPS / eps^2 divides by 1e-8, so the f32 roundings of two
renders 1e-4 apart move each distance (F2). F2 compares such a quantity
in f64 on both sides; the port's generator has no f64 path (its inputs
are cast to f32), so the bound is stated instead. At ten items in ten
splits is50k is 1 (a split of one image) and the fakes lie apart from the
noise reals (precision 0, recall 1), so IS in two splits and precision /
recall between two sets of fakes are held on the captured outputs too.
"""

import json
import os
import sys

import jax
import numpy as np

import panic3d_tpu.eval.gan_metrics as jgm
import panic3d_tpu.training.metric_eval as jme
import panic3d_tpu_torch.eval.gan_metrics as tgm
from panic3d_tpu.eval import calc_metrics as jcm
from panic3d_tpu.eval.goldens import seeded_clip_state_dict, seeded_lpips_state_dict
from panic3d_tpu.runtime.convert import convert_clip_vit_b32, convert_lpips_alex
from panic3d_tpu_torch import configs as tcfg
from panic3d_tpu_torch.eval import calc_metrics as tcm
from panic3d_tpu_torch.eval.inception import seeded_state_dict
from panic3d_tpu_torch.runtime.checkpoint import flax_from_state_dict, save_checkpoint
from panic3d_tpu_torch.runtime.convert import convert_inception_v3
from panic3d_tpu_torch.training import metric_eval as tme
from panic3d_tpu_torch.training import trainer
from panic3d_tpu_torch.utils.draws import Replay

from torch_one_thread import torch_one_thread  # noqa: F401  (autouse)
from torch_train_rig import G_KW

METRICS = ("fid50k_full", "fid_clip", "kid50k_full", "pr50k3_full", "is50k", "ppl2_wend")
ITEMS = 10
FEAT_TOL = 1e-5    # of a batch's largest feature
STATS_TOL = 1e-4   # of the largest mean or covariance entry
METRIC_TOL = 1e-5  # relative: FID, KID, fid_clip, IS
PPL_TOL = 2e-2     # relative, each distance: LPIPS / eps^2 of f32 renders (F2)
PPL_METRIC_TOL = 1e-2


def save_flax_npz(path, variables):
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat["/".join(prefix + (k,))] = np.asarray(v, np.float32)

    walk(variables["params"], ())
    np.savez(path, **flat)
    return path


class Record:
    """Spies on one package's feature-net factories, FID statistics and PPL
    distances: what each returned, in order."""

    def __init__(self, monkeypatch, metric_eval, fid_module):
        self.features, self.fid_stats, self.ppl = [], [], []
        for name in ("make_inception_feature_fn", "make_clip_feature_fn"):
            real = getattr(metric_eval, name)

            def factory(*args, _real=real, _name=name, **kwargs):
                fn = _real(*args, **kwargs)

                def feature_fn(images):
                    out = np.asarray(fn(images))
                    self.features.append((_name, out))
                    return out
                return feature_fn
            monkeypatch.setattr(metric_eval, name, factory)
        real_fd = fid_module.frechet_distance

        def frechet_distance(*stats):
            self.fid_stats.append(stats)
            return real_fd(*stats)
        monkeypatch.setattr(fid_module, "frechet_distance", frechet_distance)
        real_ppl = metric_eval.compute_ppl

        def compute_ppl(*args, **kwargs):
            self.ppl.append(np.asarray(real_ppl(*args, **kwargs)))
            return self.ppl[-1]
        monkeypatch.setattr(metric_eval, "compute_ppl", compute_ppl)


def results(run_dir):
    out = {}
    for name in METRICS:
        with open(os.path.join(run_dir, f"metric-{name}.jsonl")) as f:
            rec = json.loads(f.read().splitlines()[-1])
        assert rec["snapshot_pkl"] == "network-snapshot-000002"
        out.update(rec["results"])
    return out


def test_calc_metrics_cli_matches_jax(tmp_path, monkeypatch):
    G = tcfg.tiny(device="cpu", **G_KW).init_weights(0)
    snap = tmp_path / "run" / "network-snapshot-000002"
    save_checkpoint(str(snap), flax_from_state_dict(G.state_dict()),
                    config={"model_kwargs": dict(family="tiny", **G_KW)})
    save_checkpoint(str(tmp_path / "inception"), convert_inception_v3(seeded_state_dict(0)))
    save_checkpoint(str(tmp_path / "clip"), convert_clip_vit_b32(seeded_clip_state_dict()))
    lpips = save_flax_npz(str(tmp_path / "lpips.npz"),
                          convert_lpips_alex(seeded_lpips_state_dict()))
    argv = ["--ckpt", str(snap), "--synthetic", "--batch", str(ITEMS), "--metrics",
            ",".join(METRICS), "--metric-items", str(ITEMS), "--inception-weights",
            str(tmp_path / "inception"), "--clip-weights", str(tmp_path / "clip"),
            "--lpips-weights", lpips]

    draws, real_normal = [], jax.random.normal

    def spy(*args, **kwargs):
        out = real_normal(*args, **kwargs)
        if sys._getframe(1).f_code.co_filename.endswith("panic3d_tpu/training/metric_eval.py"):
            draws.append(np.asarray(out))
        return out

    jrec = Record(monkeypatch, jme, jgm)
    trec = Record(monkeypatch, tme, tme)
    os.makedirs(tmp_path / "jax")
    with monkeypatch.context() as m:
        m.setattr(jax.random, "normal", spy)
        jcm.main(argv + ["--run-dir", str(tmp_path / "jax")])
    # fid (1 batch), fid_clip (1), kid (1), pr (1), is (1): a z each; ppl: z0, z1
    assert [d.shape for d in draws] == [(ITEMS, G.z_dim)] * 7
    replay = Replay(normal=draws)
    os.makedirs(tmp_path / "torch")
    tcm.main(argv + ["--run-dir", str(tmp_path / "torch"), "--device", "cpu"], generator=replay)
    assert replay.left() == {"normal": 0, "uniform": 0}

    assert [n for n, _ in trec.features] == [n for n, _ in jrec.features]
    assert len(trec.features) == 9   # reals and fakes of four metrics, the fakes of is50k
    for i, ((name, got), (_, want)) in enumerate(zip(trec.features, jrec.features)):
        np.testing.assert_allclose(got, want, rtol=0, atol=FEAT_TOL * np.abs(want).max(),
                                   err_msg=f"{name}, batch {i}")
    assert len(trec.fid_stats) == len(jrec.fid_stats) == 2
    for got, want in zip(trec.fid_stats, jrec.fid_stats):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=0, atol=STATS_TOL * np.abs(w).max())
    np.testing.assert_allclose(trec.ppl[0], jrec.ppl[0], rtol=PPL_TOL)

    got, want = results(tmp_path / "torch"), results(tmp_path / "jax")
    assert got.keys() == want.keys() and len(got) == 8
    assert np.isfinite(list(got.values())).all()
    for k, w in want.items():
        if k.startswith("pr50k3_full"):
            assert got[k] == w, k
        else:
            tol = PPL_METRIC_TOL if k == "ppl2_wend" else METRIC_TOL
            np.testing.assert_allclose(got[k], w, rtol=tol, err_msg=k)

    # ten items in ten splits leave is50k at 1 (a split of one image), and
    # these fakes lie apart from the noise reals (precision 0, recall 1):
    # the same statistics on the captured outputs, where they say more
    t, j = [f for _, f in trec.features], [f for _, f in jrec.features]
    got_is, want_is = tgm.is50k(gen_probs=t[8], num_splits=2), jgm.is50k(gen_probs=j[8],
                                                                         num_splits=2)
    assert want_is["is50k_mean"] > 1.0
    for k, w in want_is.items():
        np.testing.assert_allclose(got_is[k], w, rtol=METRIC_TOL, err_msg=k)
    # the fakes of fid50k_full and of kid50k_full: the same G, other z
    assert (tgm.knn_precision_recall(t[1], t[5], nhood_size=3)
            == jgm.knn_precision_recall(j[1], j[5], nhood_size=3))


def test_trainer_metrics_at_an_in_loop_snapshot(tmp_path):
    out = trainer.main(["--name", "m", "--outdir", str(tmp_path), "--tiny", "--synthetic",
                        "--device", "cpu", "--batch", "2", "--max-steps", "4", "--tick-steps",
                        "1", "--snap", "2", "--metrics", "fid_clip", "--metric-items", "4"])
    run_dir = out["run_dir"]
    with open(os.path.join(run_dir, "metric-fid_clip.jsonl")) as f:
        lines = [json.loads(x) for x in f.read().splitlines()]
    # the in-loop snapshot of step 2 only: the final snapshot is not scored
    assert [r["snapshot_pkl"] for r in lines] == ["network-snapshot-000006"]
    assert np.isfinite(lines[0]["results"]["fid_clip"])
    assert os.listdir(os.path.join(str(tmp_path), ".metric_cache"))
    assert out["snapshot"].endswith("network-snapshot-000008")


def test_metrics_is_not_refused(tmp_path, capsys):
    args = trainer.parse_args(["--name", "x", "--metrics", "fid50k_full,fid_clip",
                               "--inception-weights", "inc", "--clip-weights", "clip"])
    trainer.refuse_unported(args)
    assert (args.inception_weights, args.clip_weights) == ("inc", "clip")
    assert trainer.main(["--name", "x", "--outdir", str(tmp_path), "--tiny", "--device", "cpu",
                         "--metrics", "fid50k_full", "--dry-run"]) is None
    assert "Gmain" in capsys.readouterr().out
