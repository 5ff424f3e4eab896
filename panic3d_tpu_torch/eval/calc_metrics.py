"""Standalone metric CLI (panic3d_tpu/eval/calc_metrics.py).

Role of ``src/calc_metrics.py``: compute registered quality metrics of a
trained snapshot outside the training loop and append each result to
``metric-<name>.jsonl`` in the run directory. The generator, the feature
nets and LPIPS run on one device (the card unless ``--device cpu``); the
metric math is eval/gan_metrics.py's, on the host. The nets are seeded
unless converted weights are given: values are paper-comparable only with
the converted detector (``--inception-weights``, a checkpoint directory of
convert_inception_v3's output, written by runtime/checkpoint.py:
save_checkpoint).

Run:
  python -m panic3d_tpu_torch.eval.calc_metrics --ckpt <snapshot-dir> \\
      --metrics fid50k_full,fid_clip,kid50k_full,pr50k3_full,is50k,ppl2_wend \\
      [--synthetic | --data DIR] [--metric-items N] [--device cpu]

Each metric draws its fakes' z from a torch.Generator seeded with --seed
afresh, as the JAX CLI starts each metric from the same key.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True, help="trainer snapshot dir")
    ap.add_argument("--metrics", default="fid50k_full",
                    help="comma list (see eval.gan_metrics.list_valid_metrics, and fid_clip)")
    ap.add_argument("--metric-items", type=int, default=50000)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--data", default=".", help="_data root (ecrutileE)")
    ap.add_argument("--data-subset", default="train")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--run-dir", default=None,
                    help="where metric-*.jsonl lands (default: the ckpt's parent)")
    ap.add_argument("--inception-weights", default=None,
                    help="checkpoint dir of converted InceptionV3 variables")
    ap.add_argument("--clip-weights", default=None,
                    help="checkpoint dir of converted CLIP variables")
    ap.add_argument("--lpips-weights", default=None, help="converted LPIPS .npz")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="the device to run on: CUDA unless 'cpu' is given")
    return ap.parse_args(argv)


def main(argv=None, generator=None):
    """Compute the requested metrics. ``generator``, when given, is the one
    source of every z (a utils/draws.py:Replay of draws made elsewhere, in
    the order the metrics ask for them); by default each metric takes a
    torch.Generator seeded with --seed."""
    args = parse_args(argv)
    import torch

    from .. import configs
    from ..runtime.checkpoint import (extract_generator_variables, load_checkpoint,
                                      state_dict_from_flax)
    from ..training.metric_eval import (compute_ppl, evaluate_fid, f32_math, generate_fakes,
                                        make_clip_feature_fn, make_inception_feature_fn)
    from .gan_metrics import FeatureStats, calc_metric, is_valid_metric, report_metric

    requested = [m for m in args.metrics.split(",") if m and m != "none"]
    for name in requested:
        if name != "fid_clip" and not is_valid_metric(name):
            raise SystemExit(f"unknown metric {name}")

    state, config = load_checkpoint(args.ckpt)
    g = configs.from_snapshot_config(config, eval_mode=False, device=args.device)
    g.load_state_dict(state_dict_from_flax(extract_generator_variables(state)), strict=True)
    g.eval()
    dev = g.device

    cfg = dict(config or {})
    size = g.img_resolution
    tiny = cfg.get("tiny") or (cfg.get("model_kwargs") or {}).get("family") == "tiny"
    chonk_ch, feat_dim = (16, 32) if tiny else (512, 512)
    if args.synthetic:
        from ..data.dataset import synthetic_batch

        def make_batch_iter():
            i = 0
            while True:
                yield synthetic_batch(bs=args.batch, size=size, chonk_ch=chonk_ch,
                                      feat_dim=feat_dim, seed=i + args.seed)
                i += 1
    else:
        from ..data.dataset import EcrutileEDataset, InfiniteBatcher

        ds = EcrutileEDataset(args.data, subset=args.data_subset, size=size)

        def to_eval(b):
            return {"image": b["image"].astype(np.float32) / 127.5 - 1,
                    "camera": b["camera"], "cond": b["condition"]}

        def make_batch_iter():
            return map(to_eval, iter(InfiniteBatcher(ds, args.batch, seed=args.seed)))

    run_dir = args.run_dir or os.path.dirname(os.path.abspath(args.ckpt))
    snapshot_name = os.path.basename(os.path.normpath(args.ckpt))

    def z_generator():
        if generator is not None:
            return generator
        return torch.Generator(device=dev).manual_seed(args.seed)

    def weights(path):
        return load_checkpoint(path)[0] if path else None

    def inception(probs=False):
        return make_inception_feature_fn(weights(args.inception_weights), probs=probs,
                                         device=dev)

    for name in requested:
        if name in ("fid50k_full", "fid_clip"):
            fn = (inception() if name == "fid50k_full"
                  else make_clip_feature_fn(weights(args.clip_weights), device=dev))
            evaluate_fid(g, make_batch_iter, fn, n_items=args.metric_items, run_dir=run_dir,
                         snapshot_name=snapshot_name, metric_name=name,
                         generator=z_generator())
        elif name in ("kid50k_full", "pr50k3_full"):
            fn = inception()
            real, gen = FeatureStats(capture_all=True), FeatureStats(capture_all=True)
            it, n = make_batch_iter(), 0
            while n < args.metric_items:
                real.append(fn(next(it)["cond"]["image"]))   # [0,1] already
                n += args.batch
            for fakes in generate_fakes(g, make_batch_iter(), args.metric_items,
                                        z_generator()):
                gen.append(fn(fakes))
                if gen.is_full or gen.num_items >= args.metric_items:
                    break
            r = calc_metric(name, gen_features=gen.get_all(), real_features=real.get_all())
            report_metric(r, run_dir=run_dir, snapshot_pkl=snapshot_name)
        elif name == "is50k":
            fn = inception(probs=True)
            probs, count = [], 0
            for fakes in generate_fakes(g, make_batch_iter(), args.metric_items,
                                        z_generator()):
                probs.append(fn(fakes))
                count += len(probs[-1])
                if count >= args.metric_items:
                    break
            r = calc_metric(name, gen_probs=np.concatenate(probs))
            report_metric(r, run_dir=run_dir, snapshot_pkl=snapshot_name)
        elif name == "ppl2_wend":
            from ..training.setup import init_lpips
            from .lpips import LPIPS, load_lpips_params

            lpips = (LPIPS(device=dev).load_variables(load_lpips_params(args.lpips_weights))
                     if args.lpips_weights else init_lpips(device=dev))

            def lpips_fn(a, b):
                with f32_math():
                    return lpips(a, b)

            d = compute_ppl(g, make_batch_iter, lpips_fn, num_samples=args.metric_items,
                            batch_size=args.batch, generator=z_generator())
            r = calc_metric(name, ppl_distances=d)
            report_metric(r, run_dir=run_dir, snapshot_pkl=snapshot_name)
        else:
            raise SystemExit(f"metric {name} needs inputs this CLI does not build "
                             "(see eval.gan_metrics' registry)")
    print(f"done: {requested} -> {run_dir}")


if __name__ == "__main__":
    main()
