"""Training CLI: flagship GAN training with snapshots, stats and
auto-resume, in one process on one device (panic3d_tpu/training/trainer.py).

Role of `_train/eg3dc/trainers/train_eclustrousC.py` (the click CLI, phase
construction, auto-resume from the newest usable snapshot) and the host
side of `training_loop_v0.py` (tick loop, stats jsonl, snapshot writing).
Snapshots are the JAX package's layout (runtime/checkpoint.py:
train_state_tree / load_train_state), so a run resumes from either
package's snapshot.

Run on the card: python -m panic3d_tpu_torch.training.trainer --name myrun
--data . --batch 8 --gamma 4 [--synthetic]; on the CPU add --device cpu
(with --tiny for a model that trains there in seconds a step).

--aug ada augments the discriminator's inputs with ADA's 'bgc' pipe
(training/augment.py) at a p that the heuristic moves every --ada-interval
steps from the real logits' signs (one read of them from the card each
time); --aug fixed holds p at --aug-p.

Options whose path is not ported yet raise NotImplementedError naming the
ROADMAP item that will port them: --fuse-recon sum|seq, --remat, --metrics
other than none, --mesh-rays > 1 and several processes,
--paste-params-mode A|Agrad, --pl-weight > 0, --triplane-depth 2 and
--tensorboard.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--name", required=True)
    ap.add_argument("--outdir", default="./_runs")
    ap.add_argument("--data", default=".")
    ap.add_argument("--data-subset", default="rutileEA")
    ap.add_argument("--cond-mode", default="ortho_front.add_shuffle2_4.reschonk_add_512")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--gamma", type=float, default=4.0, help="R1 weight")
    ap.add_argument("--glr", type=float, default=0.0025)
    ap.add_argument("--dlr", type=float, default=0.002)
    ap.add_argument("--kimg", type=int, default=25000)
    ap.add_argument("--tick", type=int, default=4, help="kimg per tick")
    ap.add_argument("--snap", type=int, default=50, help="ticks per snapshot")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mirror", action="store_true")
    # loss lambdas (train_eclustrousC.py:152-181 defaults)
    for view in ("", "-sides", "-back", "-rand"):
        for term, default in (("lpips", 10.0), ("l1", 1.0), ("alpha-l2", 0.0),
                              ("depth-l2", 0.0)):
            ap.add_argument(f"--lambda-gcond{view}-{term}", type=float,
                            default=default if view == "" else 0.0)
    ap.add_argument("--lossmask-mode-adv", default="none")
    ap.add_argument("--lossmask-mode-recon", default="none")
    for term in ("lpips", "l1", "alpha-l2", "depth-l2"):
        ap.add_argument(f"--lambda-recon-{term}", type=float, default=0.0)
    ap.add_argument("--paste-params-mode", default="none")
    ap.add_argument("--density-reg", type=float, default=0.25)
    ap.add_argument("--reg-type", default="l1")
    ap.add_argument("--fuse-recon", nargs="?", const="sum", default="auto",
                    choices=["auto", "off", "sum", "seq"])
    ap.add_argument("--pl-weight", type=float, default=0.0)
    ap.add_argument("--pl-batch-shrink", type=int, default=2)
    ap.add_argument("--pl-decay", type=float, default=0.01)
    ap.add_argument("--blur-init-sigma", type=float, default=0.0)
    ap.add_argument("--blur-fade-kimg", type=float, default=200.0)
    ap.add_argument("--gen-pose-cond", action="store_true")
    ap.add_argument("--gpc-reg-prob", type=float, default=0.5)
    ap.add_argument("--style-mixing-prob", type=float, default=0.0)
    ap.add_argument("--aug", choices=("noaug", "ada", "fixed"), default="noaug")
    ap.add_argument("--ada-target", type=float, default=0.6)
    ap.add_argument("--ada-interval", type=int, default=4)
    ap.add_argument("--ada-kimg", type=float, default=500.0)
    ap.add_argument("--aug-p", type=float, default=0.0, help="fixed-mode p")
    ap.add_argument("--batch-gpu", type=int, default=None,
                    help="micro-batch of the gradient accumulation")
    ap.add_argument("--mesh-rays", type=int, default=1)
    ap.add_argument("--accum-sum", action="store_true",
                    help="reference grad-accumulation semantics: sum micro-batch grads")
    ap.add_argument("--tensorboard", action="store_true")
    ap.add_argument("--remat", default=None, choices=["full", "dots"])
    ap.add_argument("--metrics", default="none")
    ap.add_argument("--metric-items", type=int, default=50000)
    ap.add_argument("--resume-blur", action="store_true",
                    help="keep blur/gpc rampups active after resume")
    ap.add_argument("--allow-random-lpips", action="store_true",
                    help="permit training with a random-init LPIPS net")
    ap.add_argument("--triplane-depth", type=int, default=1)
    ap.add_argument("--triplane-width", type=int, default=32)
    ap.add_argument("--backbone-resolution", type=int, default=256)
    ap.add_argument("--resolution", type=int, default=512)
    ap.add_argument("--cbase-g", type=int, default=32768)
    ap.add_argument("--cmax-g", type=int, default=512)
    ap.add_argument("--cbase-d", type=int, default=32768)
    ap.add_argument("--cmax-d", type=int, default=512)
    ap.add_argument("--map-depth", type=int, default=2)
    ap.add_argument("--mbstd-group", type=int, default=4)
    ap.add_argument("--sr-module", default=None)
    ap.add_argument("--sr-channels-hidden", type=int, default=256)
    ap.add_argument("--sr-noise-mode", default=None, choices=("random", "none"))
    ap.add_argument("--decoder-lr-mul", type=float, default=1.0)
    ap.add_argument("--use-triplane", type=int, default=1)
    ap.add_argument("--tanh-rgb-output", action="store_true")
    ap.add_argument("--c-scale", type=float, default=1.0)
    ap.add_argument("--c-noise", type=float, default=0.0,
                    help="D pose-conditioning noise (disc_c_noise)")
    ap.add_argument("--freezed", type=int, default=0,
                    help="Freeze-D: the first N discriminator layers take no updates")
    ap.add_argument("--g-num-fp16-res", type=int, default=4)
    ap.add_argument("--d-num-fp16-res", type=int, default=4)
    ap.add_argument("--sr-num-fp16-res", type=int, default=4)
    ap.add_argument("--fp32", action="store_true",
                    help="force fp32 everywhere (num_fp16_res=0 for G/D/SR)")
    ap.add_argument("--gpc-reg-fade-kimg", type=float, default=1000.0)
    ap.add_argument("--density-reg-p-dist", type=float, default=0.004)
    ap.add_argument("--density-reg-every", type=int, default=4,
                    help="Greg lazy-reg interval (g_reg_interval)")
    ap.add_argument("--neural-res-initial", type=int, default=64)
    ap.add_argument("--neural-res-final", type=int, default=None)
    ap.add_argument("--neural-res-fade-kimg", type=float, default=0.0)
    ap.add_argument("--neural-res-quantize", type=int, default=8)
    ap.add_argument("--desc", default=None, help="run-dir suffix: <name>-<desc>")
    ap.add_argument("--resume-discrim", default=None,
                    help="snapshot dir whose discriminator replaces the fresh D")
    ap.add_argument("--resume", default=None)
    ap.add_argument("--lpips-weights", default=None)
    ap.add_argument("--synthetic", action="store_true", help="train on synthetic data")
    ap.add_argument("--tiny", action="store_true", help="tiny model (smoke test)")
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--tick-steps", type=int, default=None,
                    help="override the tick interval in steps")
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--device", default=None,
                    help="the device to train on: CUDA unless 'cpu' is given")
    args = ap.parse_args(argv)
    if args.fp32:
        args.g_num_fp16_res = args.d_num_fp16_res = args.sr_num_fp16_res = 0
    return args


def refuse_unported(args) -> None:
    """Options whose path is not ported raise, naming the ROADMAP item."""
    q5 = "ROADMAP Queue 1 item 5"
    refusals = [
        (args.fuse_recon in ("sum", "seq"), f"--fuse-recon {args.fuse_recon}, {q5}"),
        (args.remat is not None, f"--remat, {q5}"),
        (args.metrics != "none", "--metrics (the GAN metrics, ROADMAP Queue 1 item 4)"),
        (args.mesh_rays > 1 or int(os.environ.get("WORLD_SIZE", "1")) > 1,
         f"--mesh-rays > 1 and several processes (torch.distributed), {q5}"),
        (args.paste_params_mode in ("A", "Agrad"),
         f"--paste-params-mode {args.paste_params_mode} (K8's backward), {q5}"),
        (args.pl_weight > 0, f"--pl-weight > 0 (Gpl), {q5}"),
        (args.triplane_depth > 1, f"--triplane-depth {args.triplane_depth} (K10's backward), "
                                  f"{q5}"),
        (args.tensorboard, f"--tensorboard, {q5}"),
    ]
    for refused, what in refusals:
        if refused:
            raise NotImplementedError(f"not ported to the H100 yet: {what}")


def d_frozen_paths(img_resolution: int, freezed: int, architecture="resnet"):
    """(block, layer) pairs for the first `freezed` D layers
    (networks_stylegan2.py:788-810): blocks from the highest resolution
    down; per block fromrgb (first block / skip only), conv0, conv1, then
    the resnet skip."""
    if freezed <= 0:
        return ()
    out, idx = [], 0
    res_log2 = int(np.log2(img_resolution))
    for i, res in enumerate(2 ** j for j in range(res_log2, 2, -1)):
        layers = ["fromrgb"] if (i == 0 or architecture == "skip") else []
        layers += ["conv0", "conv1"]
        if architecture == "resnet":
            layers.append("skip")
        for name in layers:
            if idx < freezed:
                out.append((f"b{res}", name))
            idx += 1
    return tuple(out)


def build_models(args, device=None):
    """G / D from the CLI flags (train_eclustrousC.py:189-203), on
    ``device`` (CUDA by default) -> (G, D, chonk_ch, feat_dim, model_kwargs)."""
    from .. import configs
    from ..models.dual_discriminator import DualDiscriminator

    dev = configs.resolve_device(device)
    if args.tiny:
        model_kwargs = dict(family="tiny", cond_mode="ortho_front.add_4.reschonk_add_16")
        g = configs.tiny(device=dev, cond_mode=model_kwargs["cond_mode"])
        d = DualDiscriminator(c_dim=25, img_resolution=g.img_resolution, channel_base=1024,
                              channel_max=32, epilogue_kwargs=dict(mbstd_group_size=2))
        chonk_ch, feat_dim = 16, 32
    else:
        rk = dict(triplane_depth=args.triplane_depth, c_scale=args.c_scale,
                  decoder_lr_mul=args.decoder_lr_mul, use_triplane=bool(args.use_triplane),
                  tanh_rgb_output=args.tanh_rgb_output,
                  density_reg_p_dist=args.density_reg_p_dist)
        if args.sr_module:
            rk["superresolution_module"] = args.sr_module
        if args.sr_noise_mode:
            rk["superresolution_noise_mode"] = args.sr_noise_mode
        model_kwargs = dict(
            family="flagship", cond_mode=args.cond_mode, triplane_width=args.triplane_width,
            backbone_resolution=args.backbone_resolution, img_resolution=args.resolution,
            sr_channels_hidden=args.sr_channels_hidden, sr_num_fp16_res=args.sr_num_fp16_res,
            mapping_kwargs=dict(num_layers=args.map_depth),
            synthesis_kwargs=dict(channel_base=args.cbase_g, channel_max=args.cmax_g,
                                  num_fp16_res=args.g_num_fp16_res,
                                  conv_clamp=256 if args.g_num_fp16_res > 0 else None),
            neural_rendering_resolution=args.neural_res_initial, rendering_kwargs=rk)
        g = configs.flagship(device=dev, **{k: v for k, v in model_kwargs.items()
                                            if k != "family"})
        d = DualDiscriminator(
            c_dim=25, img_resolution=args.resolution, channel_base=args.cbase_d,
            channel_max=args.cmax_d, num_fp16_res=args.d_num_fp16_res,
            conv_clamp=256 if args.d_num_fp16_res > 0 else None, disc_c_noise=args.c_noise,
            epilogue_kwargs=dict(mbstd_group_size=args.mbstd_group))
        chonk_ch, feat_dim = 512, 512
    return g, d.to(dev), chonk_ch, feat_dim, model_kwargs


def _snapshot_usable(path: str) -> bool:
    st = os.path.join(path, "state.msgpack")
    return os.path.isfile(st) and os.path.getsize(st) > 0


def find_resume(run_dir: str):
    """Auto-resume: the newest usable snapshot (train_eclustrousC.py:301-337:
    newest first, skipping snapshots whose state file is missing or empty)."""
    if not os.path.isdir(run_dir):
        return None
    snaps = sorted(d for d in os.listdir(run_dir) if d.startswith("network-snapshot-"))
    for d in reversed(snaps):
        p = os.path.join(run_dir, d)
        if _snapshot_usable(p):
            return p
    return None


def loss_config(args, box_warp: float, resume: bool):
    """The LossConfig of the CLI flags; resuming disables the blur and gpc
    rampups (train_eclustrousC.py:536-542) unless --resume-blur."""
    from .loss import LossConfig

    fade = resume and not args.resume_blur
    kw = {f: getattr(args, f) for f in (
        "lossmask_mode_adv", "lossmask_mode_recon", "density_reg", "density_reg_p_dist",
        "pl_weight", "pl_batch_shrink", "pl_decay", "reg_type", "style_mixing_prob",
        "blur_fade_kimg")}
    kw.update({f.name: getattr(args, f.name) for f in dataclasses.fields(LossConfig)
               if f.name.startswith("lambda_")})
    return LossConfig(
        r1_gamma=args.gamma, blur_init_sigma=0.0 if fade else args.blur_init_sigma,
        gpc_reg_prob=args.gpc_reg_prob if args.gen_pose_cond else None,
        gpc_reg_fade_kimg=0.0 if fade else args.gpc_reg_fade_kimg,
        paste_params_mode=None if args.paste_params_mode == "none" else args.paste_params_mode,
        box_warp=box_warp, neural_rendering_resolution_initial=args.neural_res_initial, **kw)


def phase_list(args, loss_cfg) -> list:
    """Which phases exist (training_loop_v0.py:221-266 lambda gating);
    --fuse-recon 'auto' is the separate phases."""
    from .loss import active_recon_views

    c = loss_cfg
    views = active_recon_views(c)
    phases = ["Gmain"]
    if "front" in views:
        phases.append("Gcond")
    if "left" in views:
        phases += ["Gside-left", "Gside-right"]
    if "back" in views:
        phases.append("Gside-back")
    if (c.lambda_gcond_rand_lpips + c.lambda_gcond_rand_l1 + c.lambda_gcond_rand_alpha_l2
            + c.lambda_gcond_rand_depth_l2) > 0:
        phases.append("Grand")
    if args.density_reg > 0:
        phases.append("Greg")
    phases.append("Dmain")
    if args.gamma > 0:
        phases.append("Dreg")
    return phases


def _to_device(tree, dev):
    """A numpy batch as f32 tensors on ``dev``; to the card through pinned
    memory (an asynchronous copy)."""
    import torch

    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    t = torch.as_tensor(np.ascontiguousarray(tree), dtype=torch.float32)
    if torch.device(dev).type == "cuda":
        t = t.pin_memory()
    return t.to(dev, non_blocking=True)


def _snapshot_images(G, batch, path):
    """A G_ema sample grid at snapshot time (training_loop_v0.py:435-443),
    from the first batch's cameras and conditions, const noise."""
    import torch

    from ..utils.imglib import write_png

    with torch.no_grad():
        bs = batch["image"].shape[0]
        out = G.f({"z": torch.zeros((bs, G.z_dim), device=G.device),
                   "camera_params": batch["camera"], "cond": batch["cond"],
                   "normalize_images": True}, noise_mode="const")
    img = (out["image"].float().clamp(-1, 1) * 0.5 + 0.5).cpu().numpy()
    write_png(path, np.concatenate(list(img), axis=2))


def main(argv=None, on_step=None):
    """Train; -> a summary dict (the final state, the run directory, the
    final snapshot, the steps taken, the last step's stats, and the loss,
    train config, generator and first batch the steps used).
    ``on_step(step, phases, stats)``, when given, is called after each step
    (chip_smoke.py times the steps and checks every phase's losses)."""
    args = parse_args(argv)
    refuse_unported(args)

    import torch

    from ..data.dataset import EcrutileEDataset, InfiniteBatcher, synthetic_batch
    from ..data.prefetch import Prefetcher
    from ..eval.lpips import LPIPS, load_lpips_params
    from ..runtime.checkpoint import (load_checkpoint, load_train_state, save_checkpoint,
                                      state_dict_from_flax, train_state_tree)
    from ..utils.misc import count_params, state_hash
    from .loop import TrainConfig, ada_update, build_train_step, init_state, phases_for_step
    from .setup import init_lpips, make_loss
    from .stats import Collector, JsonlLogger

    run_name = args.name + (f"-{args.desc}" if args.desc else "")
    run_dir = os.path.join(args.outdir, run_name)
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "training_options.json"), "w") as f:
        json.dump(vars(args), f, indent=1)
    resume = args.resume or find_resume(run_dir)
    # resuming makes ADA react faster (train_eclustrousC.py:536-542)
    ada_kimg = 100.0 if resume else args.ada_kimg

    G, D, chonk_ch, feat_dim, model_kwargs = build_models(args, args.device)
    dev = G.device
    snap_config = dict(vars(args), model_kwargs=model_kwargs)
    loss_cfg = loss_config(args, G.rk["box_warp"], bool(resume))
    phases = phase_list(args, loss_cfg)
    train_cfg = TrainConfig(
        batch_size=args.batch, batch_gpu=args.batch_gpu, accum_sum=args.accum_sum,
        g_lr=args.glr, d_lr=args.dlr, g_reg_interval=args.density_reg_every,
        ema_kimg=args.batch * 10 / 32,
        d_frozen=d_frozen_paths(D.img_resolution, args.freezed, D.architecture),
        phases=tuple(phases))
    if args.dry_run:
        print(json.dumps(dict(phases=phases, loss=dataclasses.asdict(loss_cfg),
                              train=dataclasses.asdict(train_cfg)), indent=1, default=str))
        return None

    size = G.img_resolution
    if args.synthetic:
        def batches():
            i = 0
            while True:
                yield synthetic_batch(bs=args.batch, size=size, chonk_ch=chonk_ch,
                                      feat_dim=feat_dim, seed=i)
                i += 1
        batch_iter = batches()
    else:
        ds = EcrutileEDataset(args.data, subset=args.data_subset, size=size, mirror=args.mirror)

        def to_train(b):
            return {"image": b["image"].astype(np.float32) / 127.5 - 1, "camera": b["camera"],
                    "xyz": b["xyz"], "alpha": b["alpha"], "cond": b["condition"]}
        batch_iter = map(to_train, iter(InfiniteBatcher(ds, args.batch, seed=args.seed)))

    G.init_weights(args.seed)
    D.init_weights(args.seed + 1)
    print(f"G {count_params(G):,} parameters, D {count_params(D):,}, on {dev}")
    state = init_state(G, D, train_cfg)
    if args.aug == "fixed":
        state.aug_p = float(np.float32(args.aug_p))
    if resume:
        print(f"resuming from {resume}")
        load_train_state(resume, state)
    if args.resume_discrim:
        print(f"resuming discriminator from {args.resume_discrim}")
        d_state, _ = load_checkpoint(args.resume_discrim)
        D.load_state_dict(state_dict_from_flax(d_state["vars_D"]), strict=True)

    uses_lpips = any(getattr(loss_cfg, f.name) > 0 for f in dataclasses.fields(loss_cfg)
                     if f.name.startswith("lambda_") and f.name.endswith("lpips"))
    if uses_lpips and not args.lpips_weights and not args.synthetic \
            and not args.allow_random_lpips:
        raise SystemExit("refusing to train against a random-init LPIPS net: pass "
                         "--lpips-weights or --allow-random-lpips")
    lpips = (LPIPS(device=dev).load_variables(load_lpips_params(args.lpips_weights))
             if args.lpips_weights else init_lpips(device=dev))

    def host_neural_res(step_i: int) -> int:
        """The ramped resolution of a step, snapped to --neural-res-quantize."""
        ramp = dataclasses.replace(
            loss_cfg, neural_rendering_resolution_final=args.neural_res_final,
            neural_rendering_resolution_fade_kimg=args.neural_res_fade_kimg)
        res = int(ramp.neural_rendering_resolution(step_i * args.batch))
        q, final = args.neural_res_quantize, args.neural_res_final
        if q > 1 and final is not None and res not in (args.neural_res_initial, final):
            lo, hi = sorted((args.neural_res_initial, final))
            res = int(np.clip(int(np.rint(res / q)) * q, lo, hi))
        return res

    steps, losses = {}, {}
    collector = Collector()
    logger = JsonlLogger(os.path.join(run_dir, "stats.jsonl"))
    total_steps = args.max_steps or (args.kimg * 1000 // args.batch)
    tick_interval = args.tick_steps or max(args.tick * 1000 // args.batch, 1)
    generator = torch.Generator(device=dev).manual_seed(args.seed)
    t_start = time.time()
    start_step = state.cur_nimg // args.batch
    first = None
    stats = {}
    # ADA: the real logits' sign rates stay on the card until a flush reads
    # them (one host wait), every --ada-interval steps and at each tick
    pending_signs, signs_hist = [], []

    def snapshot(nres):
        snap = os.path.join(run_dir, f"network-snapshot-{state.cur_nimg:06d}")
        cfg_now = dict(snap_config, model_kwargs=dict(model_kwargs,
                                                       neural_rendering_resolution=nres))
        save_checkpoint(snap, train_state_tree(state), config=cfg_now)
        return snap

    nres = host_neural_res(start_step)
    # batch assembly and the copy to the card in a worker thread
    # (data/prefetch.py), two batches ahead; closed when the loop ends
    batch_queue = Prefetcher(batch_iter, lambda b: _to_device(b, dev), depth=2)
    try:
        for step_i in range(start_step, total_steps):
            active = phases_for_step(step_i, train_cfg)
            nres = host_neural_res(step_i)
            if nres not in losses:
                losses[nres] = make_loss(G, D, lpips, dataclasses.replace(
                    loss_cfg, neural_rendering_resolution_initial=nres),
                    augment=args.aug != "noaug")
            if (active, nres) not in steps:
                steps[(active, nres)] = build_train_step(losses[nres], train_cfg, G.z_dim,
                                                         active)
            batch = next(batch_queue)
            if first is None:
                first = batch
            stats = steps[(active, nres)](state, batch, generator)
            if on_step is not None:
                on_step(step_i, active, stats)
            if args.aug == "ada":
                pending_signs.append(stats["Loss/signs/real"])
                if len(pending_signs) >= args.ada_interval or step_i % tick_interval == 0:
                    signs_hist.extend(torch.stack(pending_signs).tolist())
                    pending_signs.clear()
                # the ADA heuristic (training_loop_v0.py:398-402)
                if len(signs_hist) >= args.ada_interval:
                    ada_update(state, float(np.mean(signs_hist)), args.ada_target, args.batch,
                               args.ada_interval, ada_kimg)
                    signs_hist.clear()
                    collector.report_dict({"Progress/augment": state.aug_p})
            if step_i % tick_interval == 0 or step_i == total_steps - 1:
                collector.report_dict({k: float(v) for k, v in stats.items()})
                kimg = state.cur_nimg / 1000
                msg = " ".join(f"{k.split('/')[-1]}={collector.mean(k):.3f}"
                               for k in sorted(collector.as_dict()) if k.startswith("Loss/"))
                aug = f" augment={state.aug_p:.6g}" if args.aug != "noaug" else ""
                print(f"tick kimg={kimg:.3f} step={step_i} "
                      f"time={time.time() - t_start:.0f}s{aug} {msg}")
                logger.write(collector, kimg=kimg)
                collector.reset()
            if step_i % (tick_interval * args.snap) == 0 and step_i > 0:
                snap = snapshot(nres)
                _snapshot_images(state.G_ema, first, os.path.join(snap, "fakes.png"))
                print(f"saved {snap} (G_ema {state_hash(state.G_ema)})")
    finally:
        batch_queue.close()
    snap = snapshot(nres)
    print(f"done; final snapshot {snap} (G_ema {state_hash(state.G_ema)})")
    return {"state": state, "run_dir": run_dir, "snapshot": snap,
            "steps": total_steps - start_step, "stats": stats, "loss": losses.get(nres),
            "train_cfg": train_cfg, "generator": generator, "batch": first}


if __name__ == "__main__":
    main()
