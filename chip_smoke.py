#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (panic3d_tpu_torch) on one GPU.

    python3 chip_smoke.py [--profile DIR]

1. Prints the setup (torch, CUDA, card name and power limit); exits non-zero
   without a CUDA device.
2. Builds the four CUDA kernels from panic3d_tpu_torch/csrc/ into
   build/kernels/ and prints the build time and nvcc's resource report.
3. Checks each kernel against its plain PyTorch version on the card, at the
   flagship slice's shapes and working dtypes, and times both (median of
   CUDA-event timings).
4. Checks the whole forward of the tiny config on the card (kernels) against
   the same forward on the CPU (plain versions), in f32.
5. Runs the flagship eval view forward -- configs.flagship(eval_mode=True),
   seeded weights, 2 views (azimuths 0 and 330), triplane_crop=0.1,
   cull_clouds=0.5 -- for a few requests through TriPlaneGenerator.f, with
   the kernel launch counts zeroed before and read after; prints views/s and
   peak memory, and checks the bf16 default against the same weights pinned
   to f32.
6. Prints one JSON line per kernel summary, the card line, and last the
   {"ok": true, ...} line. Any failure raises before that line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 0
BATCH = 2          # views per request, as bench.py's default BENCH_BATCH
REQUESTS = 5       # timed flagship requests, after one warm-up request
AZIMUTHS = (0.0, 330.0)


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=10, warmup=2):
    """Median milliseconds of fn() over ``iters`` CUDA-event-timed runs."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def require(cond, msg):
    if not cond:
        raise AssertionError(msg)


def check(name, err, tol):
    print(f"  {name}: max_abs_err={err:.3e} tol={tol:.3e} {'ok' if err <= tol else 'FAIL'}")
    require(err <= tol, f"{name}: max abs error {err} > {tol}")


def flagship_inputs(G, device):
    """bench.py's inputs (__graft_entry__._flagship_inputs, numpy-seeded)."""
    import torch

    rng = np.random.RandomState(SEED)
    img = rng.rand(BATCH, 3, 512, 512).astype(np.float32)
    chonk = rng.randn(BATCH, 512, 8, 8).astype(np.float32)
    z = rng.randn(BATCH, G.z_dim).astype(np.float32)
    return {
        "z": torch.from_numpy(z).to(device),
        "elevations": torch.zeros(BATCH, device=device),
        "azimuths": torch.tensor(AZIMUTHS, device=device),
        "cond": {"image_ortho_front": torch.from_numpy(img).to(device),
                 "resnet_chonk": torch.from_numpy(chonk).to(device)},
        "triplane_crop": 0.1,
        "cull_clouds": 0.5,
    }


def kernel_checks(G, device):
    """Each kernel vs its plain version on the card at the slice's shapes.
    -> {name: (max_abs_err, ms, plain_ms)}."""
    import torch

    from panic3d_tpu_torch.cameras import camera_label, sample_rays
    from panic3d_tpu_torch.models.volumetric import renderer as vr
    from panic3d_tpu_torch.ops.upfirdn2d import setup_filter, upfirdn2d_kernel, upfirdn2d_plain

    out = {}
    rk = G.rk
    gen = torch.Generator(device=device).manual_seed(SEED)
    S, K, res = rk["depth_resolution"], rk["depth_resolution_importance"], 64
    planes = (torch.randn((BATCH, 3, 32, 256, 256), generator=gen, device=device) * 0.5)
    planes_cl = planes.to(torch.bfloat16).permute(0, 1, 3, 4, 2).contiguous()
    dec = G.decoder.weights(G.force_sigmoid)
    axes = vr.generate_plane_axes(True)
    filt = vr.DensityFilters(0.1, 0.5, None)
    cam = camera_label(torch.zeros(BATCH, device=device),
                       torch.tensor(AZIMUTHS, device=device),
                       torch.ones(BATCH, device=device), 30 * torch.ones(BATCH, device=device))
    ro, rd = sample_rays(cam[:, :16].reshape(-1, 4, 4), cam[:, 16:].reshape(-1, 3, 3), res)
    ro, rd = ro.contiguous(), rd.contiguous()
    R = res * res

    def coords_of(depths):
        n = depths.shape[2]
        return (ro[:, :, None] + depths * rd[:, :, None]).reshape(BATCH, R * n, 3).contiguous()

    # K1 at the coarse pass: planes bf16 [2,3,256,256,32], coords [2, 4096*96, 3]
    d_c = vr.sample_stratified(ro, rk["ray_start"], rk["ray_end"], S).contiguous()
    x_c = coords_of(d_c)
    print(f"K1 triplane_decode: planes {tuple(planes_cl.shape)} bf16, coords {tuple(x_c.shape)}")
    rgb_k, sig_k = vr.triplane_decode_kernel(planes_cl, x_c, dec, rk["box_warp"], axes, filt)
    rgb_p, sig_p = vr.triplane_decode_plain(planes_cl, x_c, dec, rk["box_warp"], axes, filt)
    torch.cuda.synchronize()
    # the cull threshold is a discontinuity: a sample whose alpha sits within
    # f32 rounding of it may be culled on one side only; count those apart
    culled_k, culled_p = sig_k == -1e3, sig_p == -1e3
    flips = int((culled_k != culled_p).sum())
    agree = culled_k == culled_p
    max_flips = sig_k.numel() // 100000
    print(f"  cull decisions that differ: {flips} of {sig_k.numel()} (tol {max_flips})")
    require(flips <= max_flips, f"K1: {flips} cull decisions differ")
    e_rgb = max_err(rgb_k, rgb_p)
    e_sig = float((sig_k - sig_p).abs()[agree].max())
    check("rgb (bf16; 1 bf16 ulp below 1.0 = 2^-8)", e_rgb, 2.0 ** -8)
    check("sigma (f32, MLP summation order)", e_sig, 1e-4)
    out["triplane_decode"] = (
        max(e_rgb, e_sig),
        cuda_ms(lambda: vr.triplane_decode_kernel(planes_cl, x_c, dec, rk["box_warp"], axes, filt)),
        cuda_ms(lambda: vr.triplane_decode_plain(planes_cl, x_c, dec, rk["box_warp"], axes, filt)),
    )

    # K3 on the coarse pass's real sigmas: [2,4096,96,1] -> 96 fine depths
    s_c = sig_k.reshape(BATCH, R, S, 1)
    print(f"K3 importance_sample: depths/sigmas {tuple(d_c.shape)} -> {K}")
    d_fk = vr.importance_sample_kernel(d_c, s_c, K)
    d_fp = vr.importance_sample_plain(d_c, s_c, K)
    e = max_err(d_fk, d_fp)
    check("fine depths (f32; cdf summation order at the bracket edges)", e, 1e-4)
    out["importance_sample"] = (
        e, cuda_ms(lambda: vr.importance_sample_kernel(d_c, s_c, K)),
        cuda_ms(lambda: vr.importance_sample_plain(d_c, s_c, K)))

    # K2 on the real coarse + fine samples (bf16 colors)
    x_f = coords_of(d_fk)
    rgb_f, sig_f = vr.triplane_decode_kernel(planes_cl, x_f, dec, rk["box_warp"], axes, filt)
    args = (d_c, rgb_k.reshape(BATCH, R, S, 32), s_c, x_c.reshape(BATCH, R, S, 3),
            d_fk, rgb_f.reshape(BATCH, R, K, 32), sig_f.reshape(BATCH, R, K, 1),
            x_f.reshape(BATCH, R, K, 3), rk["white_back"])
    print(f"K2 ray_composite: {S}+{K} samples x {R} rays x {BATCH}, colors bf16")
    ck = vr.ray_composite_kernel(*args)
    cp = vr.ray_composite_plain(*args)
    errs = [max_err(a, b) for a, b in zip(ck, cp)]
    for label, e in zip(("rgb", "depth", "weight total", "xyz"), errs):
        check(f"{label} (f32, summation order)", e, 1e-4)
    out["ray_composite"] = (max(errs), cuda_ms(lambda: vr.ray_composite_kernel(*args)),
                            cuda_ms(lambda: vr.ray_composite_plain(*args)))

    # K4 at its largest call (SR block1 conv0: bf16 [2,256,256,256], up=2)
    # and at the backbone's f32 skip-image upsample
    f = setup_filter([1, 3, 3, 1]).flip([0, 1]) * 4
    x = torch.randn((BATCH, 256, 256, 256), generator=gen, device=device).to(torch.bfloat16)
    spec = (f, (2, 2), (1, 1), (3, 2, 3, 2))
    print(f"K4 upfirdn2d: {tuple(x.shape)} bf16 up=2 pad (3,2,3,2) -> 514^2")
    yk, yp = upfirdn2d_kernel(x, *spec), upfirdn2d_plain(x, *spec)
    e = max_err(yk, yp)
    check("bf16 out (1 bf16 ulp of the largest value)", e, 2.0 ** -7 * float(yp.abs().max()))
    x32 = torch.randn((BATCH, 96, 128, 128), generator=gen, device=device)
    e32 = max_err(upfirdn2d_kernel(x32, f, (2, 2), (1, 1), (2, 1, 2, 1)),
                  upfirdn2d_plain(x32, f, (2, 2), (1, 1), (2, 1, 2, 1)))
    check("f32 skip-image upsample [2,96,128,128] (summation order)", e32, 1e-5)
    out["upfirdn2d"] = (e, cuda_ms(lambda: upfirdn2d_kernel(x, *spec)),
                        cuda_ms(lambda: upfirdn2d_plain(x, *spec)))
    return out


def tiny_end_to_end(device):
    """Tiny config in f32: the card (kernels) against the CPU (plain)."""
    import torch

    from panic3d_tpu_torch import configs

    rk = dict(superresolution_module="training.superresolution.SuperresolutionHybrid2X",
              depth_resolution=8, depth_resolution_importance=8, box_warp=0.7,
              ray_start=0.5, ray_end=1.5, white_back=True, use_triplane=True,
              render_dtype="float32")
    G = configs.tiny(synthesis_kwargs=dict(channel_base=2048, channel_max=64, num_fp16_res=0),
                     rendering_kwargs=rk).init_weights(SEED).eval()
    with torch.no_grad():
        G.decoder.net[2].bias[0] += 2.5
    rng = np.random.RandomState(SEED)
    x = {"z": torch.from_numpy(rng.randn(BATCH, G.z_dim).astype(np.float32)),
         "elevations": torch.tensor([0.0, 20.0]), "azimuths": torch.tensor(AZIMUTHS),
         "cond": {"image_ortho_front": torch.from_numpy(rng.rand(BATCH, 3, 64, 64)).float(),
                  "resnet_chonk": torch.from_numpy(rng.randn(BATCH, 16, 8, 8)).float()},
         "triplane_crop": 0.1, "cull_clouds": 0.5}
    with torch.no_grad():
        ref = G.f(x)
        G.to(device)
        xd = dict(x, z=x["z"].to(device), cond={k: v.to(device) for k, v in x["cond"].items()})
        got = G.f(xd)
    print("tiny config, f32: card (kernels) vs CPU (plain), tol 2e-3 (importance "
          "resampling amplifies f32 rounding)")
    for k in ("triplane", "image_raw", "image_depth", "image_weights", "image_xyz", "image"):
        check(k, max_err(got[k].cpu(), ref[k]), 2e-3)


def bf16_closeness(G, x, out, device):
    """The flagship's default precision (bf16 planes, bf16 backbone blocks
    >= 32^2 and SR) against the same weights pinned to f32, on the card,
    within the JAX package's mixed-precision bounds
    (tests/test_reference_parity.py::test_bf16_close)."""
    import torch

    from panic3d_tpu_torch import configs

    G32 = configs.flagship(
        eval_mode=True, sr_num_fp16_res=0, rendering_kwargs=dict(render_dtype="float32"),
        synthesis_kwargs=dict(channel_base=32768, channel_max=512, num_fp16_res=0)).eval()
    G32.load_state_dict(G.state_dict())
    ref = G32.to(device).f(x)
    print("flagship default (bf16) vs f32-pinned, same weights, on the card:")
    for k, tol in (("image_raw", 0.05), ("image", 0.08), ("image_depth", 0.05)):
        check(k, max_err(out[k], ref[k]), tol)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="DIR", help="also profile one request into DIR")
    args = ap.parse_args(argv)

    import torch

    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port has no CPU fallback here", file=sys.stderr)
        return 2
    card = card_line()
    print(f"card: {card}  ({torch.cuda.get_device_name(0)})")
    device = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from panic3d_tpu_torch import configs
    from panic3d_tpu_torch.kernels import KERNELS, build, launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    per = build.build_all()
    print(f"built {len(per)} kernels in {time.perf_counter() - t0:.1f} s "
          + " ".join(f"{k}={v:.1f}s" for k, v in per.items()))
    for log in sorted(build.BUILD_DIR.glob("*.log")):
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {log.stem.rsplit('-', 1)[0]}: {line.strip()}")

    G = configs.flagship(eval_mode=True).init_weights(SEED).eval()
    with torch.no_grad():
        G.decoder.net[2].bias[0] += 2.5   # so that something renders (as test_flagship_parity)
    G.to(device)

    with torch.no_grad():
        checks = kernel_checks(G, device)
        tiny_end_to_end(device)

        x = flagship_inputs(G, device)
        G.f(x)                                        # warm-up request
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        times = []
        for _ in range(REQUESTS):
            t = time.perf_counter()
            out = G.f(x)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated()

        img = out["image"]
        require(tuple(img.shape) == (BATCH, 3, 512, 512), f"image shape {tuple(img.shape)}")
        for k in ("image", "image_raw", "image_depth", "image_weights", "image_xyz", "triplane"):
            require(bool(torch.isfinite(out[k]).all()), f"non-finite {k}")
        require(float(out["image_weights"].abs().max()) > 0, "image_weights all zero")
        missing = [k for k, n in counts.items() if n == 0]
        require(not missing, f"kernels not launched on the main path: {missing}")
        med = statistics.median(times)
        print(f"flagship eval forward (ess off, 96+96, bs={BATCH}): {REQUESTS} requests, "
              f"median {med * 1e3:.3f} ms/request = {BATCH / med:.3f} views/s; "
              f"peak memory {peak / 2**30:.3f} GiB; launches per request "
              + ", ".join(f"{k}={n // REQUESTS}" for k, n in counts.items())
              + f"  [{card}]")
        print("  request ms: " + ", ".join(f"{t * 1e3:.3f}" for t in times))
        print(f"  image range [{float(img.min()):.4f}, {float(img.max()):.4f}], "
              f"mean weight {float(out['image_weights'].mean()):.4f}")
        bf16_closeness(G, x, out, device)

        if args.profile:
            from pathlib import Path

            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                G.f(x)
                torch.cuda.synchronize()
            table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
            Path(args.profile).mkdir(parents=True, exist_ok=True)
            (Path(args.profile) / "flagship_profile.txt").write_text(table)
            prof.export_chrome_trace(str(Path(args.profile) / "flagship_trace.json"))
            print("\n".join(table.splitlines()[:30]))

    summary = {"kernels": [
        {"name": name, "route": "cuda", "source": k.source, "replaces": k.replaces,
         "launches": counts[name], "max_abs_err": checks[name][0],
         "ms": checks[name][1], "plain_ms": checks[name][2]}
        for name, k in KERNELS.items()]}
    print(json.dumps(summary))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
