#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (panic3d_tpu_torch) on one GPU.

    python3 chip_smoke.py [--profile DIR] [--kernels-only] [--keyed-only] [--training-only]
                          [--forms-only [--k1-grad-parts]] [--ada-only] [--metrics-only]
                          [--options-only] [--parent DIR]

1. Prints the setup (torch, CUDA, card name and power limit); exits non-zero
   without a CUDA device.
2. Builds the CUDA kernels from panic3d_tpu_torch/csrc/ into build/kernels/
   (one nvcc per source, all started together) and prints the build time and
   nvcc's registers and spills per kernel (the kernels in NO_SPILL must not
   spill).
3. Checks each kernel against its plain PyTorch version on the card, at the
   flagship paths' shapes and working dtypes (K1 at the coarse and the fine
   pass; K4 at every distinct call of one flagship request, found by a spy
   on its wrapper, each timed, and the discriminator's 4x4 calls on its
   4x4 form: a down=2 call and the filter pass at up = down = 1;
   the ESS and occlusion kernels
   on planes of the seeded flagship; K5 at the SR call, a backbone f32
   call and the mapping layers; K1v on the full 256^3 grid of the seeded
   portrait, its plain version on a slab of 2^20 points, the f32 and f16
   grids with and without filters, with its count of bricks skipped by the
   crop; K1 also in the geometry path's form, f32 planes at the unfiltered
   surface's vertices; K9 with 10,000 points against that portrait's
   unfiltered surface, and exactly on edge cases: degenerate triangles,
   points on vertices, edges and hypotenuses; K13 on the synthetic GT head,
   51,204 queries x 102,400 triangles, kernel and plain f32 each against an
   f64 evaluation, with the atan2 branch flips and the keep/drop decisions
   at 1.3 counted apart, exactly, signs of zero included, on single
   triangles seen from their own vertices, two launches equal bit for bit,
   and its inner loop's SASS instructions a pair with the issue ceiling
   they give, printed beside the bound; K3 at 96+96 on the coarse pass's
   sigmas and at 48+48 on the ESS path's narrowed depths and their K1
   sigmas, the u's in another cdf bracket than the plain version's
   counted; K10, the trilinear K1 form, at the deep-plane render pass's
   bf16 shapes with K1's tolerances, in f32 at 2^17 points, and its
   lattice form on the whole 256^3 grid with K1v's; K11 at the 15
   StyleGAN3-T layer geometries and StyleGAN3-R's 12 radial ones at batch
   4 in the layer's dtype, kernel and plain each against an f64
   evaluation, and in its general form at two other geometries, timed
   beside the unfused composition (K4 + PyTorch's elementwise ops) and
   the whole layer forward, whose K5 call is held exact on the layer's
   conv output and whose output is held to f64 against the plain layer's;
   K4 at the equivariance metrics' calls: the phase-blocked large-filter
   kernel at the 47x47 up-4 and 11x11 (with its SASS instructions an
   output), the tiled one at a 12x12 down-2 call, the row and column forms
   at EQ-T_frac's 1x6 and 6x1 (each faster than its library call), each
   beside its one library call; K8's grid-occlusion entry (paste_front_occ:
   the occlusion volume and the rays in place of the r^2 maps) against its
   plain composition and against the K7b -> glue -> K8 chain it replaces
   (mask_dxyz flips counted apart), timed chain / fused / fused / chain
   with each one's device launches; K6b also at K = 37 with S = 2 on
   the occupancy max-pooled to 16^3, and on one grid shared by both views
   (batch stride 0); K8 also at 72^2, whose tiles are partial, and at
   70^2, whose side is not a multiple of 4 (no float4 stores); K6b's and
   K8's SASS instructions a ray and a pixel (cuobjdump) with the issue
   ceiling they give; with --parent DIR (the parent commit's sources of
   the kernels this tree redesigned, and their headers) the outputs
   against the parent's kernels' and the times in the order parent / this
   / this / parent: K4's large filters, row and column forms and 4x4
   calls, K7a and K8 (bit for bit), and K8's grid-occlusion entry against
   the parent's chain),
   and times both
   (median of CUDA-event timings), with the single PyTorch call that
   computes the same function where there is one (library_ms; K4 must beat
   it) and the least time the card could take (bound_ms, from the bytes,
   the f32 operations, the TF32 tensor-core operations and the SFU
   operations of these inputs). K2 is checked at 96+96 and 48+48 samples,
   with exact cross-half ties and with rays out of order, timed at both
   shapes, must make one device launch a call, and two launches at once on
   two streams must equal the same two in sequence (its scratch is per
   stream); K7a's cropped cells are checked exactly. K14 (grid_sample_2d)
   is checked at its callers' calls (k14_checks), its two kernels'
   registers and shared memory printed: ADA's filtered warp of a 'bgc'
   transform at p = 1 ([8,6,1560,1560] at [8,1036,1036,2]) and EQ-R's
   rotation ([4,3,2094,2094] at [4,512,512,2]) bit for bit, each timed with
   its bound and F.grid_sample (with --parent also against the parent's kernel,
   bit for bit and parent / this / this / parent), the unfiltered warp's
   align_corners=True call, border calls and a synthetic call whose tiles
   take both of the backward's branches bit for bit; at each call the
   backward's blocks that take its staged branch counted on the card and
   required equal to the footprint model's (ops/grid_sample.py:
   k14_tile_plan; ADA's call mostly staged, EQ-R's direct); its backward at
   ADA's and the two-branch call against the plain version's autograd (1e-5
   of the largest gradient: atomics), ADA's timed beside aten's
   grid_sampler_2d_backward (and the parent's), and its double backward
   equal to its forward; then augment_pipe ('bgc', p = 1, batch 8, 6
   channels, 512^2) against the plain ops on the same draws (1e-4 of the
   largest value), its forward and forward + backward ms. Under grad mode every
   kernel wrapper refuses an input that requires grad where it has no
   backward form for it (F8), and G.f of the tiny config on the card
   back-propagates as the CPU's plain version does (1e-2 relative L2 a
   parameter group) at the defaults, with training's paste (image_xyz's
   gradient too) and at triplane_depth 2 (grad_guard_checks).
   --kernels-only stops here.
4. Checks the whole forward of the tiny config on the card (kernels) against
   the same forward on the CPU (plain versions), in f32: ESS and paste off,
   then ESS and paste on, then triplane_depth 2 with the render paste.
5. Drives three paths of the flagship eval forward (seeded weights, bench.py's
   inputs, triplane_crop=0.1, cull_clouds=0.5), each with the kernel launch
   counts zeroed before and read after:
   - settings-parity: configs.flagship(eval_mode=True), 96+96 samples, paste
     off, 2 views (azimuths 0 and 330) per request;
   - ESS + paste per call: configs.flagship(eval_mode=True, ess=True) with
     eval generate's paste_params, 2 views per request (this path, the
   turntable and eval generate require K8's grid-occlusion entry launched
   and K7b's sampler and K8's map entry launched no time);
   - per-portrait turntable: one planes bundle (planes, ESS occupancy,
     occlusion volume), then the 16 eval views (4 ortho + spin12) in view
     batches of 2;
   - the keyed forward of training (keyed_forward_path): configs.flagship()
     (48+48, eval_mode False), batch 8, G.f(x, noise_mode='random',
     generator=g), with ESS off, on, and on with ray_start = ray_end =
     'auto': views/s, launches with K3's u form, K5's per-sample noise form
     and K6b's jitter and per-ray forms required (counted as their
     kernels' variants), 0 host waits, one generator seed twice equal and
     another moving image_raw, and one run with every K1, K2, K3, K5 and
     K6b launch shadowed by its plain version on the same inputs and draws
     (plain_shadow; K2's rays with a half out of depth order counted, > 0);
     then each new form alone at the path's shapes, timed with its bound
     (keyed_form_checks; with --parent and the parent's
     importance_sample.cu, ess.cu and modconv_epilogue.cu, the eval forms
     bit for bit against the parent's kernels, parent / this / this /
     parent), and a Hybrid8X flagship with superresolution_noise_mode
     'random' in f32, card against CPU on the same draws (hybrid8x_check);
     --keyed-only runs the build and these phases alone;
   training (training_checks): trainer.main at the flagship's defaults
   (batch 8, synthetic 512^2 data, Gmain, Gcond, Greg, Dmain, Dreg,
   lazy-reg Adam, G_ema), one warm-up step and TRAIN_STEPS timed ones with
   the launch counts zeroed before and read after (K1, K2, K3, K4, K5 and
   the backward forms of K1, K2 and K5 required, K4's variants forward and
   backward, its generic kernel absent), every phase's losses finite, G, D
   and G_ema moved; one step of every phase on the trained state timed
   phase by phase, its host waits counted (0 required), one profiled for the device's
   busy share; then each backward form against its plain version's autograd
   at the training shapes (K4 at the step's own transposed calls, its
   forward 4x4-form calls and the generator's 512-channel up=2 calls,
   beside their library calls, with --parent bit for bit against the
   parent's kernel; the five small transposed calls of K4_SMALL_TRANSPOSED
   no slower than their conv2d; K1 at a training render's samples and at Gcond's
   ortho front render, coarse and fine, its weight gradients bit-equal
   from launch to launch, with --parent against the parent's form; K2 at a
   training render's samples; K5 at
   the discriminator's b512 layer), R1's second order through K4's and K5's
   backward forms against the plain ops (plain_ops) in f32 and in bf16,
   and one whole step of the flagship against the same step with the plain
   ops on the same draws; then ADA's training path (ada_training_path):
   trainer.main at the same defaults with --aug fixed --aug-p 0.6 for 3
   steps, then --aug ada --ada-interval 1 resumed from its snapshot for 3
   more (K14 forward and backward and K4's four 1-D forms forward and
   backward required, finite losses, p moved by the heuristic's own steps
   on the recorded real-logit signs, s/step, ms by phase, host waits a
   step); then the trainer's options (training_options_path): the same
   training path with --paste-params-mode A --reg-type monotonic-fixed,
   then with --triplane-depth 2 --reg-type monotonic-detach (K8's grid
   entry and its backward form, or K10 and its backward form, launched,
   0 host waits in a step of every phase, s/step and card time against
   the default run's, peak memory), K8's backward
   form against its plain version at training's paste (both entries'
   masks, random output gradients, two launches equal bit for bit) and
   K10's at depth 2's coarse pass (K1's backward's tolerances), each timed
   beside its bound (--options-only runs the build, the grad-mode checks
   of step 3, a run at the defaults and this phase alone); then the GAN metrics (gan_metrics_path): calc_metrics.main on a
   seeded flagship snapshot with a seeded InceptionV3, the six metrics
   finite; fid50k_full's card work (G_ema.f and InceptionV3, K1-K5
   required) in s per 1,000 items, InceptionV3's ms a batch, host waits
   and peak memory; InceptionV3 card vs CPU and unmoved by the global TF32
   flags; trainer.main --metrics fid50k_full to one in-loop snapshot, its
   jsonl finite (--metrics-only runs the build and this phase alone);
   --training-only runs the build and these phases alone; --ada-only
   runs the build, K14's checks, the augment check and ADA's training path
   alone; --forms-only runs the build, K4's forms of the calls the generic
   kernel lost (k4_form_checks), K4's 4x4 form at training's five
   small-plane transposed calls, its b512 and SR calls and their forward
   calls (k4_fir4_calls, through k4_backward_checks) and K1's and K2's
   backward checks alone,
   and with --k1-grad-parts times K1's backward built with parts left out;
   K12's own path, the gather-decode probe; the deep-plane generator
   (configs.flagship(eval_mode=True, rendering_kwargs=dict(triplane_depth=2)),
   ESS off, eval generate's paste with occ_impl='render'): G.f per call
   (bs 2, with bf16 against f32), the turntable (a planes bundle of planes
   alone, 16 views) and Reconstructor.mesh at 256^3 with and without the
   filters, each requiring K10 launched (its render form on the views and
   the vertex colours, its lattice form on the grid) and K1, K1v, K6 and K7
   launched no time; and the geometry path of eval:
   Reconstructor.mesh of one portrait (planes, K1v, one copy of the grid,
   marching tetrahedra on the host, K1 vertex colours) with eval generate's
   filters and without them, then geometry_metrics (K9) between the
   unfiltered mesh and a synthetic reference; and the eval CLIs on a
   synthetic daredemoE tree at full size written into build/eval_cli (512^2
   portrait and GT renders, alignment pickle, a .vrm head of two shells):
   generate_portrait with the ESS flagship and the random-feature ResNet
   (16 views + 16 xyza PNGs and the mesh pickle; s/portrait and stages),
   measure.main on its output (random CLIP / LPIPS; s/portrait, stages,
   host waits, the table's rows; remove_innards must drop the inner shell),
   and generate.main --tiny through argparse; then the checkpoint path
   (checkpoint_path): the seeded ESS flagship written by the port's own
   writers as a checkpoint directory of the JAX package's layout and as a
   reference network-snapshot pickle, with a seeded line filler and
   ResNet + PCA beside it, each loaded and timed (both loaded generators'
   state_dicts and ESS + paste views equal the source's bit for bit), the
   line filler at 512^2 card against CPU (mask flips counted apart), and
   generate.main --ckpt on the eval tree (s/portrait, stages with rmline,
   launches with K1-K8 and K1v required); then the 15 StyleGAN3-T
   alias-free layers' forwards at batch 4 (K5, K11), and the equivariance
   metrics EQ-T, EQ-T_frac and EQ-R at 512^2 (64 samples of the toy
   generator in batches of 4, one host wait a batch; K14 launched once a
   batch on EQ-R), each against the same metric on the CPU within 0.01 dB. It prints views/s (s per
   portrait and its stages on the geometry path), peak memory, launches per
   run of every kernel (K4's by variant: on the three view paths all of
   them must be the polyphase kernel) and the host's waits for the card
   (0 on the render paths; on the geometry path the grid's copy and the
   colours' copy, and the metrics' two copies of distances) for each, and
   checks the bf16
   default against the same weights pinned to f32.
   --profile DIR adds a torch.profiler table and trace of one ESS + paste
   request, one turntable portrait and one deep-plane request, with the
   device's busy share; the first two's device launches, host ops and busy
   time with the grid occlusion's old chain and with K8's entry (chain /
   fused / fused / chain); one EQ-R batch's device time split by kernel
   (K4, the complex128 FFTs, grid_sample_2d, the rest); with
   --parent also a turntable portrait's device
   busy time with the parent's K6a and with this tree's, in the order
   parent / this / this / parent.
6. Prints a JSON line of the paths, the script's wall time, a JSON line of
   the kernels (one entry per entry point, with its launches on the ESS +
   paste path, else on the geometry path, else on eval measure, else on the
   probe, else on the deep-plane request, else on the StyleGAN3-T layers,
   else on EQ-R, else on the training path: the backward forms, K4's as
   its own entry "upfirdn2d_grad", else on ADA's training run: K14's
   backward, else on the options' paste run: K8's backward, else on their
   depth-2 run: K10's backward; 0 for K7b's sampler, checked only), the card
   line, and last the {"ok": true, ...} line. Any failure raises before
   that line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 0
BATCH = 2          # views per request, as bench.py's default BENCH_BATCH
REQUESTS = 5       # timed flagship requests, after one warm-up request
PORTRAITS = 3      # timed turntable portraits, after one warm-up portrait
AZIMUTHS = (0.0, 330.0)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_FLOPS = 67e12           # H100 SXM f32 outside the tensor cores
TF32_FLOPS = 495e12         # H100 SXM TF32 on the tensor cores, dense
SFU_PER_CLOCK_PER_SM = 16   # ex2/lg2 results a clock per SM, compute capability 9.0
SFU_OPS_PER_S = None        # set in main(): x SMs x the card's maximum SM clock
ISSUE_PER_S = None          # set in main(): 128 lanes a clock per SM x SMs x that clock
NO_SPILL = ("triplane_decode_kernel", "factor_terms_kernel", "occlusion_volume_kernel",
            "ray_composite_kernel", "volume_density_kernel", "triangle_records_kernel",
            "point_mesh_distance_kernel", "winding_number_kernel",
            "importance_sample_kernel", "ess_narrow_kernel",
            "paste_front_kernel", "ess_occupancy_kernel", "upfirdn2d_rows_kernel",
            "upfirdn2d_cols_kernel", "upfirdn2d_fir4_kernel", "upfirdn2d_fir4_planes_kernel",
            "upfirdn2d_fir4_flat_kernel",
            "upfirdn2d_large_phase_kernel", "upfirdn2d_rows2_kernel",
            "upfirdn2d_cols2_kernel", "triplane_decode_grad_kernel",
            "grid_sample_kernel", "grid_sample_grad_kernel", "paste_grad_pixels_kernel",
            "paste_grad_texels_kernel", "filtered_lrelu_strip_kernel")   # must not spill
PASTE_KEYS = ("mask_weights", "mask_edges", "mask_occ", "mask_dxyz")
MESH_RES = 256     # eval generate's mesh resolution
LEVEL = 0.5        # eval generate's iso level
LEVEL2 = 0.6       # the synthetic reference mesh's iso level
LEVEL_QUANTILES = (0.99, 0.98)   # the levels when the grid has no surface at those
EVAL_FILTERS = dict(triplane_crop=0.1, cull_clouds=0.5)
MESH_RUNS = 2      # timed portraits of the geometry path, after one warm-up
FULL_FRAME = ((0, 0), (512, 512))   # an ROI covering the whole 512^2 frame
SIGMA_RAISE = 14.5  # K1v's check: puts the cull's threshold inside the seeded sigmas
EVAL_PORTRAITS = 2  # timed portraits of the eval CLIs, after one warm-up
EVAL_SIZE = 512     # the synthetic portrait's and GT renders' size
EVAL_ROI = ((128, 128), (256, 256))   # the synthetic portrait's alignment ROI (512 space)
DEEP_DEPTH = 2     # the deep-plane path's triplane_depth (tests/test_round3_fixes.py:126)
DEEP_PORTRAITS = 2  # timed deep-plane turntable portraits, after one warm-up portrait
HEAD = (0.0, 1.3, 0.0)   # the synthetic GT head's bone
# profiler traces written and read back: the git-ignored build directory
BUILD_TMP = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
HEAD_LEVELS = (6, 5)     # its outer and inner shells' icosphere levels
FLIP_TOL = 1e-5          # the line filler's DoG: a 0.5-threshold flip counts only this close


# StyleGAN3's two public 512^2 configurations (NVlabs/stylegan3 train.py:
# --cfg stylegan3-t, and stylegan3-r with channel_base and channel_max
# doubled, 1x1 convs and radial down filters)
SG3_CONFIGS = {
    "stylegan3-t": dict(channel_base=32768, channel_max=512, conv_kernel=3,
                        use_radial_filters=False),
    "stylegan3-r": dict(channel_base=65536, channel_max=1024, conv_kernel=1,
                        use_radial_filters=True),
}
SG3_BATCH = 4
EQ_RES = 512        # the equivariance path's image size
EQ_SAMPLES = 64     # its samples a metric, in batches of SG3_BATCH


def sg3_layer_geometries(cfg: str, img_resolution: int = 512, w_dim: int = 512) -> list:
    """The AFSynthesisLayer arguments of the 14 layers + toRGB of a 512^2
    StyleGAN3 synthesis network: the arithmetic of NVlabs/stylegan3
    training/networks_stylegan3.py SynthesisNetwork.__init__ (cutoffs and
    stopbands in geometric progression from 2 and 2^2.1 to the last layer's
    img_resolution / 2 and x 2^0.3, 2 critically sampled layers before the
    toRGB, margin 10, the 4 highest resolutions in fp16; filter size 6 and
    lrelu upsampling 2 are the layer's defaults)."""
    c = SG3_CONFIGS[cfg]
    num_layers, num_critical, margin, num_fp16_res = 14, 2, 10, 4
    first_cutoff, first_stopband, last_stopband_rel = 2, 2 ** 2.1, 2 ** 0.3
    last_cutoff = img_resolution / 2
    last_stopband = last_cutoff * last_stopband_rel
    exponents = np.minimum(np.arange(num_layers + 1) / (num_layers - num_critical), 1)
    cutoffs = first_cutoff * (last_cutoff / first_cutoff) ** exponents
    stopbands = first_stopband * (last_stopband / first_stopband) ** exponents
    rates = np.exp2(np.ceil(np.log2(np.minimum(stopbands * 2, img_resolution))))
    half_widths = np.maximum(stopbands, rates / 2) - cutoffs
    sizes = rates + margin * 2
    sizes[-2:] = img_resolution
    channels = np.rint(np.minimum((c["channel_base"] / 2) / cutoffs, c["channel_max"]))
    channels[-1] = 3
    layers = []
    for idx in range(num_layers + 1):
        prev = max(idx - 1, 0)
        layers.append(dict(
            w_dim=w_dim, is_torgb=idx == num_layers,
            is_critically_sampled=idx >= num_layers - num_critical,
            use_fp16=bool(rates[idx] * 2 ** num_fp16_res > img_resolution),
            in_channels=int(channels[prev]), out_channels=int(channels[idx]),
            in_size=int(sizes[prev]), out_size=int(sizes[idx]),
            in_sampling_rate=int(rates[prev]), out_sampling_rate=int(rates[idx]),
            in_cutoff=float(cutoffs[prev]), out_cutoff=float(cutoffs[idx]),
            in_half_width=float(half_widths[prev]), out_half_width=float(half_widths[idx]),
            conv_kernel=c["conv_kernel"], use_radial_filters=c["use_radial_filters"]))
    return layers


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=10, warmup=2):
    """Median milliseconds of fn() on the card over ``iters`` CUDA-event-timed
    runs. Each run is queued behind a sleep kernel that outlasts the host's
    work for fn (twice a warm-up call's host time, plus 1 ms), so the card
    meets fn's launches back to back and the events read device time, not
    the host's launch overhead."""
    import torch

    for _ in range(warmup):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        host_s = time.perf_counter() - t
    cycles = int((2 * host_s + 1e-3) * 2.0e9)     # SM clock at most ~2 GHz
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def bound(n_bytes: float, flops: float, tf32_flops: float = 0.0, sfu_ops: float = 0.0):
    """The least time the card could take: the largest of the bytes over the
    memory rate, the f32 operations over the f32 peak, the TF32 tensor-core
    operations over the TF32 peak and the SFU operations (ex2, lg2) over the
    SFU rate -> (ms, bound_by)."""
    times = {"bytes": n_bytes / HBM_BYTES_PER_S * 1e3,
             "operations": max(flops / F32_FLOPS, tf32_flops / TF32_FLOPS) * 1e3,
             "sfu": sfu_ops / SFU_OPS_PER_S * 1e3 if sfu_ops else 0.0}
    by = max(times, key=times.get)
    return times[by], by


def sfu_rate():
    """SFU operations a second: 16 a clock per SM x the SMs x the card's
    maximum SM clock (nvidia-smi clocks.max.sm); and the instructions a
    second the SMs can issue, one warp instruction a clock on each of an
    SM's 4 schedulers (128 lanes) x the SMs x that clock. -> (SFU, issue)."""
    import torch

    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    mhz = float(proc.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"SFU rate: {SFU_PER_CLOCK_PER_SM} x {sms} SMs x {mhz:.0f} MHz")
    return SFU_PER_CLOCK_PER_SM * sms * mhz * 1e6, 128 * sms * mhz * 1e6


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


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


def portrait_input(G, device):
    """One portrait of bench.py's inputs (batch 1, SEED) as eval generate
    gives it to the geometry path: seeds + cond."""
    x = flagship_inputs(G, device)
    return {"seeds": [SEED], "cond": {k: v[:1] for k, v in x["cond"].items()}}


def flagship_rays(x, device, res=64):
    """The pinhole rays G.f builds for the flagship inputs (fov 30):
    -> (origins [N,R,3], directions [N,R,3], the same as [N,3,res,res])."""
    import torch

    from panic3d_tpu_torch.cameras import camera_label, sample_rays

    n = x["elevations"].shape[0]
    ones = torch.ones(n, device=device)
    cam = camera_label(x["elevations"], x["azimuths"], ones, 30 * ones)
    ro, rd = sample_rays(cam[:, :16].reshape(-1, 4, 4), cam[:, 16:25].reshape(-1, 3, 3), res)
    img = {"ray_origins": ro.transpose(1, 2).reshape(n, 3, res, res),
           "ray_directions": rd.transpose(1, 2).reshape(n, 3, res, res)}
    return ro.contiguous(), rd.contiguous(), img


def record(err, fn, plain_fn, n_bytes, flops, library_fn=None, plain_iters=10, tf32_flops=0.0,
           sfu_ops=0.0):
    """One kernel's summary: its error vs the plain version, the kernel's,
    the plain version's and the library call's times, and its bound (a plain
    version that takes seconds is timed over fewer runs)."""
    bound_ms, bound_by = bound(n_bytes, flops, tf32_flops, sfu_ops)
    return {"max_abs_err": err, "ms": cuda_ms(fn),
            "plain_ms": cuda_ms(plain_fn, iters=plain_iters, warmup=1 if plain_iters < 10 else 2),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": cuda_ms(library_fn) if library_fn else None}


def kernel_checks(G, device):
    """K1-K3 vs their plain versions on the card at the settings-parity
    path's shapes (K1 at the coarse and the fine pass). -> {name: summary}."""
    import torch

    from panic3d_tpu_torch.cameras import camera_label, sample_rays
    from panic3d_tpu_torch.models.volumetric import renderer as vr

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
    print(f"K1 triplane_decode, coarse pass: planes {tuple(planes_cl.shape)} bf16, coords "
          f"{tuple(x_c.shape)}")
    rgb_k, sig_k, e1 = check_k1(planes_cl, x_c, dec, rk["box_warp"], axes, filt)
    flops, tf32 = k1_ops(x_c.shape[0] * x_c.shape[1], 32)
    out["triplane_decode"] = record(
        e1,
        lambda: vr.triplane_decode_kernel(planes_cl, x_c, dec, rk["box_warp"], axes, filt),
        lambda: vr.triplane_decode_plain(planes_cl, x_c, dec, rk["box_warp"], axes, filt),
        nbytes(planes_cl, x_c, rgb_k, sig_k), flops, tf32_flops=tf32)

    # K3 on the coarse pass's real sigmas: [2,4096,96,1] -> 96 fine depths
    s_c = sig_k.reshape(BATCH, R, S, 1)
    d_fk, out["importance_sample"] = k3_check(d_c, s_c, K)

    # K1 at the fine pass (the importance depths), then K2 on the real coarse
    # + fine samples (bf16 colors)
    x_f = coords_of(d_fk)
    print(f"K1 triplane_decode, fine pass: coords {tuple(x_f.shape)}")
    rgb_f, sig_f, e1f = check_k1(planes_cl, x_f, dec, rk["box_warp"], axes, filt)
    out["triplane_decode"]["fine_pass"] = {"max_abs_err": e1f, "ms": cuda_ms(
        lambda: vr.triplane_decode_kernel(planes_cl, x_f, dec, rk["box_warp"], axes, filt))}
    args = (d_c, rgb_k.reshape(BATCH, R, S, 32), s_c, x_c.reshape(BATCH, R, S, 3),
            d_fk, rgb_f.reshape(BATCH, R, K, 32), sig_f.reshape(BATCH, R, K, 1),
            x_f.reshape(BATCH, R, K, 3), rk["white_back"])
    out.update(k2_checks(*args))
    return out


def k3_check(d_c, s_c, K):
    """K3 vs its plain version on coarse depths and sigmas [B,R,S,1] -> K
    fine depths, within 1e-4 (f32: the warp scans' order of rounding against
    torch.cumprod / cumsum); the u's whose fine depth lies between other bin
    midpoints than the plain version's (another cdf bracket) are counted.
    -> (the kernel's fine depths, summary)."""
    import torch

    from panic3d_tpu_torch.models.volumetric import renderer as vr

    B, R, S, _ = d_c.shape
    print(f"K3 importance_sample: depths/sigmas {tuple(d_c.shape)} -> {K}")
    d_fk = vr.importance_sample_kernel(d_c, s_c, K)
    d_fp = vr.importance_sample_plain(d_c, s_c, K)
    e = max_err(d_fk, d_fp)
    check(f"fine depths at {S}+{K} (f32; scan order at the bracket edges)", e, 1e-4)
    mids = (0.5 * (d_c[:, :, :-1, 0] + d_c[:, :, 1:, 0])).reshape(B * R, S - 1).contiguous()
    brackets = int((torch.searchsorted(mids, d_fk.reshape(B * R, K).contiguous())
                    != torch.searchsorted(mids, d_fp.reshape(B * R, K).contiguous())).sum())
    print(f"  u's in another cdf bracket than the plain version's: {brackets} of {B * R * K}")
    summary = record(e, lambda: vr.importance_sample_kernel(d_c, s_c, K),
                     lambda: vr.importance_sample_plain(d_c, s_c, K), nbytes(d_c, s_c, d_fk),
                     B * R * (S * 20 + K * 10))
    summary.update(samples=f"{S}+{K}", other_bracket=brackets)
    print(f"  ms {summary['ms']:.6f} (plain {summary['plain_ms']:.6f}), bound "
          f"{summary['bound_ms']:.6f} ms by {summary['bound_by']}")
    return d_fk, summary


def k2_checks(d_c, rgb_c, s_c, x_c, d_f, rgb_f, s_f, x_f, white_back):
    """K2 vs its plain version on the card: at 96+96 (the settings-parity
    render's coarse and fine samples, bf16 colors), at 48+48 (every other
    sample of each half: the ESS paths' shape), on the 96+96 input with exact
    cross-half ties (fine sample 3 of every ray moved onto coarse sample 4),
    and with one ray's fine half reversed and another's coarse half out of
    order (the kernel's rank-count branch); rgb, depth, weight total and xyz
    within 1e-4 (f32, summation order). Both shapes timed. One call must make
    one device launch (torch.profiler). -> {"ray_composite": summary}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from panic3d_tpu_torch.models.volumetric import renderer as vr

    full = (d_c, rgb_c, s_c, x_c, d_f, rgb_f, s_f, x_f, white_back)
    half = tuple(a[:, :, ::2].contiguous() if torch.is_tensor(a) else a for a in full)
    d_t = d_f.clone()
    d_t[:, :, 3] = d_c[:, :, 4]
    d_t = d_t.sort(dim=2).values.contiguous()
    d_cu, d_fu = d_c.clone(), d_f.clone()
    d_fu[0, 0] = d_fu[0, 0].flip(0)
    d_cu[0, 1, [2, 7]] = d_cu[0, 1, [7, 2]]
    B, R, S = d_c.shape[:3]
    K = d_f.shape[2]
    ties = int((d_c[..., None, 0] == d_t[:, :, None, :, 0]).sum())
    err = 0.0
    unsorted = (d_cu,) + full[1:4] + (d_fu,) + full[5:]
    for label, args in ((f"{S}+{K} samples", full), (f"{S // 2}+{K // 2} samples", half),
                        (f"{S}+{K} samples, {ties} cross-half ties", full[:4] + (d_t,) + full[5:]),
                        (f"{S}+{K} samples, 2 rays out of order", unsorted)):
        print(f"K2 ray_composite: {label}, {R} rays x {B}, colors bf16")
        ck, cp = vr.ray_composite_kernel(*args), vr.ray_composite_plain(*args)
        for name, a, b in zip(("rgb", "depth", "weight total", "xyz"), ck, cp):
            err = max(err, max_err(a, b))
            check(f"{name} (f32, summation order)", max_err(a, b), 1e-4)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        vr.ray_composite_kernel(*full)
        torch.cuda.synchronize()
    launched = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    print(f"  device launches of one call: {len(launched)} {launched}")
    require(len(launched) == 1, f"K2: {len(launched)} device launches per composite")

    # F9: K2's scratch is per stream. Two launches at once on two streams,
    # both released by one event behind a sleep kernel, against the same
    # two launches in sequence: equal
    seq = [vr.ray_composite_kernel(*full), vr.ray_composite_kernel(*half)]
    cur, streams = torch.cuda.current_stream(), (torch.cuda.Stream(), torch.cuda.Stream())
    torch.cuda._sleep(int(2e7))
    go = torch.cuda.Event()
    go.record(cur)
    both = []
    for st, args in zip(streams, (full, half)):
        st.wait_event(go)
        with torch.cuda.stream(st):
            both.append(vr.ray_composite_kernel(*args))
    for st in streams:
        cur.wait_stream(st)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for o_seq, o_two in zip(seq, both) for a, b in zip(o_seq, o_two))
    print(f"  two launches on two streams at once equal to the same two in sequence: {same}")
    require(same, "K2: concurrent launches on two streams differ from sequential ones")

    def summary(args):
        out = vr.ray_composite_kernel(*args)
        n = B * R * (args[0].shape[2] + args[4].shape[2])
        return record(err, lambda: vr.ray_composite_kernel(*args),
                      lambda: vr.ray_composite_plain(*args),
                      nbytes(*[a for a in args if torch.is_tensor(a)], *out), n * (2 * 35 + 20))

    main, small = summary(full), summary(half)
    print(f"  ms {main['ms']:.6f} at {S}+{K}, {small['ms']:.6f} at {S // 2}+{K // 2}")
    return {"ray_composite": dict(main, device_launches_per_call=len(launched),
                                  shapes={f"{S}+{K}": main, f"{S // 2}+{K // 2}": small})}


def k1_ops(points: int, C: int):
    """K1's operations per call -> (f32 operations, TF32 tensor-core
    operations): per point 3 planes x 4 corners x C channel lerps on the CUDA
    cores; FC C->64 and FC 64->33 on the tensor cores, each product three
    times (3xTF32)."""
    return points * 3 * C * 6, points * 3 * 2 * (C * 64 + 64 * 33)


def check_k1(planes_cl, coords, dec, box_warp, axes, filt, kernel=None, plain=None):
    """K1 (or ``kernel``, K10's render form, with its ``plain`` version)
    against its plain version on one input: cull decisions that differ
    counted apart (at most 1 in 100,000), rgb within 1 bf16 ulp below 1.0
    (2^-8; 1e-4 for f32 planes), sigma within 1e-4 where the decisions agree.
    -> (rgb, sigma, max error)."""
    import torch

    from panic3d_tpu_torch.models.volumetric import renderer as vr

    kernel = kernel or vr.triplane_decode_kernel
    plain = plain or vr.triplane_decode_plain
    rgb_k, sig_k = kernel(planes_cl, coords, dec, box_warp, axes, filt)
    rgb_p, sig_p = plain(planes_cl, coords, dec, box_warp, axes, filt)
    torch.cuda.synchronize()
    # the cull threshold is a discontinuity: a sample whose alpha sits within
    # f32 rounding of it may be culled on one side only; count those apart
    culled_k, culled_p = sig_k == -1e3, sig_p == -1e3
    flips = int((culled_k != culled_p).sum())
    agree = culled_k == culled_p
    max_flips = sig_k.numel() // 100000
    print(f"  cull decisions that differ: {flips} of {sig_k.numel()} (tol {max_flips})")
    require(flips <= max_flips, f"{kernel.__name__}: {flips} cull decisions differ")
    e_rgb = max_err(rgb_k, rgb_p)
    e_sig = float((sig_k - sig_p).abs()[agree].max())
    if planes_cl.dtype == torch.bfloat16:
        check("rgb (bf16; 1 bf16 ulp below 1.0 = 2^-8)", e_rgb, 2.0 ** -8)
    else:
        check("rgb (f32, 3xTF32 MLP)", e_rgb, 1e-4)
    check("sigma (f32, 3xTF32 MLP)", e_sig, 1e-4)
    return rgb_k, sig_k, max(e_rgb, e_sig)


def k4_call(gen, shape, dtype, f2d, up, down, pad, label):
    """One K4 call on a random input: the kernel against its plain version
    (bf16 within 1 bf16 ulp of the largest value, f32 within 1e-5: the
    summation order), timed, with a bytes bound at 4 taps an output. ->
    (input, kernel output, plain output, error, summary)."""
    import torch

    from panic3d_tpu_torch.ops.upfirdn2d import k4_plan, upfirdn2d_kernel, upfirdn2d_plain

    xx = torch.randn(shape, generator=gen, device=gen.device).to(dtype)
    spec = (f2d, up, down, pad)
    yk, yp = upfirdn2d_kernel(xx, *spec), upfirdn2d_plain(xx, *spec)
    e = max_err(yk, yp)
    tol = 2.0 ** -7 * float(yp.abs().max()) if dtype == torch.bfloat16 else 1e-5
    check(f"{label} {list(shape)} {str(dtype)[6:]} up={tuple(up)} down={tuple(down)} pad={pad} "
          f"-> {yk.shape[-2]}x{yk.shape[-1]} ({k4_plan(*spec).variant})", e, tol)
    ms = cuda_ms(lambda: upfirdn2d_kernel(xx, *spec))
    bms, _ = bound(nbytes(xx, yk), yk.numel() * 4 * 2)
    print(f"    ms {ms:.6f}  bound_ms {bms:.6f}")
    return xx, yk, yp, e, {"shape": list(shape), "dtype": str(dtype)[6:], "up": up[0],
                           "down": down[0], "pad": list(pad),
                           "variant": k4_plan(*spec).variant, "max_abs_err": e,
                           "ms": ms, "bound_ms": bms}


ADA_BATCH, ADA_CHANNELS, ADA_RES = 8, 6, 512   # batch 8; 6: D's joint pair (training/loss.py)


def ada_passes():
    """ADA's geometric warp's two sym6 resamplings at 512^2
    (training/augment.py:execute_geometric_filtered), split into their 1-D passes:
    the reflect pad margin m = min(W - 1, W / 4 + 2 Hz_pad) = 134 (Hz_pad =
    3), so the up=2 call takes [N,C,780,780] (upsample2d's padding
    [6, 5, 6, 5], gain 4) to 1560^2, and the down=2 call takes the 2x
    sample over (512 + 6) x 2 = 1036^2 (downsample2d, padding -6, the
    flipped filter) to 512^2. -> [(label, input shape, (f2d, up, down,
    pad))] in f32."""
    import importlib

    uf = importlib.import_module("panic3d_tpu_torch.ops.upfirdn2d")
    ag = importlib.import_module("panic3d_tpu_torch.training.augment")
    taps = len(ag.WAVELET_SYM6)
    hz = uf.setup_filter(ag.WAVELET_SYM6)
    n, c, w = ADA_BATCH, ADA_CHANNELS, ADA_RES
    wp, ws = w + 2 * ag.geometric_margin(w), (w + 2 * (taps // 4)) * 2
    up_x, up_y = uf.fir_passes(hz, up=2, padding=[6, 5, 6, 5], gain=4)
    dn_x, dn_y = uf.fir_passes(hz, down=2, padding=[-1, -1, -1, -1], flip_filter=True)
    wd = (ws - 2 - taps) // 2 + 1   # the down=2 x pass's output width: 512
    return [("ADA up=2, x pass", (n, c, wp, wp), up_x),
            ("ADA up=2, y pass", (n, c, wp, 2 * wp), up_y),
            ("ADA down=2, x pass", (n, c, ws, ws), dn_x),
            ("ADA down=2, y pass", (n, c, ws, wd), dn_y)]


def k4_form_checks(device, parent, gen):
    """K4's forms for the calls the generic kernel lost to its library call, each
    required to take its form, held to its plain version, timed beside its
    bound (bytes; the nonzero taps an output as operations), its plain
    version and its library call (a depthwise conv2d or conv_transpose2d),
    and with ``parent`` (--parent) equal bit for bit to the parent's generic
    kernel and timed parent / this / this / parent: the 1-D polyphase form
    at the unfused K11 composition's 1x12 up=2 pass (a StyleGAN3-T layer 10
    input, bf16) and its transposed pass (1x12 down=2), and ADA's four sym6
    passes (f32, batch 8, 512^2, ada_passes); the small 2-D form at a 3x3
    filter (f32). And the generic kernel at a call it keeps: a 5x5 filter at
    up=2 (f32), required to take it. -> {"poly1d": [...], "fir_small":
    summary, "generic": [summary], "max_abs_err": the largest error}."""
    import importlib

    import torch

    from panic3d_tpu_torch.kernels import KERNELS
    from panic3d_tpu_torch.ops.upfirdn2d import upfirdn2d_kernel, upfirdn2d_plain

    mod = importlib.import_module("panic3d_tpu_torch.ops.upfirdn2d")
    k12 = np.kaiser(12, 8.0).astype(np.float32)
    f12 = torch.from_numpy(k12 / k12.sum())
    k11_up = mod.fir_passes(f12, up=2, padding=[11, 10, 11, 10], gain=4)[0]
    k11_shape = (SG3_BATCH, 287, 276, 276)
    k11_out = (276, 2 * 276 + 10)
    k11_down = mod.transposed_pass(*k11_up, k11_shape[2:], k11_out)
    f5 = mod.setup_filter([1, 4, 6, 4, 1])
    calls = [("poly1d", "K11 composition 1x12 up=2 pass", k11_shape, torch.bfloat16, k11_up,
              "row_up2", 6),
             ("poly1d", "its transposed pass, 1x12 down=2", k11_shape[:3] + (k11_out[1],),
              torch.bfloat16, k11_down, "row_down2", 12)]
    calls += [("poly1d", label, shape, torch.float32, spec,
               mod.poly_variant(*spec[0].shape, spec[1], spec[2]), 6 if spec[1] != (1, 1)
               else 12) for label, shape, spec in ada_passes()]
    calls += [("fir_small", "3x3 filter", (BATCH, 64, 256, 256), torch.float32,
               (mod.setup_filter([1, 2, 1]), (1, 1), (1, 1), (1, 1, 1, 1)), "fir_small", 9),
              ("generic", "5x5 filter at up=2 (stays generic)", (BATCH, 64, 128, 128),
               torch.float32, (f5, (2, 2), (1, 1), (4, 3, 4, 3)), "generic", 9)]
    out, err = {"poly1d": [], "generic": []}, 0.0
    for key, label, shape, dtype, spec, variant, taps in calls:
        n_var = KERNELS["upfirdn2d"].variants.get(variant, 0)
        xg, yg, ypg, e_g, summ = k4_call(gen, shape, dtype, *spec, label)
        require(KERNELS["upfirdn2d"].variants.get(variant, 0) > n_var,
                f"K4: the {label} call did not take the {variant} form")
        err = max(err, e_g)
        bms_g, by_g = bound(nbytes(xg, yg), yg.numel() * taps * 2)
        summ.update(call=label, filter=list(spec[0].shape), bound_ms=bms_g, bound_by=by_g,
                    plain_ms=cuda_ms(lambda: upfirdn2d_plain(xg, *spec), iters=3, warmup=1))
        library_g = k4_library(xg, spec[0], spec[1], spec[3], yg.shape[-2:], down=spec[2])
        require(library_g is not None, f"K4 {label}: no library call")
        tol_g = (2.0 ** -7 if dtype == torch.bfloat16 else 1e-5) * float(ypg.abs().max())
        check(f"library call vs plain ({str(dtype)[6:]})", max_err(library_g(), ypg), tol_g)
        summ["library_ms"] = cuda_ms(library_g)
        print(f"    plain_ms {summ['plain_ms']:.6f}  library_ms {summ['library_ms']:.6f}  "
              f"bound_ms {summ['bound_ms']:.6f} ({summ['bound_by']})")
        form_kernel = {"row_up2": "upfirdn2d_rows2_kernel", "row_down2": "upfirdn2d_rows2_kernel",
                       "column_up2": "upfirdn2d_cols2_kernel",
                       "column_down2": "upfirdn2d_cols2_kernel",
                       "fir_small": "upfirdn2d_fir4_kernel"}.get(variant, "upfirdn2d_kernel")
        summ.update(parent_and_sass(
            parent, "upfirdn2d", "upfirdn2d", "upfirdn2d_kernel",
            lambda: upfirdn2d_kernel(xg, *spec), yg.numel(), "output", None, 1, None,
            profiled=form_kernel, adapt=k4_parent_adapt(parent)))
        if "parent" in summ:
            require(summ["parent"]["values_not_bit_equal"] == 0,
                    f"K4 {label}: the outputs differ from the parent's generic kernel's")
            if variant in K4_FIR4_VARIANTS:   # the 4x4 form: no slower than the parent's
                summ["parent"].update(k4_require_parent(
                    parent, lambda: upfirdn2d_kernel(xg, *spec), f"K4 {label}",
                    summ["parent"]["ms_parent_this_this_parent"]))
        if key == "fir_small":
            out[key] = summ
        else:
            out[key].append(summ)
        del xg, yg, ypg
    out["max_abs_err"] = err
    return out


def k4_checks(G, x, device, parent):
    """K4 vs its plain version on the card at every distinct call of one
    flagship request (found by a spy on ops/upfirdn2d.py:_fir: the backbone's
    up-convs and 96-channel skip upsamples, f32 and bf16, and SR's four
    calls), each timed; the SR block-1 call (bf16 [2,256,256,256] -> 514^2)
    also with its plain version and the library call. The 4x4 form at the
    discriminator's calls (bf16 [2,256,256,256]): a down=2 call ("down2")
    and the filter pass of conv2d_resample at up = down = 1 ("fir4"), each
    beside its plain version and its library call (a depthwise F.conv2d of
    stride 2, or of stride 1; each must be faster than it), with its SASS
    instructions an output, and with ``parent`` (--parent) equal bit for
    bit to the parent's kernel and timed against it; its other
    instantiations checked at f32, unaligned rows, padding 0, small planes
    (the planes plan) and an input not 16-byte aligned. The forms
    of the calls the generic kernel lost, and the generic kernel at a call
    it keeps (k4_form_checks). bf16 within 1 bf16 ulp of the largest value,
    f32 within 1e-5 (summation order). -> {"upfirdn2d": summary}."""
    import importlib

    import torch

    from panic3d_tpu_torch.kernels import KERNELS
    from panic3d_tpu_torch.ops.upfirdn2d import upfirdn2d_kernel, upfirdn2d_plain

    mod = importlib.import_module("panic3d_tpu_torch.ops.upfirdn2d")
    calls, fir = {}, mod._fir

    def spy(xx, f2d, up, down, pad):
        key = (tuple(xx.shape), xx.dtype, tuple(up), tuple(down), tuple(pad))
        calls.setdefault(key, [0, f2d.detach().clone()])[0] += 1
        return fir(xx, f2d, up, down, pad)

    mod._fir = spy
    try:
        G.f(x)
    finally:
        mod._fir = fir
    gen = torch.Generator(device=device).manual_seed(SEED)
    print(f"K4 upfirdn2d: {sum(n for n, _ in calls.values())} calls per request, "
          f"{len(calls)} distinct")

    def one(shape, dtype, f2d, up, down, pad, label):
        return k4_call(gen, shape, dtype, f2d, up, down, pad, label)

    shapes, err = [], 0.0
    for (shape, dtype, up, down, pad), (count, f2d) in sorted(
            calls.items(), key=lambda kv: (kv[0][0][1], kv[0][0][2], str(kv[0][1]))):
        *_, e, summ = one(shape, dtype, f2d, up, down, pad, f"{count} call(s)")
        shapes.append(dict(summ, calls_per_request=count))
        err = max(err, e)
    require(all(s_["variant"] == "up2" for s_ in shapes),
            "K4: a call of the request is outside the polyphase kernel's family")

    # the 4x4 form (the discriminator's calls): a 2x downsample (bf16
    # [2,256,256,256], downsample2d's padding 1) and conv2d_resample's filter
    # pass before a conv of stride 2 (padding 2, up = down = 1), each beside
    # its plain version and its library call (a depthwise conv2d, of stride
    # 2 and padding 1, or padding 2), and with ``parent`` (--parent) equal bit
    # for bit to the parent's generic kernel and timed against it
    f = next(iter(calls.values()))[1]
    forms = {}
    for variant, down, pad in (("down2", 2, 1), ("fir4", 1, 2)):
        n_form = KERNELS["upfirdn2d"].variants.get(variant, 0)
        spec_d = (f / 4, (1, 1), (down, down), (pad,) * 4)
        xd, yd, ypd, e_d, summ = one((BATCH, 256, 256, 256), torch.bfloat16, *spec_d,
                                     f"{variant} form")
        err = max(err, e_d)
        require(KERNELS["upfirdn2d"].variants.get(variant, 0) > n_form,
                f"K4: the 4x4 call at down={down} did not take the {variant} form")
        w_d = spec_d[0].to(xd.device, xd.dtype)[None, None].expand(xd.shape[1], 1, 4, 4)
        w_d = w_d.contiguous()

        def library_4x4():
            return torch.nn.functional.conv2d(xd, w_d, stride=down, padding=pad,
                                              groups=xd.shape[1])

        check(f"library conv2d (stride {down}, padding {pad}) vs plain (1 bf16 ulp)",
              max_err(library_4x4(), ypd), 2.0 ** -7 * float(ypd.abs().max()))
        bms_d, by_d = bound(nbytes(xd, yd), yd.numel() * 16 * 2)
        summ.update(plain_ms=cuda_ms(lambda: upfirdn2d_plain(xd, *spec_d), iters=3, warmup=1),
                    library_ms=cuda_ms(library_4x4), bound_ms=bms_d, bound_by=by_d)
        print(f"    plain_ms {summ['plain_ms']:.6f}  library_ms {summ['library_ms']:.6f}  "
              f"bound_ms {summ['bound_ms']:.6f}")
        require(summ["ms"] < summ["library_ms"],
                f"K4 {variant}: {summ['ms']} ms, not faster than the library call's "
                f"{summ['library_ms']} ms")
        # the instantiation this call runs: the rows plan (256-wide rows,
        # 16-byte aligned) in bf16, an odd first column at padding 1; no
        # loop (the staging and the strip of 8 outputs a lane unrolled)
        odd = int(down == 2 and pad % 2 == 1)
        summ.update(parent_and_sass(
            parent, "upfirdn2d", "upfirdn2d", "upfirdn2d_fir4_kernel",
            lambda: upfirdn2d_kernel(xd, *spec_d), yd.numel(), "output", {}, 1 / 8, None,
            new_kernel=f"upfirdn2d_fir4_kernelI13__nv_bfloat16Li{down}ELb1ELb{odd}ELi4ELi4EE",
            parent_kernel="upfirdn2d_fir4_kernel", adapt=k4_parent_adapt(parent)))
        if "parent" in summ:
            require(summ["parent"]["values_not_bit_equal"] == 0,
                    f"K4 {variant}: the outputs differ from the parent's kernel's "
                    "(the same taps in the same order)")
            summ["parent"].update(k4_require_parent(
                parent, lambda: upfirdn2d_kernel(xd, *spec_d), f"K4 {variant}",
                summ["parent"]["ms_parent_this_this_parent"]))
        forms[variant] = summ
        del xd, yd, ypd
    # the form's other instantiations (dtype, DOWN, 16-byte staging, an odd
    # first column), each checked once: down=2 in f32 at padding 1 (aligned,
    # odd) and 0 (aligned, even), in bf16 at padding 0 (aligned, even: the
    # skip images' downsample2d), and the dual discriminator's resize
    # (downsample2d at padding -1 of a 2 size + 2 image: padding 0, rows not
    # 16-byte aligned) in bf16 and f32; the filter pass at up = down = 1
    # with aligned rows in f32 (the resnet skip's, padding 1) and unaligned
    # rows in bf16 and f32; small planes (the planes plan) at down 2 and 1
    for shape, dtype, down, pad in (((BATCH, 64, 34, 34), torch.bfloat16, 2, 0),
                                    ((BATCH, 64, 9, 9), torch.float32, 1, 1),
                                    ((BATCH, 64, 256, 256), torch.float32, 2, 1),
                                    ((BATCH, 64, 128, 128), torch.float32, 2, 0),
                                    ((BATCH, 64, 256, 256), torch.bfloat16, 2, 0),
                                    ((BATCH, 3, 258, 258), torch.bfloat16, 2, 0),
                                    ((BATCH, 3, 258, 258), torch.float32, 2, 0),
                                    ((BATCH, 64, 128, 128), torch.float32, 1, 1),
                                    ((BATCH, 64, 100, 100), torch.bfloat16, 1, 1),
                                    ((BATCH, 64, 102, 102), torch.float32, 1, 2)):
        variant = "down2" if down == 2 else "fir4"
        n_form = KERNELS["upfirdn2d"].variants.get(variant, 0)
        spec_o = (f.flip([0, 1]) / 4, (1, 1), (down, down), (pad,) * 4)
        xo, yo, ypo, e_o, _ = one(shape, dtype, *spec_o, "4x4 form")
        require(KERNELS["upfirdn2d"].variants.get(variant, 0) > n_form,
                f"K4: the 4x4 call {list(shape)} at down={down} did not take the {variant} form")
        tol_o = (2.0 ** -7 if dtype == torch.bfloat16 else 1e-5) * float(ypo.abs().max())
        check("  within its tolerance x max|out|", e_o, tol_o)
        err = max(err, e_o)
        k4_require_parent(parent, lambda: upfirdn2d_kernel(xo, *spec_o),
                          f"K4 4x4 form {list(shape)} {str(dtype)[6:]}")
        del xo, yo, ypo
    # the flat plan's chunks counted from the 16-byte boundary before an
    # input whose data is not 16-byte aligned (a contiguous view one element
    # into its storage; its 128-wide rows would take the rows plan aligned)
    for dtype in (torch.bfloat16, torch.float32):
        shape_u = (BATCH, 8, 70, 128)
        flat = torch.randn(int(np.prod(shape_u)) + 1, generator=gen, device=device).to(dtype)
        xu = flat[1:].view(shape_u)
        require(xu.data_ptr() % 16 != 0, "K4: the unaligned check's input is aligned")
        spec_u = (f.flip([0, 1]) / 4, (1, 1), (2, 2), (1,) * 4)
        yu, ypu = upfirdn2d_kernel(xu, *spec_u), upfirdn2d_plain(xu, *spec_u)
        tol_u = (2.0 ** -7 if dtype == torch.bfloat16 else 1e-5) * float(ypu.abs().max())
        check(f"4x4 form, input not 16-byte aligned {list(shape_u)} {str(dtype)[6:]}",
              max_err(yu, ypu), tol_u)
        k4_require_parent(parent, lambda: upfirdn2d_kernel(xu, *spec_u),
                          f"K4 4x4 form, unaligned input {list(shape_u)} {str(dtype)[6:]}")
        err = max(err, max_err(yu, ypu))
        del flat, xu, yu, ypu

    new_forms = k4_form_checks(device, parent, gen)
    err = max(err, new_forms.pop("max_abs_err"))

    # the SR block-1 call, with its plain version and the single library
    # call for this upsample: a depthwise transposed convolution (stride 2)
    # with the flipped 4x4 filter; check it first
    spec = (f, (2, 2), (1, 1), (3, 2, 3, 2))
    xx, yk, yp, e, _ = one((BATCH, 256, 256, 256), torch.bfloat16, *spec, "SR block1 conv0")
    w_t = f.flip([0, 1]).to(xx.device, xx.dtype)[None, None].expand(xx.shape[1], 1, 4, 4)
    w_t = w_t.contiguous()

    def library():
        return torch.nn.functional.conv_transpose2d(xx, w_t, stride=2, groups=xx.shape[1])

    e_lib = max_err(library(), yp)
    check("library conv_transpose2d vs plain (1 bf16 ulp)", e_lib,
          2.0 ** -7 * float(yp.abs().max()))
    # each output takes 4 of the 16 taps (the others hit inserted zeros)
    summary = record(max(e, err), lambda: upfirdn2d_kernel(xx, *spec),
                     lambda: upfirdn2d_plain(xx, *spec), nbytes(xx, yk), yk.numel() * 4 * 2,
                     library)
    require(summary["ms"] < summary["library_ms"],
            f"K4: {summary['ms']} ms, not faster than the library call's "
            f"{summary['library_ms']} ms")
    return {"upfirdn2d": dict(summary, shapes=shapes, **forms, **new_forms,
                              equivariance=k4_equivariance_checks(device, parent))}


def k4_library(xx, f2d, up, pad, out_hw, down=(1, 1)):
    """The single PyTorch call that computes upfirdn2d_plain(xx, f2d, up,
    down, pad) (f2d already flipped, correlated; up = (upx, upy)), or None
    where there is none: at up 1 a depthwise F.conv2d of stride (downy,
    downx) with each axis's symmetric padding (a negative one a crop of
    the input, a view); at down 1 a depthwise F.conv_transpose2d of stride
    (upy, upx), whose
    left padding on an axis is k - 1 - padding, so a padding beyond k - 1
    (EQ-R's 48 at k = 47) is reached by extending the filter with leading
    zero taps, and the right edge by output_padding (< the stride)."""
    import torch
    import torch.nn.functional as F

    C = xx.shape[1]
    fh, fw = f2d.shape
    px0, px1, py0, py1 = pad
    if tuple(up) == (1, 1):
        if px0 != px1 or py0 != py1:
            return None
        w = f2d.to(xx.device, xx.dtype)[None, None].expand(C, 1, fh, fw).contiguous()
        cy, cx = max(-py0, 0), max(-px0, 0)
        xc = xx[:, :, cy:xx.shape[2] - cy, cx:xx.shape[3] - cx]
        return lambda: F.conv2d(xc, w, stride=(down[1], down[0]),
                                padding=(max(py0, 0), max(px0, 0)), groups=C)
    if tuple(down) != (1, 1):
        return None
    ext, P, k, op = [], [], [], []
    for u, kk, p0, n_in, n_out in ((up[1], fh, py0, xx.shape[2], out_hw[0]),
                                   (up[0], fw, px0, xx.shape[3], out_hw[1])):
        e = max(p0 - (kk - 1), 0)              # leading zero taps
        ext.append(e)
        P.append(e - (p0 - (kk - 1)))           # conv_transpose2d's padding
        k.append(kk + e)
        op.append(n_out - ((n_in - 1) * u - 2 * P[-1] + k[-1]))
        if not 0 <= op[-1] < u:
            return None
    w = torch.zeros(k, dtype=xx.dtype, device=xx.device)
    w[ext[0]:, ext[1]:] = f2d.flip([0, 1]).to(xx.device, xx.dtype)
    w = w[None, None].expand(C, 1, *k).contiguous()
    return lambda: F.conv_transpose2d(xx, w, stride=(up[1], up[0]), padding=tuple(P),
                                      output_padding=tuple(op), groups=C)


def k4_equivariance_checks(device, parent):
    """K4 at the equivariance path's calls on 512^2 f32 images (batch 4, 3
    channels). The phase-blocked large-filter kernel (more than 64 taps,
    from a device buffer): EQ-R's 47x47 resampling filter at up 4
    (upsample2d) and the pseudo-rotation's 11x11 (filter2d), for a rotation
    of 0.3 rad, each with its SASS instructions an output and, with
    ``parent``, equal bit for bit to the parent's large-filter kernel and
    timed against it; the tiled large-filter kernel at a 12x12 filter at
    down 2 (the calls the phase-blocked one leaves to it). The row
    and the column form: EQ-T_frac's 1x6 and 6x1 windowed sincs (filter2d),
    as apply_fractional_translation makes them for a shift of (0.3, 0.7)
    pixels (a spy on ops/upfirdn2d.py:_fir), each faster than its library
    call, with its SASS instructions an output, and with ``parent``
    (--parent) equal bit for bit to the parent's generic kernel and timed
    against it. Each against its plain version within 1e-5 x max|out| (up
    to ~140 f32 products an output, which cuDNN may sum in another order),
    timed, with its bound (the taps of each output's phase only) ->
    [summary per call]."""
    import importlib

    import torch

    from panic3d_tpu_torch.eval.equivariance import (
        apply_fractional_translation, construct_affine_bandlimit_filter, rotation_matrix)
    from panic3d_tpu_torch.kernels import KERNELS
    from panic3d_tpu_torch.ops.upfirdn2d import (
        fir_passes, k4_plan, large_phase_geometry, upfirdn2d_kernel, upfirdn2d_plain)

    gen = torch.Generator(device=device).manual_seed(SEED)
    mod = importlib.import_module("panic3d_tpu_torch.ops.upfirdn2d")
    fir, calls = mod._fir, []

    def spy(xx, f2d, up, down, pad):
        calls.append((xx.clone(), f2d.detach().clone(), up, down, pad))
        return fir(xx, f2d, up, down, pad)

    img = torch.randn((SG3_BATCH, 3, EQ_RES, EQ_RES), generator=gen, device=device)
    mod._fir = spy
    try:
        apply_fractional_translation(img, 0.3 / EQ_RES, 0.7 / EQ_RES)
    finally:
        mod._fir = fir
    mat = rotation_matrix(0.3).to(device)
    out = []
    for up, what in ((4, "EQ-R upsample2d, 47x47 at up 4"), (1, "pseudo-rotation filter2d, 11x11")):
        f = construct_affine_bandlimit_filter(mat, a=3, amax=6, up=up)
        fh, fw = f.shape
        p = fh // 2
        pads = ([p + (fw + up - 1) // 2, p + (fw - up) // 2] * 2 if up > 1
                else [fw // 2, (fw - 1) // 2] * 2)
        (f2d, upp, down, pad), = fir_passes(f, up=up, padding=pads, gain=up * up)
        xx = torch.randn((SG3_BATCH, 3, EQ_RES, EQ_RES), generator=gen, device=device)
        n_large = KERNELS["upfirdn2d"].variants.get("large", 0)
        yk = upfirdn2d_kernel(xx, f2d, upp, down, pad)
        require(KERNELS["upfirdn2d"].variants.get("large", 0) == n_large + 1,
                f"K4 {what}: not the large-filter kernel")
        yp = upfirdn2d_plain(xx, f2d, upp, down, pad)
        e = max_err(yk, yp)
        check(f"K4 large filter, {what}: {list(xx.shape)} f32 -> {yk.shape[-2]}x{yk.shape[-1]}",
              e, 1e-5 * float(yp.abs().max()))
        library = k4_library(xx, f2d, upp, pad, yk.shape[-2:])
        require(library is not None, f"K4 {what}: no library call")
        check("  library call vs plain", max_err(library(), yp), 1e-5 * float(yp.abs().max()))
        summ = record(e, lambda: upfirdn2d_kernel(xx, f2d, upp, down, pad),
                      lambda: upfirdn2d_plain(xx, f2d, upp, down, pad), nbytes(xx, yk, f2d),
                      yk.numel() * (fh * fw / up ** 2) * 2, library, plain_iters=3)
        summ.update(call=what, variant="large", shape=list(xx.shape), filter=[fh, fw], up=up,
                    pad=list(pad))
        print(f"    ms {summ['ms']:.6f}  plain_ms {summ['plain_ms']:.6f}  library_ms "
              f"{summ['library_ms']:.6f}  bound_ms {summ['bound_ms']:.6f} ({summ['bound_by']})")
        # the phase-blocked kernel's instantiation and a thread's outputs:
        # 16 phase rows x 4 columns of each column phase, for each of the
        # warp's jobs (a row phase and band each, 4 warps a block)
        g = large_phase_geometry(fh, fw, upp, down)
        per_thread = 16 * upp[0] * -(-upp[1] * g.nbands // 4)
        summ.update(parent_and_sass(
            parent, "upfirdn2d", "upfirdn2d", "upfirdn2d_large_phase_kernel",
            lambda: upfirdn2d_kernel(xx, f2d, upp, down, pad), yk.numel(), "output",
            {"FFMA": per_thread * fh * fw / (upp[0] * upp[1])}, 1 / per_thread, None,
            new_kernel=f"upfirdn2d_large_phase_kernelIfLi{g.nch}ELb{int(upp[0] == 1)}EE",
            parent_kernel="upfirdn2d_large_kernel", adapt=k4_parent_adapt(parent)))
        if "parent" in summ:
            require(summ["parent"]["values_not_bit_equal"] == 0,
                    f"K4 {what}: the phase-blocked kernel's outputs differ from the parent's "
                    "large-filter kernel's (the same taps in the same order)")
        out.append(summ)
        del yk, yp
    # the tiled large-filter kernel, which keeps the calls the phase-blocked
    # one does not take (down > 1: the unfused K11 composition's radial down
    # pass), at a 12x12 filter at down 2 (f32 [4,3,512,512], padding 5),
    # required to take it, beside a depthwise conv2d of stride 2
    k12 = np.kaiser(12, 8.0)
    f12 = torch.from_numpy((np.outer(k12, k12) / np.outer(k12, k12).sum()).astype(np.float32))
    (f2d, upp, down, pad), = fir_passes(f12, down=2, padding=5)
    xx = torch.randn((SG3_BATCH, 3, EQ_RES, EQ_RES), generator=gen, device=device)
    n_tiled = KERNELS["upfirdn2d"].variants.get("large_tiled", 0)
    yk = upfirdn2d_kernel(xx, f2d, upp, down, pad)
    require(KERNELS["upfirdn2d"].variants.get("large_tiled", 0) == n_tiled + 1,
            "K4 12x12 at down 2: not the tiled large-filter kernel")
    yp = upfirdn2d_plain(xx, f2d, upp, down, pad)
    e = max_err(yk, yp)
    check(f"K4 tiled large filter, 12x12 at down 2: {list(xx.shape)} f32 -> "
          f"{yk.shape[-2]}x{yk.shape[-1]}", e, 1e-5 * float(yp.abs().max()))
    w12 = f2d.to(device)[None, None].expand(3, 1, 12, 12).contiguous()

    def library_tiled():
        return torch.nn.functional.conv2d(xx, w12, stride=2, padding=5, groups=3)

    check("  library conv2d (stride 2) vs plain", max_err(library_tiled(), yp),
          1e-5 * float(yp.abs().max()))
    summ = record(e, lambda: upfirdn2d_kernel(xx, f2d, upp, down, pad),
                  lambda: upfirdn2d_plain(xx, f2d, upp, down, pad), nbytes(xx, yk, f2d),
                  yk.numel() * 144 * 2, library_tiled, plain_iters=3)
    summ.update(call="12x12 at down 2", variant="large_tiled", shape=list(xx.shape),
                filter=[12, 12], up=1, down=2, pad=list(pad))
    print(f"    ms {summ['ms']:.6f}  plain_ms {summ['plain_ms']:.6f}  library_ms "
          f"{summ['library_ms']:.6f}  bound_ms {summ['bound_ms']:.6f} ({summ['bound_by']})")
    summ.update(parent_and_sass(
        parent, "upfirdn2d", "upfirdn2d", "upfirdn2d_large_kernel",
        lambda: upfirdn2d_kernel(xx, f2d, upp, down, pad), yk.numel(), "output", None, 1,
        None, adapt=k4_parent_adapt(parent)))
    if "parent" in summ:
        require(summ["parent"]["values_not_bit_equal"] == 0,
                "K4 12x12 at down 2: the tiled kernel's outputs differ from the parent's")
    out.append(summ)
    del yk, yp
    require(len(calls) == 2, f"EQ-T_frac made {len(calls)} K4 calls, not 2")
    for (xx, f2d, upp, down, pad), form in zip(calls, ("row", "column")):
        fh, fw = f2d.shape
        what = f"EQ-T_frac filter2d, {fh}x{fw}"
        n_form = KERNELS["upfirdn2d"].variants.get(form, 0)
        yk = upfirdn2d_kernel(xx, f2d, upp, down, pad)
        require(k4_plan(f2d, upp, down, pad).variant == form
                and KERNELS["upfirdn2d"].variants.get(form, 0) == n_form + 1,
                f"K4 {what}: not the {form} form")
        yp = upfirdn2d_plain(xx, f2d, upp, down, pad)
        e = max_err(yk, yp)
        check(f"K4 {form} form, {what}: {list(xx.shape)} f32 -> {yk.shape[-2]}x{yk.shape[-1]}",
              e, 1e-5 * float(yp.abs().max()))
        library = k4_library(xx, f2d, upp, pad, yk.shape[-2:])
        require(library is not None, f"K4 {what}: no library call")
        check("  library call vs plain", max_err(library(), yp), 1e-5 * float(yp.abs().max()))
        summ = record(e, lambda: upfirdn2d_kernel(xx, f2d, upp, down, pad),
                      lambda: upfirdn2d_plain(xx, f2d, upp, down, pad), nbytes(xx, yk, f2d),
                      yk.numel() * fh * fw * 2, library, plain_iters=3)
        summ.update(call=what, variant=form, shape=list(xx.shape), filter=[fh, fw], up=1,
                    pad=list(pad))
        print(f"    ms {summ['ms']:.6f}  plain_ms {summ['plain_ms']:.6f}  library_ms "
              f"{summ['library_ms']:.6f}  bound_ms {summ['bound_ms']:.6f} ({summ['bound_by']})")
        require(summ["ms"] < summ["library_ms"],
                f"K4 {what}: {summ['ms']} ms, not faster than the library call's "
                f"{summ['library_ms']} ms")
        # the instantiation this call runs (f32, taps unrolled to 8): the row
        # form with 4-wide loads (the input rows are 512 wide) and the
        # staged scalar stores (the output rows 517), 4 outputs a lane; the
        # column form with scalar accesses (517-wide rows), 16 a lane
        kernel, inst, scale = (("upfirdn2d_rows_kernel", "upfirdn2d_rows_kernelIfLi8ELb1ELb0E",
                                1 / 4) if form == "row" else
                               ("upfirdn2d_cols_kernel", "upfirdn2d_cols_kernelIfLi1ELi8ELi16E",
                                1 / 16))
        summ.update(parent_and_sass(
            parent, "upfirdn2d", "upfirdn2d", kernel,
            lambda: upfirdn2d_kernel(xx, f2d, upp, down, pad), yk.numel(), "output",
            {}, scale, None, new_kernel=inst, parent_kernel="upfirdn2d_kernel",
            adapt=k4_parent_adapt(parent)))
        if "parent" in summ:
            require(summ["parent"]["values_not_bit_equal"] == 0,
                    f"K4 {what}: the {form} form's outputs differ from the parent's generic "
                    "kernel's (the same taps in the same order)")
        out.append(summ)
        del yk, yp
    return out


def k8_compare(label, args8, kernel=None, plain=None):
    """K8 vs its plain version on one input (paste_composite_kernel and
    _plain by default; ``kernel`` / ``plain`` another entry's): each binary
    mask may differ on at most 0.1 % of the pixels (a value within rounding
    of its threshold), mask_occ within 1e-5, and mask, paste and image
    within 1e-5 where the binary masks agree. -> (the kernel's outputs, the
    largest error)."""
    import torch

    from panic3d_tpu_torch.models import triplane as tp

    k8 = (kernel or tp.paste_composite_kernel)(*args8)
    p8 = (plain or tp.paste_composite_plain)(*args8)
    agree = torch.ones_like(k8["mask"], dtype=torch.bool)
    n_pix = k8["mask"].numel()
    for key in ("mask_weights", "mask_edges", "mask_dxyz"):
        flips = int((k8[key] != p8[key]).sum())
        print(f"K8 paste_front ({label}) {key}: {flips} of {n_pix} pixels differ, passes "
              f"{float(k8[key].mean()):.4f} (tol {n_pix // 1000})")
        require(flips <= n_pix // 1000, f"K8: {flips} {key} pixels differ")
        agree &= k8[key] == p8[key]
    e8 = max_err(k8["mask_occ"], p8["mask_occ"])
    check("K8 mask_occ (bilinear upsample, f32)", e8, 1e-5)
    print(f"  mask passes {float(k8['mask'].mean()):.4f}")

    def where_agree(key):
        return float((k8[key] - p8[key]).abs()[agree.expand_as(k8[key])].max())

    e8 = max(e8, where_agree("mask"))
    check("K8 mask where the binary masks agree (f32)", where_agree("mask"), 1e-5)
    # the upsampled xyz and the front uv are the plain version's rounded
    # operations, so the projection reads the same texels with the same
    # weights
    for key in ("paste", "image"):
        e8 = max(e8, where_agree(key))
        check(f"K8 {key} where the masks agree (f32, the same rounded operations)",
              where_agree(key), 1e-5)
    return k8, e8


def paste_chain(image, front, weights, xyz, vol, rays, bw, offset_occ, seg_len, thresh_occ,
                thresh_weight, thresh_edges, thresh_dxyz, fwmask=None):
    """The grid occlusion's path before K8 took it in (paste_front on the
    card until then): K7b's sampler at the render's surface points, the
    threshold and the discrepancy in torch, then K8's map entry. Same
    contract as triplane.py:paste_composite_occ_kernel."""
    import torch

    from panic3d_tpu_torch.models import triplane as tp

    occ = tp.front_occlusion_grid(vol, xyz, offset_occ, seg_len)
    occ_bin = (occ < thresh_occ).to(torch.float32)
    dxyz = tp.TriPlaneGenerator._get_xyz_discrepancy(xyz, rays)
    return tp.paste_composite_kernel(image, front, weights, xyz, occ_bin, dxyz, bw,
                                     thresh_weight, thresh_edges, thresh_dxyz, fwmask)


def chain_libs(parent):
    """The parent's K7b and K8 entry points, where --parent holds their
    sources: {entry point: library}."""
    return {name: parent[stem][0] for name, stem in (("occlusion_sample", "front_occlusion"),
                                                     ("paste_front", "paste_front"))
            if stem in parent}


class chained_paste:
    """Within the block paste_front's grid occlusion runs paste_chain, with
    the parent's kernels where ``parent`` holds them."""

    def __init__(self, parent):
        self.swap = parent_entries(chain_libs(parent))

    def __enter__(self):
        from panic3d_tpu_torch.models import triplane as tp

        self.fused = tp.paste_composite_occ_kernel
        tp.paste_composite_occ_kernel = paste_chain
        self.swap.__enter__()

    def __exit__(self, *exc):
        from panic3d_tpu_torch.models import triplane as tp

        self.swap.__exit__(*exc)
        tp.paste_composite_occ_kernel = self.fused


# the device launches of cuDNN, cuBLAS(Lt) and CUTLASS (conv and matmul
# kernels, their layout transposes, split-K reductions and memsets) and of
# copies, by name
LIBRARY_KERNELS = re.compile(r"cudnn|cublas|xmma|cutlass|nvjet|gemm|splitK|getrf|laswp|trsm|"
                             r"Memset|Memcpy")


def trace_counts(fn, runs: int = 1) -> dict:
    """``runs`` calls of fn after a warm-up, under one torch.profiler
    window: a call's device kernels and copies and their device time, of
    them the libraries' (cuDNN's, cuBLAS's and their memsets and copies,
    whose number moves from call to call with the algorithms the libraries
    pick), its host-side ops, and the device's busy time and the span
    (busy_span) over the window, each divided by ``runs``; and the distinct
    names of the window's device launches (their first 120 characters)."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    with tempfile.NamedTemporaryFile(suffix=".json", dir=BUILD_TMP) as f:
        prof.export_chrome_trace(f.name)
        with open(f.name) as g:
            trace = json.load(g)
    dev = [e for e in trace["traceEvents"] if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    require(dev, "trace_counts: the profiler recorded no device activity")
    busy, span, n_dev, n_ops = busy_span(trace)
    lib = sum(bool(LIBRARY_KERNELS.search(e.get("name", ""))) for e in dev)
    by_name = {}
    for e in dev:
        k = e.get("name", "")[:60]
        by_name[k] = by_name.get(k, 0.0) + e["dur"] / 1e3 / runs
    return {"device_launches": n_dev / runs, "library_launches": lib / runs,
            "device_us": sum(e["dur"] for e in dev) / runs, "host_ops": n_ops / runs,
            "busy_ms": busy / runs, "span_ms": span / runs,
            "names": list(dict.fromkeys(e.get("name", "")[:120] for e in dev)),
            "top_ms": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8])}


def paste_chain_compare(parent, args_f, out_f, label, timed=True):
    """K8's grid-occlusion entry against the chain it replaces (paste_chain;
    with --parent the parent's K7b and K8) on the same inputs: the values
    that differ, counted apart where mask_dxyz flips (the discrepancy's
    norm, rounded by torch in its own order, on the other side of
    thresh_dxyz) and required equal elsewhere; with ``timed``, device times
    in the order chain / fused / fused / chain and the device launches and
    time of a call of each (trace_counts). -> {label: ...}."""
    import torch

    from panic3d_tpu_torch.models import triplane as tp

    swap = parent_entries(chain_libs(parent))

    def chain():
        with swap:
            return paste_chain(*args_f)

    def fused():
        return tp.paste_composite_occ_kernel(*args_f)

    got = chain()
    flips = got["mask_dxyz"] != out_f["mask_dxyz"]
    n_pix = flips.numel()
    keys = [k for k in got if k != "mask_frontweight"]
    differ = {k: int((got[k] != out_f[k]).sum()) for k in keys}
    elsewhere = sum(int((got[k] != out_f[k])[~flips.expand_as(got[k])].sum()) for k in keys)
    whose = "the parent's" if chain_libs(parent) else "this tree's"
    print(f"K8 grid occlusion entry vs {whose} K7b -> glue -> K8 chain ({label}): "
          f"mask_dxyz flips {int(flips.sum())} of {n_pix}; values that differ {differ}; "
          f"where mask_dxyz agrees {elsewhere}")
    require(elsewhere == 0 and int(flips.sum()) <= n_pix // 1000,
            "K8 grid occlusion entry: outputs differ from the chain it replaces")
    got = {"whose": whose, "mask_dxyz_flips": int(flips.sum()), "values_not_bit_equal": differ}
    if not timed:
        return {label: got}
    c1 = cuda_ms(chain)
    f1, f2 = cuda_ms(fused), cuda_ms(fused)
    c2 = cuda_ms(chain)
    calls = {"chain": trace_counts(chain, runs=10), "fused": trace_counts(fused, runs=10)}
    print(f"  chain / fused / fused / chain {c1:.6f} / {f1:.6f} / {f2:.6f} / {c2:.6f} ms; "
          + "; ".join(f"{k}: {v['device_launches']:g} device launches, {v['device_us']:.3f} us, "
                      f"{v['host_ops']:g} host ops ({', '.join(v['names'])})"
                      for k, v in calls.items()))
    return {label: dict(got, ms_chain_fused_fused_chain=[c1, f1, f2, c2], per_call=calls)}


PARENT_SOURCES = {}   # build_parent: stem -> the parent's source it built


def build_parent(parent_dir):
    """The parent commit's sources of the kernels this tree redesigned
    (``--parent DIR``: DIR/<stem>.cu, e.g. written by ``git show
    <parent>:panic3d_tpu_torch/csrc/ess.cu``), built with the tree's nvcc
    flags into build/parent/ -> {stem: (ctypes library, .so path)}; {}
    without DIR. A header the parent's sources include is taken from DIR
    where DIR holds it (a quoted include looks beside the source first),
    else from this tree's csrc/."""
    import ctypes
    from pathlib import Path

    from panic3d_tpu_torch.kernels import build

    if not parent_dir:
        return {}
    PARENT_SOURCES.clear()
    out_dir = Path(__file__).resolve().parent / "build" / "parent"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {}
    for src in sorted(Path(parent_dir).glob("*.cu")):
        so = out_dir / f"{src.stem}.so"
        proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC}", str(src),
                               "-o", str(so)], capture_output=True, text=True, timeout=600)
        require(proc.returncode == 0, f"parent {src.name} failed to build:\n{proc.stderr}")
        libs[src.stem] = (ctypes.CDLL(str(so)), so)
        PARENT_SOURCES[src.stem] = src
    print(f"parent kernels built from {parent_dir}: {sorted(libs)}")
    return libs


class parent_entries:
    """Within the block, the kernel wrappers launch the entry points named
    in ``libs`` ({entry point: the parent's ctypes library}) from the
    parent's libraries in place of this tree's, with the same arguments; or,
    where the value is (library, adapt), with ``adapt(argtypes, args)`` ->
    the parent's (argtypes, args) (an entry point whose arguments changed)."""

    def __init__(self, libs: dict):
        self.libs = libs

    def __enter__(self):
        import ctypes

        from panic3d_tpu_torch.kernels import build

        self.launch = launch = build.launch

        def parent_launch(name, argtypes, *args):
            if name not in self.libs:
                return launch(name, argtypes, *args)
            lib, adapt = (self.libs[name] if isinstance(self.libs[name], tuple)
                          else (self.libs[name], None))
            if adapt is not None:
                argtypes, args = adapt(argtypes, args)
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
            rc = fn(*args)
            require(rc == 0, f"parent {name}: CUDA error {rc}")

        build.launch = parent_launch

    def __exit__(self, *exc):
        from panic3d_tpu_torch.kernels import build

        build.launch = self.launch


def sass_listing(so, kernel: str):
    """[(address, instruction)] of ``kernel``'s SASS in the library ``so``
    (cuobjdump -sass), NOPs left out; None without cuobjdump or the kernel."""
    import os
    import re
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.isfile(tool):
        return None
    text = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    body = next((f for f in re.split(r"\n\s*Function : ", text)[1:]
                 if kernel in f.split("\n", 1)[0]), None)
    if body is None:
        return None
    return [(int(m.group(1), 16), m.group(2).strip()) for m in
            re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)
            if not m.group(2).strip().startswith("NOP")]


def sass_loops(ins):
    """The loops of a SASS listing: spans from a backward branch's target
    to the branch -> [(first address, last address, instructions)]."""
    import re

    loops = []
    for addr, text_ in ins:
        m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", text_)
        if m and int(m.group(1), 16) < addr:
            lo = int(m.group(1), 16)
            loops.append((lo, addr, [o for a, o in ins if lo <= a <= addr]))
    return loops


def sass_per_thread(so, kernel: str, work: dict):
    """A thread's SASS instructions, estimated from the static listing of
    the kernel's body (up to its first subroutine: slow paths called out
    of line, such as an IEEE division's, are not counted): the
    instructions outside loops once each (remainder loops and untaken
    branches included), and the loop that holds the most of the marker
    instruction ``op`` of ``work`` (the main, unrolled one) run
    work[op] / (markers in it) times, work[op] being how often the thread
    executes ``op`` in loops. -> dict, or None without cuobjdump."""
    import re

    ins = sass_listing(so, kernel)
    if ins is None:
        return None
    calls = [int(m.group(1), 16) for _, o in ins
             if (m := re.search(r"\bCALL\.REL\S*\s+(0x[0-9a-f]+)", o))]
    body = [(a, o) for a, o in ins if not calls or a < min(calls)]
    loops, dyn, used = sass_loops(body), float(len(body)), []
    for op, n in work.items():
        cands = [(sum(bool(re.search(rf"(^|\s){op}\b", o)) for o in span), -len(span), lo,
                  hi, span)
                 for lo, hi, span in loops if (lo, hi) not in used]
        cands = [c for c in cands if c[0]]
        if not cands:
            continue
        marks, _, lo, hi, span = max(cands)
        used.append((lo, hi))
        dyn += len(span) * (n / marks - 1)
    return {"static": len(body), "out_of_line": len(ins) - len(body), "loops": len(loops),
            "per_thread": dyn}


def kernel_device_us(fn, kernels, runs: int = 20):
    """The device time of the launches of ``kernels`` (a name, or a tuple of
    names: those of one entry point) in a call of fn, from torch.profiler's
    CUDA activity (the kernels alone: no events, no other launch of fn),
    summed over a call and averaged over ``runs`` calls, in microseconds;
    None where the profiler records no such kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    names = (kernels,) if isinstance(kernels, str) else tuple(kernels)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if any(k in e.key for k in names)]
    total = sum(getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
                for e in hits)
    return total / runs if hits else None


def parent_and_sass(parent, stem, name, kernel, fn, items, unit, new_work, new_scale,
                    parent_work, new_kernel=None, parent_kernel=None, profiled=None,
                    parent_profiled=None, adapt=None):
    """This tree's kernel against the parent's (``--parent``): the outputs
    compared bit for bit, then device times in the order parent / this /
    this / parent in one process; and each one's SASS instructions a
    ``unit`` (a ray, a pixel, an output) with the issue ceiling they give: a
    thread's instructions x ``new_scale`` (the lanes an item takes over
    the items a thread takes) for this tree's kernel (``new_kernel``, the
    instantiation the path runs, else ``kernel``), x 1 for the parent's
    one thread an item (``parent_kernel``, else ``kernel``; ``parent_work``
    None: not counted). ``profiled`` / ``parent_profiled``: the kernels
    of the entry point that torch.profiler times alone (default the
    kernel's name). The parent's entry point takes this tree's arguments,
    or ``adapt``'s (parent_entries). -> {"sass": ..., "parent": ...}."""
    import torch

    from panic3d_tpu_torch.kernels import build

    parent_kernel = parent_kernel or kernel
    out = {}
    mine = (sass_per_thread(build.build(stem), new_kernel or kernel, new_work)
            if new_work is not None else None)
    if mine:
        mine["per_" + unit] = mine["per_thread"] * new_scale
        mine["ceiling_ms"] = items * mine["per_" + unit] / ISSUE_PER_S * 1e3
    theirs = None
    if stem in parent:
        lib, so = parent[stem]
        swap = {name: lib if adapt is None else (lib, adapt)}
        if parent_work is not None:
            theirs = sass_per_thread(so, parent_kernel, parent_work)
        if theirs:
            theirs["per_" + unit] = theirs["per_thread"]
            theirs["ceiling_ms"] = items * theirs["per_" + unit] / ISSUE_PER_S * 1e3
        got = fn()
        with parent_entries(swap):
            want = fn()
        if torch.is_tensor(got):
            got, want = (got,), (want,)
        pairs = list(zip(got, want)) if isinstance(got, tuple) else [
            (got[k], want[k]) for k in got]
        differ = sum(int((a != b).sum()) for a, b in pairs)
        with parent_entries(swap):
            p1 = cuda_ms(fn)
        n1, n2 = cuda_ms(fn), cuda_ms(fn)
        with parent_entries(swap):
            p2 = cuda_ms(fn)
        with parent_entries(swap):
            us_parent = kernel_device_us(fn, parent_profiled or parent_kernel)
        out["parent"] = {"ms_parent_this_this_parent": [p1, n1, n2, p2],
                         "kernel_us_profiler": us_parent,
                         "values_not_bit_equal": differ,
                         "values": sum(a.numel() for a, _ in pairs)}
        print(f"  {kernel}: parent / this / this / parent {p1:.6f} / {n1:.6f} / {n2:.6f} / "
              f"{p2:.6f} ms; outputs not equal bit for bit to the parent's: {differ} of "
              f"{out['parent']['values']}; the parent's kernel alone (torch.profiler) "
              f"{us_parent} us")
    else:
        print(f"  {kernel}: parent not given (--parent), not timed against it")
    for who, sm in (("this tree", mine), ("parent", theirs)):
        if sm:
            print(f"  {kernel} SASS ({who}): {sm['static']} static instructions "
                  f"(+{sm['out_of_line']} out of line), {sm['loops']} loops; "
                  f"~{sm['per_' + unit]:.1f} lane instructions a {unit}; "
                  f"issue ceiling {sm['ceiling_ms']:.6f} ms")
        elif who == "this tree" and new_work is not None:
            print(f"  {kernel} SASS: not measured (no cuobjdump, or the kernel not found)")
    out["sass"] = {"this": mine, "parent": theirs}
    out["kernel_us_profiler"] = kernel_device_us(fn, profiled or kernel)
    print(f"  {kernel} alone (torch.profiler, mean of 20 calls): "
          f"{out['kernel_us_profiler']} us")
    return out


def ess_paste_kernel_checks(G, x, device, parent):
    """K6, K7, K8 and K12 vs their plain versions on the card: K6 and K7 on
    the planes of the seeded flagship (bench.py's inputs), K7's sampler and
    K8 on its ESS render, K12 at the Pallas probe's shapes.
    -> {name: summary}."""
    import torch

    from panic3d_tpu_torch.eval.generate import INFERENCE_OPTS
    from panic3d_tpu_torch.models import triplane as tp
    from panic3d_tpu_torch.models.volumetric import lattice as vlat
    from panic3d_tpu_torch.models.volumetric import renderer as vr
    from panic3d_tpu_torch.ops.gather_dot import gather_dot_kernel, gather_dot_plain

    out = {}
    rk, bw = G.rk, G.rk["box_warp"]
    dec = G._decoder()
    filt = vr.DensityFilters(x["triplane_crop"], x["cull_clouds"], None)
    axes = vr.generate_plane_axes(rk["use_triplane"])
    ref = G.f(x)                                       # ESS on, paste off
    planes = ref["triplane"].float()
    N = planes.shape[0]
    ess = rk["ess"]
    G_, ss = ess["grid"], ess.get("supersample", 2)
    C = planes.shape[2]
    mlp_flops = 2 * (C * 64 + 64) + 3 * C             # sigma-only decode of one point

    # K6 occupancy: differing cells counted apart (a sigma within f32
    # rounding of the cull or occupancy threshold may fall either side)
    terms = vlat.lattice_features(planes, axes, (G_ * ss,) * 3, bw)
    args6 = (terms, dec, bw, G_, ss, ess["thresh"], filt)
    occ_k = vr.ess_occupancy_kernel(*args6)
    occ_p = vr.ess_occupancy_plain(*args6)
    differ = int((occ_k != occ_p).sum())
    print(f"K6 ess_occupancy: {N} x {G_ * ss}^3 lattice -> {G_}^3, occupied "
          f"{float(occ_k.mean()):.4f}; cells that differ: {differ} of {occ_k.numel()} "
          f"(tol {occ_k.numel() // 10000})")
    require(differ <= occ_k.numel() // 10000, f"K6: {differ} occupancy cells differ")
    # the work of the factored decode (csrc/ess.cu): the factor launch's
    # rows (C FMAs a hidden unit); per point the crop keeps, 2 adds, 64
    # softplus (4 f32 operations and 2 SFU ones: ex2, lg2) and net2's FMA a
    # hidden unit, the filters and the threshold (~40); the cropped points
    # are not decoded. (The bound before PR 12: every point decoded in full,
    # C x 64 + 64 FMAs and the plane mean.)
    Gs = G_ * ss
    kept6 = int((~vr.triplane_crop_mask(vlat.lattice_world_coords((Gs,) * 3, bw, device),
                                        x["triplane_crop"], bw)).sum()) * N
    rows6 = sum(t[0].shape[0] * t[0].shape[1] * t[0].shape[2] for t in terms)
    out["ess_occupancy"] = record(
        float(differ), lambda: vr.ess_occupancy_kernel(*args6),
        lambda: vr.ess_occupancy_plain(*args6),
        nbytes(*(t[0] for t in terms), occ_k),
        rows6 * C * 64 * 2 + kept6 * (64 * (2 + 4 + 2) + 40), sfu_ops=kept6 * 64 * 2)
    out["ess_occupancy"].update(
        points=N * Gs ** 3, points_decoded=kept6,
        bound_ms_before=bound(nbytes(*(t[0] for t in terms), occ_k),
                              N * Gs ** 3 * mlp_flops)[0])
    print(f"  {kept6} of {N * Gs ** 3} points kept by the crop and decoded; bound "
          f"{out['ess_occupancy']['bound_ms']:.6f} ms ({out['ess_occupancy']['bound_by']}; "
          f"before PR 12's recount {out['ess_occupancy']['bound_ms_before']:.6f}, ops)")
    out["ess_occupancy"].update(parent_and_sass(
        parent, "ess", "ess_occupancy", "ess_occupancy_kernel",
        lambda: vr.ess_occupancy_kernel(*args6), N * Gs ** 3, "point", None, 1, None,
        profiled=("factor_terms_kernel", "ess_occupancy_kernel", "dilate3_kernel"),
        parent_profiled=("ess_occupancy_kernel", "dilate3_kernel")))

    # K6 narrowing, fed the same occupancy
    occ_out = (vr.zero_feature_density(planes, dec, filt.cull_clouds, None)
               > ess["thresh"]).float()
    ro, rd, rays_img = flagship_rays(x, device)
    S = rk["depth_resolution"]
    args6b = (occ_k, occ_out, ro, rd, rk["ray_start"], rk["ray_end"], bw, rk, S)
    nk, npl = vr.ess_narrow_kernel(*args6b), vr.ess_narrow_plain(*args6b)
    errs = [max_err(a, b) for a, b in zip(nk, npl)]
    for label, e in zip(("t0", "t1", "coarse depths"), errs):
        check(f"K6 ess_narrow {label} (f32, the same rounded operations)", e, 1e-6)
    print(f"  values not equal bit for bit to the plain version's: "
          f"{sum(int((a != b).sum()) for a, b in zip(nk, npl))} of "
          f"{sum(a.numel() for a in nk)}")
    span = float((nk[1] - nk[0]).mean())
    print(f"  {ro.shape[0]} x {ro.shape[1]} rays, {ess['taps']} taps; mean narrowed span "
          f"{span:.4f} of {rk['ray_end'] - rk['ray_start']}")
    out["ess_narrow"] = record(
        max(errs), lambda: vr.ess_narrow_kernel(*args6b), lambda: vr.ess_narrow_plain(*args6b),
        nbytes(occ_k, ro, rd, *nk), ro.shape[0] * ro.shape[1] * (ess["taps"] * 20 + S * 5))
    # the edge cases: a partial chunk of taps (K = 37) with S = 2, on the
    # occupancy max-pooled to 16^3 (37 taps cover the interval at that
    # grid), and one grid shared by both views (batch stride 0, the
    # turntable's form)
    occ16 = torch.nn.functional.max_pool3d(occ_k, 2).contiguous()
    cases = {"K=37, S=2, 16^3 grid": (occ16, dict(rk, ess=dict(ess, taps=37)), 2),
             "stride-0 occupancy": (occ_k[:1].expand_as(occ_k), rk, S)}
    edge = {}
    for label, (occ_c, rk_c, S_c) in cases.items():
        args_c = (occ_c, occ_out, ro, rd, rk["ray_start"], rk["ray_end"], bw, rk_c, S_c)
        kc, pc = vr.ess_narrow_kernel(*args_c), vr.ess_narrow_plain(*args_c)
        e = max(max_err(a, b) for a, b in zip(kc, pc))
        check(f"K6 ess_narrow, {label}: t0, t1, depths {tuple(kc[2].shape)}", e, 1e-6)
        edge[label] = e
    out["ess_narrow"]["edge_cases"] = edge
    out["ess_narrow"].update(parent_and_sass(
        parent, "ess", "ess_narrow", "ess_narrow_kernel", lambda: vr.ess_narrow_kernel(*args6b),
        ro.shape[0] * ro.shape[1], "ray",
        new_work={"LDG": -(-ess["taps"] // 32), "STG": -(-S // 32)}, new_scale=32,
        parent_work={"LDG": ess["taps"], "STG": S},
        new_kernel="ess_narrow_kernelILb0ELb0E"))   # the eval form: fixed bounds, no jitter

    # K3 at the ESS paths' 48+48: the narrowed coarse depths, and the
    # coarse sigmas K1 decodes there (the render's planes and dtype)
    planes_cl = ref["triplane"].to(vr.RENDER_DTYPES[rk.get("render_dtype", "bfloat16")])
    planes_cl = planes_cl.permute(0, 1, 3, 4, 2).contiguous()
    d_c = nk[2].contiguous()
    x_c = (ro[:, :, None] + d_c * rd[:, :, None]).reshape(N, -1, 3).contiguous()
    _, sig_c = vr.triplane_decode_kernel(planes_cl, x_c, dec, bw, axes, filt)
    out["importance_sample_ess"] = k3_check(d_c, sig_c.reshape(d_c.shape).contiguous(),
                                            rk["depth_resolution_importance"])[1]

    # K7 volume: the 256-long f32 suffix sum in another order, the first
    # layer factored through the plane sum; a cull decision that flips
    # changes a whole column below it, so columns that differ beyond the
    # tolerance are counted apart
    grid = tuple(rk.get("occ_grid", (128, 128, 256)))
    terms7 = vlat.lattice_features(planes, axes, grid, bw)
    args7 = (terms7, dec, bw, grid, filt)
    A_k, A_p = vlat.occlusion_volume_kernel(*args7), vlat.occlusion_volume_plain(*args7)
    tol7 = 1e-5 * float(A_p.abs().max())
    col_err = (A_k - A_p).abs().amax(-1)
    bad = int((col_err > tol7).sum())
    print(f"K7 occlusion_volume: {N} x {grid} lattice; columns beyond tol: {bad} of "
          f"{col_err.numel()} (tol {col_err.numel() // 10000})")
    require(bad <= col_err.numel() // 10000, f"K7: {bad} columns differ")
    e7 = float(col_err[col_err <= tol7].max())
    check("A (f32; 1e-5 x max|A|, scan order)", e7, tol7)
    # the crop's cells are not decoded: where no kept cell lies at or above
    # a cell (a cropped column, or above the box) A is exactly the plain
    # version's; below the box the density is exactly 0, so A stays constant
    kept = ~vr.triplane_crop_mask(vlat.lattice_world_coords(grid, bw, device),
                                  x["triplane_crop"], bw)[..., 0]
    above = torch.flip(torch.cumsum(torch.flip(kept.int(), (2,)), 2), (2,))
    exact = (above == 0).expand_as(A_k)
    below = (~kept & (above > 0)).expand_as(A_k)
    pairs = below[..., :-1] & below[..., 1:]
    n_exact = int((A_k != A_p)[exact].sum())
    n_step = int((A_k[..., :-1] != A_k[..., 1:])[pairs].sum())
    n_kept = N * int(kept.sum())
    print(f"  kept by the crop: {n_kept} of {A_k.numel()} cells; cropped cells with no kept cell "
          f"above: {int(exact.sum())}, of them differing from the plain version: {n_exact}; "
          f"cells below the box whose A differs from the cell above: {n_step} of "
          f"{int(pairs.sum())}")
    require(n_exact == 0 and n_step == 0, "K7: a cropped cell was not exact")
    rows = sum(t[0].shape[0] * t[0].shape[1] * t[0].shape[2] for t in terms7)
    # per kept point, counted from the kernel: 64 x (3 adds and the 1/3
    # FMA, softplus's 5 f32 operations and 2 SFU ones, net2's FMA), the
    # density and the cull; per cell the scan; the factored layer's rows
    out["occlusion_volume"] = record(
        e7, lambda: vlat.occlusion_volume_kernel(*args7),
        lambda: vlat.occlusion_volume_plain(*args7), nbytes(*(t[0] for t in terms7), A_k),
        n_kept * (64 * 11 + 40) + A_k.numel() * 4 + rows * C * 64 * 2,
        sfu_ops=n_kept * 64 * 2)
    # its factored first layer moved to lattice_decode.cuh (shared with K6a):
    # the volume must equal the parent's bit for bit
    out["occlusion_volume"].update(parent_and_sass(
        parent, "front_occlusion", "occlusion_volume", "occlusion_volume_kernel",
        lambda: vlat.occlusion_volume_kernel(*args7), A_k.numel(), "cell", None, 1, None,
        profiled=("factor_terms_kernel", "occlusion_volume_kernel"),
        parent_profiled=("factor_terms_kernel", "occlusion_volume_kernel")))
    if "parent" in out["occlusion_volume"]:
        require(out["occlusion_volume"]["parent"]["values_not_bit_equal"] == 0,
                "K7a: the volume differs from the parent's")

    # K7 sampler on the render's surface points, fed the same volume
    vol = G.front_occlusion_volume(ref["triplane"], x["triplane_crop"], x["cull_clouds"])
    p = ref["image_xyz"] * torch.tensor([-1.0, 1.0, -1.0], device=device)[None, :, None, None]
    pts = p.reshape(N, 3, -1).transpose(1, 2).contiguous()
    seg = float(rk["ray_end"]) - float(rk["ray_start"])
    args7b = (vol["A"], vol["density0"], pts, bw, 0.01, seg)
    ok, op = vlat.occlusion_sample_kernel(*args7b), vlat.occlusion_sample_plain(*args7b)
    e = max_err(ok, op)
    check("K7 occlusion_sample (f32, the same rounded operations)", e, 1e-5)
    out["occlusion_sample"] = record(
        e, lambda: vlat.occlusion_sample_kernel(*args7b),
        lambda: vlat.occlusion_sample_plain(*args7b), nbytes(pts, ok) + pts.shape[1] * N * 32,
        pts.shape[1] * N * 40)

    # K8 on the render, and on the render with its denser half made opaque
    # and its surface points put on their rays (so that every mask passes
    # part of the image: the seeded weights are not opaque anywhere)
    pp = INFERENCE_OPTS["paste_params"]
    occ_bin = (ok.transpose(1, 2).reshape(N, 1, 64, 64) < pp["thresh_occ"]).float()
    front = x["cond"]["image_ortho_front"]
    w_op = (ref["image_weights"] * 2).clamp_max(1.0)
    flip = torch.tensor([-1.0, 1.0, -1.0], device=device)[None, :, None, None]
    on_ray = (rays_img["ray_origins"] + ref["image_depth"] * rays_img["ray_directions"]) * flip
    xyz_op = torch.where(w_op > 0.95, on_ray, ref["image_xyz"])
    e8 = 0.0
    for label, wts, xyz in (("render", ref["image_weights"], ref["image_xyz"]),
                            ("opaque variant", w_op, xyz_op)):
        dxyz = G._get_xyz_discrepancy(xyz, rays_img)
        args8 = (ref["image"], front, wts, xyz, occ_bin, dxyz, bw, pp["thresh_weight"],
                 pp["thresh_edges"], pp["thresh_dxyz"])
        k8, e = k8_compare(label, args8)
        e8 = max(e8, e)
        if label == "render":
            args_main, out_main = args8, k8
        else:
            args_opaque = args8
    # partial tiles: the opaque variant pasted at 72^2 (K8's tiles are 8 x 32)
    small = [torch.nn.functional.interpolate(a, size=(72, 72), mode="bilinear",
                                             align_corners=False) for a in args_opaque[:2]]
    e8 = max(e8, k8_compare("opaque variant at 72^2, partial tiles",
                            (*small, *args_opaque[2:]))[1])
    # a side that is not a multiple of 4: the pixel-by-pixel stores
    small = [torch.nn.functional.interpolate(a, size=(70, 70), mode="bilinear",
                                             align_corners=False) for a in args_opaque[:2]]
    e8 = max(e8, k8_compare("opaque variant at 70^2, scalar stores",
                            (*small, *args_opaque[2:]))[1])
    n_pix = out_main["mask"].numel()
    out["paste_front"] = record(
        e8, lambda: tp.paste_composite_kernel(*args_main),
        lambda: tp.paste_composite_plain(*args_main),
        nbytes(*(a for a in args_main if torch.is_tensor(a)))
        + nbytes(*(v for k_, v in out_main.items() if k_ != "mask_frontweight")),
        n_pix * 400)
    out["paste_front"].update(parent_and_sass(
        parent, "paste_front", "paste_front", "paste_front_kernel",
        lambda: tp.paste_composite_kernel(*args_main), n_pix, "pixel",
        new_work={"STG": 2 * front.shape[1]}, new_scale=1 / 4,
        parent_work={"STG": 2 * front.shape[1]}, new_kernel="paste_front_kernelILb1ELb0E"))

    # K8's grid-occlusion entry (paste_front_occ): the volume, the rays and
    # the thresholds in place of the two r^2 maps, on the render and on its
    # opaque variant, against its plain version (the composition of K7b's
    # plain sampler, the threshold, the discrepancy and K8's plain version),
    # and against the chain it replaces (K7b, the torch glue and K8's map
    # entry: with --parent the parent's kernels), whose outputs it equals
    # but where the discrepancy's norm rounds across thresh_dxyz (counted)
    seg = float(rk["ray_end"]) - float(rk["ray_start"])
    # the rays contiguous, as G.f's ortho select (torch.where) gives them
    rays_f = {k: v.contiguous() for k, v in rays_img.items()}
    occ_args = (vol, rays_f, bw, pp["offset_occ"], seg, pp["thresh_occ"],
                pp["thresh_weight"], pp["thresh_edges"], pp["thresh_dxyz"])
    eF = 0.0
    for label, wts, xyz in (("render", ref["image_weights"], ref["image_xyz"]),
                            ("opaque variant", w_op, xyz_op)):
        argsF = (ref["image"], front, wts, xyz, *occ_args)
        kF, e = k8_compare(f"grid occlusion entry, {label}", argsF,
                           tp.paste_composite_occ_kernel, tp.paste_composite_occ_plain)
        eF = max(eF, e)
        if label == "render":
            args_f, out_f = argsF, kF
        else:
            chain_opaque = paste_chain_compare(parent, argsF, kF, "chain_opaque", timed=False)
    out["paste_front_occ"] = record(
        eF, lambda: tp.paste_composite_occ_kernel(*args_f),
        lambda: tp.paste_composite_occ_plain(*args_f),
        # the maps and images K8 reads and writes, and the 8 texels of the
        # volume each render pixel's occlusion reads
        nbytes(*(a for a in args_f[:4] if torch.is_tensor(a)), *rays_f.values())
        + nbytes(*(v for k_, v in out_f.items() if k_ != "mask_frontweight"))
        + ref["image_xyz"][:, 0].numel() * 8 * 4,
        n_pix * 400 + ref["image_xyz"][:, 0].numel() * 120)
    out["paste_front_occ"].update(paste_chain_compare(parent, args_f, out_f, "chain"),
                                  **chain_opaque)
    out["paste_front_occ"].update(parent_and_sass(
        {}, "paste_front", "paste_front_occ", "paste_front_kernel",
        lambda: tp.paste_composite_occ_kernel(*args_f), n_pix, "pixel",
        new_work={"STG": 2 * front.shape[1]}, new_scale=1 / 4, parent_work=None,
        new_kernel="paste_front_kernelILb1ELb1E"))

    # K12 at the Pallas probe's shapes (scripts/bench_pallas_gather.py)
    gen = torch.Generator(device=device).manual_seed(SEED)
    table = torch.randn((4096, 128), generator=gen, device=device)
    w = torch.randn((128, 64), generator=gen, device=device) * 0.1
    idx = torch.randint(0, 4096, (131072,), generator=gen, device=device, dtype=torch.int32)
    gk, gp = gather_dot_kernel(idx, table, w), gather_dot_plain(idx, table, w)
    e = max_err(gk, gp)
    check("K12 gather_dot (f32 dot of 128, summation order)", e, 2e-5)
    # the function needs one row product per distinct index, then the copies
    distinct = int(torch.unique(idx).numel())
    print(f"  {idx.numel()} indices, {distinct} distinct rows")
    out["gather_dot"] = record(
        e, lambda: gather_dot_kernel(idx, table, w), lambda: gather_dot_plain(idx, table, w),
        nbytes(idx, table, w, gk), distinct * w.shape[0] * w.shape[1] * 2)
    return out


def epilogue_kernel_checks(device):
    """K5 vs its plain version on the card, exact: at its largest call (SR
    block0's up=2 conv, bf16 [2,256,256,256]: demodulation, bias, lrelu,
    gain, clamp 256; SR takes no noise), at a backbone f32 call (b16 conv1
    [2,512,16,16] with const noise, times its strength and premultiplied),
    and at the mapping layers' [2,512] f32 bias + lrelu. -> {name: summary}."""
    import torch

    from panic3d_tpu_torch.ops.bias_act import modconv_epilogue_kernel, modconv_epilogue_plain

    gen = torch.Generator(device=device).manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device) * scale

    def lrelu_args(x, clamp, noise=None):
        N, C = x.shape[:2]
        dcoef = torch.rand((N, C), generator=gen, device=device) * 0.1 + 0.05 \
            if x.ndim == 4 else None
        return dict(x=x, dcoef=dcoef, noise=noise, bias=randn(C, scale=0.1), act="lrelu",
                    gain=2 ** 0.5, clamp=clamp,
                    noise_strength=randn(scale=0.1) if noise is not None else None)

    # the SR call: values that reach the clamp (|x * dcoef| up to ~300)
    sr = lrelu_args(randn(BATCH, 256, 256, 256, scale=3000.0).to(torch.bfloat16), 256.0)
    calls = [("SR block0 conv0 bf16 [2,256,256,256]", sr),
             ("b16 conv1 f32 [2,512,16,16], const noise",
              lrelu_args(randn(BATCH, 512, 16, 16, scale=3000.0), 256.0, randn(16, 16))),
             ("b16 conv1 f32 [2,512,16,16], premultiplied noise",
              dict(lrelu_args(randn(BATCH, 512, 16, 16, scale=3000.0), 256.0, randn(16, 16)),
                   noise_strength=None)),
             ("mapping fc f32 [2,512]", lrelu_args(randn(BATCH, 512), None))]
    err = 0.0
    for label, kw in calls:
        e = max_err(modconv_epilogue_kernel(**kw), modconv_epilogue_plain(**kw))
        check(f"K5 modconv_epilogue {label} (the same rounded operations)", e, 0.0)
        err = max(err, e)
    clamped = float((modconv_epilogue_plain(**sr).float().abs() == 256).float().mean())
    print(f"  SR call: {100 * clamped:.2f} % of the outputs at the clamp")
    y = modconv_epilogue_kernel(**sr)
    # per element: demod, bias, the lrelu test and multiply, gain, clamp
    return {"modconv_epilogue": record(
        err, lambda: modconv_epilogue_kernel(**sr), lambda: modconv_epilogue_plain(**sr),
        nbytes(sr["x"], y, sr["dcoef"], sr["bias"]), y.numel() * 7)}


def k5_bound_sum(fn):
    """K5's bound summed over its calls in one run of fn (a spy on
    ops/bias_act.py:modconv_epilogue_kernel; per call the bytes of x, y,
    dcoef, noise and bias, and 7 operations an element, as K5's row)
    -> (calls, bound ms)."""
    import importlib

    mod = importlib.import_module("panic3d_tpu_torch.ops.bias_act")
    real, bounds = mod.modconv_epilogue_kernel, []

    def spy(x, dcoef=None, noise=None, noise_strength=None, bias=None, *rest):
        y = real(x, dcoef, noise, noise_strength, bias, *rest)
        reads = [t for t in (dcoef, noise, bias) if t is not None]
        bounds.append(bound(nbytes(x, y, *reads), y.numel() * 7)[0])
        return y

    mod.modconv_epilogue_kernel = spy
    try:
        fn()
    finally:
        mod.modconv_epilogue_kernel = real
    return len(bounds), sum(bounds)


def mesh_levels(grid):
    """The iso levels of the unfiltered mesh and of its synthetic reference:
    eval generate's LEVEL and LEVEL2 when both lie inside the grid's
    densities (between its 1st and 99th percentiles), else the
    LEVEL_QUANTILES percentiles of the grid (the seeded weights' densities
    may lie above 0.5 everywhere, leaving no surface). -> (level, level2)."""
    import torch

    d = grid.float().flatten()[::8]
    q = torch.quantile(d, torch.tensor([0.01, 0.99, *LEVEL_QUANTILES], device=d.device))
    lo, hi, a, b = (float(v) for v in q)
    if lo < min(LEVEL, LEVEL2) and max(LEVEL, LEVEL2) < hi:
        return LEVEL, LEVEL2
    print(f"  the unfiltered densities span [{lo:.4f}, {hi:.4f}] (1st-99th percentile), "
          f"outside {LEVEL} or {LEVEL2}: levels from the {LEVEL_QUANTILES} percentiles, "
          f"{a:.6f} and {b:.6f}")
    return a, b


def grid_mesh(grid, level):
    """Marching tetrahedra on a density grid on the card -> (verts, faces)
    in index units."""
    from panic3d_tpu_torch.runtime.native_ops import marching_tetrahedra

    return marching_tetrahedra(grid.float().cpu().numpy(), level)


def k9_edge_cases(n=64):
    """K9's edge cases as (verts [3T,3], faces [T,3] int32, points [P,3]):
    random triangles with a zero-length edge, a collinear (n2 == 0) and a
    point triangle among them, and right triangles with power-of-two legs;
    points on their vertices, on their edges, in their prisms, and on the
    right triangles' hypotenuses (beta + gamma exactly 1)."""
    r = np.random.RandomState(SEED)
    a, b, c = (r.randn(n, 3).astype(np.float32) for _ in range(3))
    b[0] = a[0]
    c[1] = a[1] + 0.5 * (b[1] - a[1])
    b[2] = c[2] = a[2]
    s = (2.0 ** r.randint(-4, 5, (n, 1))).astype(np.float32)
    a2 = r.randn(n, 3).astype(np.float32)
    b2 = a2 + s * np.float32([1, 0, 0])
    c2 = a2 + s * np.float32([0, 1, 0])
    u = r.rand(n, 1).astype(np.float32) * 0.5
    v = r.rand(n, 1).astype(np.float32) * 0.5
    nrm = np.cross(b - a, c - a)
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-12)
    fr = (r.randint(1, 8, (n, 1)) / 8).astype(np.float32)
    h = r.randn(n, 1).astype(np.float32)
    pts = [a, b, c, a + u * (b - a), b + u * (c - b), a + u * (b - a) + v * (c - a) + h * nrm,
           a2 + s * np.concatenate([fr, 1 - fr, h], 1)]
    A, B, Cc = (np.concatenate(x) for x in ((a, a2), (b, b2), (c, c2)))
    T = len(A)
    faces = np.stack([np.arange(T), T + np.arange(T), 2 * T + np.arange(T)], 1)
    return (np.concatenate([A, B, Cc]).astype(np.float32), faces.astype(np.int32),
            np.concatenate(pts).astype(np.float32))


def volume_kernel_checks(G, device, parent):
    """K1v and K9 vs their plain versions on the card, on the planes of the
    seeded ESS flagship portrait (batch 1, SEED). K1v on the full 256^3
    grid; its plain version on a slab of 2^20 lattice points (16 x-slices
    through the middle of the box: they cross the crop box and the
    surface). K1 in the geometry path's vertex-colour form, on the f32
    planes at the unfiltered surface's vertex world positions. K9 with
    10,000 points sampled on the unfiltered surface at the reference level
    against the triangles of the unfiltered surface (mesh_levels). With
    ``parent`` (--parent), K1v against the parent's kernel: equal bits,
    timed in turns. -> ({name: summary, plus
    triplane_decode_vertex_colours}, the mesh levels)."""
    import torch

    from panic3d_tpu_torch.eval import mesh_metrics as mm
    from panic3d_tpu_torch.eval import volume as vol
    from panic3d_tpu_torch.models.volumetric import renderer as vr

    out = {}
    rk, bw, N = G.rk, G.rk["box_warp"], MESH_RES
    _, planes = vol.portrait_planes(G, portrait_input(G, device))
    dec, axes = G._decoder(), vr.generate_plane_axes(rk["use_triplane"])
    filt = vr.DensityFilters(**EVAL_FILTERS)
    start = (N // 2 - 8) * N * N
    stop = min(start + 2**20, N**3)
    print(f"K1v volume_density: planes {tuple(planes.shape)} f32, {N}^3 lattice; plain on "
          f"flat indices [{start}, {stop})")

    def slab(grid):
        return grid.flip(0).reshape(-1)[start:stop].float()

    coords = vol.lattice_kernel(N, bw, device)
    e = max_err(coords, vol.create_samples_device(N, bw, 0, N**3, device))
    check(f"K1v lattice coordinates, all {N}^3 (f32 divisions and fmod, exact)", e, 0.0)
    del coords
    # eval generate's filters on the seeded decoder, and on the same decoder
    # with net2's sigma bias raised by SIGMA_RAISE so that voxels survive the
    # cull (it keeps only densities within an ulp or so of 1.0, sigma >~ 17;
    # the seeded sigmas lie around 2-4)
    b1 = dec.b1.clone()
    b1[0] += SIGMA_RAISE
    errs = []
    for label, d in (("seeded", dec), (f"sigma bias +{SIGMA_RAISE}", dec._replace(b1=b1))):
        g32 = vol.density_grid_kernel(planes, d, N, bw, axes, filt, torch.float32)
        p32 = vol.density_grid_plain(planes, d, N, bw, axes, filt, torch.float32,
                                     start=start, stop=stop)
        kept_k, kept_p = slab(g32) > -1e3, p32 > -1e3
        flips = int((kept_k != kept_p).sum())
        agree = kept_k == kept_p
        print(f"  filtered, {label}: {int(kept_k.sum())} of {p32.numel()} slab voxels survive "
              f"the crop and the cull ({int((g32 > -1e3).sum())} of {N**3} in the grid); cull "
              f"decisions that differ: {flips} (counted apart; tol {p32.numel() // 10000})")
        require(flips <= p32.numel() // 10000, f"K1v: {flips} cull decisions differ")
        errs.append(float((slab(g32) - p32).abs()[agree].max()))
        check(f"K1v density, filtered, {label}, f32, where the decisions agree", errs[-1],
              1e-6)
        g16 = vol.density_grid_kernel(planes, d, N, bw, axes, filt, torch.float16)
        p16 = vol.density_grid_plain(planes, d, N, bw, axes, filt, torch.float16,
                                     start=start, stop=stop)
        errs.append(float((slab(g16) - p16.float()).abs()[agree].max()))
        check(f"K1v density, filtered, {label}, f16 grid, where the decisions agree",
              errs[-1], 0.0)
    # without filters the densities span (0, 1); sigma carries the MLP's
    # summation order (K1's tolerance 1e-4) and d density / d sigma <= 1/4
    gu = vol.density_grid_kernel(planes, dec, N, bw, axes, vr.DensityFilters(),
                                 torch.float32)
    pu = vol.density_grid_plain(planes, dec, N, bw, axes, vr.DensityFilters(), torch.float32,
                                start=start, stop=stop)
    eu = max_err(slab(gu), pu)
    check("K1v density, unfiltered, f32 (1e-4 sigma x 1/4)", eu, 2.5e-5)
    # the unfiltered f16 grid, the one the no-filters geometry path meshes:
    # the kernel's f32 densities rounded once to f16, everywhere; against the
    # plain f16 slab, equal where the two f32 densities round to the same
    # f16, else one f16 ulp apart (2^-11 in [0.5, 1)), counted apart
    g16u = vol.density_grid_kernel(planes, dec, N, bw, axes, vr.DensityFilters(),
                                   torch.float16)
    errs.append(max_err(g16u, gu.to(torch.float16)))
    check("K1v density, unfiltered, f16 grid = its f32 grid rounded to f16", errs[-1], 0.0)
    p16u = vol.density_grid_plain(planes, dec, N, bw, axes, vr.DensityFilters(),
                                  torch.float16, start=start, stop=stop)
    same = slab(gu).half() == pu.half()
    d16 = (slab(g16u) - p16u.float()).abs()
    print(f"  unfiltered f16 slab: {int((~same).sum())} of {d16.numel()} voxels whose f32 "
          f"densities round to different f16 values (counted apart)")
    errs.append(float(d16[same].max()))
    check("K1v density, unfiltered, f16 grid vs plain where the f16 roundings agree",
          errs[-1], 0.0)
    check("K1v density, unfiltered, f16 grid vs plain elsewhere (1 f16 ulp below 1.0)",
          float(d16.max()), 2.0**-11)
    del g16u, p16u
    levels = mesh_levels(gu)
    print(f"  unfiltered: {int((pu > levels[0]).sum())} of {pu.numel()} slab voxels above the "
          f"mesh level {levels[0]:.6f}")
    C = planes.shape[2]
    # the crop skip, counted by the kernel on the filtered grid
    stats = torch.zeros(3, dtype=torch.int32, device=device)
    vol.density_grid_kernel(planes, dec, N, bw, axes, filt, torch.float16, stats=stats)
    BX, BY, BZ = vol.K1V_BRICK
    bricks = -(-N // BX) * -(-N // BY) * -(-N // BZ)
    skipped, cols, outside = (int(v) for v in stats.tolist())
    print(f"  bricks of {BX}x{BY}x{BZ}: {bricks}; skipped by the crop {skipped}; columns skipped "
          f"in the bricks decoded {cols}; planes read outside a window {outside}")
    # the work the function needs: the points the crop keeps (the rest are
    # the constant -1e3). Per kept point: layer 1 on the tensor cores, each
    # product three times (3xTF32, K1's formula); 64 softplus x 2 MUFU
    # operations and the tail's 4 exp/log on the SFU; on the CUDA cores 3
    # planes x C x 6 for the lerps, the plane mean, 64 x (bias, softplus's
    # f32 operations, sigma's multiply-add) and the tail's ~40
    coords = vol.create_samples_device(N, bw, 0, N**3, device)
    n_kept = int((~vr.triplane_crop_mask(coords, filt.triplane_crop, bw)).sum())
    del coords
    print(f"  points kept by the crop: {n_kept} of {N**3}")
    out["volume_density"] = record(
        max(*errs, eu),
        lambda: vol.density_grid_kernel(planes, dec, N, bw, axes, filt, torch.float16),
        lambda: vol.density_grid_plain(planes, dec, N, bw, axes, filt, torch.float16),
        nbytes(planes, g16), n_kept * (3 * C * 6 + C + 64 * 8 + 40), plain_iters=3,
        tf32_flops=n_kept * 3 * 2 * C * 64, sfu_ops=n_kept * (64 * 2 + 4))
    out["volume_density"].update(points_kept=n_kept, bricks=bricks, bricks_skipped=skipped,
                                 columns_skipped=cols, planes_outside_window=outside)
    # K1v's kernel is a form of the brick kernel K10's lattice form
    # shares: its outputs equal the parent's bit for bit
    out["volume_density"].update(parent_and_sass(
        parent, "triplane_decode", "volume_density", "volume_density_kernel",
        lambda: vol.density_grid_kernel(planes, dec, N, bw, axes, filt, torch.float16),
        N**3, "point", None, 1, None))
    if "parent" in out["volume_density"]:
        require(out["volume_density"]["parent"]["values_not_bit_equal"] == 0,
                "K1v: the grid differs from the parent's")
    ms = out["volume_density"]["ms"]
    print(f"  ms {ms:.6f}: {N**3 / ms / 1e6:.3f} G lattice points/s, {n_kept / ms / 1e6:.3f} G "
          f"kept points/s; bound {out['volume_density']['bound_ms']:.6f} ms "
          f"({out['volume_density']['bound_by']})")
    del g32, g16, p32, p16

    # K9 on the unfiltered surfaces (the filtered one may be empty)
    verts, faces = grid_mesh(gu, levels[0])
    v2, f2 = grid_mesh(gu, levels[1])
    require(len(faces) > 0 and len(f2) > 0, "the unfiltered grid has no surface")

    # K1 as the geometry path runs it for the vertex colours: one portrait's
    # f32 planes, the unfiltered mesh's vertex world positions
    # (vol.vertex_world, as extract_mesh), no density filters
    planes_cl = planes.permute(0, 1, 3, 4, 2).contiguous()
    world = torch.from_numpy(vol.vertex_world(verts, N, bw)[None]).to(device)
    nofilt = vr.DensityFilters()
    print(f"K1 triplane_decode, vertex colours: planes {tuple(planes_cl.shape)} f32, "
          f"coords {tuple(world.shape)}")
    rgb_k, sig_k, e1 = check_k1(planes_cl, world, dec, bw, axes, nofilt)
    flops, tf32 = k1_ops(world.shape[1], C)
    out["triplane_decode_vertex_colours"] = dict(coords=list(world.shape), **record(
        e1,
        lambda: vr.triplane_decode_kernel(planes_cl, world, dec, bw, axes, nofilt),
        lambda: vr.triplane_decode_plain(planes_cl, world, dec, bw, axes, nofilt),
        nbytes(planes_cl, world, rgb_k, sig_k), flops, plain_iters=3, tf32_flops=tf32))
    print("  " + ", ".join(f"{k} {v}" for k, v in out["triplane_decode_vertex_colours"].items()))
    del planes_cl, world, rgb_k, sig_k

    print(f"K9 point_mesh_distance: unfiltered surface at {levels[0]:.6f}: {len(verts)} verts, "
          f"{len(faces)} faces; at {levels[1]:.6f}: {len(v2)} verts, {len(f2)} faces")
    pts = torch.from_numpy(mm.sample_points_on_mesh(v2 / N * bw - bw / 2, f2, 10000,
                                                    seed=SEED)).to(device)
    vt = torch.from_numpy(verts / N * bw - bw / 2).to(device)
    ft = torch.from_numpy(faces).to(device)
    dk = mm.point_mesh_distance_sq_kernel(pts, vt, ft)
    dp = mm.point_mesh_distance_sq_plain(pts, vt, ft)
    rel = float(((dk - dp).abs() / dp.clamp_min(1e-30)).max())
    exact = int((dk == dp).sum())
    print(f"  {exact} of {dk.numel()} squared distances exactly equal")
    check("K9 squared distances, relative (the same rounded operations)", rel, 1e-5)
    for t in (0.005, 0.01):
        nk, np_ = int((dk.sqrt() < t).sum()), int((dp.sqrt() < t).sum())
        print(f"  points within {t}: kernel {nk}, plain {np_}")
        require(nk == np_, f"K9: F1 counts at {t} differ")
    # degenerate triangles, and points on vertices, on edges, in prisms and
    # on the hypotenuse of right triangles (beta + gamma exactly 1): exact
    ev, ef, ep = (torch.from_numpy(a).to(device) for a in k9_edge_cases())
    e_k = mm.point_mesh_distance_sq_kernel(ep, ev, ef)
    e_p = mm.point_mesh_distance_sq_plain(ep, ev, ef)
    print(f"  edge cases ({len(ep)} points, {len(ef)} triangles, degenerate ones included): "
          f"{int((e_k == e_p).sum())} of {len(ep)} exactly equal")
    require(torch.equal(e_k, e_p), "K9: an edge case differs from the plain version")
    # ~118 operations per (point, triangle) pair, the plain version's count
    # (the kernel evaluates every pair; FMA-free, so it issues at half the
    # f32 rate this divides by)
    pairs = pts.shape[0] * ft.shape[0]
    out["point_mesh_distance"] = record(
        max_err(dk, dp), lambda: mm.point_mesh_distance_sq_kernel(pts, vt, ft),
        lambda: mm.point_mesh_distance_sq_plain(pts, vt, ft), nbytes(pts, vt, ft, dk),
        pairs * 118, plain_iters=2)
    out["point_mesh_distance"].update(pairs=pairs, exactly_equal=exact)
    ms = out["point_mesh_distance"]["ms"]
    print(f"  ms {ms:.6f}: {pairs / ms / 1e9:.3f} T pairs/s; bound "
          f"{out['point_mesh_distance']['bound_ms']:.6f} ms")
    return out, levels


def grad_guard_checks(device):
    """F8: under grad mode every kernel wrapper without a backward form
    refuses a CUDA input that requires grad before it launches, and the seven
    with one (K1, K2, K4, K5, K8, K10, K14) refuse the inputs they give no
    gradient (K1's and K10's coordinates, K2's depths, K4's filter, K5's
    noise, K8's front image, K14's grid); no launch is counted. Then G.f
    of the tiny config on the card back-propagates through the backward
    forms as the CPU's plain version does (tiny_backward_check): at the
    defaults, with training's paste and at depth 2."""
    import torch

    from panic3d_tpu_torch.eval import gltf
    from panic3d_tpu_torch.eval import mesh_metrics as mm
    from panic3d_tpu_torch.eval import volume as vol
    from panic3d_tpu_torch.kernels import KERNELS, launch_counts, reset_launch_counts
    from panic3d_tpu_torch.models import triplane as tp
    from panic3d_tpu_torch.models.volumetric import lattice as vlat
    from panic3d_tpu_torch.models.volumetric import renderer as vr
    from panic3d_tpu_torch.ops.bias_act import modconv_epilogue_kernel
    from panic3d_tpu_torch.ops.filtered_lrelu import filtered_lrelu_kernel
    from panic3d_tpu_torch.ops.gather_dot import gather_dot_kernel
    from panic3d_tpu_torch.ops.grid_sample import grid_sample_2d_kernel
    from panic3d_tpu_torch.ops.upfirdn2d import upfirdn2d_kernel

    def t(*shape, grad=False, dtype=torch.float32):
        return torch.zeros(shape, device=device, dtype=dtype).requires_grad_(grad)

    def dec(grad=False):   # a parameter of the decoder requires grad
        return vr.Decoder(t(64, 32, grad=grad), t(64), t(33, 64), t(33))

    axes, nof = vr.generate_plane_axes(True), vr.DensityFilters()
    i32 = dict(dtype=torch.int32)
    calls = {
        "volume_density": lambda: vol.density_grid_kernel(t(1, 3, 32, 8, 8, grad=True), dec(),
                                                          16, 0.7, axes, nof),
        "importance_sample": lambda: vr.importance_sample_kernel(
            t(1, 4, 8, 1), t(1, 4, 8, 1, grad=True), 8),
        "ess_occupancy": lambda: vr.ess_occupancy_kernel(
            [(t(1, 4, 4, 32), 0, 1)] * 3, dec(True), 0.7, 2, 2, 0.01, nof),
        "ess_narrow": lambda: vr.ess_narrow_kernel(
            t(1, 2, 2, 2), t(1), t(1, 4, 3, grad=True), t(1, 4, 3), 0.5, 1.5, 0.7, {"ess": {}}, 8),
        "occlusion_volume": lambda: vlat.occlusion_volume_kernel(
            [(t(1, 4, 4, 32), 0, 1)] * 3, dec(True), 0.7, (4, 4, 4), nof),
        "occlusion_sample": lambda: vlat.occlusion_sample_kernel(
            t(1, 4, 4, 4, grad=True), t(1), t(1, 8, 3), 0.7, 0.01, 1.0),
        # K8's front image takes no gradient (its image and xyz do)
        "paste_front": lambda: tp.paste_composite_kernel(
            t(1, 3, 8, 8), t(1, 3, 8, 8, grad=True), t(1, 1, 8, 8), t(1, 3, 8, 8),
            t(1, 1, 8, 8), t(1, 1, 8, 8), 0.7, 0.5, 0.5, 0.5),
        "paste_front_occ": lambda: tp.paste_composite_occ_kernel(
            t(1, 3, 8, 8), t(1, 3, 8, 8, grad=True), t(1, 1, 8, 8), t(1, 3, 8, 8),
            {"A": t(1, 4, 4, 4), "density0": t(1), "box_warp": 0.7},
            {"ray_origins": t(1, 3, 8, 8), "ray_directions": t(1, 3, 8, 8)}, 0.7, 0.01, 1.0,
            0.05, 0.5, 0.5, 0.5),
        "point_mesh_distance": lambda: mm.point_mesh_distance_sq_kernel(
            t(8, 3, grad=True), t(3, 3), t(1, 3, **i32)),
        "winding_number": lambda: gltf.winding_numbers_kernel(
            t(4, 3, grad=True), t(1, 3, dtype=torch.int64), t(2, 3)),
        "gather_dot": lambda: gather_dot_kernel(t(8, **i32), t(8, 16), t(16, 8, grad=True)),
        "filtered_lrelu": lambda: filtered_lrelu_kernel(
            t(1, 2, 8, 8), t(12), t(12), t(2, grad=True), up=2, down=2, padding=[5, 6, 5, 6]),
        # K10's coordinates take no gradient (its volumes and decoder do)
        "triplane_decode_deep": lambda: vr.triplane_decode_deep_kernel(
            t(3, 2, 4, 4, 32), t(1, 8, 3, grad=True), dec(), 0.7, vr.generate_plane_axes(True),
            vr.DensityFilters()),
        "volume_density_deep": lambda: vol.density_grid_deep_kernel(
            t(1, 3, 64, 8, 8, grad=True), dec(), 16, 0.7, vr.generate_plane_axes(True),
            vr.DensityFilters(), 2),
    }
    with_backward = {"triplane_decode", "ray_composite", "upfirdn2d", "modconv_epilogue",
                     "grid_sample_2d", "triplane_decode_grad", "ray_composite_grad",
                     "modconv_epilogue_grad", "grid_sample_2d_grad", "paste_front_grad",
                     "triplane_decode_deep_grad"}
    require(set(calls) | with_backward == set(KERNELS), "F8: a kernel without a grad-mode check")
    # the inputs the backward forms give no gradient
    calls["triplane_decode [coords]"] = lambda: vr.triplane_decode_kernel(
        t(1, 3, 8, 8, 32), t(1, 16, 3, grad=True), dec(), 0.7, axes, nof)
    calls["ray_composite [depths]"] = lambda: vr.ray_composite_kernel(
        t(1, 4, 8, 1, grad=True), t(1, 4, 8, 32), t(1, 4, 8, 1), t(1, 4, 8, 3),
        t(1, 4, 8, 1), t(1, 4, 8, 32), t(1, 4, 8, 1), t(1, 4, 8, 3), True)
    calls["upfirdn2d [filter]"] = lambda: upfirdn2d_kernel(t(1, 4, 8, 8), t(4, 4, grad=True),
                                                           (2, 2), (1, 1), (2, 1, 2, 1))
    calls["grid_sample_2d [grid]"] = lambda: grid_sample_2d_kernel(t(1, 4, 8, 8),
                                                                  t(1, 5, 6, 2, grad=True))
    # the keyed forms: the input each adds requires grad
    calls["importance_sample [u]"] = lambda: vr.importance_sample_kernel(
        t(1, 4, 8, 1), t(1, 4, 8, 1), 8, u=t(4, 8, grad=True))
    calls["modconv_epilogue [per_sample_noise]"] = lambda: modconv_epilogue_kernel(
        t(2, 8, 4, 4), noise=t(2, 1, 4, 4, grad=True))
    calls["ess_narrow [per_ray]"] = lambda: vr.ess_narrow_kernel(
        t(1, 2, 2, 2), t(1), t(1, 4, 3), t(1, 4, 3), t(1, 4, 1, grad=True), t(1, 4, 1), 0.7,
        {"ess": {}}, 8)
    calls["ess_narrow [jitter]"] = lambda: vr.ess_narrow_kernel(
        t(1, 2, 2, 2), t(1), t(1, 4, 3), t(1, 4, 3), 0.5, 1.5, 0.7, {"ess": {}}, 8,
        jitter=t(1, 4, 8, 1, grad=True))
    reset_launch_counts()
    refused = []
    with torch.enable_grad():
        for name, fn in calls.items():
            try:
                fn()
            except RuntimeError as e:
                if "the CUDA kernel has no backward" in str(e):
                    refused.append(name)
                    continue
                raise
    print(f"F8: under grad mode {len(refused)} of {len(calls)} calls refuse an input that "
          f"requires grad ({', '.join(refused)})")
    require(refused == list(calls), f"F8: not refused: {set(calls) - set(refused)}")
    require(sum(launch_counts().values()) == 0, "F8: a kernel launched under grad mode")

    for case in ("default", "paste", "depth 2"):
        tiny_backward_check(device, case)


TINY_GRAD_TOL = 1e-2   # the tiny G.f's gradients, card against CPU, relative L2 a group


def tiny_backward_check(device, case):
    """G.f of the tiny config on the card back-propagates through the
    backward forms, against the plain version on the CPU (f32, the same
    weights and inputs): its render, backbone and superresolution
    parameters get finite gradients within TINY_GRAD_TOL relative L2 a
    group of the CPU's (K1's MLP is 3xTF32 and importance resampling
    amplifies rounding, ROADMAP F2). ``case``: "default"; "paste", with
    training's paste (the grid occlusion on a 16x16x32 lattice, K8's
    paste_front_occ entry and its backward form) at a thresh_weight in the
    widest gap of the CPU's upsampled weights between their 30 % and 70 %
    quantiles (the card's mask must equal the CPU's) and every occlusion
    and discrepancy passed, the decoder's density bias raised 2.5 so that
    most surface points lie in the box (where the front projection is not
    clamped): image_xyz's gradient, channels 0 and 1 only, also within
    TINY_GRAD_TOL; "depth 2", triplane_depth DEEP_DEPTH (K10 and its
    backward form)."""
    import torch

    from panic3d_tpu_torch import configs
    from panic3d_tpu_torch.kernels import launch_counts, reset_launch_counts, variant_counts
    from panic3d_tpu_torch.models import triplane as tp

    rng = np.random.RandomState(SEED)
    x = {"z": rng.randn(1, 64).astype(np.float32), "elevations": np.zeros(1, np.float32),
         "azimuths": np.full(1, 30.0, np.float32),
         "cond": {"image_ortho_front": rng.rand(1, 3, 64, 64).astype(np.float32),
                  "resnet_chonk": rng.randn(1, 16, 8, 8).astype(np.float32)}}
    rk = dict(configs.tiny_kwargs()["rendering_kwargs"], render_dtype="float32")
    rk.update({"paste": dict(occ_grid=(16, 16, 32)),
               "depth 2": dict(triplane_depth=DEEP_DEPTH)}.get(case, {}))
    launched = {"default": ("triplane_decode_grad",),
                "paste": ("triplane_decode_grad", "paste_front_occ", "paste_front_grad"),
                "depth 2": ("triplane_decode_deep_grad",)}[case]
    paste, grads, masks = None, {}, {}
    for dev in (torch.device("cpu"), device):
        G = configs.tiny(device=dev, synthesis_kwargs=dict(channel_base=2048, channel_max=64,
                                                           num_fp16_res=0),
                         rendering_kwargs=rk).init_weights(SEED)
        xd = {k: ({c: torch.from_numpy(a).to(dev) for c, a in v.items()} if k == "cond"
                  else torch.from_numpy(v).to(dev)) for k, v in x.items()}
        if case == "paste":
            with torch.no_grad():
                G.decoder.net[2].bias[0] += 2.5
                if paste is None:   # the threshold from the CPU's render
                    out = G.f(dict(xd))
                    w = tp.upsample_bilinear(out["image_weights"], out["image"].shape[-1])
                    w = w.flatten().sort().values
                    lo, hi = int(0.3 * w.numel()), int(0.7 * w.numel())
                    i = lo + int((w[lo + 1:hi] - w[lo:hi - 1]).argmax())
                    paste = dict(mode="default", thresh_weight=float(w[i] + w[i + 1]) / 2,
                                 thresh_edges=0.02, thresh_occ=2.0, offset_occ=0.01,
                                 thresh_dxyz=1.0, occ_impl="grid")
            xd["paste_params"] = paste
        reset_launch_counts()
        with torch.enable_grad():
            out = G.f(xd)
            loss = out["image"].square().mean() + out["image_raw"].square().mean()
            params = dict(G.named_parameters())
            if paste is not None:
                params["image_xyz"] = out["image_xyz"]
                masks[dev.type] = out["paste"]["mask"].detach().cpu()
            gr = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads[dev.type] = {n: g for n, g in zip(params, gr) if g is not None}
        if dev.type == "cuda":
            counts, k4 = launch_counts(), variant_counts().get("upfirdn2d", {})
    for name in launched + ("ray_composite_grad", "modconv_epilogue_grad"):
        require(counts[name] > 0, f"tiny G.f backward ({case}): {name} not launched")
    require(any(v.startswith("grad_") for v in k4),
            f"tiny G.f backward ({case}): no transposed K4 pass")
    groups = ("decoder.", "backbone.", "superresolution.")
    if paste is not None:
        differ = int((masks["cuda"] != masks["cpu"]).sum())
        passes = float(masks["cpu"].mean())
        print(f"  tiny G.f with paste (thresh_weight {paste['thresh_weight']:.6f}): the mask "
              f"passes {passes:.4f}, {differ} pixels differ card vs CPU")
        require(differ == 0 and 0.05 < passes < 0.95,
                f"tiny G.f backward (paste): mask passes {passes}, {differ} pixels differ")
        g_xyz = grads["cpu"]["image_xyz"]
        require(float(g_xyz[:, :2].abs().max()) > 0 and float(g_xyz[:, 2].abs().max()) == 0,
                "tiny G.f backward (paste): image_xyz's gradient must fill channels 0 and 1")
        groups += ("image_xyz",)
    for group in groups:
        names = [n for n in grads["cpu"] if n.startswith(group)]
        require(names and all(n in grads["cuda"] for n in names),
                f"tiny G.f backward ({case}): {group} has no gradient on the card")
        num = sum(float((grads["cuda"][n].cpu() - grads["cpu"][n]).square().sum()) for n in names)
        den = sum(float(grads["cpu"][n].square().sum()) for n in names)
        check(f"tiny G.f backward ({case}), card vs CPU: {group}* (relative L2)",
              math.sqrt(num / den), TINY_GRAD_TOL)
        require(all(bool(torch.isfinite(grads["cuda"][n]).all()) for n in names),
                f"tiny G.f backward ({case}): non-finite {group} gradient")


def tiny_end_to_end(device, ess_paste: bool, deep: bool = False):
    """Tiny config in f32: the card (kernels) against the CPU (plain); with
    ess_paste, ESS (grid 8, 16 taps) and eval generate's paste_params on a
    small occlusion lattice; with deep, triplane_depth DEEP_DEPTH (K10) and
    eval generate's paste_params with the render occlusion, ESS off."""
    import torch

    from panic3d_tpu_torch import configs
    from panic3d_tpu_torch.eval.generate import INFERENCE_OPTS

    rk = dict(superresolution_module="training.superresolution.SuperresolutionHybrid2X",
              depth_resolution=8, depth_resolution_importance=8, box_warp=0.7,
              ray_start=0.5, ray_end=1.5, white_back=True, use_triplane=True,
              render_dtype="float32")
    if ess_paste:
        rk.update(ess=dict(grid=8, taps=16, thresh=0.01, margin=1.0), occ_grid=(32, 32, 64))
    if deep:
        rk.update(triplane_depth=DEEP_DEPTH)
    G = configs.tiny(synthesis_kwargs=dict(channel_base=2048, channel_max=64, num_fp16_res=0),
                     rendering_kwargs=rk, device="cpu").init_weights(SEED).eval()
    with torch.no_grad():
        G.decoder.net[2].bias[0] += 2.5
    rng = np.random.RandomState(SEED)
    x = {"z": torch.from_numpy(rng.randn(BATCH, G.z_dim).astype(np.float32)),
         "elevations": torch.tensor([0.0, 20.0]), "azimuths": torch.tensor(AZIMUTHS),
         "cond": {"image_ortho_front": torch.from_numpy(rng.rand(BATCH, 3, 64, 64)).float(),
                  "resnet_chonk": torch.from_numpy(rng.randn(BATCH, 16, 8, 8)).float()},
         "triplane_crop": 0.1, "cull_clouds": 0.5}
    if ess_paste:
        x["paste_params"] = INFERENCE_OPTS["paste_params"]
    if deep:
        x["paste_params"] = dict(INFERENCE_OPTS["paste_params"], occ_impl="render")
    with torch.no_grad():
        ref = G.f(x)
        G.to(device)
        xd = dict(x, z=x["z"].to(device), cond={k: v.to(device) for k, v in x["cond"].items()})
        got = G.f(xd)
    what = (f"triplane_depth {DEEP_DEPTH}, render paste" if deep
            else f"ESS and paste {'on' if ess_paste else 'off'}")
    print(f"tiny config, f32, {what}: card (kernels) vs CPU (plain), tol 2e-3 (importance "
          "resampling amplifies f32 rounding)")
    keys = ["triplane", "image_raw", "image_depth", "image_weights", "image_xyz"]
    if deep:
        for k in keys + ["image_prepaste"]:
            check(k, max_err(got[k].cpu(), ref[k]), 2e-3)
        compare_paste(got["paste"], ref["paste"], 2e-3)
        return
    if not ess_paste:
        keys.append("image")
        for k in keys:
            check(k, max_err(got[k].cpu(), ref[k]), 2e-3)
        return
    differ = int((got["_ess_occ"][0].cpu() != ref["_ess_occ"][0]).sum())
    print(f"  occupancy cells that differ: {differ}")
    require(differ == 0, f"tiny: {differ} occupancy cells differ")
    for k in keys + ["image_prepaste"]:
        check(k, max_err(got[k].cpu(), ref[k]), 2e-3)
    compare_paste(got["paste"], ref["paste"], 2e-3)


def compare_paste(got, ref, tol, with_projection=True):
    """Paste outputs against a reference: the binary masks by the pixels
    that differ (at most 1 % of them: each is a threshold of a value that
    carries the render's rounding), the rest where every mask agrees. The
    projected front image is compared only when both sides project the same
    surface points (with_projection): its uv moves ~730 texels per unit of
    xyz, so another precision's xyz reads other texels."""
    import torch

    got = {k: v.to(ref[k].device) for k, v in got.items() if torch.is_tensor(v)}
    agree = torch.ones_like(ref["mask"], dtype=torch.bool)
    n_pix = ref["mask"].numel()
    for k in ("mask_weights", "mask_edges", "mask_dxyz"):
        flips = int((got[k] != ref[k]).sum())
        print(f"  {k}: {flips} of {n_pix} pixels differ; passes {float(ref[k].mean()):.4f}")
        require(flips <= n_pix // 100, f"{k}: {flips} pixels differ")
        agree &= got[k] == ref[k]
    check("mask_occ (bilinear of the binary occlusion)",
          float((got["mask_occ"] - ref["mask_occ"]).abs()[agree].max()), tol)
    for k in ("image", "paste") if with_projection else ("image",):
        check(f"paste {k} where the masks agree",
              float((got[k] - ref[k]).abs()[agree.expand_as(ref[k])].max()), tol)


def bf16_closeness(G, x, out, make_f32):
    """The flagship's default precision (bf16 planes, bf16 backbone blocks
    >= 32^2 and SR) against the same weights pinned to f32, on the card,
    within the JAX package's mixed-precision bounds
    (tests/test_reference_parity.py::test_bf16_close). With paste on, the
    pre-paste image is held to the image bound and the pasted image is
    compared where the paste masks agree."""
    G32 = make_f32(sr_num_fp16_res=0, rendering_kwargs=dict(render_dtype="float32"),
                   synthesis_kwargs=dict(channel_base=32768, channel_max=512, num_fp16_res=0))
    G32.load_state_dict(G.state_dict())
    ref = G32.eval().f(x)
    print("flagship default (bf16) vs f32-pinned, same weights, on the card:")
    image = "image_prepaste" if "paste" in out else "image"
    for k, tol in (("image_raw", 0.05), (image, 0.08), ("image_depth", 0.05)):
        check(k, max_err(out[k], ref[k]), tol)
    if "paste" in out:
        compare_paste(out["paste"], ref["paste"], 0.08, with_projection=False)
    del G32


def count_syncs(fn) -> int:
    """The times one run of fn makes the host wait for the card (torch's
    sync debug mode: a copy from or to pageable host memory, .item(), a
    data-dependent shape)."""
    import warnings

    import torch

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
            torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchronizing" in str(w.message) for w in caught)


def drive(label, fn, n_views, n_runs, card, unit="views", waits=lambda out: 0):
    """Runs fn once to warm up, then n_runs times with the launch counts
    zeroed before and read after, then once more counting its host waits,
    which must be waits(output) (0 on the render paths); prints views/s,
    peak memory, launches (and K4's by variant) and host waits per run.
    -> (last output, launch counts of the n_runs, summary dict)."""
    import torch

    from panic3d_tpu_torch.kernels import launch_counts, reset_launch_counts, variant_counts

    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times = []
    for _ in range(n_runs):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    counts = launch_counts()
    per_run = {k: n / n_runs for k, n in counts.items() if n}
    variants = {k: {v: n / n_runs for v, n in d.items()} for k, d in variant_counts().items()}
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(times)
    syncs = count_syncs(fn)
    print(f"{label}: {n_runs} runs of {n_views} {unit}, median {med * 1e3:.3f} ms/run = "
          f"{n_views / med:.3f} {unit}/s; peak memory {peak / 2**30:.3f} GiB; host waits "
          f"per run {syncs}; launches per run "
          + ", ".join(f"{k}={n:g}" for k, n in per_run.items()) + f"  [{card}]")
    if variants:
        print("  launches per run by variant: " + ", ".join(
            f"{k}.{v}={n:g}" for k, d in variants.items() for v, n in d.items()))
    print("  run ms: " + ", ".join(f"{t * 1e3:.3f}" for t in times))
    want = waits(out)
    require(syncs == want, f"{label}: the host waited for the card {syncs} times in a run, "
                           f"expected {want}")
    return out, counts, {f"{unit}_per_s": n_views / med, "ms_per_run": med * 1e3,
                         "peak_gib": peak / 2**30, "host_waits_per_run": syncs,
                         "launches_per_run": per_run, "variants_per_run": variants}


def geometry_path(G, device, card, levels):
    """The geometry path of eval (generate.py:309-318, measure.py:178-215)
    on one portrait of the ESS flagship (batch 1, SEED), through the
    library entry point: Reconstructor.mesh -> planes -> K1v 256^3 -> one
    copy -> marching tetrahedra -> vertex colours (K1). Once with eval
    generate's filters (the user's path), once without (the random-init
    smoke of generate.py --no-filters) at levels[0]; then geometry_metrics
    (K9) between the unfiltered mesh and a synthetic reference, the same
    portrait's surface at levels[1] placed in the GT heads' cv frame, with
    a full-frame ROI. -> (summaries by path, launch counts of the
    unfiltered mesh and the metrics runs)."""
    import numpy as np

    from panic3d_tpu_torch.api import Reconstructor
    from panic3d_tpu_torch.eval.measure import CV2WORLD, geometry_metrics

    cond1 = portrait_input(G, device)["cond"]
    bw = G.rk["box_warp"]

    def waits(mesh):   # the grid's copy, and the colours' when there are vertices
        return 1 + int(len(mesh["verts"]) > 0)

    out, meshes = {}, {}
    for key, opts, level in (("geometry_eval_filters", EVAL_FILTERS, LEVEL),
                             ("geometry_no_filters", {}, levels[0])):
        rec = Reconstructor(model=G, opts=opts)
        mesh, counts, summ = drive(
            f"geometry path, {'eval filters' if opts else 'no filters'} ({MESH_RES}^3, level "
            f"{level:.6f})", lambda: rec.mesh(cond1, resolution=MESH_RES, level=level), 1,
            MESH_RUNS, card, unit="portraits", waits=waits)
        stages = {}
        rec.mesh(cond1, resolution=MESH_RES, level=level, stages=stages)
        v, f, c = mesh["verts"], mesh["faces"], mesh["colors"]
        require(np.isfinite(v).all() and (f.size == 0 or (f.min() >= 0 and f.max() < len(v)))
                and (c.size == 0 or (c.min() >= 0 and c.max() <= 1)), f"{key}: bad mesh")
        print(f"  {summ['ms_per_run'] / 1e3:.4f} s/portrait; one staged run: "
              + ", ".join(f"{k} {t * 1e3:.3f} ms" for k, t in stages.items())
              + f"; {len(v)} verts, {len(f)} faces")
        if not len(f):
            print("  the mesh is empty: the seeded weights leave no voxel above the cull")
        names = ("modconv_epilogue", "upfirdn2d", "volume_density")
        require_launched(counts, names + (("triplane_decode",) if len(v) else ()), key)
        summ.update(stages_ms={k: t * 1e3 for k, t in stages.items()}, verts=len(v),
                    faces=len(f), level=level)
        out[key], meshes[key] = summ, (mesh, counts)

    mesh, counts_mesh = meshes["geometry_no_filters"]
    ref = Reconstructor(model=G, opts={}).mesh(cond1, resolution=MESH_RES, level=levels[1])
    ref_cv = {"verts": (CV2WORLD[:3, :3] @ (ref["verts"] * np.asarray([-1, 1, 1])).T).T,
              "faces": ref["faces"]}
    timings = {}
    metrics, counts_metrics, summ = drive(
        f"geometry metrics (10,000 samples a side, reference at level {levels[1]:.6f})",
        lambda: geometry_metrics(mesh, ref_cv, FULL_FRAME, bw, device=device, timings=timings),
        1, MESH_RUNS, card, unit="portraits", waits=lambda out: 2)
    require_launched(counts_metrics, ("point_mesh_distance",), "geometry metrics")
    require(all(np.isfinite(v) for v in metrics.values()), "non-finite geometry metrics")
    print(f"  K9 (host clock, with the copies) p2s {timings['p2s'] * 1e3:.3f} ms, s2p "
          f"{timings['s2p'] * 1e3:.3f} ms; reference {len(ref['verts'])} verts, "
          f"{len(ref['faces'])} faces; " + ", ".join(f"{k} {v:.6f}" for k, v in metrics.items()))
    k9_dev = metrics_k9_ms(mesh, ref_cv, bw, device)
    print("  K9 device ms (CUDA events) on the metrics' own inputs: " + ", ".join(
        f"{k} {v['ms']:.6f} ({v['points']} points x {v['faces']} faces)" for k, v in k9_dev.items())
        + f"  [{card}]")
    summ.update(metrics=metrics, k9_ms={k: t * 1e3 for k, t in timings.items()},
                k9_device_ms=k9_dev)
    out["geometry_metrics"] = summ
    counts = {k: counts_mesh[k] + counts_metrics[k] for k in counts_mesh}
    return out, counts


def metrics_k9_ms(mesh_pred, mesh_gt, bw, device):
    """K9's device time (CUDA events) in each direction of geometry_metrics,
    on its own points and meshes (eval/measure.py:geometry_metrics with the
    full-frame ROI). -> {"p2s" | "s2p": {"ms", "points", "faces"}}."""
    import torch

    from panic3d_tpu_torch.eval import measure
    from panic3d_tpu_torch.eval import mesh_metrics as mm

    verts = mesh_pred["verts"] * np.asarray([-1, 1, 1])[None]
    pred = measure.filter_mesh(verts, mesh_pred["faces"], FULL_FRAME, bw)
    gt = measure.filter_mesh(mesh_gt["verts"], mesh_gt["faces"], FULL_FRAME, bw)
    inv = np.linalg.inv(measure.CV2WORLD)[:3, :3]
    pts_pred = mm.sample_points_on_mesh(pred["verts"], pred["faces"], 10000, seed=0)
    pts_gt = (inv @ mm.sample_points_on_mesh(gt["verts"], gt["faces"], 10000, seed=0).T).T
    out = {}
    for key, pts, v, f in (("p2s", pts_pred, (inv @ gt["verts"].T).T, gt["faces"]),
                           ("s2p", pts_gt, pred["verts"], pred["faces"])):
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(device, dt)
                for a, dt in ((pts, torch.float32), (v, torch.float32), (f, torch.int32))]
        out[key] = {"ms": cuda_ms(lambda: mm.point_mesh_distance_sq_kernel(*args), iters=3,
                                  warmup=1), "points": len(pts), "faces": len(f)}
    return out


def icosphere(level: int, radius: float, center):
    """An icosphere with outward faces -> (verts [V,3] f32, faces [T,3]
    int64): 10 * 4^level + 2 vertices, 20 * 4^level faces."""
    t = (1 + 5 ** 0.5) / 2
    v = [(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0), (0, -1, t), (0, 1, t), (0, -1, -t),
         (0, 1, -t), (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1)]
    f = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11), (1, 5, 9), (5, 11, 4),
         (11, 10, 2), (10, 7, 6), (7, 1, 8), (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8),
         (3, 8, 9), (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    v = [np.asarray(p, np.float64) / np.linalg.norm(p) for p in v]
    for _ in range(level):
        mids, nf = {}, []
        for a, b, c in f:
            m = []
            for i, j in ((a, b), (b, c), (c, a)):
                key = (min(i, j), max(i, j))
                if key not in mids:
                    p = v[i] + v[j]
                    v.append(p / np.linalg.norm(p))
                    mids[key] = len(v) - 1
                m.append(mids[key])
            ab, bc, ca = m
            nf += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        f = nf
    return ((np.asarray(v) * radius + np.asarray(center)).astype(np.float32),
            np.asarray(f, np.int64))


def gt_head():
    """The synthetic GT head: an outer shell (icosphere level 6, radius 0.15)
    and an inner "innards" shell (level 5, radius 0.09) about the
    decapitation centre, the head bone + (0, 0.1, 0): 51,204 vertices and
    102,400 triangles, the order of a VRoid avatar (no GT .vrm is in the
    repository). The inner shell's vertices wind to ~1.5, the outer's to
    ~0.5. -> (verts, faces, number of outer vertices, number of outer faces)."""
    c = (HEAD[0], HEAD[1] + 0.1, HEAD[2])
    vo, fo = icosphere(HEAD_LEVELS[0], 0.15, c)
    vi, fi = icosphere(HEAD_LEVELS[1], 0.09, c)
    return np.concatenate([vo, vi]), np.concatenate([fo, fi + len(vo)]), len(vo), len(fo)


def write_vrm(path, verts, faces):
    """A binary glTF (.vrm) with one triangle primitive (uint32 indices) and
    a VRM head bone at HEAD."""
    import struct

    ibm = np.eye(4, dtype=np.float32)
    ibm[:3, 3] = -np.asarray(HEAD, np.float32)
    parts = [verts.astype(np.float32).tobytes(), faces.astype(np.uint32).tobytes(),
             ibm.T.tobytes()]
    offs = np.cumsum([0] + [len(p) for p in parts[:-1]]).tolist()
    blob = b"".join(parts)
    gltf = {
        "asset": {"version": "2.0"}, "buffers": [{"byteLength": len(blob)}],
        "bufferViews": [{"buffer": 0, "byteOffset": o, "byteLength": len(p)}
                        for o, p in zip(offs, parts)],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": len(verts), "type": "VEC3"},
            {"bufferView": 1, "componentType": 5125, "count": faces.size, "type": "SCALAR"},
            {"bufferView": 2, "componentType": 5126, "count": 1, "type": "MAT4"}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0}, "indices": 1, "mode": 4}]}],
        "nodes": [{"name": "head"}], "skins": [{"joints": [0], "inverseBindMatrices": 2}],
        "extensions": {"VRM": {"humanoid": {"humanBones": [{"bone": "head", "node": 0}]}}},
    }
    js = json.dumps(gltf).encode()
    js += b" " * ((-len(js)) % 4)
    blob += b"\0" * ((-len(blob)) % 4)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, 12 + 8 + len(js) + 8 + len(blob)))
        f.write(struct.pack("<II", len(js), 0x4E4F534A) + js)
        f.write(struct.pack("<II", len(blob), 0x004E4942) + blob)


def daredemo_tree(root: str, size: int) -> str:
    """A synthetic daredemoE tree under root (laid out as
    tests/test_eval_cli.py builds it): a size^2 RGBA portrait, the GT ortho
    and rgb60 renders at size^2, the metadata JSON, the alignment pickle
    with a 512-space ROI, a one-line subset and the GT head's .vrm. -> the
    portrait's basename."""
    import os
    import pickle

    from panic3d_tpu_torch.cameras import camsubs
    from panic3d_tpu_torch.utils.imglib import Img

    rng = np.random.RandomState(SEED)
    base = os.path.join(root, "_data", "lustrous")
    meta = {}
    franch, idx = "synthetic", "0000"
    yy, xx = np.mgrid[0:size, 0:size] / (size - 1.0)

    def put_png(dtype, view, fov):
        # smooth colour ramps with noise, and an opaque disc
        rgb = (np.stack([xx, yy, 1 - xx]) * rng.rand(3, 1, 1)
               + 0.1 * rng.rand(3, size, size)).clip(0, 1)
        alpha = (((xx - 0.5) ** 2 + (yy - 0.5) ** 2) < 0.16)[None].astype(np.float32)
        d = os.path.join(base, "renders", "daredemoE", dtype, franch, idx)
        Img(np.concatenate([rgb, alpha]).astype(np.float32)).save(os.path.join(d, f"{view}.png"))
        meta[f"daredemoE/{dtype}/{franch}/{idx}/{view}"] = {
            "render_params": dict(elev=0.0, azim=0.0, dist=1.0, fov=fov)}

    put_png("fandom_align", "front", -1)
    for view in ("front", "left", "right", "back"):
        put_png("ortho", view, -1)
    for v in camsubs["spin12"]:
        put_png("rgb60", f"{v:04d}", 30)
    with open(os.path.join(base, "renders", "daredemoE", "daredemoE_meta.json"), "w") as f:
        json.dump(meta, f)
    bn = f"daredemoE/fandom_align/{franch}/{idx}/front"
    kpts = np.concatenate([rng.rand(28, 2) * (size - 1), np.ones((28, 1))],
                          axis=1).astype(np.float32)
    align = {bn: {"area_of_interest": EVAL_ROI, "transformation": np.eye(3, dtype=np.float32),
                  "_alignment": {"source": {"keypoints": kpts[None], "_detection_used": 0}}}}
    with open(os.path.join(base, "renders", "daredemoE", "fandom_align_alignment.pkl"),
              "wb") as f:
        pickle.dump(align, f)
    os.makedirs(os.path.join(base, "subsets"), exist_ok=True)
    with open(os.path.join(base, "subsets", "daredemoE_test.csv"), "w") as f:
        f.write(f"{franch}/{idx}\n")
    vrm = os.path.join(base, "raw", "dssc", franch, f"{idx}.vrm")
    os.makedirs(os.path.dirname(vrm), exist_ok=True)
    verts, faces, _, _ = gt_head()
    write_vrm(vrm, verts, faces)
    print(f"synthetic daredemoE tree: 17 renders of {size}^2 RGBA, ROI {EVAL_ROI}; GT head "
          f"{len(verts)} vertices, {len(faces)} triangles (two shells; an assumption: no GT "
          f".vrm is in the repository)")
    return bn


def winding_edge_cases(device, n=64):
    """K13 where every term is a signed zero: single triangles seen from
    their own vertices (a, b or c exactly 0). -> (calls, outputs equal with
    their signs)."""
    import torch

    from panic3d_tpu_torch.eval import gltf

    rng = np.random.RandomState(SEED + 3)
    same = 0
    for _ in range(n):
        v = torch.from_numpy(rng.randn(3, 3).astype(np.float32)).to(device)
        f = torch.tensor([[0, 1, 2]], device=device)
        k = gltf.winding_numbers_kernel(v, f, v)
        p = gltf.winding_numbers_plain(v, f, v)
        same += bool(torch.equal(k, p) and torch.equal(torch.signbit(k), torch.signbit(p)))
    return n, same


def k13_checks(device):
    """K13 on the synthetic GT head (every vertex a query, as remove_innards
    runs it): the kernel and its plain version (f32, chunked as the JAX
    package) each against an f64 evaluation of the plain version. A query
    whose winding number is off the f64 one by >= 0.25 took another atan2
    branch somewhere (a flip); the kernel's largest error elsewhere must be
    at most twice the plain version's, its flips at most 0.1 % of the
    queries, and its keep/drop decisions at 1.3 those of the plain version
    wherever the f64 winding number is not within 1e-3 of 1.3.
    -> {"winding_number": summary}."""
    import torch

    from panic3d_tpu_torch.eval import gltf

    verts, faces, _, _ = gt_head()
    v = torch.from_numpy(verts).to(device)
    f = torch.from_numpy(faces).to(device)
    Q, T = len(verts), len(faces)
    wk = gltf.winding_numbers_kernel(v, f, v)
    wp = gltf.winding_numbers_plain(v, f, v)
    w64 = gltf.winding_numbers_plain(v, f, v, chunk=512, dtype=torch.float64)
    torch.cuda.synchronize()
    flip_k = (wk.double() - w64).abs() >= 0.25
    flip_p = (wp.double() - w64).abs() >= 0.25
    flip_kp = (wk - wp).abs() >= 0.25
    ok = ~(flip_k | flip_p)
    err_k = float((wk.double() - w64).abs()[ok].max())
    err_p = float((wp.double() - w64).abs()[ok].max())
    band = (w64 - 1.3).abs() < 1e-3
    differ = (wk < 1.3) != (wp < 1.3)
    n_edge, same_edge = winding_edge_cases(device)
    # two launches on the same inputs: the splits are added in a fixed order
    same_bits = torch.equal(wk.view(torch.int32), gltf.winding_numbers_kernel(v, f, v)
                            .view(torch.int32))
    print(f"K13 winding_number: {Q} queries x {T} triangles; max |w - w_f64| kernel "
          f"{err_k:.3e}, plain f32 {err_p:.3e}; branch flips (|w - w_f64| >= 0.25) kernel "
          f"{int(flip_k.sum())}, plain {int(flip_p.sum())}, kernel vs plain {int(flip_kp.sum())};"
          f" decisions at 1.3 that differ: {int((differ & ~band).sum())} outside the band, "
          f"{int((differ & band).sum())} of {int(band.sum())} inside |w - 1.3| < 1e-3; kept "
          f"{int((wk < 1.3).sum())}; signed-zero cases equal {same_edge} of {n_edge}; two "
          f"launches equal bit for bit: {same_bits}")
    require(err_k <= 2 * err_p, f"K13: error vs f64 {err_k} > 2 x the plain version's {err_p}")
    require(int(flip_kp.sum()) <= Q // 1000, f"K13: {int(flip_kp.sum())} branch flips")
    require(int((differ & ~band).sum()) == 0, "K13: keep/drop decisions differ outside the band")
    require(same_edge == n_edge, "K13: a signed-zero case differs from the plain version")
    require(same_bits, "K13: two launches on the same inputs differ")
    # ~60 f32 operations a pair (3 differences of 3, 3 squared norms and 4 dot
    # products of 5, a cross product of 9, den's 7, the sum's add) and 4 SFU
    # operations (3 square roots and atan2's reciprocal)
    pairs = float(Q) * T
    n_bytes = nbytes(v, f.to(torch.int32), v) + 4 * Q
    summary = record(float((wk - wp).abs()[~flip_kp].max()),
                     lambda: gltf.winding_numbers_kernel(v, f, v),
                     lambda: gltf.winding_numbers_plain(v, f, v), n_bytes, 60 * pairs,
                     plain_iters=2, sfu_ops=4 * pairs)
    summary.update(queries=Q, triangles=T, ops_per_pair=60, sfu_per_pair=4,
                   err_vs_f64=err_k, plain_err_vs_f64=err_p, flips=int(flip_k.sum()),
                   plain_flips=int(flip_p.sum()), flips_vs_plain=int(flip_kp.sum()),
                   decisions_differ_in_band=int((differ & band).sum()), deterministic=same_bits)
    # the issue ceiling: the inner loop's SASS instructions a pair, issued
    # at one warp instruction a clock per scheduler (beside the bound, not
    # instead of it)
    sass = sass_per_pair("winding_number", "winding_number_kernel", r"MUFU\.(SQRT|RSQ)", 3)
    if sass:
        sass["ceiling_ms"] = pairs * sass["per_pair"] / ISSUE_PER_S * 1e3
        print(f"  inner loop: {sass['loop_instructions']} SASS instructions, {sass['loop_mufu']} "
              f"MUFU, {sass['pairs_per_iteration']:g} pairs an iteration: "
              f"{sass['per_pair']:.2f} instructions a pair; issue ceiling "
              f"{sass['ceiling_ms']:.6f} ms")
    else:
        print("  inner loop's SASS: not measured (no cuobjdump, or no loop with MUFU found)")
    summary["sass"] = sass
    print(f"  K13 {summary['ms']:.6f} ms (plain {summary['plain_ms']:.6f}), bound "
          f"{summary['bound_ms']:.6f} ms by {summary['bound_by']}, issue ceiling "
          + (f"{sass['ceiling_ms']:.6f} ms" if sass else "not measured"))
    del wk, wp, w64
    torch.cuda.empty_cache()   # the f64 evaluation's ~20 GB, out of the later paths' pool
    return {"winding_number": summary}


def eval_cli_path(G, device, card):
    """The eval CLIs on a synthetic daredemoE tree at full size (build/eval_cli):
    generate_portrait with the seeded ESS flagship and the random-feature
    ResNet (one warm-up portrait, EVAL_PORTRAITS timed; eval generate's
    --no-filters form at the 99th-percentile level of the portrait's grid,
    because the seeded weights leave no surface under the filters, F7),
    then measure.main on its output (random CLIP/LPIPS; one warm-up run,
    EVAL_PORTRAITS timed), each with the launch counts zeroed before and
    read after, then generate.main --tiny through argparse on a 64^2 tree
    beside it.
    -> (summary, launch counts of the timed measure runs)."""
    import os
    import pickle
    import shutil
    from pathlib import Path

    import torch

    from panic3d_tpu_torch.data.databack import DatabackendMinna
    from panic3d_tpu_torch.eval import generate, measure
    from panic3d_tpu_torch.eval.gltf import LustrousGLTF
    from panic3d_tpu_torch.eval.volume import density_grid, portrait_planes
    from panic3d_tpu_torch.kernels import launch_counts, reset_launch_counts
    from panic3d_tpu_torch.models.resnet import random_feature_extractor
    from panic3d_tpu_torch.models.volumetric import renderer as vr

    root = Path(__file__).resolve().parent / "build" / "eval_cli"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    bn = daredemo_tree(str(root), EVAL_SIZE)
    print(f"  tree written in {time.perf_counter() - t0:.3f} s")
    out = str(root / "evalout")
    dk = DatabackendMinna(str(root))
    with open(root / "_data/lustrous/renders/daredemoE/fandom_align_alignment.pkl", "rb") as f:
        aligndata = pickle.load(f)
    resnet = random_feature_extractor(SEED, device=device)
    opts = {k: v for k, v in generate.INFERENCE_OPTS.items()
            if k not in ("triplane_crop", "cull_clouds")}

    def portrait(level, stages=None):
        return generate.generate_portrait(G, resnet, dk[bn], aligndata[bn], opts, SEED, BATCH,
                                          out, level=level, mesh_res=MESH_RES, stages=stages)

    cond = portrait(LEVEL)   # warm-up
    with torch.no_grad():
        _, planes = portrait_planes(G, {"cond": cond, "seeds": [SEED]})
        grid = density_grid(planes, G._decoder(), MESH_RES, G.rk["box_warp"],
                            vr.generate_plane_axes(True), vr.DensityFilters())
    level = mesh_levels(grid)[0]
    del planes, grid
    reset_launch_counts()
    times, stages = [], {}
    for _ in range(EVAL_PORTRAITS):
        t, one = time.perf_counter(), {}
        portrait(level, one)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        for k, v in one.items():
            stages[k] = stages.get(k, 0.0) + v
    counts_gen = launch_counts()
    require_launched(counts_gen, ESS_PASTE_KERNELS + ("volume_density",), "eval generate")
    require_absent(counts_gen, GRID_PASTE_ABSENT, "eval generate")
    waits_gen = count_syncs(lambda: portrait(level))
    with open(os.path.join(out, bn.replace("fandom_align", "marching_cubes") + ".pkl"),
              "rb") as f:
        mc = pickle.load(f)
    pngs = {sub: len(os.listdir(os.path.join(out, os.path.dirname(
        bn.replace("fandom_align", sub))))) for sub in ("ortho", "ortho_xyza", "rgb60", "xyza60")}
    require(pngs == {"ortho": 4, "ortho_xyza": 4, "rgb60": 12, "xyza60": 12},
            f"eval generate wrote {pngs}")
    require(set(mc) == {"verts", "faces", "normals", "values", "colors"} and len(mc["faces"]),
            f"eval generate: mesh pickle {sorted(mc)} with {len(mc['faces'])} faces")
    gen_s = statistics.median(times)
    print(f"eval generate (ESS flagship, --no-filters at level {level:.6f}, view batch {BATCH}):"
          f" {EVAL_PORTRAITS} portraits, median {gen_s:.4f} s/portrait (runs "
          + ", ".join(f"{t:.4f}" for t in times) + "); stages per portrait: "
          + ", ".join(f"{k} {t / EVAL_PORTRAITS * 1e3:.3f} ms" for k, t in stages.items())
          + f"; {len(mc['verts'])} verts, {len(mc['faces'])} faces, PNGs {pngs}; host waits "
          f"per portrait {waits_gen}; launches per portrait "
          + ", ".join(f"{k}={n / EVAL_PORTRAITS:g}" for k, n in counts_gen.items() if n)
          + f"  [{card}]")

    gl = LustrousGLTF(str(root / "_data/lustrous/raw/dssc/synthetic/0000.vrm"))
    _, _, n_outer, f_outer = gt_head()
    n_all, f_all = len(gl.verts), len(gl.faces)
    gl.remove_innards(device=device)
    require(len(gl.verts) == n_outer and len(gl.faces) == f_outer,
            f"remove_innards kept {len(gl.verts)} of {n_all} vertices, expected the outer "
            f"shell's {n_outer}")
    print(f"  remove_innards (K13): kept {len(gl.verts)} of {n_all} vertices and "
          f"{len(gl.faces)} faces: the inner shell removed")

    argv = ["--data", str(root), "--out", out, "--allow-random-metrics", "--device", str(device)]
    measure.main(argv)   # warm-up
    reset_launch_counts()
    times, mstages, results = [], {}, None
    for _ in range(EVAL_PORTRAITS):
        t = time.perf_counter()
        results = measure.main(argv, stages=mstages)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    counts_meas = launch_counts()
    require_launched(counts_meas, ("winding_number", "point_mesh_distance"), "eval measure")
    ans2d, ans3d = results
    table = {f"{s}/{m}": float(np.mean(v)) for s in ans2d for m, v in ans2d[s].items()}
    table.update({f"geom/{k}": float(np.mean(v)) for k, v in ans3d.items()})
    require(all(np.isfinite(v) for v in table.values()), f"eval measure: non-finite {table}")
    waits_meas = count_syncs(lambda: measure.main(argv))
    meas_s = statistics.median(times)
    print(f"eval measure: {EVAL_PORTRAITS} runs of 1 portrait, median {meas_s:.4f} s/portrait "
          "(runs " + ", ".join(f"{t:.4f}" for t in times) + "); stages per portrait: "
          + ", ".join(f"{k} {t / EVAL_PORTRAITS * 1e3:.3f} ms" for k, t in mstages.items())
          + f"; host waits per portrait {waits_meas}; launches per portrait "
          + ", ".join(f"{k}={n / EVAL_PORTRAITS:g}" for k, n in counts_meas.items() if n)
          + f"  [{card}]")
    print("  rows: " + ", ".join(f"{k} {v:.6f}" for k, v in table.items()))

    t = time.perf_counter()
    daredemo_tree(str(root / "tiny"), 64)   # the tiny model takes 64^2 portraits
    generate.main(["--tiny", "--data", str(root / "tiny"), "--out", str(root / "tiny_out"),
                   "--skip-rmline", "--no-filters", "--mesh-res", "64", "--level", "0.17",
                   "--device", str(device)])
    torch.cuda.synchronize()
    tiny_pngs = sum(len(files) for _, _, files in os.walk(root / "tiny_out"))
    require(tiny_pngs == 33, f"generate --tiny wrote {tiny_pngs} files, expected 32 PNGs + 1")
    print(f"generate.main --tiny through argparse: {time.perf_counter() - t:.3f} s, "
          f"{tiny_pngs} files  [{card}]")
    summary = {
        "generate_s_per_portrait": gen_s, "generate_stages_ms": {
            k: t / EVAL_PORTRAITS * 1e3 for k, t in stages.items()},
        "generate_host_waits": waits_gen, "mesh_level": level,
        "mesh_verts": len(mc["verts"]), "mesh_faces": len(mc["faces"]),
        "measure_s_per_portrait": meas_s, "measure_stages_ms": {
            k: t / EVAL_PORTRAITS * 1e3 for k, t in mstages.items()},
        "measure_host_waits": waits_meas, "table": table,
        "gt_head": {"verts": n_all, "faces": f_all, "kept_verts": n_outer},
    }
    return summary, counts_meas


def checkpoint_path(Ge, cond1, device, card, level):
    """Trained-weight loading and the paper's preprocess on the card, with
    checkpoints written here under build/ckpt (no weights are in the
    repository) by the port's own writers: the seeded ESS flagship ``Ge`` as
    flagship/state.msgpack + config.json (flax's msgpack layout, model_kwargs
    of family flagship with ESS's rendering kwargs), a seeded RMLineGenerator
    as rmline/, a seeded ResNet50 with a seeded PCA basis and mean as resnet/
    (+ pca.npz), and Ge as network-snapshot-000000.pkl in the reference's
    persistent-pickle layout. Then, each timed: Reconstructor(ckpt=) and
    the pickle (extract_reference_generator -> generator_config_from_init_
    kwargs -> load_generator_state) must give Ge's state_dict and its ESS +
    paste views bit for bit; the line filler on the synthetic 512^2
    portrait, card against the CPU (convs in f32: cudnn.allow_tf32 is off
    for the whole run; line-mask pixels that differ counted apart, the DoG
    flips behind them each within FLIP_TOL of the 0.5 threshold, the filled
    image within 1e-5 where the masks agree); generate.main --ckpt on the
    eval CLIs' tree (build/eval_cli, --no-filters at ``level``) after a
    warm-up run: s/portrait and its stages (rmline included), loading, host
    waits, launches (K1-K8 and K1v required). -> the summary."""
    import os
    import pickle
    import shutil
    from pathlib import Path

    import torch

    from panic3d_tpu_torch import configs
    from panic3d_tpu_torch.api import Reconstructor
    from panic3d_tpu_torch.data.databack import DatabackendMinna
    from panic3d_tpu_torch.eval import generate
    from panic3d_tpu_torch.kernels import launch_counts, reset_launch_counts
    from panic3d_tpu_torch.models.resnet import ResNet50, load_pca_extractor
    from panic3d_tpu_torch.models.rmlinegan import RMLineGenerator, RMLineWrapper
    from panic3d_tpu_torch.models.triplane import TriPlaneGenerator
    from panic3d_tpu_torch.runtime import checkpoint as ck
    from panic3d_tpu_torch.utils.sketchers import batch_dog

    root = Path(BUILD_TMP) / "ckpt"
    shutil.rmtree(root, ignore_errors=True)
    summary = {"write_s": {}, "load_s": {}}

    def timed(table, name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        summary[table][name] = time.perf_counter() - t
        return out

    ess_rk = {k: Ge.rk[k] for k in ("ess", "depth_resolution", "depth_resolution_importance")}
    timed("write_s", "flagship", lambda: ck.save_checkpoint(
        str(root / "flagship"), ck.flax_from_state_dict(Ge.state_dict()),
        {"model_kwargs": {"family": "flagship", "rendering_kwargs": ess_rk}}))
    timed("write_s", "rmline", lambda: ck.save_checkpoint(
        str(root / "rmline"), ck.module_variables(RMLineGenerator(device=device).init_weights(SEED))))
    rng = np.random.RandomState(SEED + 1)

    def write_resnet():
        ck.save_checkpoint(str(root / "resnet"), ck.module_variables(
            ResNet50(device=device).init_weights(SEED + 1)))
        np.savez(root / "resnet" / "pca.npz", components=rng.randn(512, 2048).astype(np.float32),
                 mean=(0.1 * rng.randn(2048)).astype(np.float32))

    timed("write_s", "resnet", write_resnet)
    pkl = str(root / "network-snapshot-000000.pkl")
    timed("write_s", "pickle", lambda: ck.save_reference_pickle(
        pkl, Ge, configs.flagship_kwargs(eval_mode=True, ess=True)))
    sizes = {p.name: p.stat().st_size for p in (root / "flagship" / "state.msgpack",
                                                Path(pkl))}

    # loading: the native directory, the reference pickle, the aux models
    opts = dict(EVAL_FILTERS, paste_params=generate.INFERENCE_OPTS["paste_params"])
    rec = timed("load_s", "flagship", lambda: Reconstructor(ckpt=str(root / "flagship"),
                                                            opts=opts, seed=SEED, device=device))

    def from_pickle():
        sd, _, kw, extras = ck.extract_reference_generator(pkl)
        G = TriPlaneGenerator(**ck.generator_config_from_init_kwargs(kw, extras),
                              force_sigmoid=True).to(device).eval()
        return ck.load_generator_state(G, sd)

    Gp = timed("load_s", "pickle", from_pickle)
    args = argparse.Namespace(ckpt=str(root / "flagship"))
    rmline = timed("load_s", "rmline", lambda: generate._load_rmline(args, device))
    timed("load_s", "resnet", lambda: load_pca_extractor(str(root / "resnet"), device=device))
    want = Ge.state_dict()
    for label, G in (("checkpoint dir", rec.g), ("reference pickle", Gp)):
        got = G.state_dict()
        differ = [k for k in want if not torch.equal(got[k], want[k])]
        require(set(got) == set(want) and not differ and G.rk == Ge.rk,
                f"{label}: state_dict or rendering kwargs differ from the source ({differ[:5]})")
    views = generate.eval_views()
    pick = [views[i] for i in (0, 3, 4, 10)]   # 2 ortho, 2 perspective
    angles = [[float(v[j]) for v in pick] for j in (2, 3, 4)]
    seeded = Reconstructor(model=Ge, opts=opts, seed=SEED)
    ref = seeded.views(cond1, *angles)
    require(all(np.array_equal(ref[k], v) for k, v in seeded.views(cond1, *angles).items()),
            "the seeded flagship's views differ from run to run")
    for label, r in (("checkpoint dir", rec), ("reference pickle",
                                                Reconstructor(model=Gp, opts=opts, seed=SEED))):
        out = r.views(cond1, *angles)
        errs = {k: float(np.abs(out[k] - ref[k]).max()) for k in ref}
        require(all(np.array_equal(out[k], ref[k]) for k in ref),
                f"{label}: ESS + paste views differ from the seeded flagship's: {errs}")
    print(f"checkpoint path (torch {torch.__version__}): wrote "
          + ", ".join(f"{k} {v:.3f} s" for k, v in summary["write_s"].items())
          + " (" + ", ".join(f"{k} {v / 2 ** 20:.1f} MiB" for k, v in sizes.items())
          + "); loaded " + ", ".join(f"{k} {v:.3f} s" for k, v in summary["load_s"].items())
          + f"; the directory's and the pickle's generators equal the source's state_dict and "
          f"its {len(pick)} ESS + paste views bit for bit  [{card}]")

    # the line filler at 512^2: card against the CPU
    eval_root = Path(BUILD_TMP) / "eval_cli"
    with open(eval_root / "_data/lustrous/renders/daredemoE/fandom_align_alignment.pkl",
              "rb") as f:
        align = pickle.load(f)
    dk = DatabackendMinna(str(eval_root))
    bn = next(iter(align))
    rgb = dk[bn]["image"].bg("w").convert("RGB").t()
    kpts = generate._aligned_keypoints(align[bn])
    cpu_wrap = RMLineWrapper(RMLineGenerator(device="cpu").load_variables(
        ck.load_checkpoint(str(root / "rmline"))[0]))
    x_dev = torch.from_numpy(rgb)[None].to(device)
    with torch.no_grad():
        f_d, m_d, h_d = (t.cpu() for t in rmline(x_dev, kpts))
        f_c, m_c, h_c = cpu_wrap(torch.from_numpy(rgb)[None], kpts)
        dog_d = batch_dog(x_dev, t=1.0, sigma=0.5, k=1.6).cpu()
        dog_c = batch_dog(torch.from_numpy(rgb)[None], t=1.0, sigma=0.5, k=1.6)
    dog_flips = (dog_d > 0.5) != (dog_c > 0.5)
    require(bool(((dog_c[dog_flips] - 0.5).abs() <= FLIP_TOL).all()),
            "line filler: a DoG pixel crossed 0.5 farther than FLIP_TOL from it")
    mask_diff = m_d != m_c
    require(int(mask_diff.sum()) <= 4 * int(dog_flips.sum()),
            f"line filler: {int(mask_diff.sum())} mask pixels differ from "
            f"{int(dog_flips.sum())} DoG flips")
    require(torch.equal(h_d, h_c), "line filler: the face hulls differ")
    agree = ~mask_diff.expand_as(f_c)
    err = float((f_d - f_c)[agree].abs().max())
    check("line filler card vs CPU (filled image where the masks agree)", err, 1e-5)

    def fill():
        out = rmline(x_dev, kpts)
        torch.cuda.synchronize()
        return out

    fill()
    times = []
    for _ in range(5):
        t = time.perf_counter()
        fill()
        times.append((time.perf_counter() - t) * 1e3)
    fill_ms = statistics.median(times)
    stack = torch.zeros((1, 4, 524, 524), device=device)   # 512^2 padded by the depth
    gen_ms = cuda_ms(lambda: rmline.gen(stack))
    print(f"line filler at 512^2 (convs f32, cudnn TF32 off): {fill_ms:.3f} ms a portrait "
          f"(median of 5, host clock, facehull on the host included), generator alone "
          f"{gen_ms:.3f} ms device; line pixels {float(m_d.mean()):.4f} of the image; card "
          f"vs CPU: {int(mask_diff.sum())} mask pixels differ from {int(dog_flips.sum())} "
          f"DoG flips, filled image max err {err:.3e} where they agree  [{card}]")
    summary["rmline"] = {"ms": fill_ms, "generator_ms": gen_ms, "max_abs_err": err,
                         "mask_pixels_differ": int(mask_diff.sum()),
                         "dog_flips": int(dog_flips.sum()), "tf32": False}

    # eval generate from the checkpoint, with the line filler and the ResNet-PCA
    out = str(root / "evalout")
    argv = ["--ckpt", str(root / "flagship"), "--data", str(eval_root), "--out", out,
            "--no-filters", "--level", f"{level}", "--mesh-res", str(MESH_RES),
            "--device", str(device)]
    generate.main(argv)   # warm-up
    reset_launch_counts()
    stages = {}
    t = time.perf_counter()
    generate.main(argv, stages=stages)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t
    counts = launch_counts()
    require_launched(counts, ESS_PASTE_KERNELS + ("volume_density",), "generate --ckpt")
    require_absent(counts, GRID_PASTE_ABSENT, "generate --ckpt")
    require("rmline" in stages, f"generate --ckpt ran no line filler: stages {stages}")
    waits = count_syncs(lambda: generate.main(argv))
    with open(os.path.join(out, bn.replace("fandom_align", "marching_cubes") + ".pkl"),
              "rb") as f:
        mc = pickle.load(f)
    per_portrait = sum(v for k, v in stages.items() if k != "load")
    print(f"generate.main --ckpt (ESS flagship, rmline/ and resnet/, --no-filters at level "
          f"{level:.6f}): {per_portrait:.4f} s/portrait + load {stages['load']:.3f} s "
          f"(run {run_s:.4f} s); stages "
          + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in stages.items())
          + f"; {len(mc['verts'])} verts, {len(mc['faces'])} faces; host waits per run "
          f"{waits} (loading included); launches per portrait "
          + ", ".join(f"{k}={n:g}" for k, n in counts.items() if n) + f"  [{card}]")
    summary["generate"] = {"s_per_portrait": per_portrait, "run_s": run_s,
                           "stages_ms": {k: v * 1e3 for k, v in stages.items()},
                           "host_waits": waits, "mesh_faces": len(mc["faces"]),
                           "launches": {k: n for k, n in counts.items() if n}}
    return summary


def sass_per_pair(stem: str, kernel: str, op: str, per_pair: int):
    """The static SASS instructions a pair in ``kernel``'s innermost loop that
    holds MUFU instructions, from cuobjdump -sass of csrc/<stem>.cu's build:
    the loop is the shortest span from a backward branch's target to the
    branch, and its pairs an iteration are its instructions matching the
    regular expression ``op`` over ``per_pair`` (K13: its square roots,
    MUFU.SQRT or MUFU.RSQ, 3 a pair). Slow paths called from outside the
    span are not counted. -> dict, or None without cuobjdump or such a
    loop."""
    import re

    from panic3d_tpu_torch.kernels import build

    ins = sass_listing(build.build(stem), kernel)
    if ins is None:
        return None
    loops = [(len(span), sum("MUFU" in o for o in span), marks)
             for _, _, span in sass_loops(ins)
             if (marks := sum(bool(re.search(op, o)) for o in span))]
    if not loops:
        return None
    n, mufu, marks = min(loops)
    return {"loop_instructions": n, "loop_mufu": mufu,
            "pairs_per_iteration": marks / per_pair, "per_pair": n * per_pair / marks}


def _entry_name(mangled: str) -> str:
    """A kernel's name and template arguments from its mangled symbol:
    the last <length><name> component, then bf16/f32 and the integer
    arguments (e.g. triplane_decode_kernel<bf16,32>)."""
    import re

    i, name = 2, mangled
    nested = mangled[i:i + 1] == "N"
    i += nested
    while (m := re.match(r"\d+", mangled[i:])):
        n, j = int(m.group()), i + m.end()
        name, i = mangled[j:j + n], j + n
        if not nested:
            break
    args = mangled[i:].split("Ev")[0] if mangled[i:i + 1] == "I" else ""
    dtype = ["bf16"] if "bfloat16" in args else ["f32"] if args.startswith("If") else []
    ints = re.findall(r"L[ib](-?\d+)E", args)
    return name + (f"<{','.join(dtype + ints)}>" if dtype or ints else "")


def ptxas_report(text: str):
    """nvcc -Xptxas -v's report -> [(kernel<template args>, registers,
    spill store bytes, spill load bytes, static shared memory bytes)] per
    entry function."""
    import re

    out, fn, spills = [], None, (0, 0)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn, spills = _entry_name(m.group(1)), (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            smem = re.search(r"(\d+) bytes smem", line)
            out.append((fn, int(m.group(1)), *spills, int(smem.group(1)) if smem else 0))
            fn = None
    return out


def touched_bytes(vols_cl, coords, axes, box_warp) -> int:
    """The bytes of the deep volumes [N*3,D,H,W,C] whose texels the
    trilinear corners of coords [N,M,3] touch inside the volumes, each
    texel counted once: what a decode of those points must read."""
    import itertools

    import torch

    from panic3d_tpu_torch.models.volumetric import renderer as vr

    NP, D, H, W, C = vols_cl.shape
    dev = vols_cl.device
    proj = vr.project_onto_planes(axes, (2.0 / box_warp) * coords.float()).reshape(NP, -1, 3)
    size = torch.tensor([W, H, D], dtype=torch.float32, device=dev)
    i0 = torch.floor(((proj + 1) * size - 1) / 2).long()
    base = torch.arange(NP, device=dev)[:, None] * (D * H * W)
    seen = torch.zeros(NP * D * H * W, dtype=torch.bool, device=dev)
    for dx, dy, dz in itertools.product((0, 1), repeat=3):
        x, y, z = i0[..., 0] + dx, i0[..., 1] + dy, i0[..., 2] + dz
        ok = (x >= 0) & (x < W) & (y >= 0) & (y < H) & (z >= 0) & (z < D)
        seen[(base + (z * H + y) * W + x)[ok]] = True
    return int(seen.sum()) * C * vols_cl.element_size()


def k10_ops(points: int, C: int):
    """K10's render form per call -> (f32 operations, TF32 tensor-core
    operations): per point 3 planes x 2 z slices x C channels of 6 lerp
    operations and 2 for the blend on the CUDA cores; K1's two layers on
    the tensor cores, each product three times (3xTF32)."""
    return points * 3 * C * (2 * 6 + 2), points * 3 * 2 * (C * 64 + 64 * 33)


def k10_checks(Gd, device, parent):
    """K10, the trilinear K1 form, vs its plain version on the card. The
    render form (triplane_decode_deep) at the deep-plane render pass's
    shapes: 6 bf16 volumes [2,256,256,32] of random depth-2 flagship planes
    at the coarse pass's 393,216 points a portrait, eval generate's crop and
    cull, K1's tolerances (check_k1); and on f32 volumes of one portrait at
    2^17 points through the box (the vertex colours' form). The lattice
    form (volume_density_deep) on the seeded deep flagship portrait's f32
    planes over the whole 256^3 lattice, against the plain version on a slab
    of 2^20 points, with K1v's tolerances (k10_grid_checks). Each is timed
    with its plain version; the render form also beside F.grid_sample (5-D,
    bilinear, zeros, align_corners=False) on the same bf16 volumes and
    points, the sample alone (no PyTorch call computes the decode). The
    bounds count the texels the points touch (touched_bytes).
    -> {"triplane_decode_deep": summary, "volume_density_deep": summary}."""
    import torch
    import torch.nn.functional as F

    from panic3d_tpu_torch.eval import volume as vol
    from panic3d_tpu_torch.models.volumetric import renderer as vr

    D, bw, S = DEEP_DEPTH, Gd.rk["box_warp"], Gd.rk["depth_resolution"]
    dec = Gd._decoder()
    axes = vr.generate_plane_axes(Gd.rk["use_triplane"])
    filt = vr.DensityFilters(**EVAL_FILTERS)
    gen = torch.Generator(device=device).manual_seed(SEED)
    planes = torch.randn((BATCH, 3, 32 * D, 256, 256), generator=gen, device=device) * 0.5

    # the render form at the coarse pass of bench.py's two views
    ro, rd, _ = flagship_rays({"elevations": torch.zeros(BATCH, device=device),
                               "azimuths": torch.tensor(AZIMUTHS, device=device)}, device)
    depths = vr.sample_stratified(ro, Gd.rk["ray_start"], Gd.rk["ray_end"], S)
    coords = (ro[:, :, None] + depths * rd[:, :, None]).reshape(BATCH, -1, 3).contiguous()
    vols = vr.deep_volumes_cl(planes, D, torch.bfloat16)
    print(f"K10 triplane_decode_deep, coarse pass: volumes {tuple(vols.shape)} bf16, coords "
          f"{tuple(coords.shape)}")
    fns = dict(kernel=vr.triplane_decode_deep_kernel, plain=vr.triplane_decode_deep_plain)
    rgb, sig, err = check_k1(vols, coords, dec, bw, axes, filt, **fns)
    flops, tf32 = k10_ops(coords.shape[0] * coords.shape[1], 32)
    touched = touched_bytes(vols, coords, axes, bw)
    print(f"  texels the corners touch: {touched} of {nbytes(vols)} volume bytes")
    summary = record(err, lambda: vr.triplane_decode_deep_kernel(vols, coords, dec, bw, axes,
                                                                 filt),
                     lambda: vr.triplane_decode_deep_plain(vols, coords, dec, bw, axes, filt),
                     touched + nbytes(coords, rgb, sig), flops, tf32_flops=tf32)
    M = coords.shape[1]
    pts = vr.project_onto_planes(axes, (2.0 / bw) * coords).to(torch.bfloat16)
    lib_in = planes.to(torch.bfloat16).reshape(BATCH * 3, 32, D, 256, 256)
    lib_grid = pts.reshape(BATCH * 3, 1, 1, M, 3)
    summary["grid_sample_ms"] = cuda_ms(lambda: F.grid_sample(
        lib_in, lib_grid, mode="bilinear", padding_mode="zeros", align_corners=False))
    summary["volume_bytes_touched"] = touched
    del rgb, sig, lib_in, lib_grid, pts

    # the f32 form (the vertex colours) on one portrait at 2^17 points
    vols32 = vr.deep_volumes_cl(planes[:1], D)
    pts32 = ((torch.rand((1, 2**17, 3), generator=gen, device=device) - 0.5) * bw).contiguous()
    print(f"K10 triplane_decode_deep, f32: volumes {tuple(vols32.shape)}, coords "
          f"{tuple(pts32.shape)}")
    _, _, err32 = check_k1(vols32, pts32, dec, bw, axes, vr.DensityFilters(), **fns)
    summary["f32_2e17_points"] = {"max_abs_err": err32, "ms": cuda_ms(
        lambda: vr.triplane_decode_deep_kernel(vols32, pts32, dec, bw, axes))}
    print(f"  ms {summary['ms']:.6f} (plain {summary['plain_ms']:.6f}, F.grid_sample alone "
          f"{summary['grid_sample_ms']:.6f}, bound {summary['bound_ms']:.6f} "
          f"{summary['bound_by']}); f32 at 2^17 points {summary['f32_2e17_points']['ms']:.6f}")
    del vols, vols32, planes
    return {"triplane_decode_deep": summary,
            "volume_density_deep": k10_grid_checks(Gd, device, vol, vr, parent)}


def k10_grid_checks(Gd, device, vol, vr, parent):
    """K10's lattice form (volume_density_deep) vs density_grid_plain at
    D = 2 on the seeded deep flagship portrait's f32 planes, K1v's checks
    and tolerances: the whole 256^3 grid by the kernel, a slab of 2^20
    points (16 x-slices through the middle of the box) by the plain
    version; filtered (eval generate's crop and cull) on the seeded decoder
    and on the decoder with sigma's bias raised by SIGMA_RAISE, f32 and f16
    grids, cull decisions that differ counted apart; unfiltered in f32. The
    bound counts the points the crop keeps. Then the kernel's stats (bricks
    skipped by the crop, columns skipped, planes read outside a window);
    and with ``parent`` (--parent) the parent's kernel (K1's kernel with a
    trilinear gather) timed against it, parent / this / this / parent, its
    bits compared, and the unfiltered grid's mesh (faces at the grid's own
    level) beside the parent's. -> summary."""
    import torch

    N, bw, D = MESH_RES, Gd.rk["box_warp"], DEEP_DEPTH
    _, planes = vol.portrait_planes(Gd, portrait_input(Gd, device))
    dec, axes = Gd._decoder(), vr.generate_plane_axes(Gd.rk["use_triplane"])
    filt = vr.DensityFilters(**EVAL_FILTERS)
    start = (N // 2 - 8) * N * N
    stop = start + 2**20
    print(f"K10 volume_density_deep: planes {tuple(planes.shape)} f32, {N}^3 lattice; plain "
          f"on flat indices [{start}, {stop})")

    def kernel(d, f, dtype):
        return vol.density_grid_deep_kernel(planes, d, N, bw, axes, f, D, dtype)

    def plain(d, f, dtype):
        return vol.density_grid_plain(planes, d, N, bw, axes, f, dtype, start=start, stop=stop,
                                      triplane_depth=D)

    def slab(grid):
        return grid.flip(0).reshape(-1)[start:stop].float()

    b1 = dec.b1.clone()
    b1[0] += SIGMA_RAISE
    errs = []
    for label, d in (("seeded", dec), (f"sigma bias +{SIGMA_RAISE}", dec._replace(b1=b1))):
        g32, p32 = kernel(d, filt, torch.float32), plain(d, filt, torch.float32)
        kept_k, kept_p = slab(g32) > -1e3, p32 > -1e3
        flips = int((kept_k != kept_p).sum())
        agree = kept_k == kept_p
        print(f"  filtered, {label}: {int(kept_k.sum())} of {p32.numel()} slab voxels survive "
              f"the crop and the cull ({int((g32 > -1e3).sum())} of {N**3} in the grid); cull "
              f"decisions that differ: {flips} (counted apart; tol {p32.numel() // 10000})")
        require(flips <= p32.numel() // 10000, f"K10 lattice: {flips} cull decisions differ")
        errs.append(float((slab(g32) - p32).abs()[agree].max()))
        check(f"K10 density, filtered, {label}, f32, where the decisions agree", errs[-1], 1e-6)
        g16, p16 = kernel(d, filt, torch.float16), plain(d, filt, torch.float16)
        errs.append(float((slab(g16) - p16.float()).abs()[agree].max()))
        check(f"K10 density, filtered, {label}, f16 grid, where the decisions agree",
              errs[-1], 0.0)
    # without filters: sigma carries the MLP's summation order (K1's 1e-4)
    # and d density / d sigma <= 1/4
    gu = kernel(dec, vr.DensityFilters(), torch.float32)
    errs.append(max_err(slab(gu), plain(dec, vr.DensityFilters(), torch.float32)))
    check("K10 density, unfiltered, f32 (1e-4 sigma x 1/4)", errs[-1], 2.5e-5)
    errs.append(max_err(kernel(dec, vr.DensityFilters(), torch.float16), gu.to(torch.float16)))
    check("K10 density, unfiltered, f16 grid = its f32 grid rounded to f16", errs[-1], 0.0)
    C = planes.shape[2] // D
    level = mesh_levels(gu)[0]
    faces = len(grid_mesh(gu, level)[1])
    if "triplane_decode" in parent:
        with parent_entries({"volume_density_deep": parent["triplane_decode"][0]}):
            gp = kernel(dec, vr.DensityFilters(), torch.float32)
        faces_parent = len(grid_mesh(gp, level)[1])
        print(f"  unfiltered mesh at the grid's level {level:.6f}: {faces} faces; from the "
              f"parent's grid {faces_parent}; its densities within "
              f"{max_err(gu, gp):.3e} of the parent's")
        del gp
    else:
        faces_parent = None
        print(f"  unfiltered mesh at the grid's level {level:.6f}: {faces} faces")
    del gu
    coords = vol.create_samples_device(N, bw, 0, N**3, device)
    kept = coords[~vr.triplane_crop_mask(coords, filt.triplane_crop, bw)[:, 0]]
    n_kept = kept.shape[0]
    touched = touched_bytes(vr.deep_volumes_cl(planes, D), kept[None], axes, bw)
    del coords, kept
    print(f"  points kept by the crop: {n_kept} of {N**3}; texels their corners touch: "
          f"{touched} of {nbytes(planes)} plane bytes")
    # per kept point: 3 planes x 2 slices x C lerps and the blend, the mean,
    # 64 x (bias, softplus, sigma's multiply-add, ...) and the tail on the
    # CUDA cores; layer 1 in 3xTF32 (K1v's count); 64 softplus x 2 and the
    # tail's 4 exp/log on the SFU. Bytes: the texels the kept points' corners
    # touch, read once, and the f16 grid written once.
    out = record(
        max(errs), lambda: kernel(dec, filt, torch.float16),
        lambda: vol.density_grid_plain(planes, dec, N, bw, axes, filt, torch.float16,
                                       triplane_depth=D),
        touched + N**3 * 2, n_kept * (3 * C * 14 + C + 64 * 8 + 40), plain_iters=3,
        tf32_flops=n_kept * 3 * 2 * C * 64, sfu_ops=n_kept * (64 * 2 + 4))
    out.update(points_kept=n_kept, volume_bytes_touched=touched, mesh_faces=faces,
               mesh_faces_parent=faces_parent)
    print(f"  ms {out['ms']:.6f}: {N**3 / out['ms'] / 1e6:.3f} G lattice points/s; plain "
          f"{out['plain_ms']:.3f}; bound {out['bound_ms']:.6f} ms ({out['bound_by']})")
    # the crop skip and the windows, counted by the kernel on the filtered grid
    stats = torch.zeros(3, dtype=torch.int32, device=device)
    vol.density_grid_deep_kernel(planes, dec, N, bw, axes, filt, D, torch.float16, stats=stats)
    BX, BY, BZ = vol.K1V_BRICK
    bricks = -(-N // BX) * -(-N // BY) * -(-N // BZ)
    skipped, cols, outside = (int(v) for v in stats.tolist())
    print(f"  bricks of {BX}x{BY}x{BZ}: {bricks}; skipped by the crop {skipped}; columns skipped "
          f"in the bricks decoded {cols}; planes read outside a window {outside}")
    out.update(bricks=bricks, bricks_skipped=skipped, columns_skipped=cols,
               planes_outside_window=outside)
    out.update(parent_and_sass(
        parent, "triplane_decode", "volume_density_deep", "volume_density_kernel",
        lambda: kernel(dec, filt, torch.float16), N**3, "point", None, 1, None,
        parent_kernel="triplane_decode_kernel"))
    return out


# ---------------------------------------------------------------------------
# the alias-free layer (K11) and the equivariance metrics (K4's large and generic filters)

K11_SCALE = 80.0    # K11 checks' input scale: x sqrt(2) after the act, so the clamp (256) is hit


def k11_ops(plan, n, c, h_in):
    """K11's f32 operations for one call: the FIR's multiply-adds (2 each),
    the taps that meet inserted zeros skipped; the up pass runs along the
    input's h_in rows, then along the intermediate's columns."""
    th, tw = plan.mid
    oh, ow = plan.out
    fuh = len(plan.fu)

    def taps(axis, size):   # position i's phase starts at k0(i) = (k0(0) - i) mod up
        return sum(len(range((plan.k0[axis][0] - i) % plan.up, fuh, plan.up))
                   for i in range(size))

    fdn = math.isqrt(len(plan.fd)) if plan.fd2d else len(plan.fd)
    up_macs = h_in * taps(1, tw) + tw * taps(0, th)
    down_macs = oh * ow * fdn * fdn if plan.fd2d else (th * ow + oh * ow) * fdn
    return 2.0 * n * c * (up_macs + down_macs)


def k11_parent(parent, fn, label):
    """K11's call fn against the parent's K11 (--parent DIR holding
    filtered_lrelu.cu; its entry point reads the plan's leading fields,
    the tile form's layout): equal bits, not slower in every round
    (parent_rounds). None without the parent's K11."""
    if "filtered_lrelu" not in parent:
        return None
    return require_parent(parent_rounds({"filtered_lrelu": parent["filtered_lrelu"][0]}, fn),
                          label)


def k11_one(layer, label, device, gen, parent):
    """K11 at one layer's geometry, batch SG3_BATCH, in the layer's dtype:
    the kernel and its plain version each against an f64 evaluation of the
    plain version (the kernel's error at most the plain version's in bf16,
    where it rounds once and the plain version after every step; at most
    twice it in f32, as K13 is held: f32 sums whose order may differ), |out|
    <= clamp x the down filter's sum of |taps| (exactly <= clamp at the
    toRGB); timed with its bound, the plain version and the unfused
    composition (K4 + PyTorch's elementwise bias, act and clamp); then the
    whole layer forward (cuDNN + K5 + K11) against the same layer with the
    plain K5 and K11: K5 exact against its plain version on the layer's own
    conv output (demodulation only, or nothing at the toRGB), and each
    layer's output against the f64 evaluation of the plain K11 on its own
    K11 input, held as the kernel alone is. With --parent, the kernel
    against the parent's (k11_parent). -> summary."""
    import importlib

    import torch

    from panic3d_tpu_torch.ops.bias_act import (
        bias_act, modconv_epilogue_kernel, modconv_epilogue_plain)
    from panic3d_tpu_torch.ops.filtered_lrelu import (
        TILE, filtered_lrelu_kernel, filtered_lrelu_plain, k11_plan)
    from panic3d_tpu_torch.ops.upfirdn2d import upfirdn2d

    sg3 = importlib.import_module("panic3d_tpu_torch.models.stylegan3")
    conv = importlib.import_module("panic3d_tpu_torch.ops.conv")
    dtype = torch.bfloat16 if layer.use_fp16 else torch.float32
    n_in = layer.in_size + layer.kernel - 1   # the conv's output, K11's input
    c = layer.out_channels
    x = (torch.randn((SG3_BATCH, c, n_in, n_in), generator=gen, device=device)
         * K11_SCALE).to(dtype)
    b = (torch.randn((c,), generator=gen, device=device) * 0.3).to(dtype)
    kw = dict(fu=layer.up_filter, fd=layer.down_filter, b=b, up=layer.up_factor,
              down=layer.down_factor, padding=layer.padding,
              gain=1.0 if layer.is_torgb else math.sqrt(2),
              slope=1.0 if layer.is_torgb else 0.2, clamp=layer.conv_clamp)
    def f64_errs(x_in, k11_kw, *ys):   # the f64 evaluation, an image at a time
        kw64, errs = dict(k11_kw, b=k11_kw["b"].double()), [0.0] * len(ys)
        for i in range(x_in.shape[0]):
            y64 = filtered_lrelu_plain(x_in[i:i + 1].double(), **kw64)
            errs = [max(e_, float((y[i:i + 1].double() - y64).abs().max()))
                    for e_, y in zip(errs, ys)]
            del y64
        return errs

    yk = filtered_lrelu_kernel(x, **kw)
    yp = filtered_lrelu_plain(x, **kw)
    err_k, err_p = f64_errs(x, kw, yk, yp)
    factor = 1.0 if dtype == torch.bfloat16 else 2.0
    e = max_err(yk, yp)
    fd_abs = (float(layer.down_filter.abs().sum()) if layer.down_filter is not None else 1.0)
    if layer.down_filter is not None and layer.down_filter.ndim == 1:
        fd_abs = fd_abs ** 2
    peak = float(yk.float().abs().max())
    print(f"  K11 {label}: x {list(x.shape)} {str(dtype)[6:]} up {layer.up_factor} down "
          f"{layer.down_factor} pad {layer.padding} -> {list(yk.shape[2:])}; max |k - plain| "
          f"{e:.3e}; vs f64: kernel {err_k:.3e}, plain {err_p:.3e} (limit {factor:g}x); max "
          f"|out| {peak:.3f} (limit {layer.conv_clamp * fd_abs:.3f})")
    require(err_k <= factor * err_p,
            f"K11 {label}: error vs f64 {err_k} > {factor} x the plain version's {err_p}")
    require(peak <= layer.conv_clamp * fd_abs, f"K11 {label}: |out| {peak} beyond the clamp")
    if layer.is_torgb:
        require(peak <= layer.conv_clamp, f"K11 {label}: |out| {peak} > clamp")
    plan = k11_plan(x.shape, kw["fu"], kw["fd"], kw["up"], kw["down"], kw["padding"],
                    kw["gain"], kw["slope"], kw["clamp"])
    tile = (list(plan.strip.t) + [plan.strip.smem] if plan.strip else [TILE, TILE, None])
    print(f"    form {plan.form}, output tile {tile[0]}x{tile[1]}, shared memory {tile[2]} B")
    vs_parent = k11_parent(parent, lambda: filtered_lrelu_kernel(x, **kw), f"K11 {label}")

    def composition():
        y = bias_act(x, b)
        y = upfirdn2d(y, kw["fu"], up=kw["up"], padding=kw["padding"], gain=kw["up"] ** 2)
        y = bias_act(y, act="lrelu", alpha=kw["slope"], gain=kw["gain"], clamp=kw["clamp"])
        return upfirdn2d(y, kw["fd"], down=kw["down"])

    e_comp = max_err(composition(), yp)
    n_bytes, flops = nbytes(x, yk) + 4 * c, k11_ops(plan, SG3_BATCH, c, n_in)
    summ = record(e, lambda: filtered_lrelu_kernel(x, **kw),
                  lambda: filtered_lrelu_plain(x, **kw), n_bytes, flops, plain_iters=3)
    summ.update(composition_ms=cuda_ms(composition), bytes=n_bytes, flops=flops,
                form=plan.form, tile=tile, parent=vs_parent)
    del yk, yp

    # the whole layer: cuDNN conv + K5 + K11, against the layer with the
    # plain K5 and K11; spies keep each run's K5 arguments and K11 input
    xin = torch.randn((SG3_BATCH, layer.in_channels, layer.in_size, layer.in_size),
                      generator=gen, device=device)
    w = torch.randn((SG3_BATCH, 512), generator=gen, device=device)
    k5, k11 = conv.modconv_epilogue, sg3.filtered_lrelu

    def forward(k5_fn, k11_fn):
        seen = {}

        def k5_spy(*a, **k):
            seen["k5"] = (a, k)
            return k5_fn(*a, **k)

        def k11_spy(x_, **k):
            seen["k11"] = (x_, k)
            return k11_fn(x_, **k)

        conv.modconv_epilogue, sg3.filtered_lrelu = k5_spy, k11_spy
        try:
            return layer(xin, w), seen
        finally:
            conv.modconv_epilogue, sg3.filtered_lrelu = k5, k11

    out, seen = forward(k5, k11)
    out_plain, seen_plain = forward(modconv_epilogue_plain, filtered_lrelu_plain)
    a5, k5_kw = seen["k5"]
    e5 = max_err(modconv_epilogue_kernel(*a5, **k5_kw), modconv_epilogue_plain(*a5, **k5_kw))
    check(f"    K5 at {label}: {list(a5[0].shape)} {str(a5[0].dtype)[6:]}, "
          f"{'demodulation' if a5[1] is not None else 'no demodulation'} (exact)", e5, 0.0)
    e_layer = max_err(out, out_plain)
    err_layer, = f64_errs(*seen["k11"], out)
    err_layer_plain, = f64_errs(*seen_plain["k11"], out_plain)
    layer_ms = cuda_ms(lambda: layer(xin, w))
    print(f"    ms {summ['ms']:.6f}  bound_ms {summ['bound_ms']:.6f} ({summ['bound_by']})  "
          f"plain_ms {summ['plain_ms']:.6f}  composition_ms {summ['composition_ms']:.6f} "
          f"(vs plain {e_comp:.3e}); layer forward {layer_ms:.6f} ms, vs the plain layer's "
          f"{e_layer:.3e}; vs f64: layer {err_layer:.3e}, plain layer {err_layer_plain:.3e} "
          f"(limit {factor:g}x)")
    require(err_layer <= factor * err_layer_plain,
            f"K11 {label}: the layer's error vs f64 {err_layer} > {factor} x the plain "
            f"layer's {err_layer_plain}")
    summ.update(layer=label, x=list(x.shape), dtype=str(dtype)[6:], up=layer.up_factor,
                down=layer.down_factor, padding=list(layer.padding), out=list(out.shape[2:]),
                err_vs_f64=err_k, plain_err_vs_f64=err_p, layer_ms=layer_ms,
                layer_err_vs_plain=e_layer, layer_err_vs_f64=err_layer,
                plain_layer_err_vs_f64=err_layer_plain, k5_err=e5)
    del out, out_plain, xin, x, seen, seen_plain
    return summ


def k11_general_checks(device, gen, parent):
    """K11's general form (the geometries outside StyleGAN3's compiled ones)
    at two: up 2 with 24 up taps (12 a phase) and 12 down taps, f32, and up
    4 with 12 up taps (3 a phase) and the 12x12 radial filter, bf16, each on
    [4,64,60,60], held to f64 as k11_one holds the layers; with --parent,
    against the parent's (k11_parent). -> (max error vs the plain version,
    the parent comparisons)."""
    import torch

    from panic3d_tpu_torch.models.stylegan3 import design_lowpass_filter
    from panic3d_tpu_torch.ops.filtered_lrelu import filtered_lrelu_kernel, filtered_lrelu_plain

    err, vs_parent = 0.0, []
    for up, ut, dtype, radial in ((2, 24, torch.float32, False), (4, 12, torch.bfloat16, True)):
        fu = torch.from_numpy(design_lowpass_filter(ut, cutoff=10.0, width=6.0, fs=64.0))
        fd = torch.from_numpy(design_lowpass_filter(12, cutoff=9.0, width=7.0, fs=64.0,
                                                    radial=radial))
        x = (torch.randn((SG3_BATCH, 64, 60, 60), generator=gen, device=device)
             * K11_SCALE).to(dtype)
        b = (torch.randn((64,), generator=gen, device=device) * 0.3).to(dtype)
        kw = dict(fu=fu, fd=fd, b=b, up=up, down=2, padding=[ut // 2, ut // 2 - 1] * 2,
                  clamp=256.0)
        yk, yp = filtered_lrelu_kernel(x, **kw), filtered_lrelu_plain(x, **kw)
        y64 = filtered_lrelu_plain(x.double(), **dict(kw, b=b.double()))
        err_k, err_p = max_err(yk.double(), y64), max_err(yp.double(), y64)
        factor = 1.0 if dtype == torch.bfloat16 else 2.0
        e = max_err(yk, yp)
        print(f"  K11 general form: up {up}, {ut} up taps, {'12x12' if radial else '12'} down "
              f"taps, {str(dtype)[6:]} {list(x.shape)} -> {list(yk.shape[2:])}; max |k - plain| "
              f"{e:.3e}; vs f64: kernel {err_k:.3e}, plain {err_p:.3e} (limit {factor:g}x)")
        require(err_k <= factor * err_p, f"K11 general form: error vs f64 {err_k} > {factor} x "
                                         f"the plain version's {err_p}")
        vs_parent.append(k11_parent(parent, lambda: filtered_lrelu_kernel(x, **kw),
                                    f"K11 general form, up {up}"))
        err = max(err, e)
    return err, vs_parent


def sg3_layers(cfg, device, radial_only=False):
    """The AF layers of a StyleGAN3 configuration on the card, seeded
    weights -> [(label, layer)]."""
    from panic3d_tpu_torch.models.stylegan2 import init_weights
    from panic3d_tpu_torch.models.stylegan3 import AFSynthesisLayer

    out = []
    for i, g in enumerate(sg3_layer_geometries(cfg)):
        if radial_only and (g["is_critically_sampled"] or g["is_torgb"]):
            continue
        layer = AFSynthesisLayer(**g, device=device)
        init_weights(layer, SEED + i)
        out.append((f"{cfg} L{i} {'toRGB ' if g['is_torgb'] else ''}"
                    f"{g['in_size']}->{g['out_size']} C{g['out_channels']}", layer.eval()))
    return out


def k11_checks(device, parent):
    """K11 at every stylegan3-t geometry and the 12 radial stylegan3-r ones
    (k11_one), and in its general form (k11_general_checks), with --parent
    each against the parent's K11; the sums over the 15 T layers on a line
    of their own.
    -> {"filtered_lrelu": summary}: its top-level numbers are the 15 T
    layers' sums (the bound from their summed bytes and operations)."""
    import torch

    from panic3d_tpu_torch.kernels import KERNELS

    gen = torch.Generator(device=device).manual_seed(SEED)
    n0 = KERNELS["filtered_lrelu"].launches
    per = {}
    for cfg, radial in (("stylegan3-t", False), ("stylegan3-r", True)):
        print(f"K11 filtered_lrelu, {cfg}{' radial layers' if radial else ''} (batch {SG3_BATCH})")
        per[cfg] = [k11_one(layer, label, device, gen, parent)
                    for label, layer in sg3_layers(cfg, device, radial_only=radial)]
        torch.cuda.empty_cache()
    e_general, general_parent = k11_general_checks(device, gen, parent)
    require(KERNELS["filtered_lrelu"].launches > n0, "K11 did not launch")
    t = per["stylegan3-t"]
    sums = {k: sum(g[k] for g in t) for k in ("ms", "plain_ms", "composition_ms", "layer_ms")}
    n_bytes = sum(g["bytes"] for g in t)
    flops = sum(g["flops"] for g in t)
    bound_ms, bound_by = bound(n_bytes, flops)
    print(f"K11 over the 15 stylegan3-t layers at batch {SG3_BATCH}: {sums['ms']:.6f} ms (bound "
          f"{bound_ms:.6f} ms by {bound_by}; the layers' bounds summed "
          f"{sum(g['bound_ms'] for g in t):.6f}), plain {sums['plain_ms']:.6f} ms, unfused "
          f"composition {sums['composition_ms']:.6f} ms; the layers' forwards "
          f"{sums['layer_ms']:.6f} ms")
    parent_sums = None
    if t[0]["parent"] is not None:
        # each layer's last round: the parent's two times and this tree's two
        parent_sums = [sum(g["parent"]["ms_parent_this_this_parent"][i] for g in t)
                       for i in range(4)]
        print(f"K11 over the 15 stylegan3-t layers, parent / this / this / parent "
              + " / ".join(f"{v:.6f}" for v in parent_sums) + " ms")
    return {"filtered_lrelu": {
        "max_abs_err": max([e_general] + [g["max_abs_err"] for cfg in per for g in per[cfg]]),
        "ms": sums["ms"], "plain_ms": sums["plain_ms"], "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None, "composition_ms": sums["composition_ms"],
        "layers_forward_ms": sums["layer_ms"], "batch": SG3_BATCH,
        "parent_ms_parent_this_this_parent": parent_sums, "general_parent": general_parent,
        "geometries": {cfg: per[cfg] for cfg in per}}}


def sg3_layers_path(device, card):
    """The 15 stylegan3-t layers' forwards at batch 4 in sequence (each on
    its own seeded input, as a synthesis network's layers run), driven with
    the launch counts zeroed before and read after: K11 15 a run, K5 15.
    -> (launch counts, summary)."""
    import torch

    layers = sg3_layers("stylegan3-t", device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    ins = [(torch.randn((SG3_BATCH, m.in_channels, m.in_size, m.in_size), generator=gen,
                        device=device), torch.randn((SG3_BATCH, 512), generator=gen,
                                                    device=device)) for _, m in layers]

    def run():
        return [m(x, w) for (_, m), (x, w) in zip(layers, ins)]

    outs, counts, summ = drive(f"stylegan3-t layers (15 AF layers, batch {SG3_BATCH})", run,
                               len(layers), REQUESTS, card, unit="layers")
    for (label, m), y in zip(layers, outs):
        require(tuple(y.shape) == (SG3_BATCH, m.out_channels, m.out_size, m.out_size)
                and bool(torch.isfinite(y).all()), f"{label}: bad output")
    require_launched(counts, ("filtered_lrelu", "modconv_epilogue"), "stylegan3-t layers")
    require(summ["launches_per_run"]["filtered_lrelu"] == len(layers),
            f"K11 launched {summ['launches_per_run']['filtered_lrelu']} times a run")
    print(f"  {summ['ms_per_run']:.3f} ms for the 15 layers  [{card}]")
    return counts, summ


def blob_synthesis(res):
    """The toy generator of tests/test_equivariance.py:95-113 in torch, at
    ``res``: Gaussian blobs whose coordinates ride the input transform,
    equivariant by construction."""
    import torch

    def synthesis(ws, transform):
        xs = -0.5 + (torch.arange(res, dtype=torch.float32, device=ws.device) + 0.5) / res
        gy, gx = torch.meshgrid(xs, xs, indexing="ij")
        pts = torch.stack([gx, gy, torch.ones_like(gx)], -1) @ transform.T
        cx, cy = ws[:, 0, None, None] * 0.2, ws[:, 1, None, None] * 0.2
        sg = 0.06 + 0.025 * torch.sigmoid(ws[:, 2, None, None])
        d2 = (pts[..., 0] - cx) ** 2 + (pts[..., 1] - cy) ** 2
        img = torch.exp(-d2 / (2 * sg ** 2))
        return torch.stack([img, 0.5 * img, img * img], 1)

    return synthesis


EQ_METRICS = ("eqt50k_int", "eqt50k_frac", "eqr50k")


def equivariance_path(device, card):
    """calc_metric("eqt50k_int" | "eqt50k_frac" | "eqr50k") at 512^2, 64
    samples in batches of 4, on the toy generator, on the card through
    drive() (a warm-up run, REQUESTS timed runs with the launch counts
    zeroed before and read after, then one run counting host waits: one a
    batch, the sums' copy), then on the CPU with the same latents and the
    same generator draws: the PSNRs within 0.01 dB; K4's large-filter
    kernel launched on EQ-R. -> (launch counts of EQ-R's runs, summary)."""
    import torch

    from panic3d_tpu_torch.eval.gan_metrics import calc_metric
    from panic3d_tpu_torch.utils.device import to_device

    batches = EQ_SAMPLES // SG3_BATCH
    ws_host = torch.randn((EQ_SAMPLES, 3), generator=torch.Generator().manual_seed(SEED))
    ws_dev = to_device(ws_host.numpy(), device)
    synthesis = blob_synthesis(EQ_RES)

    def metric(name, ws):
        return calc_metric(name, synthesis_fn=synthesis,
                           ws_iter=iter(ws.split(SG3_BATCH)), num_samples=EQ_SAMPLES,
                           img_resolution=EQ_RES,
                           generator=torch.Generator().manual_seed(SEED))["results"][name]

    out, counts_r = {}, None
    for name in EQ_METRICS:
        psnr, counts, summ = drive(
            f"{name} at {EQ_RES}^2 ({EQ_SAMPLES} samples in batches of {SG3_BATCH})",
            lambda: metric(name, ws_dev), EQ_SAMPLES, REQUESTS, card, unit="samples",
            waits=lambda _: batches)
        t = time.perf_counter()
        psnr_cpu = metric(name, ws_host)
        cpu_s = time.perf_counter() - t
        diff = 0.0 if psnr == psnr_cpu else abs(psnr - psnr_cpu)
        k4 = summ["variants_per_run"].get("upfirdn2d", {})
        print(f"  card {psnr:.6f} dB, CPU {psnr_cpu:.6f} dB (|diff| {diff:.3e}); "
              f"{summ['ms_per_run'] / batches:.3f} ms a batch; CPU run {cpu_s:.1f} s  [{card}]")
        require(diff <= 0.01, f"{name}: card {psnr} dB vs CPU {psnr_cpu} dB")
        require(math.isfinite(psnr) or psnr == math.inf, f"{name}: PSNR {psnr}")
        if name == "eqr50k":
            require(k4.get("large", 0) >= 2 * batches,
                    f"eqr50k: K4's large-filter kernel launched {k4.get('large', 0)} times a run")
            k14 = summ["launches_per_run"].get("grid_sample_2d", 0)
            require(k14 >= batches, f"eqr50k: K14 launched {k14:g} times a run of {batches} "
                                    "batches")
            counts_r = counts
        finite = {v: (v if math.isfinite(v) else str(v)) for v in (psnr, psnr_cpu)}
        out[name] = dict(summ, psnr_db=finite[psnr], cpu_psnr_db=finite[psnr_cpu],
                         ms_per_batch=summ["ms_per_run"] / batches, cpu_s=cpu_s)
    return counts_r, out


def eqr_profile(device) -> dict:
    """One EQ-R batch (calc_metric("eqr50k") of SG3_BATCH samples of the toy
    generator at EQ_RES^2) under torch.profiler, its device kernel time
    split by name: K4 (upfirdn2d), the rotation filters' FFTs (cuFFT's
    kernels, *fft*, complex128: F13), grid_sample_2d on the up-4 image (K14;
    the kernels launched inside a record_function range around
    eval/equivariance.py's grid_sample_2d), and the rest; with the
    host span and the device's busy time. -> {part: ms}."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from panic3d_tpu_torch.eval import equivariance as eq
    from panic3d_tpu_torch.eval.gan_metrics import calc_metric
    from panic3d_tpu_torch.utils.device import to_device

    ws = to_device(torch.randn((SG3_BATCH, 3),
                               generator=torch.Generator().manual_seed(SEED)).numpy(), device)
    synthesis = blob_synthesis(EQ_RES)
    sample = eq.grid_sample_2d

    def traced(*a, **k):
        with record_function("grid_sample_2d"):
            return sample(*a, **k)

    def batch():
        return calc_metric("eqr50k", synthesis_fn=synthesis, ws_iter=iter([ws]),
                           num_samples=SG3_BATCH, img_resolution=EQ_RES,
                           generator=torch.Generator().manual_seed(SEED))

    eq.grid_sample_2d = traced
    try:
        batch()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            batch()
            torch.cuda.synchronize()
    finally:
        eq.grid_sample_2d = sample
    path = os.path.join(BUILD_TMP, "eqr_batch_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    os.unlink(path)
    ev = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    ranges = [(e["ts"], e["ts"] + e["dur"], e.get("tid")) for e in ev
              if e.get("name") == "grid_sample_2d" and e.get("cat") != "kernel"]
    dev_cats = ("kernel", "gpu_memcpy", "gpu_memset")
    inside = {e["args"]["correlation"] for e in ev
              if e.get("cat") not in dev_cats and "correlation" in e.get("args", {})
              and any(t0 <= e["ts"] <= t1 and tid == e.get("tid") for t0, t1, tid in ranges)}
    parts = dict.fromkeys(("K4 upfirdn2d", "complex128 FFTs", "grid_sample_2d", "rest"), 0.0)
    counts = dict.fromkeys(parts, 0)
    for e in ev:
        if e.get("cat") not in dev_cats:
            continue
        name = e.get("name", "")
        part = ("K4 upfirdn2d" if "upfirdn2d" in name else
                "complex128 FFTs" if re.search("fft", name, re.I) else
                "grid_sample_2d" if e.get("args", {}).get("correlation") in inside
                else "rest")
        parts[part] += e["dur"] / 1e3
        counts[part] += 1
    busy, span, n_dev, n_ops = busy_span(trace)
    print(f"one EQ-R batch ({SG3_BATCH} samples at {EQ_RES}^2) by device kernel: "
          + ", ".join(f"{k} {v:.6f} ms ({counts[k]})" for k, v in parts.items())
          + f"; device busy {busy:.3f} of a {span:.3f} ms span, {n_dev} device launches "
          f"from {n_ops} host ops")
    return dict(ms=parts, launches=counts, busy_ms=busy, span_ms=span, host_ops=n_ops)


DEEP_KERNELS = ("triplane_decode_deep", "ray_composite", "importance_sample", "upfirdn2d",
                "modconv_epilogue", "paste_front")
DEEP_ABSENT = ("triplane_decode", "volume_density", "ess_occupancy", "ess_narrow",
               "occlusion_volume", "occlusion_sample", "paste_front_occ")


def deep_plane_paths(Gd, x, device, card):
    """The deep-plane generator (flagship eval, triplane_depth DEEP_DEPTH,
    ESS off, 96+96) on its three entry points, with eval generate's paste
    and the render occlusion (the JAX package's ESS and grid occlusion fail
    at D > 1, ROADMAP F12): G.f per call (bench.py's inputs, bs 2), with
    the bf16 default against the same weights pinned to f32; the
    per-portrait turntable (a planes bundle of planes alone, then the 16
    eval views in view batches of 2); Reconstructor.mesh at 256^3 with eval
    generate's filters and without them (at the grid's own levels,
    mesh_levels). Each requires K10, K4, K5 and, on the view paths, K2, K3
    and K8 launched (K10's render form on the views and the mesh's vertex
    colours, its lattice form on the mesh's grid), and K1, K1v, K6 and K7
    launched no time. -> (summaries by path, the launch counts of the
    per-call path and of the no-filters mesh)."""
    import numpy as np

    from panic3d_tpu_torch import configs
    from panic3d_tpu_torch.api import Reconstructor
    from panic3d_tpu_torch.eval import volume as vol
    from panic3d_tpu_torch.eval.generate import (
        INFERENCE_OPTS, eval_views, planes_bundle, render_from_planes)
    from panic3d_tpu_torch.models.volumetric import renderer as vr

    paste = dict(INFERENCE_OPTS["paste_params"], occ_impl="render")
    xp = dict(x, paste_params=paste)
    summaries = {}
    out, counts, summ = drive(
        f"deep planes per call (triplane_depth {DEEP_DEPTH}, ESS off, 96+96, render paste, "
        f"bs={BATCH})", lambda: Gd.f(xp), BATCH, REQUESTS, card)
    check_outputs(out, (BATCH, 3, 512, 512))
    require_launched(counts, DEEP_KERNELS, "deep per call")
    require_absent(counts, DEEP_ABSENT, "deep per call")
    require_k4_polyphase(summ, "deep per call")
    for k in PASTE_KEYS:
        print(f"  {k} passes {float(out['paste'][k].mean()):.4f}")
    summaries["deep_per_call"], counts_call = summ, counts

    def make_f32(rendering_kwargs, **kw):
        return configs.flagship(eval_mode=True, rendering_kwargs=dict(
            rendering_kwargs, triplane_depth=DEEP_DEPTH), **kw)

    bf16_closeness(Gd, xp, out, make_f32)
    del out

    opts = dict(EVAL_FILTERS, paste_params=paste)
    cond1 = {k: v[:1] for k, v in x["cond"].items()}
    views = eval_views()
    bundle = planes_bundle(Gd, SEED, cond1, opts)
    require(set(bundle) == {"ws", "planes"}, f"deep planes bundle holds {set(bundle)}")

    def portrait():
        bundle = planes_bundle(Gd, SEED, cond1, opts)
        last = None
        for i in range(0, len(views), BATCH):
            cc = views[i:i + BATCH]
            cc = cc + [cc[-1]] * (BATCH - len(cc))
            last = render_from_planes(Gd, opts, bundle, [c[2] for c in cc], [c[3] for c in cc],
                                      [c[4] for c in cc], cond1)
        return last

    out, counts, summ = drive(
        f"deep planes turntable ({len(views)} views, view batch {BATCH})", portrait,
        len(views), DEEP_PORTRAITS, card)
    check_outputs(out, (BATCH, 3, 512, 512))
    require_launched(counts, DEEP_KERNELS, "deep turntable")
    require_absent(counts, DEEP_ABSENT, "deep turntable")
    print(f"  {summ['ms_per_run'] / 1e3:.4f} s/portrait  [{card}]")
    summaries["deep_turntable"] = summ
    del out

    _, planes = vol.portrait_planes(Gd, portrait_input(Gd, device))
    grid = vol.density_grid(planes, Gd._decoder(), MESH_RES, Gd.rk["box_warp"],
                            vr.generate_plane_axes(Gd.rk["use_triplane"]), vr.DensityFilters(),
                            triplane_depth=DEEP_DEPTH)
    level0 = mesh_levels(grid)[0]
    del grid
    for key, mopts, level in (("deep_mesh_eval_filters", EVAL_FILTERS, LEVEL),
                              ("deep_mesh_no_filters", {}, level0)):
        rec = Reconstructor(model=Gd, opts=mopts)
        mesh, counts, summ = drive(
            f"deep planes mesh, {'eval filters' if mopts else 'no filters'} ({MESH_RES}^3, "
            f"level {level:.6f})", lambda: rec.mesh(cond1, resolution=MESH_RES, level=level), 1,
            MESH_RUNS, card, unit="portraits", waits=lambda m: 1 + int(len(m["verts"]) > 0))
        stages = {}
        rec.mesh(cond1, resolution=MESH_RES, level=level, stages=stages)
        v, f, c = mesh["verts"], mesh["faces"], mesh["colors"]
        require(np.isfinite(v).all() and (f.size == 0 or (f.min() >= 0 and f.max() < len(v)))
                and (c.size == 0 or (c.min() >= 0 and c.max() <= 1)), f"{key}: bad mesh")
        print(f"  {summ['ms_per_run'] / 1e3:.4f} s/portrait; one staged run: "
              + ", ".join(f"{k} {t * 1e3:.3f} ms" for k, t in stages.items())
              + f"; {len(v)} verts, {len(f)} faces  [{card}]")
        require_launched(counts, ("volume_density_deep", "upfirdn2d", "modconv_epilogue")
                         + (("triplane_decode_deep",) if len(v) else ()), key)
        require_absent(counts, DEEP_ABSENT, key)
        summ.update(stages_ms={k: t * 1e3 for k, t in stages.items()}, verts=len(v),
                    faces=len(f), level=level)
        summaries[key] = summ
    return summaries, (counts_call, counts)


def require_k4_polyphase(summary, label):
    """Every K4 launch of a path ran the polyphase (up2) kernel."""
    k4 = summary["launches_per_run"].get("upfirdn2d", 0)
    up2 = summary["variants_per_run"].get("upfirdn2d", {}).get("up2", 0)
    print(f"  K4 launches per run {k4:g}, of them polyphase (up2) {up2:g}")
    require(k4 > 0 and up2 == k4, f"{label}: K4 ran {k4} launches, {up2} polyphase")


def require_launched(counts, names, label):
    missing = [k for k in names if counts[k] == 0]
    require(not missing, f"{label}: kernels not launched: {missing}")


def require_absent(counts, names, label):
    launched = {k: counts[k] for k in names if counts[k]}
    print(f"  launched no time: {', '.join(names)}")
    require(not launched, f"{label}: kernels launched off their path: {launched}")


def check_outputs(out, shape):
    import torch

    img = out["image"]
    require(tuple(img.shape) == shape, f"image shape {tuple(img.shape)}")
    for k in ("image", "image_raw", "image_depth", "image_weights", "image_xyz"):
        if k in out:
            require(bool(torch.isfinite(out[k]).all()), f"non-finite {k}")
    require(float(out["image_weights"].abs().max()) > 0, "image_weights all zero")
    print(f"  image range [{float(img.min()):.4f}, {float(img.max()):.4f}], "
          f"mean weight {float(out['image_weights'].mean()):.4f}")


def launch_means(fn, runs: int = 5) -> dict:
    """``runs`` calls of fn after a warm-up under one torch.profiler window:
    for each device kernel name (its first 60 characters) the launches
    recorded and their mean device time in ms. The profiler can drop a
    launch's record (a K10 backward call's 4 launches were recorded 3.4
    times a call), so a kernel's time is its recorded launches' mean, not
    a sum divided by ``runs``."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    with tempfile.NamedTemporaryFile(suffix=".json", dir=BUILD_TMP) as f:
        prof.export_chrome_trace(f.name)
        with open(f.name) as g:
            trace = json.load(g)
    seen = {}
    for e in trace["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            n, total = seen.get(e.get("name", "")[:60], (0, 0.0))
            seen[e.get("name", "")[:60]] = (n + 1, total + e["dur"] / 1e3)
    return {k: (n, total / n) for k, (n, total) in seen.items()}


def busy_span(trace: dict):
    """The card's busy time in a profiled run, from its chrome trace: the
    union of kernel, copy and memset intervals, and the span from the
    first host-side op to the last device interval. -> (busy ms, span ms,
    device intervals, host-side ops)."""
    ev = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    dev = sorted((e["ts"], e["ts"] + e["dur"]) for e in ev
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    ops = [e for e in ev if e.get("cat") == "cpu_op"]
    busy, end = 0.0, float("-inf")
    for t0, t1 in dev:
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    span = end - min(e["ts"] for e in ops + [{"ts": dev[0][0]}])
    return busy / 1e3, span / 1e3, len(dev), len(ops)


def device_busy(trace: dict) -> str:
    busy, span, n_dev, n_ops = busy_span(trace)
    return (f"profiled request: device busy {busy:.3f} ms of a {span:.3f} ms span "
            f"({100 * busy / span:.1f} %); {n_dev} device kernels and copies from "
            f"{n_ops} host-side ops")


def device_time_by_kind(trace: dict) -> str:
    """Device kernel time in a profiled run by kind: K10, K4, K1, K5, K2,
    K6a's decode and dilation, K7a, the factored first layer of K6a and
    K7a, PyTorch's elementwise kernels (the epilogue's unfused ops and
    other glue), the other kernels."""
    kinds = {"K10 triplane_decode_deep": r"triplane_decode_kernel<[^>]*, [12]>",
             "K4 upfirdn2d": "upfirdn2d", "K1 triplane_decode": "triplane_decode_kernel",
             "K5 modconv_epilogue": "modconv_epilogue", "K2 ray_composite": "ray_composite",
             "K6a ess_occupancy": "ess_occupancy_kernel|dilate3_kernel",
             "K7a occlusion_volume": "occlusion_volume_kernel",
             "K6a/K7a factor_terms": "factor_terms_kernel",
             "PyTorch elementwise": "elementwise_kernel"}
    times = dict.fromkeys([*kinds, "other"], 0.0)
    counts = dict.fromkeys(times, 0)
    for e in trace["traceEvents"]:
        if e.get("ph") != "X" or e.get("cat") != "kernel":
            continue
        name = e.get("name", "")
        kind = next((k for k, part in kinds.items() if re.search(part, name)), "other")
        times[kind] += e["dur"]
        counts[kind] += 1
    return "device kernel time by kind: " + ", ".join(
        f"{k} {t / 1e3:.3f} ms ({counts[k]} launches)" for k, t in times.items())


RENDER_KERNELS = ("triplane_decode", "ray_composite", "importance_sample", "upfirdn2d",
                  "modconv_epilogue")
# the grid occlusion's paths: K8's paste_front_occ entry reads the volume;
# K7b's sampler and K8's map-taking entry launch no time there
ESS_PASTE_KERNELS = RENDER_KERNELS + ("ess_occupancy", "ess_narrow", "occlusion_volume",
                                      "paste_front_occ")
GRID_PASTE_ABSENT = ("occlusion_sample", "paste_front")
# kernels no path of the port launches since K8 took the grid occlusion in:
# checked among the kernels only
CHECK_ONLY = ("occlusion_sample",)


# ---------------------------------------------------------------------------
# the keyed forward (training's G.f: noise_mode='random', a render key)

KEYED_BATCH = 8     # the trainer's --batch default (panic3d_tpu/training/trainer.py:35)
KEYED_RUNS = 3      # timed keyed forwards a configuration, after one warm-up
# the keyed forms each kernel wrapper counts as a variant, by configuration
KEYED_FORMS = {"ess off": {"importance_sample": "u", "modconv_epilogue": "per_sample_noise"},
               "ess on": {"importance_sample": "u", "modconv_epilogue": "per_sample_noise",
                          "ess_narrow": "jitter"},
               "auto, ess on": {"importance_sample": "u", "modconv_epilogue": "per_sample_noise",
                                "ess_narrow": "per_ray"}}
KEYED_KERNELS = {"ess off": RENDER_KERNELS,
                 "ess on": RENDER_KERNELS + ("ess_occupancy", "ess_narrow"),
                 "auto, ess on": RENDER_KERNELS + ("ess_occupancy", "ess_narrow")}


def keyed_generators(device, labels=("ess off", "ess on", "auto, ess on"), **kw):
    """The flagship with the training settings (48+48 samples, eval_mode
    False), seeded weights with the sigma bias raised (as the eval paths)
    and every noise strength 0.1 (the seeded init zeroes them), as three
    generators: ESS off, ESS on, and ESS on with ray_start = ray_end =
    'auto' (those of ``labels``). -> {label: generator}."""
    import torch

    from panic3d_tpu_torch import configs
    from panic3d_tpu_torch.models.stylegan2 import SynthesisLayer

    G = configs.flagship(device=device, **kw).init_weights(SEED).eval()
    with torch.no_grad():
        G.decoder.net[2].bias[0] += 2.5
        for m in G.modules():
            if isinstance(m, SynthesisLayer) and m.use_noise:
                m.noise_strength.fill_(0.1)
    out = {"ess off": G}
    base = kw.pop("rendering_kwargs", {})
    for label, rk in (("ess on", {}), ("auto, ess on", dict(ray_start="auto", ray_end="auto"))):
        if label in labels:
            Gx = configs.flagship(ess=True, device=device, rendering_kwargs=dict(base, **rk),
                                  **kw).eval()
            Gx.load_state_dict(G.state_dict())
            out[label] = Gx
    return {k: v for k, v in out.items() if k in labels}


def keyed_inputs(G, device, n=KEYED_BATCH):
    """n training-like views: seeded z, cond and cameras (elevation within
    +-20, any azimuth, fov 30)."""
    import torch

    rng = np.random.RandomState(SEED + 1)
    return {"z": torch.from_numpy(rng.randn(n, G.z_dim).astype(np.float32)).to(device),
            "elevations": torch.from_numpy(rng.uniform(-20, 20, n).astype(np.float32)).to(device),
            "azimuths": torch.from_numpy(rng.uniform(0, 360, n).astype(np.float32)).to(device),
            "cond": {"image_ortho_front": torch.from_numpy(
                         rng.rand(n, 3, 512, 512).astype(np.float32)).to(device),
                     "resnet_chonk": torch.from_numpy(
                         rng.randn(n, 512, 8, 8).astype(np.float32)).to(device)}}


def _recorder_class():
    from panic3d_tpu_torch.utils import draws

    class Recorder(draws.Replay):
        """Draws from a torch.Generator, each kept (by kind, in order) so that
        a Replay can feed the same numbers to another run."""

        def __init__(self, generator):
            super().__init__()
            self.generator, self.kept = generator, {"normal": [], "uniform": []}

        def take(self, kind, shape, device):
            t = draws._draw(kind, shape, self.generator, device, "Recorder")
            self.kept[kind].append(t)
            return t

        def replay(self, device):
            return draws.Replay(**{k: [t.to(device) for t in v] for k, v in self.kept.items()})

    return Recorder


class plain_shadow:
    """Within the block, every launch of K1, K2, K3, K5 and K6b also runs the
    kernel's plain version on the same inputs (the drawn jitter, u and
    noise included) and keeps the largest difference by kernel and form:
    K5 exact, K6b within 1e-6 (the plain version's own ops on the card),
    K3, K2 within 1e-4 (f32 scan and sum order), K1 as check_k1 (cull flips
    counted apart, rgb within 2^-8 in bf16, sigma within 1e-4). K2 calls also
    count the rays with a half out of depth order (the rank-count branch).
    The last inputs of each keyed form are kept (``inputs``) for timing."""

    def __init__(self):
        self.err, self.calls, self.inputs = {}, {}, {}
        self.unsorted_rays = self.flips = self.points = 0

    def _keep(self, key, err):
        self.err[key] = max(self.err.get(key, 0.0), err)
        self.calls[key] = self.calls.get(key, 0) + 1

    def __enter__(self):
        import importlib

        import torch

        vr = importlib.import_module("panic3d_tpu_torch.models.volumetric.renderer")
        ba = importlib.import_module("panic3d_tpu_torch.ops.bias_act")
        self.saved = [(vr, n, getattr(vr, n)) for n in (
            "triplane_decode_kernel", "importance_sample_kernel", "ray_composite_kernel",
            "ess_narrow_kernel")] + [(ba, "modconv_epilogue_kernel", ba.modconv_epilogue_kernel)]
        real = {n: f for _, n, f in self.saved}

        def k1(planes_cl, coords, dec, bw, axes, filters=vr.DensityFilters()):
            rgb, sig = real["triplane_decode_kernel"](planes_cl, coords, dec, bw, axes, filters)
            rgb_p, sig_p = vr.triplane_decode_plain(planes_cl, coords, dec, bw, axes, filters)
            ck, cp = sig == -1e3, sig_p == -1e3
            self.flips += int((ck != cp).sum())
            self.points += sig.numel()
            agree = ck == cp
            self._keep(("triplane_decode", "rgb"), max_err(rgb, rgb_p))
            self._keep(("triplane_decode", "sigma"),
                       float((sig - sig_p).abs()[agree].max()) if bool(agree.any()) else 0.0)
            return rgb, sig

        def k3(depths, sigmas, n_importance, u=None):
            out = real["importance_sample_kernel"](depths, sigmas, n_importance, u)
            form = "u" if u is not None else "linspace"
            self._keep(("importance_sample", form),
                       max_err(out, vr.importance_sample_plain(depths, sigmas, n_importance, u)))
            self.inputs[("importance_sample", form)] = (depths, sigmas, n_importance, u)
            return out

        def k2(d1, c1, s1, x1, d2, c2, s2, x2, white_back):
            args = (d1, c1, s1, x1, d2, c2, s2, x2, white_back)
            out = real["ray_composite_kernel"](*args)
            for a, b in zip(out, vr.ray_composite_plain(*args)):
                self._keep(("ray_composite", "merge"), max_err(a, b))
            bad = torch.zeros(d1.shape[:2], dtype=torch.bool, device=d1.device)
            for d in (d1, d2):
                if d.shape[2] > 1:
                    bad |= (d[:, :, 1:, 0] < d[:, :, :-1, 0]).any(-1)
            self.unsorted_rays += int(bad.sum())
            return out

        def k6b(occ, occ_outside, ro, rd, ray_start, ray_end, bw, options, S, jitter=None):
            args = (occ, occ_outside, ro, rd, ray_start, ray_end, bw, options, S)
            out = real["ess_narrow_kernel"](*args, jitter=jitter)
            form = ("per_ray" if torch.is_tensor(ray_start) else "fixed") + (
                "+jitter" if jitter is not None else "")
            for a, b in zip(out, vr.ess_narrow_plain(*args, jitter=jitter)):
                self._keep(("ess_narrow", form), max_err(a, b))
            self.inputs[("ess_narrow", form)] = (args, jitter)
            return out

        def k5(x, dcoef=None, noise=None, noise_strength=None, bias=None, *rest):
            out = real["modconv_epilogue_kernel"](x, dcoef, noise, noise_strength, bias, *rest)
            plain = ba.modconv_epilogue_plain(x, dcoef, noise, noise_strength, bias, *rest)
            form = "per_sample_noise" if noise is not None and noise.ndim == 4 else "other"
            self._keep(("modconv_epilogue", form), max_err(out, plain))
            if form == "per_sample_noise":
                kept = self.inputs.get(("modconv_epilogue", form))
                if kept is None or x.numel() > kept[0].numel():
                    self.inputs[("modconv_epilogue", form)] = (x, dcoef, noise, noise_strength,
                                                               bias, *rest)
            return out

        for mod, name, fn in ((vr, "triplane_decode_kernel", k1),
                              (vr, "importance_sample_kernel", k3),
                              (vr, "ray_composite_kernel", k2), (vr, "ess_narrow_kernel", k6b),
                              (ba, "modconv_epilogue_kernel", k5)):
            setattr(mod, name, fn)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)

    def report(self, label):
        """Print and check the differences; -> {kernel.form: max error}."""
        tol = {"triplane_decode": {"rgb": 2.0 ** -8, "sigma": 1e-4},
               "importance_sample": 1e-4, "ray_composite": 1e-4, "ess_narrow": 1e-6,
               "modconv_epilogue": 0.0}
        out = {}
        for (name, form), e in sorted(self.err.items()):
            t = tol[name][form] if isinstance(tol[name], dict) else tol[name]
            check(f"{label}: {name} [{form}] kernel vs plain, {self.calls[(name, form)]} calls",
                  e, t)
            out[f"{name}.{form}"] = e
        print(f"  {label}: K1 cull decisions that differ {self.flips} of {self.points}")
        require(self.flips <= self.points // 100000, f"{label}: {self.flips} cull flips")
        print(f"  {label}: rays that take K2's rank-count branch (a half out of order): "
              f"{self.unsorted_rays}")
        require(self.unsorted_rays > 0, f"{label}: no ray took K2's unsorted branch")
        return dict(out, k2_unsorted_rays=self.unsorted_rays, k1_cull_flips=self.flips)


def keyed_forward_path(device, card):
    """The keyed forward at full width (the flagship with the training
    settings, batch KEYED_BATCH, G.f(x, noise_mode='random', generator=g)),
    ESS off, on, and on with 'auto' bounds: each driven (views/s, launches,
    0 host waits) with K3's u form, K5's per-sample noise form and, with
    ESS, K6b's jitter or per-ray form required; the same generator seed twice
    equal, another seed changing image_raw; one run with every kernel
    launch shadowed by its plain version (plain_shadow). -> (paths summary,
    {(kernel, form): inputs} for the form checks, launch counts of the ESS
    run)."""
    import torch

    Gs = keyed_generators(device)
    x = keyed_inputs(Gs["ess off"], device)
    summary, inputs, counts_ess = {}, {}, None
    for label, G in Gs.items():
        gen = torch.Generator(device=device).manual_seed(SEED)
        out, counts, summ = drive(
            f"keyed forward, {label} (48+48, bs={KEYED_BATCH}, noise_mode='random', a "
            "generator)", lambda: G.f(x, noise_mode="random", generator=gen), KEYED_BATCH,
            KEYED_RUNS, card)
        check_outputs(out, (KEYED_BATCH, 3, 512, 512))
        require_launched(counts, KEYED_KERNELS[label], f"keyed {label}")
        for name, form in KEYED_FORMS[label].items():
            n = summ["variants_per_run"].get(name, {}).get(form, 0)
            print(f"  {name} [{form}] launches per run {n:g}")
            require(n > 0, f"keyed {label}: {name}'s {form} form launched no time")
        if label == "ess on":
            counts_ess = counts
        del out

        def run(seed):
            g = torch.Generator(device=device).manual_seed(seed)
            return G.f(x, noise_mode="random", generator=g)

        a, b, c = run(7), run(7), run(8)
        same = all(torch.equal(a[k], b[k]) for k in ("image", "image_raw", "image_depth"))
        moved = float((a["image_raw"] - c["image_raw"]).abs().max())
        print(f"  same seed twice equal: {same}; another seed moves image_raw by {moved:.4f}")
        require(same, f"keyed {label}: one seed gave two outputs")
        require(moved > 0, f"keyed {label}: the draws do not reach image_raw")
        del a, b, c
        with plain_shadow() as shadow:
            run(7)
            torch.cuda.synchronize()
        summ["kernel_vs_plain"] = shadow.report(f"keyed {label}")
        for key, val in shadow.inputs.items():
            inputs.setdefault(key, val)
        summary[label.replace(", ", "_").replace(" ", "_")] = summ
    return summary, inputs, counts_ess


def keyed_form_checks(inputs, keyed):
    """Each new kernel form alone at the keyed path's shapes against its
    plain version, timed with its bound (no single library call computes
    any of them). -> {kernel name: {form: summary}}."""
    import torch

    from panic3d_tpu_torch.models.volumetric import renderer as vr
    from panic3d_tpu_torch.ops.bias_act import modconv_epilogue_kernel, modconv_epilogue_plain

    out = {}
    d, s, K, u = inputs[("importance_sample", "u")]
    B, R, S, _ = d.shape
    y = vr.importance_sample_kernel(d, s, K, u)
    e = max_err(y, vr.importance_sample_plain(d, s, K, u))
    check(f"K3 importance_sample, u form, {S}+{K} at {B}x{R} rays", e, 1e-4)
    out["importance_sample"] = {"u": dict(record(
        e, lambda: vr.importance_sample_kernel(d, s, K, u),
        lambda: vr.importance_sample_plain(d, s, K, u), nbytes(d, s, u, y),
        B * R * (S * 20 + K * 10)), samples=f"{S}+{K}")}

    args5 = inputs[("modconv_epilogue", "per_sample_noise")]
    x5, dcoef, noise = args5[:3]
    y = modconv_epilogue_kernel(*args5)
    e = max_err(y, modconv_epilogue_plain(*args5))
    check(f"K5 modconv_epilogue, per-sample noise, {x5.dtype} {tuple(x5.shape)} (exact)", e, 0.0)
    reads = [t for t in (dcoef, noise, args5[4]) if t is not None]
    out["modconv_epilogue"] = {"per_sample_noise": dict(record(
        e, lambda: modconv_epilogue_kernel(*args5), lambda: modconv_epilogue_plain(*args5),
        nbytes(x5, y, *reads), y.numel() * 8), shape=list(x5.shape), dtype=str(x5.dtype))}

    args6, jitter = inputs[("ess_narrow", "per_ray+jitter")]
    occ, ro, rs_, re_ = args6[0], args6[2], args6[4], args6[5]
    S6, taps = args6[8], int(args6[7]["ess"].get("taps", 64))
    k6 = vr.ess_narrow_kernel(*args6, jitter=jitter)
    e = max(max_err(a, b) for a, b in zip(k6, vr.ess_narrow_plain(*args6, jitter=jitter)))
    check(f"K6b ess_narrow, per-ray bounds and jitter, {tuple(ro.shape[:2])} rays", e, 1e-6)
    n_rays = ro.shape[0] * ro.shape[1]
    out["ess_narrow"] = {"per_ray": dict(record(
        e, lambda: vr.ess_narrow_kernel(*args6, jitter=jitter),
        lambda: vr.ess_narrow_plain(*args6, jitter=jitter),
        nbytes(occ, args6[2], args6[3], rs_, re_, jitter, *k6), n_rays * (taps * 20 + S6 * 6)),
        taps=taps, samples=S6)}
    for name, forms in out.items():
        for form, summ in forms.items():
            summ["launches_keyed_per_run"] = {
                cfg: v["variants_per_run"].get(name, {}).get(form, 0) for cfg, v in keyed.items()}
            print(f"  {name} [{form}]: ms {summ['ms']:.6f} (plain {summ['plain_ms']:.6f}), "
                  f"bound {summ['bound_ms']:.6f} ms by {summ['bound_by']}")
    return out


def keyed_parent_checks(parent, inputs):
    """With --parent (the parent's importance_sample.cu, ess.cu and
    modconv_epilogue.cu): this tree's K3 without u, K6b with fixed bounds
    and no jitter and K5 with one noise map for the batch give the parent
    kernels' outputs bit for bit, timed parent / this / this / parent.
    The parent's entry points take their own (shorter) argument lists."""
    import ctypes

    import torch

    from panic3d_tpu_torch.kernels import build as kb
    from panic3d_tpu_torch.models.volumetric import renderer as vr
    from panic3d_tpu_torch.ops.bias_act import activation_funcs, modconv_epilogue_kernel

    if not all(k in parent for k in ("importance_sample", "ess", "modconv_epilogue")):
        return {}

    def entry(stem, name, argtypes):
        fn = getattr(parent[stem][0], name)
        fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
        return fn

    P, I, L, F = kb.PTR, kb.INT, kb.LONG, kb.FLOAT
    stream = torch.cuda.current_stream().cuda_stream
    res = {}

    d, s, K, _ = inputs[("importance_sample", "u")]
    k3_old = entry("importance_sample", "importance_sample", (P, P, P, I, I, I, P))

    def k3_parent():
        o = torch.empty((*d.shape[:2], K, 1), device=d.device)
        require(k3_old(d.data_ptr(), s.data_ptr(), o.data_ptr(), d.shape[0] * d.shape[1],
                       d.shape[2], K, stream) == 0, "parent K3 failed")
        return o

    res["importance_sample"] = (k3_parent, lambda: vr.importance_sample_kernel(d, s, K))

    args6, _ = inputs[("ess_narrow", "fixed+jitter")]
    occ, occ_out, ro, rd, rs_, re_, bw, opts, S = args6
    taps, margin = int(opts["ess"].get("taps", 64)), float(opts["ess"].get("margin", 1))
    k6_old = entry("ess", "ess_narrow", (P,) * 7 + (I,) * 4 + (L,) + (F,) * 4 + (I, P))
    occ_out1 = occ_out.to(device=occ.device, dtype=torch.float32).reshape(1).contiguous()

    def k6_parent():
        N, R = ro.shape[:2]
        t0 = torch.empty((N, R, 1), device=ro.device)
        t1 = torch.empty_like(t0)
        dd = torch.empty((N, R, S, 1), device=ro.device)
        require(k6_old(occ.data_ptr(), occ_out1.data_ptr(), ro.data_ptr(), rd.data_ptr(),
                       t0.data_ptr(), t1.data_ptr(), dd.data_ptr(), N * R, R, occ.shape[-1],
                       taps, occ.stride(0), float(rs_), float(re_), float(bw), margin, S,
                       stream) == 0, "parent K6b failed")
        return t0, t1, dd

    res["ess_narrow"] = (k6_parent, lambda: vr.ess_narrow_kernel(*args6))

    x5, dcoef, noise, strength, bias, act, alpha, gain, clamp = inputs[
        ("modconv_epilogue", "per_sample_noise")]
    const = noise[0, 0].contiguous()
    k5_old = entry("modconv_epilogue", "modconv_epilogue",
                   (P, P, I, L, I, I) + (P,) * 4 + (I, F, F, I, F, P))

    def k5_parent():
        y = torch.empty_like(x5)
        C, inner = x5.shape[1], x5[0, 0].numel()
        require(k5_old(x5.data_ptr(), y.data_ptr(), 1 if x5.dtype == torch.bfloat16 else 0,
                       x5.numel(), C, inner, dcoef.data_ptr(), const.data_ptr(),
                       strength.detach().float().reshape(1).contiguous().data_ptr(),
                       bias.detach().float().contiguous().data_ptr(), int(act == "lrelu"),
                       float(activation_funcs[act].def_alpha if alpha is None else alpha),
                       float(activation_funcs[act].def_gain if gain is None else gain),
                       int(clamp is not None),
                       float(clamp) if clamp is not None else 0.0, stream) == 0,
                "parent K5 failed")
        return y

    res["modconv_epilogue"] = (k5_parent, lambda: modconv_epilogue_kernel(
        x5, dcoef, const, strength, bias, act, alpha, gain, clamp))
    out = {}
    for name, (old, new) in res.items():
        a, b = old(), new()
        a, b = (a,) if torch.is_tensor(a) else a, (b,) if torch.is_tensor(b) else b
        equal = all(torch.equal(p, q) for p, q in zip(a, b))
        ms = [cuda_ms(f) for f in (old, new, new, old)]
        print(f"{name}, eval form: this tree's kernel equals the parent's bit for bit: {equal}; "
              "ms parent / this / this / parent " + " / ".join(f"{m:.6f}" for m in ms))
        require(equal, f"{name}: the eval form differs from the parent kernel's")
        out[name] = {"bit_equal_to_parent": equal, "ms_parent_this_this_parent": ms}
    return out


def hybrid8x_check(device, card):
    """A Hybrid8X flagship with superresolution_noise_mode='random' (the
    trainer's --sr-module / --sr-noise-mode), pinned to f32, keyed, on the
    card against the CPU with the same draws (the card's recorded, replayed
    on the CPU), batch BATCH: the triplane within 1e-4 of its largest value
    (f32 convolutions summed in other orders); the SR module alone on the
    same inputs and noise within 1e-3; the images within F2's model
    (FLAGSHIP_PARITY.json: max 0.05, mean 5e-3). -> summary."""
    import torch

    kw = dict(rendering_kwargs=dict(
        superresolution_module="training.superresolution.SuperresolutionHybrid8X",
        superresolution_noise_mode="random", render_dtype="float32"),
        sr_num_fp16_res=0,
        synthesis_kwargs=dict(channel_base=32768, channel_max=512, num_fp16_res=0))
    Gc = keyed_generators(device, ("ess off",), **kw)["ess off"]
    Gh = keyed_generators("cpu", ("ess off",), **kw)["ess off"]
    xc = keyed_inputs(Gc, device, BATCH)
    xh = {k: (v.cpu() if torch.is_tensor(v) else {kk: vv.cpu() for kk, vv in v.items()})
          for k, v in xc.items()}
    Recorder = _recorder_class()
    rec = Recorder(torch.Generator(device=device).manual_seed(SEED))
    t = time.perf_counter()
    got = Gc.f(xc, noise_mode="random", generator=rec)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t
    rep = rec.replay("cpu")
    t = time.perf_counter()
    ref = Gh.f(xh, noise_mode="random", generator=rep)
    t_cpu = time.perf_counter() - t
    require(rep.left() == {"normal": 0, "uniform": 0}, "Hybrid8X: draws left over")
    n_sr = sum(1 for m in Gc.superresolution.modules() if hasattr(m, "noise_strength"))
    print(f"Hybrid8X flagship, f32, keyed with random SR noise, bs={BATCH}: card vs CPU, the "
          f"card's {len(rec.kept['normal'])} normal draws ({n_sr} of them the SR's) and "
          f"{len(rec.kept['uniform'])} uniform ones replayed on the CPU "
          f"(card {t_card:.3f} s, CPU {t_cpu:.3f} s)")
    require(tuple(got["image"].shape) == (BATCH, 3, 512, 512), "Hybrid8X image shape")
    scale = float(ref["triplane"].abs().max())
    check("triplane (f32 convolutions; 1e-4 of its largest value)",
          max_err(got["triplane"].cpu(), ref["triplane"]), 1e-4 * scale)
    out = {}
    for k in ("image_raw", "image_depth", "image"):
        diff = (got[k].cpu() - ref[k]).abs()
        out[k] = {"max": float(diff.max()), "mean": float(diff.mean())}
        check(f"{k} max (F2)", out[k]["max"], 0.05)
        check(f"{k} mean (F2)", out[k]["mean"], 5e-3)
    # the SR alone on the same inputs and noise
    g = torch.Generator().manual_seed(SEED)
    feat = torch.randn((BATCH, 32, 64, 64), generator=g) * 0.5
    ws = torch.randn((BATCH, Gh.num_ws, 512), generator=g)
    sr_noise = [torch.randn((BATCH, 1, r, r), generator=g) for r in (256, 256, 512, 512)]
    from panic3d_tpu_torch.utils import draws

    sr_c = Gc.superresolution(feat[:, :3].to(device), feat.to(device), ws.to(device),
                              noise_mode="random",
                              generator=draws.Replay(normal=[n.to(device) for n in sr_noise]))
    sr_h = Gh.superresolution(feat[:, :3], feat, ws, noise_mode="random",
                              generator=draws.Replay(normal=sr_noise))
    e_sr = max_err(sr_c.cpu(), sr_h)
    check("SR module alone, random noise, card vs CPU (f32)", e_sr, 1e-3)
    return dict(out, triplane_err=max_err(got["triplane"].cpu(), ref["triplane"]), sr_err=e_sr,
                card_s=t_card, cpu_s=t_cpu, card=card)



# ---------------------------------------------------------------------------
# training: the backward forms of K1, K2, K4 and K5, R1's second order, one
# step against the plain ops, and trainer.main at the flagship defaults

TRAIN_BATCH = 8        # the trainer's default batch
TRAIN_STEPS = 4        # timed steps after one warm-up step: Greg at steps 0 and 4, Dreg at 0
TRAIN_ARGS = ("--synthetic", "--tick-steps", "1", "--snap", "1000000")
BACKWARD_KERNELS = ("triplane_decode_grad", "ray_composite_grad", "modconv_epilogue_grad")
TRAIN_KERNELS = ("triplane_decode", "ray_composite", "importance_sample", "upfirdn2d",
                 "modconv_epilogue") + BACKWARD_KERNELS
TRAIN_RUNS = {         # by run: the trainer's flags beyond TRAIN_ARGS, the kernels launched
    "default": ((), TRAIN_KERNELS,   # ... and the kernels launched no time
                ("paste_front_grad", "triplane_decode_deep", "triplane_decode_deep_grad")),
    "paste": (("--paste-params-mode", "A", "--reg-type", "monotonic-fixed"),
              TRAIN_KERNELS + ("occlusion_volume", "paste_front_occ", "paste_front_grad"),
              ("triplane_decode_deep", "triplane_decode_deep_grad")),
    "depth2": (("--triplane-depth", "2", "--reg-type", "monotonic-detach"),
               ("triplane_decode_deep", "triplane_decode_deep_grad", "ray_composite",
                "ray_composite_grad", "importance_sample", "upfirdn2d", "modconv_epilogue",
                "modconv_epilogue_grad"),
               ("triplane_decode", "triplane_decode_grad", "paste_front_occ", "paste_front_grad")),
}
STEP_TOL_F32 = 1e-2    # the f32 step against the plain ops: relative L2 of G's update
D_STEP_TOL_F32 = 0.1   # ... and of D's, which learns from G's images (F2)
R1_TOL = {"float32": 1e-3, "bfloat16": 0.05}   # R1 against the plain ops: value and gradients


def plain_ops():
    """A context in which K1, K2, K3, K4, K5 and K14 take their plain
    versions on CUDA tensors too (the dispatchers swapped for the plain
    functions, and back on leaving): the whole step's, R1's and ADA's
    references on the card."""
    import importlib

    vr = importlib.import_module("panic3d_tpu_torch.models.volumetric.renderer")
    uf = importlib.import_module("panic3d_tpu_torch.ops.upfirdn2d")
    ba = importlib.import_module("panic3d_tpu_torch.ops.bias_act")
    conv = importlib.import_module("panic3d_tpu_torch.ops.conv")
    sg2 = importlib.import_module("panic3d_tpu_torch.models.stylegan2")
    gs = importlib.import_module("panic3d_tpu_torch.ops.grid_sample")
    k14_users = [importlib.import_module(f"panic3d_tpu_torch.{m}") for m in (
        "ops.grid_sample", "training.augment", "training.loss", "eval.equivariance")]

    def k1_plain(planes_cl, coords, dec, box_warp, axes, filters=vr.DensityFilters()):
        return vr.triplane_decode_plain(planes_cl, coords, dec, box_warp, axes, filters)

    swaps = [(vr, "triplane_decode", k1_plain), (vr, "ray_composite", vr.ray_composite_plain),
             (vr, "importance_sample", vr.importance_sample_plain),
             (uf, "_fir", uf.upfirdn2d_plain)] + [
        (m, "modconv_epilogue", ba.modconv_epilogue_plain) for m in (ba, conv, sg2)] + [
        (m, "grid_sample_2d", gs.grid_sample_2d_plain) for m in k14_users]

    @contextlib.contextmanager
    def ctx():
        saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
        for m, n, f in swaps:
            setattr(m, n, f)
        try:
            yield
        finally:
            for m, n, f in saved:
                setattr(m, n, f)
    return ctx()


def rel_max_err(a, b) -> float:
    """max |a - b| over max |b|."""
    return max_err(a, b) / max(float(b.float().abs().max()), 1e-30)


def k1_grad_ops(points: int, C: int):
    """K1's backward form's operations a call, by K1's forward's rule ->
    (f32 operations, TF32 tensor-core operations): per point the gather's
    lerps (3 planes x C x 6) and the scatter's corner products (3 x 4 x C x
    2) on the CUDA cores; the five products (layers 1 and 2 again, dL/dh,
    dL/df and the two weight gradients: 3 x (C*64 + 64*33) multiply-adds)
    on the tensor cores, each three times (3xTF32)."""
    return points * 3 * C * (6 + 8), points * 3 * 2 * 3 * (C * 64 + 64 * 33)


def k1_grad_bytes(planes_cl, coords, g_rgb, g_sigma) -> int:
    """The bytes the function of K1's (or K10's) backward form must move:
    its inputs read once (the planes or volumes, the coordinates, the output
    gradients) and the planes' gradient written once in their dtype (the
    kernel's f32 scratch, zeroed and cast back, is its design's cost, not
    the function's). The decoder's weights and their gradients (~80 KB)
    are left out."""
    return nbytes(planes_cl, coords, g_rgb, g_sigma) + planes_cl.numel() * planes_cl.element_size()


def k1g_parent_adapt():
    """parent_entries' adapt for the parent's K1 / K10 backward form: where
    its entry point predates the quads argument, the call without it; where
    its source also predates the quads (2 CTAs of 4 warps an SM, a weight
    partial a CTA), its persistent grid as its wrapper sized it: min(2 x
    the SMs, the rounds of 4 tiles of 16 points); the partials' scratch this
    tree allocates (ctas x quads rows) holds its partials. None where its
    entry point takes this tree's arguments."""
    from pathlib import Path

    import torch

    src = PARENT_SOURCES.get("triplane_decode_grad")
    text = "" if src is None else Path(src).read_text()
    if src is None or "int ctas, int quads" in text:
        return None
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    old_grid = "QUADS" not in text

    def adapt(argtypes, args):
        ctas = args[12]
        if old_grid:
            points = args[14] * args[15]   # N, M
            ctas = max(1, min(2 * sms, -(-points // 64)))
        return argtypes[:13] + argtypes[14:], args[:12] + (ctas,) + args[14:]

    return adapt


def k1g_parent(parent, name, fn, label):
    """K1's or K10's backward form (fn: a wrapper call, its entry point
    ``name``) against the parent's kernel (--parent DIR holding
    triplane_decode_grad.cu), run on its own grid (k1g_parent_adapt): the
    largest difference from the parent's outputs relative to each one's
    max (the scatter's atomics and the partials' grouping differ), and
    parent / this / this / parent rounds (parent_rounds), failing a call
    slower than the parent in each of 3 rounds. None without the parent."""
    if "triplane_decode_grad" not in parent:
        return None

    def compare(got, want):
        return {"relative_err_vs_parent": max(rel_max_err(a.double(), b.double())
                                              for a, b in zip(got, want))}

    cmp_ = parent_rounds({name: (parent["triplane_decode_grad"][0], k1g_parent_adapt())},
                         fn, compare)
    t = cmp_["ms_parent_this_this_parent"]
    print(f"  {label}: parent / this / this / parent " + " / ".join(f"{v:.6f}" for v in t)
          + f" ms (round {len(cmp_['rounds'])}; this / parent "
          f"{(t[1] + t[2]) / (t[0] + t[3]):.3f}); largest difference from the parent's "
          f"relative to each max {cmp_['relative_err_vs_parent']:.3e}")
    require(not cmp_["slower"], f"{label}: slower than the parent kernel in each of "
                                f"{len(cmp_['rounds'])} rounds: {cmp_['rounds']}")
    return cmp_


def training_render_samples(G, device, ortho=False):
    """A training render's samples on the card: bf16 planes [8,3,256,256,32]
    (random), 64^2 rays of 8 random pinhole cameras (or, with ``ortho``,
    of Gcond's ortho front camera: cameras/conventions.py:get_rays_ortho at
    elevation 0, azimuth 0, distance 1, as loss.py's Gcond renders it), 48
    jittered coarse depths, K1's coarse pass, K3's u form at random u, K1's
    fine pass. -> dict of the tensors K1's and K2's backward forms take."""
    import torch

    from panic3d_tpu_torch.cameras import camera_label, sample_rays
    from panic3d_tpu_torch.cameras.conventions import get_rays_ortho
    from panic3d_tpu_torch.models.volumetric import renderer as vr

    rk = G.rk
    N, S, K, res = TRAIN_BATCH, rk["depth_resolution"], rk["depth_resolution_importance"], 64
    R = res * res
    gen = torch.Generator(device=device).manual_seed(SEED)
    planes = torch.randn((N, 3, 32, 256, 256), generator=gen, device=device) * 0.5
    planes_cl = planes.to(torch.bfloat16).permute(0, 1, 3, 4, 2).contiguous()
    ones = torch.ones(N, device=device)
    if ortho:
        zeros = torch.zeros(N, device=device)
        ro, rd = get_rays_ortho(zeros, zeros, ones, rk["box_warp"], res)
        ro = ro.reshape(N, 3, R).transpose(1, 2)
        rd = rd.reshape(N, 3, R).transpose(1, 2)
    else:
        cam = camera_label(torch.rand(N, generator=gen, device=device) * 40 - 10,
                           torch.rand(N, generator=gen, device=device) * 360 - 180, ones,
                           30 * ones)
        ro, rd = sample_rays(cam[:, :16].reshape(-1, 4, 4), cam[:, 16:].reshape(-1, 3, 3), res)
    ro, rd = ro.contiguous(), rd.contiguous()
    dec, axes, nof = G._decoder(), vr.generate_plane_axes(True), vr.DensityFilters()

    def coords_of(depths):
        return (ro[:, :, None] + depths * rd[:, :, None]).reshape(N, -1, 3).contiguous()

    with torch.no_grad():
        d_c = vr.sample_stratified(ro, rk["ray_start"], rk["ray_end"], S, jitter=torch.rand(
            (N, R, S, 1), generator=gen, device=device)).contiguous()
        x_c = coords_of(d_c)
        rgb_c, s_c = vr.triplane_decode_kernel(planes_cl, x_c, dec, rk["box_warp"], axes, nof)
        u = torch.rand((N * R, K), generator=gen, device=device)
        d_f = vr.importance_sample_kernel(d_c, s_c.reshape(N, R, S, 1), K, u)
        x_f = coords_of(d_f)
        rgb_f, s_f = vr.triplane_decode_kernel(planes_cl, x_f, dec, rk["box_warp"], axes, nof)
    return dict(planes_cl=planes_cl, dec=dec, axes=axes, nof=nof, bw=rk["box_warp"], gen=gen,
                k2=(d_c, rgb_c.reshape(N, R, S, 32), s_c.reshape(N, R, S, 1),
                    x_c.reshape(N, R, S, 3), d_f, rgb_f.reshape(N, R, K, 32),
                    s_f.reshape(N, R, K, 1), x_f.reshape(N, R, K, 3)),
                x_c=x_c, x_f=x_f, white_back=rk["white_back"])


def k1_grad_check(label, t, x, parent, timed_plain=True):
    """K1's backward form at one pass (the samples ``x`` of a training
    render ``t``, random output gradients) against its plain version
    (autograd of triplane_decode_plain): the plane gradient (bf16) within 1
    bf16 ulp of the largest value (2^-7 x max: the plain's scatter is f32
    atomics too); the weight gradients, sums over 1.57 M points whose terms
    nearly cancel, the kernel's and the f32 plain version's each against an
    f64 evaluation: the kernel's within 10x the plain's error (or 1e-4) of
    each tensor's max. Timed beside its bound and (``timed_plain``) its
    plain version, and with ``parent`` (--parent: the parent's
    triplane_decode_grad.cu) against the parent's form, parent / this / this /
    parent, failing a call slower in each of 3 rounds (k1g_parent).
    -> summary."""
    import torch

    from panic3d_tpu_torch.models.volumetric import renderer as vr

    gen, planes_cl = t["gen"], t["planes_cl"]
    N, P = x.shape[:2]
    g_rgb = (torch.randn((N, P, 32), generator=gen, device=x.device) * 1e-3).to(torch.bfloat16)
    g_sig = torch.randn((N, P, 1), generator=gen, device=x.device) * 1e-3
    args = (planes_cl, x, t["dec"], t["bw"], t["axes"], t["nof"], g_rgb, g_sig)
    print(f"K1's backward form, {label}: planes {tuple(planes_cl.shape)} bf16, coords "
          f"{tuple(x.shape)}")
    with torch.no_grad():
        gk = vr.triplane_decode_grad_kernel(*args)
        gp = vr.triplane_decode_grad_plain(*args)
        dec64 = t["dec"]._replace(**{f: getattr(t["dec"], f).double()
                                      for f in ("w0", "b0", "w1", "b1")})
        g64 = vr.triplane_decode_grad_plain(planes_cl.double(), x.double(), dec64, *args[3:6],
                                            g_rgb.double(), g_sig.double())
    e_planes = rel_max_err(gk[0], gp[0])
    check(f"K1 backward, {label}: the plane gradient (relative to its max)", e_planes, 2.0 ** -7)
    e_w, e_wp = 0.0, 0.0
    for name, a, b, c in zip(("w0", "b0", "w1", "b1"), gk[1:], gp[1:], g64[1:]):
        ek, ep = rel_max_err(a.double(), c), rel_max_err(b.double(), c)
        print(f"  K1 backward, {label}: d{name} against f64: kernel {ek:.3e}, plain {ep:.3e}")
        e_w, e_wp = max(e_w, ek), max(e_wp, ep)
    check(f"K1 backward, {label}: the decoder's weight gradients against f64 (relative to each "
          "max)", e_w, max(1e-4, 10 * e_wp))
    again = vr.triplane_decode_grad_kernel(*args)
    differ = sum(int((a != b).sum()) for a, b in zip(gk[1:], again[1:]))
    print(f"  K1 backward, {label}: weight gradients of two launches not bit-equal: {differ}")
    require(differ == 0, f"K1 backward, {label}: the weight gradients change between runs")
    del g64, again
    f32_ops, tf32_ops = k1_grad_ops(N * P, planes_cl.shape[-1])
    n_bytes = k1_grad_bytes(planes_cl, x, g_rgb, g_sig)
    with torch.no_grad():
        if timed_plain:
            summ = record(max_err(gk[0], gp[0]), lambda: vr.triplane_decode_grad_kernel(*args),
                          lambda: vr.triplane_decode_grad_plain(*args), n_bytes, f32_ops,
                          plain_iters=3, tf32_flops=tf32_ops)
        else:
            bms, by = bound(n_bytes, f32_ops, tf32_ops)
            summ = {"max_abs_err": max_err(gk[0], gp[0]),
                    "ms": cuda_ms(lambda: vr.triplane_decode_grad_kernel(*args)),
                    "bound_ms": bms, "bound_by": by}
    summ.update(relative_err=e_planes, weight_grads_relative_err_f64=e_w, bytes=n_bytes,
                plain_weight_grads_relative_err_f64=e_wp,
                shapes={"planes": list(planes_cl.shape), "coords": list(x.shape)},
                kernel_us_profiler=kernel_device_us(
                    lambda: vr.triplane_decode_grad_kernel(*args),
                    ("triplane_decode_grad_kernel", "triplane_decode_grad_finish")))
    print(f"  ms {summ['ms']:.6f}  bound_ms {summ['bound_ms']:.6f} ({summ['bound_by']})  "
          f"kernels alone (torch.profiler) {summ['kernel_us_profiler']} us")
    del gk, gp
    with torch.no_grad():
        summ["parent"] = k1g_parent(parent, "triplane_decode_grad",
                                    lambda: vr.triplane_decode_grad_kernel(*args),
                                    f"K1 backward, {label}")
    return summ


K1G_PARTS = {"all": 15, "atomics as plain stores": 7, "no scatter": 13,
             "no weight products": 11, "no gather": 14, "decode and backward MLP only": 8}


def k1_grad_parts(G, device):
    """Where K1's backward form's time goes (ncu does not run on the card's
    machine): csrc/triplane_decode_grad.cu built with parts left out
    (-DK1G_PARTS, K1G_PARTS), each variant's main kernel timed alone by
    torch.profiler at the pinhole training pass and Gcond's ortho front
    coarse pass, and as K10's backward form at depth 2's coarse training
    pass (k10_grad_inputs). A variant without a part gives wrong values:
    only the full build is checked (k1_grad_check, k10_grad_check).
    -> {pass: {variant: us}}."""
    import ctypes
    from pathlib import Path

    import torch

    from panic3d_tpu_torch.kernels import build
    from panic3d_tpu_torch.models.volumetric import renderer as vr

    out = Path(BUILD_TMP) / "k1g_parts"
    out.mkdir(parents=True, exist_ok=True)
    src = build.CSRC / "triplane_decode_grad.cu"
    procs = {name: (subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC}",
                                      f"-DK1G_PARTS={bits}", str(src), "-o",
                                      str(out / f"parts{bits}.so")],
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
                     out / f"parts{bits}.so") for name, bits in K1G_PARTS.items()}
    libs = {}
    for name, (proc, so) in procs.items():
        _, err = proc.communicate(timeout=600)
        require(proc.returncode == 0, f"K1 backward, {name}: build failed:\n{err}")
        libs[name] = ctypes.CDLL(str(so))
    result = {}
    for label, ortho in (("pinhole training pass", False), ("ortho front coarse pass", True)):
        t = training_render_samples(G, device, ortho=ortho)
        x = t["x_c"]
        N, P = x.shape[:2]
        g_rgb = (torch.randn((N, P, 32), generator=t["gen"], device=device) * 1e-3).to(
            torch.bfloat16)
        g_sig = torch.randn((N, P, 1), generator=t["gen"], device=device) * 1e-3
        args = (t["planes_cl"], x, t["dec"], t["bw"], t["axes"], t["nof"], g_rgb, g_sig)
        result[label] = {}
        with torch.no_grad():
            for name, lib in libs.items():
                with parent_entries({"triplane_decode_grad": lib}):
                    us = kernel_device_us(lambda: vr.triplane_decode_grad_kernel(*args),
                                          "triplane_decode_grad_kernel")
                result[label][name] = us
        print(f"K1 backward by parts, {label} (main kernel alone, us): " + ", ".join(
            f"{k} {v:.1f}" for k, v in result[label].items()))
        del t, args
    label, args = "depth 2 coarse pass (K10)", k10_grad_inputs(device)
    result[label] = {}
    with torch.no_grad():
        for name, lib in libs.items():
            with parent_entries({"triplane_decode_deep_grad": lib}):
                result[label][name] = kernel_device_us(
                    lambda: vr.triplane_decode_deep_grad_kernel(*args),
                    "triplane_decode_grad_kernel")
    print(f"K10 backward by parts, {label} (main kernel alone, us): " + ", ".join(
        f"{k} {v:.1f}" for k, v in result[label].items()))
    return result


def k1_k2_grad_checks(G, device, parent):
    """K1's and K2's backward forms against their plain versions on the card
    at a training render's shapes (training_render_samples). K1
    (k1_grad_check): the pinhole training pass (its coarse samples) and
    Gcond's ortho front render (coarse and fine: on the xy plane every
    sample of a ray shares its texel). K2: the colours' gradient (bf16)
    within 2^-7 x max, the sigmas' (f32) within 1e-3 x max (the reverse
    recurrence against autograd's cumprod). -> {name: summary}."""
    import torch

    from panic3d_tpu_torch.models.volumetric import renderer as vr

    t = training_render_samples(G, device)
    gen = t["gen"]
    k1 = k1_grad_check("pinhole training pass", t, t["x_c"], parent)
    to = training_render_samples(G, device, ortho=True)
    k1["ortho_front"] = {name: k1_grad_check(f"ortho front {name} pass", to, to[key], parent,
                                             timed_plain=False)
                         for name, key in (("coarse", "x_c"), ("fine", "x_f"))}
    del to

    k2 = t["k2"]
    B, R = k2[0].shape[:2]
    with torch.no_grad():
        rgb, depth, wsum, xyz = vr.ray_composite_kernel(*k2, t["white_back"])
    g_comp = torch.randn((B, R, 35), generator=gen, device=device)
    g_dep = torch.randn((B, R, 1), generator=gen, device=device)
    g_ws = torch.randn((B, R, 1), generator=gen, device=device)
    args2 = (*k2, t["white_back"], depth, g_comp, g_dep, g_ws)
    print(f"K2's backward form: {B * R} rays, {k2[0].shape[2]}+{k2[4].shape[2]} samples, "
          f"bf16 colours")
    with torch.no_grad():
        gk = vr.ray_composite_grad_kernel(*args2)
        gp = vr.ray_composite_grad_plain(*args2)
    e_c = max(rel_max_err(gk[0], gp[0]), rel_max_err(gk[2], gp[2]))
    e_s = max(rel_max_err(gk[1], gp[1]), rel_max_err(gk[3], gp[3]))
    check("K2 backward: the colours' gradient (relative to its max)", e_c, 2.0 ** -7)
    check("K2 backward: the sigmas' gradient (relative to its max)", e_s, 1e-3)
    d_c, c1, s1, x1, d_f, c2, s2, x2 = k2
    with torch.no_grad():
        k2s = record(max(max_err(a, b) for a, b in zip(gk, gp)),
                     lambda: vr.ray_composite_grad_kernel(*args2),
                     lambda: vr.ray_composite_grad_plain(*args2),
                     nbytes(d_c, c1, s1, x1, d_f, c2, s2, x2, depth, g_comp, g_dep, g_ws, *gk),
                     B * R * (k2[0].shape[2] + k2[4].shape[2]) * (4 * 32 + 40), plain_iters=3)
    k2s.update(colours_relative_err=e_c, sigmas_relative_err=e_s,
               shapes={"rays": B * R, "samples": [k2[0].shape[2], k2[4].shape[2]]})
    return {"triplane_decode_grad": k1, "ray_composite_grad": k2s}


def k5_grad_check(device):
    """K5's backward form against its plain version (epilogue_grad_plain,
    what autograd of the plain epilogue computes) at a discriminator layer
    of the flagship at batch 8: bf16 [8,64,512,512], lrelu, gain sqrt(2),
    clamp 256 (b512's conv0). Exact: both round after the gain and after the
    slope. -> summary."""
    import torch

    from panic3d_tpu_torch.ops.bias_act import (epilogue_grad_kernel, epilogue_grad_plain,
                                                modconv_epilogue_kernel)

    gen = torch.Generator(device=device).manual_seed(SEED)
    shape = (TRAIN_BATCH, 64, 512, 512)
    x = (torch.randn(shape, generator=gen, device=device) * 100).to(torch.bfloat16)
    bias = torch.randn(64, generator=gen, device=device)
    cfg = ("lrelu", None, math.sqrt(2), 256.0)
    with torch.no_grad():
        y = modconv_epilogue_kernel(x, bias=bias, act=cfg[0], gain=cfg[2], clamp=cfg[3])
        dy = torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
        dk, dp = epilogue_grad_kernel(dy, y, *cfg), epilogue_grad_plain(dy, y, *cfg)
    clamped = float((y.abs() >= cfg[3]).float().mean())
    check(f"K5 backward {list(shape)} bf16 ({100 * clamped:.2f} % clamped)", max_err(dk, dp), 0.0)
    return dict(record(max_err(dk, dp), lambda: epilogue_grad_kernel(dy, y, *cfg),
                       lambda: epilogue_grad_plain(dy, y, *cfg), nbytes(dy, y, dk),
                       dy.numel() * 4.0), shape=list(shape), clamped_share=clamped)


def k4_backward_library(xx, f2d, up, down, pad, out_hw):
    """The single PyTorch call that computes a transposed pass: at down 2 a
    depthwise conv2d of stride 2 (symmetric padding), else k4_library's."""
    import torch.nn.functional as F

    if tuple(down) == (1, 1):
        return k4_library(xx, f2d, up, pad, out_hw)
    px0, px1, py0, py1 = pad
    if tuple(up) != (1, 1) or px0 != px1 or py0 != py1 or min(pad) < 0:
        return None
    C = xx.shape[1]
    w = f2d.to(xx.device, xx.dtype)[None, None].expand(C, 1, *f2d.shape).contiguous()
    return lambda: F.conv2d(xx, w, stride=(down[1], down[0]), padding=(py0, px0), groups=C)


K4_FIR4_VARIANTS = ("down2", "fir4", "fir_small")   # K4's 4x4 form
# the five small transposed calls of a training step that lost to their
# depthwise conv2d before the 4x4 form's planes plan: (shape, dtype name,
# down); each must now take no more time than it
K4_SMALL_TRANSPOSED = {((8, 512, 34, 34), "bfloat16", 2), ((8, 512, 18, 18), "float32", 2),
                       ((8, 512, 10, 10), "float32", 2), ((8, 512, 9, 9), "float32", 1),
                       ((8, 512, 7, 7), "float32", 1)}


def k4_fir4_calls():
    """The 4x4 form's calls of a training step that --forms-only holds
    without training, keyed as training_path collects them ({(transposed,
    shape, dtype, up, down, pad): [count, f2d]}): the generator's up=2 calls
    (conv2d_resample's 3x3 conv, padding (3, 2, 3, 2)) on 512 channels of
    16^2 (bf16), 8^2 and 4^2 (f32), forward, and their transposed passes
    (34^2, 18^2, 10^2 -> 16^2, 8^2, 4^2 at down 2); the discriminator's
    filter passes (padding 2 before its 3x3 down-conv, 1 before its 1x1
    skip) at b8 (f32, 512 channels) and b512 (bf16, 64 channels), forward
    and transposed (9^2 and 7^2 -> 8^2; 513^2 and 511^2 -> 512^2); and the
    transposed pass of the SR's up=2 call (bf16 [8,256,514,514] -> 256^2).
    Counts 1."""
    import importlib

    import torch

    uf = importlib.import_module("panic3d_tpu_torch.ops.upfirdn2d")
    f = uf.setup_filter([1, 3, 3, 1])
    calls = {}

    def add(shape, dtype, spec):
        f2d, up, down, pad = spec
        out_hw = uf._out_size(shape[2], shape[3], 4, 4, up, down, pad)
        calls[(False, tuple(shape), dtype, tuple(up), tuple(down), tuple(pad))] = [1, f2d]
        t = uf.transposed_pass(f2d, up, down, pad, tuple(shape[2:]), out_hw)
        calls[(True, (*shape[:2], *out_hw), dtype, tuple(t[1]), tuple(t[2]),
               tuple(t[3]))] = [1, t[0]]

    up2 = uf.fir_passes(f, up=2, padding=[3, 2, 3, 2], gain=4)[0]
    for res, dtype in ((16, torch.bfloat16), (8, torch.float32), (4, torch.float32)):
        add((TRAIN_BATCH, 512, res, res), dtype, up2)
    for c, res, dtype in ((512, 8, torch.float32), (64, 512, torch.bfloat16)):
        for pad in (2, 1):
            add((TRAIN_BATCH, c, res, res), dtype, uf.fir_passes(f, padding=pad)[0])
    add((TRAIN_BATCH, 256, 256, 256), torch.bfloat16, up2)
    del calls[(False, (TRAIN_BATCH, 256, 256, 256), torch.bfloat16, (2, 2), (1, 1),
               (3, 2, 3, 2))]   # the SR's forward call is the view path's (k4_checks)
    return calls


def k4_parent_adapt(parent):
    """parent_entries' adapt for the parent's K4 (--parent): None where its
    entry point takes this tree's arguments (or there is no parent K4), else
    one that drops the 4x4 form's block plan (f4_plan, f4_rows: the two
    arguments before the stream), which its entry point predates."""
    from pathlib import Path

    src = PARENT_SOURCES.get("upfirdn2d") if "upfirdn2d" in parent else None
    if src is None or "f4_plan" in Path(src).read_text():
        return None
    return lambda argtypes, args: (argtypes[:-3] + argtypes[-1:], args[:-3] + args[-1:])


K4_PARENT_ROUNDS = 3   # parent / this / this / parent rounds before a call counts as slower


def k4_slower(times) -> bool:
    """A parent / this / this / parent round (ms) in which this tree's
    faster time exceeds the parent's slower one by more than the round's
    spread: the larger max / min - 1 of the two parent times and of the two
    of this tree."""
    p, t = (times[0], times[3]), (times[1], times[2])
    spread = max(max(p) / min(p), max(t) / min(t)) - 1
    return min(t) > max(p) * (1 + spread)


def parent_rounds(swap, fn, compare=None):
    """fn() against the same launches of the parent's entry points (``swap``:
    parent_entries' map): values not equal bit for bit (or ``compare(this,
    parent)``'s dict), and the times in the order parent / this / this /
    parent, timed again while a round is slower (k4_slower), up to
    K4_PARENT_ROUNDS rounds; "slower": every round was."""
    got = fn()
    with parent_entries(swap):
        want = fn()
    differ = (compare(got, want) if compare is not None else
              {"values_not_bit_equal": int((got != want).sum()), "values": got.numel()})
    del got, want
    rounds = []
    while len(rounds) < K4_PARENT_ROUNDS and (not rounds or k4_slower(rounds[-1])):
        with parent_entries(swap):
            p1 = cuda_ms(fn)
        n1, n2 = cuda_ms(fn), cuda_ms(fn)
        with parent_entries(swap):
            p2 = cuda_ms(fn)
        rounds.append([p1, n1, n2, p2])
    return {"ms_parent_this_this_parent": rounds[-1], "rounds": rounds,
            "slower": k4_slower(rounds[-1]), **differ}


def require_parent(cmp_, label):
    """Print the round of a parent_rounds comparison that decides, and
    require the outputs bit-equal to the parent's and not slower than it in
    every round. -> cmp_."""
    t = cmp_["ms_parent_this_this_parent"]
    print(f"    parent / this / this / parent {t[0]:.6f} / {t[1]:.6f} / {t[2]:.6f} / "
          f"{t[3]:.6f} ms (round {len(cmp_['rounds'])}); values not equal bit for bit: "
          f"{cmp_['values_not_bit_equal']} of {cmp_['values']}")
    require(cmp_["values_not_bit_equal"] == 0,
            f"{label}: the outputs differ from the parent kernel's")
    require(not cmp_["slower"], f"{label}: slower than the parent kernel in each of "
                                f"{len(cmp_['rounds'])} rounds: {cmp_['rounds']}")
    return cmp_


def k4_parent_compare(parent, fn):
    """fn() (a K4 launch) against the same launch of the parent's entry
    point (--parent DIR holding upfirdn2d.cu): parent_rounds. None without
    the parent's K4."""
    if "upfirdn2d" not in parent:
        return None
    return parent_rounds({"upfirdn2d": (parent["upfirdn2d"][0], k4_parent_adapt(parent))}, fn)


def k4_require_parent(parent, fn, label, times=None):
    """Require a 4x4-form call (fn) bit-equal to the parent's kernel and no
    slower than it (k4_parent_compare; ``times``: a first round already
    timed, kept where it is not slower), and print the round that decides.
    -> the comparison, or None without the parent's K4."""
    cmp_ = None
    if times is None or k4_slower(times):
        cmp_ = k4_parent_compare(parent, fn)
    if cmp_ is None:
        return None if times is None else {"ms_parent_this_this_parent": times, "slower": False}
    return require_parent(cmp_, label)


def k4_backward_checks(calls, device, parent):
    """K4 at every distinct 4x4-form call of one training step, in both
    directions (``calls``: {(transposed, shape, dtype, up, down, pad):
    [count, f2d]}): the transposed passes (K4's backward form, K4's own
    forms), the forward "down2", "fir4" and "fir_small" calls, and the
    generator's forward "up2" calls at 512 channels of 4^2..16^2; each
    against its plain version (bf16 within 1 bf16 ulp of the largest value,
    f32 within 1e-5), timed beside its plain version, its bound and its
    library call (a depthwise conv2d; conv_transpose2d for "up2"), and with
    ``parent`` (--parent; {} without) bit for bit against the parent's
    kernel, timed parent / this / this / parent (k4_parent_compare), the
    4x4-form calls required no slower than it (k4_require_parent). The
    calls of K4_SMALL_TRANSPOSED must take no more time than their conv2d.
    The summary's own numbers are the largest transposed call's. ->
    summary."""
    import importlib

    import torch

    uf = importlib.import_module("panic3d_tpu_torch.ops.upfirdn2d")
    gen = torch.Generator(device=device).manual_seed(SEED)
    rows, head, lost = [], None, []
    for (transposed, shape, dtype, up, down, pad), (count, f2d) in sorted(
            calls.items(), key=lambda kv: (not kv[0][0], -np.prod(kv[0][1]), kv[0][5])):
        xx = torch.randn(shape, generator=gen, device=device).to(dtype)
        spec = (f2d, up, down, pad)
        with torch.no_grad():
            yk = uf._launch_k4(xx, *spec, transposed)
            yp = uf.upfirdn2d_plain(xx, *spec)
        e = max_err(yk, yp)
        tol = 2.0 ** -7 * float(yp.abs().max()) if dtype == torch.bfloat16 else 1e-5
        variant = uf.k4_plan(*spec).variant
        plan = (uf.fir4_block_plan(shape[0] * shape[1], *shape[2:], *yk.shape[-2:], down[0],
                                   dtype, *f2d.shape,
                                   shift=xx.data_ptr() % 16 // xx.element_size()).plan
                if variant in K4_FIR4_VARIANTS else None)
        label = "K4 backward" if transposed else "K4 forward"
        check(f"{label} x{count} {list(shape)} {str(dtype)[6:]} up={up[0]} down={down[0]} "
              f"pad={list(pad)} -> {yk.shape[-2]}x{yk.shape[-1]} ({variant}"
              + (f", {plan}" if plan else "") + ")", e, tol)
        lib = k4_backward_library(xx, f2d, up, down, pad, tuple(yk.shape[-2:]))
        fh, fw = f2d.shape

        def fn(xx=xx, spec=spec, transposed=transposed):
            return uf._launch_k4(xx, *spec, transposed)

        row = dict(record(e, fn, lambda: uf.upfirdn2d_plain(xx, *spec), nbytes(xx, yk),
                          yk.numel() * fh * fw * 2.0 / (up[0] * up[1]), library_fn=lib,
                          plain_iters=3),
                   direction="transposed" if transposed else "forward", shape=list(shape),
                   dtype=str(dtype)[6:], up=up[0], down=down[0], pad=list(pad),
                   variant=variant, plan=plan, calls_per_step=count)
        print(f"    ms {row['ms']:.6f}  plain {row['plain_ms']:.6f}  bound {row['bound_ms']:.6f} "
              f"({row['bound_by']}, {100 * row['bound_ms'] / row['ms']:.1f} %)  library "
              + (f"{row['library_ms']:.6f}" if row["library_ms"] is not None else "none"))
        if plan:   # the 4x4 form: bit-equal to the parent's and no slower
            cmp_ = k4_require_parent(parent, fn, f"{label} {list(shape)} ({variant}, {plan})")
        else:
            cmp_ = k4_parent_compare(parent, fn)
            if cmp_ is not None:
                t = cmp_["ms_parent_this_this_parent"]
                print(f"    parent / this / this / parent {t[0]:.6f} / {t[1]:.6f} / "
                      f"{t[2]:.6f} / {t[3]:.6f} ms; values not equal bit for bit: "
                      f"{cmp_['values_not_bit_equal']} of {cmp_['values']}")
                require(cmp_["values_not_bit_equal"] == 0,
                        f"{label} {list(shape)}: the outputs differ from the parent kernel's")
        if cmp_ is not None:
            row["parent"] = cmp_
        if (transposed and (tuple(shape), str(dtype)[6:], down[0]) in K4_SMALL_TRANSPOSED
                and row["library_ms"] is not None and row["ms"] > row["library_ms"]):
            lost.append((list(shape), row["ms"], row["library_ms"]))
        rows.append(row)
        if transposed:
            head = head or row
        del xx, yk, yp
    require(head is not None, "K4 backward: no transposed call in the training step")
    require(not lost, f"K4: small transposed calls slower than their conv2d: {lost}")
    return dict({k: head[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                      "library_ms")},
                max_abs_err=max(r["max_abs_err"] for r in rows if r["direction"] == "transposed"),
                calls=rows, variants=sorted({r["variant"] for r in rows}))


def r1_checks(device, res=512):
    """R1 (the Dreg phase: a gradient of the discriminator's gradient,
    through K4's and K5's backward forms and their own backward) on the
    flagship discriminator at batch 8, 512^2, against the same with the
    plain ops (plain_ops): the penalty and the gradient of every parameter
    of D (one vector) within R1_TOL relative, in f32 (no bf16 blocks) and in
    the flagship's bf16 at the top 4 resolutions. -> summary."""
    import torch

    from panic3d_tpu_torch.kernels import launch_counts, reset_launch_counts, variant_counts
    from panic3d_tpu_torch.models.dual_discriminator import DualDiscriminator
    from panic3d_tpu_torch.training.loss import LossConfig, OrthoCondLoss

    gen = torch.Generator(device=device).manual_seed(SEED)
    batch = {"image": torch.rand((TRAIN_BATCH, 3, res, res), generator=gen, device=device) * 2 - 1,
             "cond": {}}
    c = torch.randn((TRAIN_BATCH, 25), generator=gen, device=device)
    out = {}
    for label, fp16 in (("float32", 0), ("bfloat16", 4)):
        D = DualDiscriminator(c_dim=25, img_resolution=res, num_fp16_res=fp16,
                              conv_clamp=256 if fp16 else None).to(device).init_weights(SEED)
        loss = OrthoCondLoss(LossConfig(r1_gamma=4.0), None, None, None,
                             lambda img, c_, cond, g: D(img, c_, cond, generator=g), None)
        params = list(D.parameters())
        runs = []
        for plain in (False, True):
            reset_launch_counts()
            with plain_ops() if plain else contextlib.nullcontext():
                value, _ = loss.d_reg_loss(batch, c, None, 0, gain=16.0)
                grads = torch.autograd.grad(value, params, allow_unused=True)
                grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
            torch.cuda.synchronize()
            counts, variants = launch_counts(), variant_counts().get("upfirdn2d", {})
            runs.append((value.detach(), torch.cat([g.reshape(-1) for g in grads]), counts,
                         variants))
        (vk, gk, ck, vk4), (vp, gp, cp, _) = runs
        e_v = float((vk - vp).abs() / vp.abs())
        e_g = float((gk - gp).norm() / gp.norm())
        check(f"R1 {label} D: the penalty (relative)", e_v, R1_TOL[label])
        check(f"R1 {label} D: the gradient of D's parameters (relative L2)", e_g, R1_TOL[label])
        grad_k4 = {k: n for k, n in vk4.items() if k.startswith("grad_")}
        print(f"  kernel run: K5's backward {ck['modconv_epilogue_grad']} launches, K4's "
              f"transposed passes {grad_k4}; plain run launched "
              f"{sum(cp.values())} kernels")
        require(ck["modconv_epilogue_grad"] > 0 and grad_k4, "R1: a backward form not launched")
        require(sum(cp.values()) == 0, "R1: the plain run launched a kernel")
        out[label] = {"penalty": float(vk), "penalty_relative_err": e_v,
                      "grad_relative_l2": e_g, "k5_grad_launches": ck["modconv_epilogue_grad"],
                      "k4_grad_variants": grad_k4}
    return out


def step_vs_plain(device, card):
    """One whole training step of the flagship (batch 8, every phase: Greg
    first, then Gmain, Gcond, Dmain, Dreg) with the kernels, against the
    same step with the plain ops (plain_ops), from the same weights on the
    same draws (one generator seed: both draw the same numbers in the same
    order), in f32 (--fp32 and an f32 render) and at the trainer's bf16
    defaults; in f32 the kernels' step runs twice. Adam's eps is 1e-4 here
    (TrainConfig.eps), above the gradients' rounding, so that each
    element's step is a smooth function of its gradient (at 1e-8 it is ~lr
    sign(g), and a rounding-sized gradient flips it). Held, for each
    module's update (the parameters after the step less before): in f32,
    G's and G_ema's (whose gradients pass through all four backward forms)
    within STEP_TOL_F32 relative L2 of the plain ops', or within twice the
    kernels' own run-to-run distance where that is larger (the plane
    gradient's atomics add in another order each run); D's within
    D_STEP_TOL_F32: D learns from the generator's images, which the
    importance resampling moves between any two f32 implementations
    (ROADMAP F2: up to 0.021 at flagship shape; printed here for one G.f
    on the step's draws), while D's own forward and backward agree with
    the plain ops within 5e-7 (r1_checks); in bf16, within twice the plain
    ops' own distance between bf16 and f32 (bf16's rounding is the noise
    floor there). -> summary."""
    import copy

    import torch

    from panic3d_tpu_torch.data.dataset import synthetic_batch
    from panic3d_tpu_torch.training import TrainConfig, build_train_step, init_state, trainer
    from panic3d_tpu_torch.training.setup import init_lpips, make_loss

    cfg = TrainConfig(batch_size=TRAIN_BATCH, eps=1e-4,
                      phases=("Greg", "Gmain", "Gcond", "Dmain", "Dreg"))
    lpips = init_lpips(device=device)
    updates, times, before, f2 = {}, {}, {}, {}
    for precision, extra in (("float32", ["--fp32"]), ("bfloat16", [])):
        args = trainer.parse_args(["--name", "cmp", *TRAIN_ARGS, *extra])
        G, D, chonk, feat, _ = trainer.build_models(args, device)
        if precision == "float32":
            G.rk["render_dtype"] = "float32"
        G.init_weights(SEED)
        D.init_weights(SEED + 1)
        loss_cfg = trainer.loss_config(args, G.rk["box_warp"], False)
        batch = trainer._to_device(synthetic_batch(bs=TRAIN_BATCH, size=G.img_resolution,
                                                   chonk_ch=chonk, feat_dim=feat), device)
        before = {"G": copy.deepcopy(G.state_dict()), "D": copy.deepcopy(D.state_dict())}
        if precision == "float32":   # F2's size here: one G.f on the step's draws
            xin = {"z": torch.randn((TRAIN_BATCH, G.z_dim), device=device,
                                    generator=torch.Generator(device=device).manual_seed(SEED)),
                   "camera_params": batch["camera"], "cond": batch["cond"],
                   "normalize_images": True}
            outs = []
            for plain in (False, True):
                gen = torch.Generator(device=device).manual_seed(SEED)
                with torch.no_grad(), plain_ops() if plain else contextlib.nullcontext():
                    outs.append(G.f(xin, noise_mode="random", generator=gen))
            f2 = {k: max_err(outs[0][k], outs[1][k]) for k in ("image", "image_raw")}
            print(f"  f32 G.f on the step's draws, kernels vs plain ops: image max |diff| "
                  f"{f2['image']:.3e}, image_raw {f2['image_raw']:.3e} (ROADMAP F2)")
            del outs
        for plain, rep in ((False, 0), (True, 0)) + (((False, 1),) if precision == "float32"
                                                     else ()):
            Gs, Ds = copy.deepcopy(G), copy.deepcopy(D)
            state = init_state(Gs, Ds, cfg)
            step = build_train_step(make_loss(Gs, Ds, lpips, loss_cfg), cfg, G.z_dim, cfg.phases)
            gen = torch.Generator(device=device).manual_seed(SEED)
            torch.cuda.synchronize()
            t = time.perf_counter()
            with plain_ops() if plain else contextlib.nullcontext():
                step(state, batch, gen)
            torch.cuda.synchronize()
            key = (precision, "plain" if plain else ("kernels", "kernels again")[rep])
            times[key] = time.perf_counter() - t
            updates[key] = {
                "G": {n: p.detach() - before["G"][n] for n, p in Gs.named_parameters()},
                "D": {n: p.detach() - before["D"][n] for n, p in Ds.named_parameters()},
                "G_ema": {n: p.detach() - before["G"][n]
                          for n, p in state.G_ema.named_parameters()}}
            del state, step, Gs, Ds
        del G, D, before, batch

    def dist(a, b, module):
        u, v = updates[a][module], updates[b][module]
        num = math.sqrt(sum(float((u[n] - v[n]).float().square().sum()) for n in v))
        return num / math.sqrt(sum(float(v[n].float().square().sum()) for n in v))

    out = {"seconds": {f"{p} {k}": t for (p, k), t in times.items()},
           "f32_gf_image_max_diff": f2}
    for module in ("G", "D", "G_ema"):
        f32 = dist(("float32", "kernels"), ("float32", "plain"), module)
        again = dist(("float32", "kernels again"), ("float32", "kernels"), module)
        bf16 = dist(("bfloat16", "kernels"), ("bfloat16", "plain"), module)
        floor = dist(("bfloat16", "plain"), ("float32", "plain"), module)
        tol = D_STEP_TOL_F32 if module == "D" else max(STEP_TOL_F32, 2 * again)
        check(f"one step in f32, kernels vs plain ops: {module}'s update (relative L2; "
              f"kernels run to run {again:.3e})", f32, tol)
        check(f"one step in bf16, kernels vs plain ops: {module}'s update (relative L2; "
              f"plain bf16 vs plain f32 {floor:.3e})", bf16, 2 * floor)
        out[module] = {"f32_relative_l2": f32, "f32_kernels_run_to_run": again,
                       "bf16_relative_l2": bf16, "bf16_vs_f32_plain_relative_l2": floor}
    print("  one step (the first of each, with warm-up): " + ", ".join(
        f"{p} {k} {t:.3f} s" for (p, k), t in times.items()) + f"  [{card}]")
    return out


def training_path(device, card, run="default", capture=None):
    """trainer.main at the flagship's defaults on the card (synthetic 512^2
    data, batch 8, the five phases, lazy-reg Adam, G_ema) with
    TRAIN_RUNS[run]'s flags: one warm-up step and TRAIN_STEPS timed ones,
    the launch counts zeroed before and read after (the run's kernels
    launched, the backward forms too, and its absent ones not; K4's
    variants forward and backward, its generic kernel not), every phase's
    losses finite at every step, G, D and G_ema moved from their seeded
    weights; then, on the trained state, one step of every phase timed
    phase by phase (CUDA events), one counted for its host waits (0
    required), one profiled for the device's busy share, and K4's
    transposed calls of one step, its forward 4x4-form calls and the
    generator's 512-channel up=2 calls collected for k4_backward_checks. With
    ``capture`` (a list) the first call of
    triplane.py:paste_composite_occ_kernel is appended to it (K8's backward
    check takes training's paste from it). -> (launch counts, summary, K4's
    calls)."""
    import importlib
    import shutil

    import torch

    from panic3d_tpu_torch.kernels import launch_counts, reset_launch_counts, variant_counts
    from panic3d_tpu_torch.models import triplane as tp
    from panic3d_tpu_torch.training import build_train_step, phases_for_step, trainer

    flags, required, absent = TRAIN_RUNS[run]
    outdir = os.path.join(BUILD_TMP, "train_runs")
    shutil.rmtree(os.path.join(outdir, f"smoke_{run}"), ignore_errors=True)
    argv = ["--name", f"smoke_{run}", "--outdir", outdir, *TRAIN_ARGS, *flags,
            "--max-steps", str(1 + TRAIN_STEPS)]
    label = f"training ({' '.join(flags) or 'defaults'})"
    marks, bad, outs = [], [], []

    def on_step(i, phases, stats):
        torch.cuda.synchronize()
        marks.append((i, phases, time.perf_counter()))
        bad.extend(k for k, v in stats.items() if not math.isfinite(float(v)))

    def train():
        outs.append(trainer.main(argv, on_step=on_step))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    if capture is None:
        train()
    else:
        capture.append(capture_call(tp, "paste_composite_occ_kernel", train))
    out = outs.pop()
    counts, variants = launch_counts(), variant_counts()
    peak = torch.cuda.max_memory_allocated()
    require(not bad, f"{label}: non-finite losses {bad}")
    ran = [p for _, phases, _ in marks for p in phases]
    require(all(p in ran for p in ("Gmain", "Gcond", "Greg", "Dmain", "Dreg")),
            f"{label}: phases run {sorted(set(ran))}")
    require_launched(counts, required, label)
    require_absent(counts, absent, label)
    steps = len(marks)
    step_s = [b[2] - a[2] for a, b in zip(marks, marks[1:])]
    k4v = variants.get("upfirdn2d", {})
    print(f"{label}, flagship defaults, batch {TRAIN_BATCH}, synthetic 512^2: "
          f"{steps} steps, the first {marks[0][2] - t0:.3f} s after the start (build, init, "
          f"warm-up); then s/step " + ", ".join(f"{s:.3f}" for s in step_s)
          + f" (median {statistics.median(step_s):.3f}); peak memory {peak / 2**30:.3f} GiB; "
          f"launches per step " + ", ".join(f"{k}={n / steps:g}" for k, n in counts.items() if n)
          + f"  [{card}]")
    print("  K4 launches per step by variant, forward: " + ", ".join(
        f"{v}={n / steps:g}" for v, n in k4v.items() if not v.startswith("grad_"))
        + "; backward: " + ", ".join(f"{v[5:]}={n / steps:g}" for v, n in k4v.items()
                                     if v.startswith("grad_")))
    require(not any(v in k4v for v in ("generic", "grad_generic")),
            f"{label}: K4's generic kernel ran: {k4v}")

    # G, D and G_ema moved from their seeded weights
    args = trainer.parse_args(argv)
    G0, D0, *_ = trainer.build_models(args, device)
    G0.init_weights(args.seed)
    D0.init_weights(args.seed + 1)
    state = out["state"]
    moved = {}
    with torch.no_grad():
        for name, mod, ref in (("G", state.G, G0), ("D", state.D, D0),
                               ("G_ema", state.G_ema, G0)):
            ref_p = dict(ref.named_parameters())
            moved[name] = max(float((p - ref_p[n]).abs().max())
                              for n, p in mod.named_parameters())
    print("  largest parameter change: " + ", ".join(f"{k} {v:.3e}" for k, v in moved.items()))
    require(all(v > 0 for v in moved.values()), f"{label}: a module did not move: {moved}")
    del G0, D0

    # one step of every phase on the trained state: each phase's ms (CUDA
    # events), and K4's transposed calls (a spy on its launch)
    cfg, batch, gen = out["train_cfg"], out["batch"], out["generator"]
    phases = phases_for_step(0, cfg)
    step = build_train_step(out["loss"], cfg, state.G.z_dim, phases)
    uf = importlib.import_module("panic3d_tpu_torch.ops.upfirdn2d")
    launch, calls, events = uf._launch_k4, {}, []

    def spy(x, f2d, up, down, pad, transposed=False):
        variant = uf.k4_plan(f2d, up, down, pad).variant
        if (transposed or variant in K4_FIR4_VARIANTS
                or (variant == "up2" and x.shape[1] == 512 and x.shape[2] <= 16)):
            key = (transposed, tuple(x.shape), x.dtype, tuple(up), tuple(down), tuple(pad))
            calls.setdefault(key, [0, f2d.detach().clone()])[0] += 1
        return launch(x, f2d, up, down, pad, transposed)

    def on_phase(phase):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((phase, ev))

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    uf._launch_k4 = spy
    try:
        step(state, batch, gen, on_phase=on_phase)
    finally:
        uf._launch_k4 = launch
    torch.cuda.synchronize()
    phase_ms, prev = {}, start
    for phase, ev in events:
        phase_ms[phase] = prev.elapsed_time(ev)
        prev = ev
    print("  one step of every phase, ms by phase: " + ", ".join(
        f"{p} {ms:.3f}" for p, ms in phase_ms.items()) + f"  [{card}]")
    waits = count_syncs(lambda: step(state, batch, gen))
    prof = trace_counts(lambda: step(state, batch, gen))
    busy = prof["busy_ms"] / prof["span_ms"]
    print(f"  host waits a step {waits}; profiled step: device busy {prof['busy_ms']:.3f} ms of "
          f"{prof['span_ms']:.3f} ({100 * busy:.1f} %), {prof['device_launches']:g} device "
          f"launches from {prof['host_ops']:g} host ops  [{card}]")
    require(waits == 0, f"{label}: {waits} host waits in a step")
    summary = {"steps": steps, "s_per_step": step_s,
               "s_per_step_median": statistics.median(step_s),
               "first_step_s_from_start": marks[0][2] - t0, "peak_gib": peak / 2**30,
               "launches_per_step": {k: n / steps for k, n in counts.items() if n},
               "k4_variants_per_step": {v: n / steps for v, n in k4v.items()},
               "phase_ms_all_phase_step": phase_ms, "host_waits_per_step": waits,
               "device_busy_share": busy, "profiled_step": {k: v for k, v in prof.items()
                                                            if k != "names"},
               "largest_change": moved}
    return counts, summary, calls


def training_checks(device, card, parent):
    """The training path (training_path), then the backward forms at its
    shapes (K4 at the step's own transposed calls, beside its forward
    4x4-form and 512-channel up=2 calls, with --parent against the parent's
    kernel; K1 and K2 at a training
    render's, K5 at a discriminator layer), R1's second order and one whole
    step against the plain ops, then ADA's training path
    (ada_training_path). -> (kernel summaries, the path's launch counts,
    the path's summary, the ADA run's launch counts)."""
    import torch

    from panic3d_tpu_torch import configs

    with torch.enable_grad():
        counts, summary, calls = training_path(device, card)
    checks = {"upfirdn2d_grad": k4_backward_checks(calls, device, parent)}
    summary["k4_grad_launches"] = sum(n for v, n in summary["k4_variants_per_step"].items()
                                      if v.startswith("grad_")) * summary["steps"]
    G = configs.flagship(device=device).init_weights(SEED)
    checks.update(k1_k2_grad_checks(G, device, parent))
    del G
    checks["modconv_epilogue_grad"] = k5_grad_check(device)
    with torch.enable_grad():
        summary["r1_vs_plain"] = r1_checks(device)
        summary["step_vs_plain"] = step_vs_plain(device, card)
    torch.cuda.empty_cache()
    with torch.enable_grad():
        counts_ada, summary["ada"] = ada_training_path(device, card)
    return checks, counts, summary, counts_ada


K14_GRAD_TOL = 1e-5   # K14's backward vs the plain version's autograd, of the largest gradient
ADA_TOL = 1e-4        # augment_pipe on the card vs the plain ops, of the largest value
ADA_STEPS = 3         # ADA training steps: step 0 runs every phase, steps 1 and 2 are timed
ADA_K4_FORMS = ("row_up2", "column_up2", "row_down2", "column_down2")


def capture_call(module, name, fn):
    """Run fn() with ``module.<name>`` spied on -> the (args, kwargs) of its
    first call."""
    real, seen = getattr(module, name), []

    def spy(*args, **kwargs):
        if not seen:
            seen.append((args, kwargs))
        return real(*args, **kwargs)

    setattr(module, name, spy)
    try:
        fn()
    finally:
        setattr(module, name, real)
    require(seen, f"{name} was not called")
    return seen[0]


def k14_calls(device):
    """K14's calls as their callers make them: ADA's filtered warp (a 'bgc'
    transform at p = 1 on [8,6,512,512]: [8,6,1560,1560] at [8,1036,1036,2]),
    its unfiltered warp (align_corners=True, [8,6,512,512] at [8,512,512,2])
    and EQ-R's rotation of a batch of 4 at 512^2 ([4,3,2094,2094] at
    [4,512,512,2]); and a synthetic call that takes both of the kernels'
    branches in one launch (k14_two_branch_call).
    -> {label: (input, grid, padding_mode, align_corners)}."""
    import dataclasses

    import torch

    from panic3d_tpu_torch.eval import equivariance as eq
    from panic3d_tpu_torch.training import augment as ag

    gen = torch.Generator(device=device).manual_seed(SEED)
    x = torch.rand((ADA_BATCH, ADA_CHANNELS, ADA_RES, ADA_RES), generator=gen,
                   device=device) * 2 - 1
    out = {}
    for label, cfg in (("ada", ag.AugmentConfig.bgc()),
                       ("ada_unfiltered", dataclasses.replace(ag.AugmentConfig.bgc(),
                                                              filtered=False))):
        (xi, grid), kw = capture_call(ag, "grid_sample_2d", lambda: ag.augment_pipe(
            x, torch.Generator(device=device).manual_seed(SEED), 1.0, cfg))
        out[label] = (xi, grid, kw["padding_mode"], kw["align_corners"])
    img = torch.rand((SG3_BATCH, 3, EQ_RES, EQ_RES), generator=gen, device=device)
    (xi, grid), kw = capture_call(eq, "grid_sample_2d",
                                  lambda: eq.apply_fractional_rotation(img, 0.35))
    out["eqr"] = (xi, grid, kw.get("padding_mode", "zeros"), kw.get("align_corners", False))
    out["two_branch"] = k14_two_branch_call(device, gen)
    return out


def k14_two_branch_call(device, gen):
    """A synthetic K14 call whose tiles take both of the backward's branches
    in one launch:
    [2,5,1024,1022] (W % 4 = 2: the backward's scalar flush; 5 channels: a
    staged pass of 3, then one of 2, and the forward's last batch of one
    channel) sampled at [2,256,256,2], the output's left
    half at about a texel a point, sheared (footprints of ~400 texels:
    staged), its right half at 4 texels a point (a 4x minification,
    footprints of ~4,000 texels: direct); the second image shifted by
    (5.25, 3.5) texels. -> (input, grid, "zeros", False)."""
    import torch

    H, W, S = 1024, 1022, 256
    x = torch.rand((2, 5, H, W), generator=gen, device=device) * 2 - 1
    py, px = torch.meshgrid(torch.arange(S, dtype=torch.float32, device=device),
                            torch.arange(S, dtype=torch.float32, device=device), indexing="ij")
    left = px < S // 2
    ix = torch.where(left, px + 0.2 * py + 0.3, (px - S // 2) * 4 + 0.7)
    iy = torch.where(left, py + 0.15 * px + 0.3, py * 4 + 0.7)
    shift = torch.tensor([[0.0, 0.0], [5.25, 3.5]], device=device)
    pts = torch.stack([ix, iy], -1)[None] + shift[:, None, None]
    size = torch.tensor([W, H], dtype=torch.float32, device=device)
    grid = ((2 * pts + 1) / size - 1).contiguous()   # texels -> align_corners=False's [-1, 1]
    return x, grid, "zeros", False


def k14_touched_bytes(x, grid, padding, align) -> int:
    """The bytes of the input texels that some point's bilinear corners
    read (a texel read by many points counts once)."""
    import torch

    from panic3d_tpu_torch.ops import grid_sample as gs

    N, C, H, W = x.shape
    corners, _, _ = gs._corners(N, H, W, grid.reshape(N, -1, 2), padding, align, x.dtype)
    hit = torch.zeros(N * H * W, dtype=torch.bool, device=x.device)
    for lin, valid in corners:
        hit[lin.reshape(-1) if valid is None else lin[valid]] = True
    return int(hit.sum()) * C * x.element_size()


def k14_ops(points: int, C: int) -> float:
    """f32 operations: a point's unnormalisation, floors and weights (~16),
    and per channel the lerps' 3 subtractions, 3 products and 3 sums."""
    return points * (16 + 9 * C)


def k14_parent_args(argtypes, args):
    """Arguments for K14 entry points that take the points of an image, P =
    Hg Wg, where this tree's take Hg and Wg (parent_entries' adapt)."""
    from panic3d_tpu_torch.kernels import build as kb

    return ((*argtypes[:7], kb.LONG, *argtypes[9:]),
            (*args[:7], args[7] * args[8], *args[9:]))


def k14_parent_adapt():
    """parent_entries' adapt for the parent's K14: k14_parent_args where the
    parent's grid_sample.cu takes ``long long P`` (its entry points before
    the tiles), else None (it takes this tree's arguments)."""
    import re

    src = PARENT_SOURCES.get("grid_sample")
    if src is None:
        return None
    return (k14_parent_args if re.search(r"int W,\s*long long P,", src.read_text())
            else None)


def k14_branches(x, grid, pad, ac) -> dict:
    """The blocks of K14's backward at this call that take the staged branch,
    counted on the card (the check entry grid_sample_2d_grad_counted: the
    backward's kernel at the call's shapes, a random output gradient), and
    the share that ops/grid_sample.py:k14_tile_plan (the footprint test in
    PyTorch) predicts; fails unless the two agree tile for tile in number.
    -> {"staged_share", "staged_blocks", "tiles", "modelled_staged_share"}."""
    import torch

    from panic3d_tpu_torch.kernels import build as kb
    from panic3d_tpu_torch.ops import grid_sample as gs

    N, C, H, W = x.shape
    Hg, Wg = grid.shape[1:3]
    g = torch.randn((N, C, Hg, Wg), generator=torch.Generator(device=x.device).manual_seed(SEED),
                    device=x.device)
    g, grid_c = gs._k14_operands(g, grid, "K14 grid_sample_2d_grad_counted", (H, W))
    gx = torch.zeros((N, C, H, W), device=x.device)
    count = torch.zeros(1, dtype=torch.int64, device=x.device)
    kb.launch("grid_sample_2d_grad_counted", gs._K14_ARGS[:-1] + (kb.PTR, kb.PTR),
              g.data_ptr(), grid_c.data_ptr(), gx.data_ptr(), N, C, H, W, Hg, Wg,
              gs._PADDING[pad], int(bool(ac)), count.data_ptr(),
              torch.cuda.current_stream(x.device).cuda_stream)
    plan = gs.k14_tile_plan(grid, H, W, pad, ac)
    staged, tiles = int(count.item()), plan["staged"].numel()
    modelled = int(plan["staged"].sum())
    require(staged == modelled, f"K14's backward at {list(x.shape)} {pad}: {staged} blocks "
            f"took the staged branch on the card, the footprint model says {modelled}")
    return {"staged_share": staged / tiles, "staged_blocks": staged, "tiles": tiles,
            "modelled_staged_share": modelled / tiles}


def k14_resources():
    """K14's two kernels' registers and static shared memory from nvcc's
    -Xptxas -v report. -> {kernel: {"registers", "smem_bytes"}}."""
    from panic3d_tpu_torch.kernels import build

    report = ptxas_report(build.build("grid_sample").with_suffix(".log").read_text())
    return {fn: {"registers": regs, "smem_bytes": smem} for fn, regs, _, _, smem in report}


def k14_checks(device, parent):
    """K14 against its plain version on the card at its callers' calls
    (k14_calls): the forward bit for bit (its arithmetic is the plain
    version's, uncontracted) at ADA's, EQ-R's and the two-branch call; at
    each call the backward's blocks that take its staged branch, counted on
    the card and required equal to the footprint model's (k14_branches:
    ADA's call mostly staged, EQ-R's mostly direct, the two-branch call's
    both); ADA's and EQ-R's forward timed with their bound (the texels read, the grid and the output
    over 3.35 TB/s) and F.grid_sample (bilinear, the same padding and
    align_corners), and with ``parent`` (the parent's grid_sample.cu) bit for
    bit against the parent's kernel, timed parent / this / this / parent
    with the SASS instructions a point; the unfiltered warp's
    align_corners=True call and border calls bit for bit; the backward at
    ADA's and the two-branch call (zeros and border) against the plain
    version's autograd within K14_GRAD_TOL of the largest gradient (atomics
    sum in another order), ADA's timed with its bound (the output's
    gradient, the grid and the whole input gradient) and aten's
    grid_sampler_2d_backward (the input's gradient alone), and against the
    parent's; the double backward equal to K14's forward on the same grid;
    the two kernels' registers and shared memory.
    -> {"grid_sample_2d": summary, "grid_sample_2d_grad": summary}."""
    import torch
    import torch.nn.functional as F

    from panic3d_tpu_torch.ops import grid_sample as gs

    res = k14_resources()
    for fn, r in res.items():
        print(f"  {fn}: {r['registers']} registers, {r['smem_bytes']} bytes of shared memory "
              f"a block of {gs.K14_TILE ** 2} threads")
    with torch.no_grad():
        calls = k14_calls(device)
    fwd, shapes, branches = None, {}, {}
    for label, (x, grid, pad, ac) in calls.items():
        C = x.shape[1]
        pts = grid.shape[0] * grid.shape[1] * grid.shape[2]
        with torch.no_grad():
            yk = gs.grid_sample_2d_kernel(x, grid, pad, ac)
            yp = gs.grid_sample_2d_plain(x, grid, pad, ac)
            e = max_err(yk, yp)
            check(f"K14 {label} {list(x.shape)} at {list(grid.shape)} {pad} "
                  f"align_corners={ac}, bit for bit", e, 0.0)
            summ = {"max_abs_err": e}
            modes = (pad,)
            if label in ("ada_unfiltered", "two_branch"):   # border calls on the same grids
                e_b = max_err(gs.grid_sample_2d_kernel(x, grid, "border", ac),
                              gs.grid_sample_2d_plain(x, grid, "border", ac))
                check(f"K14 {label} border padding, bit for bit", e_b, 0.0)
                summ.update(border_max_abs_err=e_b)
                modes = (pad, "border")
            for mode in modes:
                br = k14_branches(x, grid, mode, ac)
                branches[label if mode == pad else f"{label}_{mode}"] = br
                print(f"  K14 backward's staged branch at {label} {mode}: {br['staged_blocks']} "
                      f"of {br['tiles']} blocks on the card ({br['staged_share']:.4f}), as the "
                      "footprint model says")
            share = branches[label]["staged_share"]
            if label == "ada":
                require(share >= 0.5, f"K14 at ADA's call: staged blocks {share}, not most")
            elif label == "eqr":
                require(share <= 0.1, f"K14 at EQ-R's call: staged blocks {share}, not direct")
            elif label == "two_branch":
                require(0.3 <= share <= 0.7, f"K14's two-branch call: staged blocks {share}")
            if label not in ("ada", "eqr"):
                shapes[label] = summ
                continue
            n_bytes = k14_touched_bytes(x, grid, pad, ac) + nbytes(grid, yk)
            summ.update(record(e, lambda: gs.grid_sample_2d_kernel(x, grid, pad, ac),
                               lambda: gs.grid_sample_2d_plain(x, grid, pad, ac), n_bytes,
                               k14_ops(pts, C),
                               library_fn=lambda: F.grid_sample(x, grid, mode="bilinear",
                                                                padding_mode=pad,
                                                                align_corners=ac),
                               plain_iters=3))
            summ.update(input=list(x.shape), grid=list(grid.shape), touched_bytes=n_bytes)
            print(f"  ms {summ['ms']:.6f} (plain {summ['plain_ms']:.6f}, F.grid_sample "
                  f"{summ['library_ms']:.6f}, bound {summ['bound_ms']:.6f} by "
                  f"{summ['bound_by']}, {n_bytes / 1e6:.1f} MB)")
            summ.update(parent_and_sass(
                parent, "grid_sample", "grid_sample_2d", "grid_sample_kernel",
                lambda: gs.grid_sample_2d_kernel(x, grid, pad, ac), pts, "point",
                {"STG": C}, 1, {"STG": C}, adapt=k14_parent_adapt()))
            if "parent" in summ:
                require(summ["parent"]["values_not_bit_equal"] == 0,
                        f"K14 at {label}'s call: the output differs from the parent's")
        shapes[label] = summ
        if fwd is None:
            fwd = dict(summ)
    fwd["shapes"] = shapes
    fwd["resources"] = res.get("grid_sample_kernel")

    # the backward at ADA's call, and its own backward (R1 through the augment)
    bwd = None
    for label in ("two_branch", "ada"):
        x, grid, pad, ac = calls.pop(label)
        gen = torch.Generator(device=device).manual_seed(SEED + 1)
        out_shape = (x.shape[0], x.shape[1]) + tuple(grid.shape[1:3])
        g = torch.randn(out_shape, generator=gen, device=device)
        for mode in (pad, "border") if label == "two_branch" else (pad,):
            with torch.enable_grad():
                xr = x.detach().requires_grad_(True)
                gr = g.detach().requires_grad_(True)
                (gk,) = torch.autograd.grad(gs.grid_sample_2d_kernel(xr, grid, mode, ac), xr,
                                            gr, create_graph=True)
                xp = x.detach().requires_grad_(True)
                (gp,) = torch.autograd.grad(gs.grid_sample_2d_plain(xp, grid, mode, ac), xp, g)
                e = max_err(gk.detach(), gp)
                tol = K14_GRAD_TOL * float(gp.abs().max())
                check(f"K14 backward {label} {list(x.shape)} at {list(grid.shape)} {mode} vs "
                      "the plain autograd", e, tol)
                ddx = torch.randn(tuple(x.shape), generator=gen, device=device)
                (ddy,) = torch.autograd.grad(gk, gr, ddx)
            with torch.no_grad():
                e2 = max_err(ddy, gs.grid_sample_2d_kernel(ddx, grid, mode, ac))
                check("K14 double backward = K14's forward of the incoming gradient", e2, 0.0)
            del gk, gp, ddy, ddx, xr, xp, gr
            if label == "two_branch":
                shapes[label][f"grad_{mode}_max_abs_err"] = e
                shapes[label][f"grad_{mode}_tol"] = tol
        if label == "two_branch":
            continue
        with torch.no_grad():
            n_bytes = nbytes(g, grid) + x.numel() * 4
            pts = grid.shape[0] * grid.shape[1] * grid.shape[2]
            C = x.shape[1]
            shape = tuple(x.shape)
            bwd = record(e, lambda: gs._launch_k14_grad(g, grid, shape, pad, ac),
                         lambda: gs.grid_sample_2d_grad_plain(g, grid, shape, pad, ac),
                         n_bytes, pts * (16 + 10 * C),
                         library_fn=lambda: torch.ops.aten.grid_sampler_2d_backward(
                             g, x, grid, 0, 0 if pad == "zeros" else 1, ac, [True, False]),
                         plain_iters=3)
            bwd.update(tol=tol, double_backward_max_abs_err=e2, input=list(x.shape),
                       grid=list(grid.shape), staged_share=branches[label]["staged_share"],
                       staged_blocks=branches[label]["staged_blocks"],
                       tiles=branches[label]["tiles"], branches=branches,
                       resources=res.get("grid_sample_grad_kernel"))
            print(f"  K14 backward ms {bwd['ms']:.6f} (plain {bwd['plain_ms']:.6f}, aten "
                  f"grid_sampler_2d_backward {bwd['library_ms']:.6f}, bound "
                  f"{bwd['bound_ms']:.6f} by {bwd['bound_by']})")
            bwd.update(parent_and_sass(
                parent, "grid_sample", "grid_sample_2d_grad", "grid_sample_grad_kernel",
                lambda: gs._launch_k14_grad(g, grid, shape, pad, ac), pts, "point",
                {"BAR": -(-C // 3)}, 1, {"LDG": C}, adapt=k14_parent_adapt()))   # passes of CB = 3
            if "parent" in bwd:
                e_par = max_err(gs._launch_k14_grad(g, grid, shape, pad, ac),
                                k14_parent_grad(parent, g, grid, shape, pad, ac))
                check("K14 backward vs the parent's kernel", e_par, tol)
                bwd["parent"]["max_abs_err"] = e_par
        del x, grid, g
    torch.cuda.empty_cache()
    return {"grid_sample_2d": fwd, "grid_sample_2d_grad": bwd}


def k14_parent_grad(parent, g, grid, shape, pad, ac):
    """The parent's K14 backward form at the same call (parent_entries)."""
    from panic3d_tpu_torch.ops import grid_sample as gs

    with parent_entries({"grid_sample_2d_grad": (parent["grid_sample"][0],
                                                 k14_parent_adapt())}):
        return gs._launch_k14_grad(g, grid, shape, pad, ac)


def augment_check(device, card):
    """augment_pipe on the card at batch 8, 6 channels, 512^2, 'bgc' at
    p = 1: against the same pipe with the plain ops (plain_ops: K4's and
    K14's plain versions) on the same draws (one generator seed), within
    ADA_TOL of the largest value; its launches (K14 and the four 1-D K4
    forms required); ms of the forward and of the forward + backward
    (CUDA events). -> summary."""
    import torch

    from panic3d_tpu_torch.kernels import launch_counts, reset_launch_counts, variant_counts
    from panic3d_tpu_torch.training import augment as ag

    gen = torch.Generator(device=device).manual_seed(SEED)
    x = torch.rand((ADA_BATCH, ADA_CHANNELS, ADA_RES, ADA_RES), generator=gen,
                   device=device) * 2 - 1

    def run(xx):
        return ag.augment_pipe(xx, torch.Generator(device=device).manual_seed(SEED), 1.0,
                               ag.AugmentConfig.bgc())

    with torch.no_grad():
        reset_launch_counts()
        yk = run(x)
        counts, k4v = launch_counts(), variant_counts().get("upfirdn2d", {})
        with plain_ops():
            yp = run(x)
        e = rel_max_err(yk, yp)
        check(f"augment_pipe 'bgc' p=1 {list(x.shape)} vs the plain ops (of the largest value)",
              e, ADA_TOL)
        require(counts["grid_sample_2d"] == 1 and all(k4v.get(v) == 1 for v in ADA_K4_FORMS),
                f"augment_pipe: launches {counts}, K4's {k4v}")
        ms_fwd = cuda_ms(lambda: run(x))
        del yk, yp
    gy = torch.randn(tuple(x.shape), generator=gen, device=device)
    xr = x.detach().requires_grad_(True)

    def fwd_bwd():
        with torch.enable_grad():
            return torch.autograd.grad(run(xr), xr, gy)

    ms_both = cuda_ms(fwd_bwd)
    prof = trace_counts(fwd_bwd)
    waits = count_syncs(fwd_bwd)
    print(f"augment_pipe 'bgc' p=1 {list(x.shape)}: forward {ms_fwd:.3f} ms, forward + "
          f"backward {ms_both:.3f} ms; {prof['device_launches']:g} device launches, busy "
          f"{prof['busy_ms']:.3f} of {prof['span_ms']:.3f} ms, host waits {waits}; by kernel "
          + ", ".join(f"{k} {v:.3f}" for k, v in prof["top_ms"].items()) + f"  [{card}]")
    return {"rel_max_err": e, "tol": ADA_TOL, "ms_forward": ms_fwd,
            "ms_forward_backward": ms_both, "host_waits": waits,
            "profiled_forward_backward": {k: v for k, v in prof.items() if k != "names"}}


def ada_training_path(device, card):
    """trainer.main at the flagship defaults (batch 8, synthetic 512^2
    data) with --aug fixed --aug-p 0.6 for ADA_STEPS steps, then with --aug
    ada --ada-interval 1 resumed from its snapshot for ADA_STEPS more, the
    launch counts zeroed before and read after each: K14 forward and
    backward, the four 1-D K4 forms forward and backward and the training
    kernels launched; every phase's losses finite; under fixed p 0.6, under
    ada p moved from 0.6 by the heuristic's own steps on the recorded signs
    of the real logits (sign(s - 0.6) x 8 / 100,000 a step at a resumed
    run's ADA kimg, clamped at 0, in f32); s/step of the steps after the
    first, and one step of every phase timed phase by phase (CUDA events)
    and counted for its host waits. -> (launch counts of the ada run,
    summary)."""
    import shutil

    import torch

    from panic3d_tpu_torch.kernels import launch_counts, reset_launch_counts, variant_counts
    from panic3d_tpu_torch.training import build_train_step, phases_for_step, trainer

    outdir = os.path.join(BUILD_TMP, "train_runs_ada")
    shutil.rmtree(outdir, ignore_errors=True)
    summary, counts_ada, snap = {}, None, None
    for mode in ("fixed", "ada"):
        if mode == "fixed":
            extra = ("--aug", "fixed", "--aug-p", "0.6", "--max-steps", str(ADA_STEPS))
        else:   # resumed from the fixed run's snapshot: p starts at 0.6
            extra = ("--aug", "ada", "--ada-interval", "1", "--resume", snap,
                     "--max-steps", str(2 * ADA_STEPS))
        argv = ["--name", f"smoke_{mode}", "--outdir", outdir, *TRAIN_ARGS, *extra]
        marks, bad, signs = [], [], []

        def on_step(i, phases, stats):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            bad.extend(k for k, v in stats.items() if not math.isfinite(float(v)))
            signs.append(float(stats["Loss/signs/real"]))

        torch.cuda.synchronize()
        reset_launch_counts()
        out = trainer.main(argv, on_step=on_step)
        counts, k4v = launch_counts(), variant_counts().get("upfirdn2d", {})
        label = f"ADA training (--aug {mode})"
        require(not bad, f"{label}: non-finite losses {bad}")
        require_launched(counts, TRAIN_KERNELS + ("grid_sample_2d", "grid_sample_2d_grad"),
                         label)
        missing = [v for f in ADA_K4_FORMS for v in (f, "grad_" + f) if not k4v.get(v)]
        require(not missing, f"{label}: K4's 1-D forms not launched: {missing}")
        p = np.float32(0.6)
        if mode == "ada":   # a resumed run's ADA kimg: 100
            for sgn in signs:
                p = max(p + np.float32(np.sign(sgn - 0.6) * TRAIN_BATCH / 100_000), np.float32(0))
        require(out["state"].aug_p == float(p),
                f"{label}: p {out['state'].aug_p}, the heuristic gives {float(p)}")
        steps = len(marks)
        step_s = [b - a for a, b in zip(marks, marks[1:])]

        # one step of every phase on the trained state, phase by phase
        state, cfg, batch, gen = out["state"], out["train_cfg"], out["batch"], out["generator"]
        step = build_train_step(out["loss"], cfg, state.G.z_dim, phases_for_step(0, cfg))
        events = []

        def on_phase(phase):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append((phase, ev))

        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        step(state, batch, gen, on_phase=on_phase)
        torch.cuda.synchronize()
        phase_ms, prev = {}, start
        for phase, ev in events:
            phase_ms[phase] = prev.elapsed_time(ev)
            prev = ev
        waits = count_syncs(lambda: step(state, batch, gen))
        prof = trace_counts(lambda: step(state, batch, gen))
        per_step = {k: n / steps for k, n in counts.items() if n}
        print(f"{label}, flagship defaults, batch {TRAIN_BATCH}: {steps} steps, p "
              f"{out['state'].aug_p:.7g} (real-logit signs "
              + ", ".join(f"{v:.3f}" for v in signs) + "); s/step after the first "
              + ", ".join(f"{v:.3f}" for v in step_s) + "; launches per step "
              + ", ".join(f"{k}={n:g}" for k, n in per_step.items()) + f"  [{card}]")
        print("  K4 1-D forms per step: " + ", ".join(
            f"{v}={k4v.get(v, 0) / steps:g}" for f in ADA_K4_FORMS for v in (f, "grad_" + f)))
        print("  one step of every phase, ms by phase: " + ", ".join(
            f"{k} {v:.3f}" for k, v in phase_ms.items()) + f"; host waits in a step {waits}"
            + ("; ADA's flush: 1 host wait every --ada-interval steps" if mode == "ada" else "")
            + f"  [{card}]")
        print(f"  profiled step: device busy {prof['busy_ms']:.3f} ms of {prof['span_ms']:.3f} "
              f"({100 * prof['busy_ms'] / prof['span_ms']:.1f} %), "
              f"{prof['device_launches']:g} device launches from {prof['host_ops']:g} host ops"
              f"  [{card}]")
        summary[mode] = {"steps": steps, "aug_p": out["state"].aug_p, "signs_real": signs,
                         "s_per_step": step_s, "launches_per_step": per_step,
                         "k4_variants_per_step": {v: n / steps for v, n in k4v.items()},
                         "phase_ms_all_phase_step": phase_ms, "host_waits_per_step": waits,
                         "profiled_step": {k: v for k, v in prof.items() if k != "names"}}
        if mode == "ada":
            counts_ada = counts
            require(out["state"].aug_p != float(np.float32(0.6)), f"{label}: p did not move")
        snap = out["snapshot"]
        del out, state, step, batch
        torch.cuda.empty_cache()
    return counts_ada, summary


K8G_TOL = 1e-5         # K8's backward vs the plain autograd: the xyz gradient, of its max
K8G_IMAGE_TOL = 1e-6   # ... the image's, g - g mask (one FMA against two roundings), of its max
K10G_PLANES_TOL = 2.0 ** -7   # K10's backward: the volumes' gradient (bf16), K1's rule


def k8_grad_checks(call, card):
    """K8's backward form against its plain version (autograd of the paste's
    projection, paste_front_grad_plain) at training's paste: the arguments
    of one paste_composite_occ_kernel call of a training step (N = 8, C =
    3, the 64^2 render into 512^2), both entries' masks (paste_front_occ's
    on those arguments; paste_front's on the same, its occlusion and
    discrepancy maps by the plain ops), random output gradients. Training's
    thresholds pass next to nothing at seeded weights (the discrepancy's
    5e-6), so the check takes the weights' median for thresh_weight and
    passes every occlusion and discrepancy: the mask then passes about half
    the image (required between 5 % and 95 %). The seeded render's
    composited points may lie outside the box, where the projection's
    border clamp gives no gradient: the check takes them squashed into it,
    0.3 tanh(xyz / 0.3) (|xyz| < bw / 2 = 0.35). The
    image's gradient within K8G_IMAGE_TOL and the xyz's within K8G_TOL of
    each one's max; two launches equal bit for bit; the paste's own
    gradient (None in training) checked once. Timed: each entry's forward,
    the backward and the plain version (CUDA events), beside the bytes
    bound. -> summary (paste_front_occ's mask; paste_front's under
    "map_entry")."""
    import torch

    from panic3d_tpu_torch.models import triplane as tp

    (image, front, weights, xyz, vol, rays, bw, offset_occ, seg_len, thresh_occ, thr_w, thr_e,
     thr_d, *rest), kw = call
    fwmask = rest[0] if rest else kw.get("fwmask")
    image, weights, xyz = image.detach(), weights.detach(), xyz.detach()
    N, C, S, _ = image.shape
    r = xyz.shape[-1]
    gen = torch.Generator(device=image.device).manual_seed(SEED)
    g_img = torch.randn(image.shape, generator=gen, device=image.device)
    g_paste = torch.randn(image.shape, generator=gen, device=image.device)
    print(f"K8's backward form at training's paste: image {tuple(image.shape)}, front "
          f"{tuple(front.shape)}, xyz {tuple(xyz.shape)}")
    with torch.no_grad():
        train_pass = float(tp.paste_composite_occ_kernel(
            image, front, weights, xyz, vol, rays, bw, offset_occ, seg_len, thresh_occ, thr_w,
            thr_e, thr_d, fwmask)["mask"].mean())
        print(f"  training's thresholds pass {train_pass:.4f} of the pixels")
        thr_w, thr_o, thr_d = float(weights.float().quantile(0.5)), 2.0, 1.0
        xyz = 0.3 * torch.tanh(xyz / 0.3)
        occ_args = (image, front, weights, xyz, vol, rays, bw, offset_occ, seg_len, thr_o,
                    thr_w, thr_e, thr_d, fwmask)
        occ = tp.front_occlusion_grid(vol, xyz, offset_occ, seg_len, tp._occlusion_sample_plain)
        map_args = (image, front, weights, xyz, (occ < thr_o).to(torch.float32),
                    tp.TriPlaneGenerator._get_xyz_discrepancy(xyz, rays), bw, thr_w, thr_e,
                    thr_d, fwmask)
        entries = {"paste_front_occ": lambda: tp.paste_composite_occ_kernel(*occ_args),
                   "paste_front": lambda: tp.paste_composite_kernel(*map_args)}
        out = {}
        for entry, fwd in entries.items():
            mask = fwd()["mask"]
            args = (mask, g_img, None, front, xyz, bw)
            gk = tp.paste_front_grad_kernel(*args)
            gp = tp.paste_front_grad_plain(*args)
            again = tp.paste_front_grad_kernel(*args)
            differ = sum(int((a != b).sum()) for a, b in zip(gk, again))
            print(f"  K8 backward ({entry}'s mask, passes {float(mask.mean()):.4f}): values of "
                  f"two launches not bit-equal: {differ}")
            require(0.05 < float(mask.mean()) < 0.95,
                    f"K8 backward ({entry}): the mask passes {float(mask.mean())}")
            require(differ == 0, f"K8 backward ({entry}): the gradients change between runs")
            e_img, e_xyz = rel_max_err(gk[0], gp[0]), rel_max_err(gk[1], gp[1])
            check(f"K8 backward ({entry}): the image's gradient (relative to its max)", e_img,
                  K8G_IMAGE_TOL)
            check(f"K8 backward ({entry}): the xyz gradient (relative to its max)", e_xyz, K8G_TOL)
            require(float(gk[1][:, 2].abs().max()) == 0 and float(gk[1].abs().max()) > 0,
                    f"K8 backward ({entry}): the xyz gradient must fill channels 0 and 1 only")
            n_bytes = nbytes(mask, g_img, front, xyz, *gk)
            flops = N * S * S * (C * 16 + 40) + N * r * r * 2 * (S // r + 2) ** 2 * 2
            summ = record(max(max_err(a, b) for a, b in zip(gk, gp)),
                          lambda: tp.paste_front_grad_kernel(*args),
                          lambda: tp.paste_front_grad_plain(*args), n_bytes, flops,
                          plain_iters=3)
            summ.update(forward_ms=cuda_ms(fwd), image_relative_err=e_img,
                        xyz_relative_err=e_xyz, mask_passes=float(mask.mean()),
                        shapes={"image": list(image.shape), "front": list(front.shape),
                                "xyz": list(xyz.shape)})
            print(f"  K8 {entry} forward ms {summ['forward_ms']:.6f}; backward ms "
                  f"{summ['ms']:.6f}, plain {summ['plain_ms']:.6f}, bound_ms "
                  f"{summ['bound_ms']:.6f} ({summ['bound_by']})  [{card}]")
            out[entry] = summ
            del gk, gp, again
        # the paste output's own gradient (the kernel's g_paste operand)
        args = (mask, g_img, g_paste, front, xyz, bw)
        gk, gp = tp.paste_front_grad_kernel(*args), tp.paste_front_grad_plain(*args)
        e_paste = max(rel_max_err(gk[0], gp[0]), rel_max_err(gk[1], gp[1]))
        check("K8 backward with the paste's own gradient (relative to each max)", e_paste,
              K8G_TOL)
    summary = dict(out["paste_front_occ"], map_entry=out["paste_front"],
                   with_paste_gradient_relative_err=e_paste,
                   training_thresholds_pass=train_pass, thresh_weight=thr_w)
    return summary


def k10_grad_ops(points: int, C: int):
    """K10's backward form's operations a call, by K1's backward's rule
    (k1_grad_ops) with the trilinear gather and scatter: per point and
    channel of each plane the 8 corners' lerps and blend (14) and their
    products into the 8 corners (16) on the CUDA cores; K1's five products
    on the tensor cores in 3xTF32."""
    return points * 3 * C * (14 + 16), k1_grad_ops(points, C)[1]


def k10_grad_inputs(device):
    """Depth 2's coarse training pass for K10's backward form: bf16 volumes
    [24,2,256,256,32] (seeded planes), 8 x 4,096 rays of random pinhole
    cameras x 48 jittered depths, a seeded decoder, random output
    gradients -> the wrappers' arguments."""
    import torch

    from panic3d_tpu_torch import configs
    from panic3d_tpu_torch.cameras import camera_label, sample_rays
    from panic3d_tpu_torch.models.volumetric import renderer as vr

    rk = configs.flagship_kwargs()["rendering_kwargs"]
    N, S, res, C, D = TRAIN_BATCH, rk["depth_resolution"], 64, 32, DEEP_DEPTH
    gen = torch.Generator(device=device).manual_seed(SEED)
    planes = torch.randn((N, 3, C * D, 256, 256), generator=gen, device=device) * 0.5
    vols = vr.deep_volumes_cl(planes, D, torch.bfloat16)
    del planes
    ones = torch.ones(N, device=device)
    cam = camera_label(torch.rand(N, generator=gen, device=device) * 40 - 10,
                       torch.rand(N, generator=gen, device=device) * 360 - 180, ones, 30 * ones)
    ro, rd = sample_rays(cam[:, :16].reshape(-1, 4, 4), cam[:, 16:].reshape(-1, 3, 3), res)
    depths = vr.sample_stratified(ro, rk["ray_start"], rk["ray_end"], S, jitter=torch.rand(
        (N, res * res, S, 1), generator=gen, device=device))
    x = (ro[:, :, None] + depths * rd[:, :, None]).reshape(N, -1, 3).contiguous()
    w = [torch.randn(s, generator=gen, device=device) for s in ((64, C), (64,), (33, 64), (33,))]
    dec = vr.Decoder(w[0], w[1] * 0.1, w[2], w[3] * 0.1, 1.0, False)
    axes, nof, bw = vr.generate_plane_axes(True), vr.DensityFilters(), rk["box_warp"]
    P = x.shape[1]
    g_rgb = (torch.randn((N, P, 32), generator=gen, device=device) * 1e-3).to(torch.bfloat16)
    g_sig = torch.randn((N, P, 1), generator=gen, device=device) * 1e-3
    return (vols, x, dec, bw, axes, nof, g_rgb, g_sig)


def k10_grad_check(device, card, parent):
    """K10's backward form against its plain version (autograd of
    triplane_decode_deep_plain) on the card at depth 2's coarse training
    pass: bf16 volumes [24,2,256,256,32] (seeded planes), 8 x 4,096 rays of
    random pinhole cameras x 48 jittered depths, a seeded decoder, random
    output gradients. K1's backward's tolerances (k1_grad_check): the
    volumes' gradient within 2^-7 of its max; the decoder's against an f64
    evaluation, the kernel's within 10x the f32 plain version's error (or
    1e-4) of each max; the weight gradients equal bit for bit over two
    launches. Timed beside its bound and the plain version, and with
    --parent against the parent's kernel (k1g_parent). -> summary."""
    import torch

    from panic3d_tpu_torch.models.volumetric import renderer as vr

    args = k10_grad_inputs(device)
    vols, x, dec, bw, axes, nof, g_rgb, g_sig = args
    N, P, C, D = x.shape[0], x.shape[1], vols.shape[-1], vols.shape[1]
    print(f"K10's backward form, depth {D} coarse training pass: volumes {tuple(vols.shape)} "
          f"bf16, coords {tuple(x.shape)}")
    with torch.no_grad():
        gk = vr.triplane_decode_deep_grad_kernel(*args)
        gp = vr.triplane_decode_deep_grad_plain(*args)
        dec64 = dec._replace(**{f: getattr(dec, f).double() for f in ("w0", "b0", "w1", "b1")})
        g64 = vr.triplane_decode_deep_grad_plain(vols.double(), x.double(), dec64, bw, axes, nof,
                                                 g_rgb.double(), g_sig.double())
    e_vols = rel_max_err(gk[0], gp[0])
    check("K10 backward: the volumes' gradient (relative to its max)", e_vols, K10G_PLANES_TOL)
    e_w, e_wp = 0.0, 0.0
    for name, a, b, c in zip(("w0", "b0", "w1", "b1"), gk[1:], gp[1:], g64[1:]):
        ek, ep = rel_max_err(a.double(), c), rel_max_err(b.double(), c)
        print(f"  K10 backward: d{name} against f64: kernel {ek:.3e}, plain {ep:.3e}")
        e_w, e_wp = max(e_w, ek), max(e_wp, ep)
    check("K10 backward: the decoder's weight gradients against f64 (relative to each max)",
          e_w, max(1e-4, 10 * e_wp))
    del g64
    again = vr.triplane_decode_deep_grad_kernel(*args)
    differ = sum(int((a != b).sum()) for a, b in zip(gk[1:], again[1:]))
    print(f"  K10 backward: weight gradients of two launches not bit-equal: {differ}")
    require(differ == 0, "K10 backward: the weight gradients change between runs")
    f32_ops, tf32_ops = k10_grad_ops(N * P, C)
    n_bytes = k1_grad_bytes(vols, x, g_rgb, g_sig)
    with torch.no_grad():
        summ = record(max_err(gk[0], gp[0]), lambda: vr.triplane_decode_deep_grad_kernel(*args),
                      lambda: vr.triplane_decode_deep_grad_plain(*args), n_bytes, f32_ops,
                      plain_iters=3, tf32_flops=tf32_ops)
    # where a call's time goes: each device launch (the f32 scratch's
    # fill, the kernel, the weight partials' sum, the cast), by torch.profiler
    runs = 10
    means = launch_means(lambda: vr.triplane_decode_deep_grad_kernel(*args), runs)
    summ.update(relative_err=e_vols, weight_grads_relative_err_f64=e_w, bytes=n_bytes,
                plain_weight_grads_relative_err_f64=e_wp,
                shapes={"volumes": list(vols.shape), "coords": list(x.shape)},
                launch_means_ms={k: ms for k, (n, ms) in means.items()},
                launches_recorded={k: n for k, (n, ms) in means.items()}, profiled_calls=runs)
    print(f"  ms {summ['ms']:.6f}  plain_ms {summ['plain_ms']:.6f}  bound_ms "
          f"{summ['bound_ms']:.6f} ({summ['bound_by']}; {n_bytes} bytes)  [{card}]")
    print(f"  {runs} calls profiled, by launch (recorded, mean ms): " + ", ".join(
        f"{k} {n} {ms:.6f}" for k, (n, ms) in means.items())
        + f"; the means sum to {sum(ms for _, ms in means.values()):.6f}  [{card}]")
    with torch.no_grad():
        summ["parent"] = k1g_parent(parent, "triplane_decode_deep_grad",
                                    lambda: vr.triplane_decode_deep_grad_kernel(*args),
                                    "K10 backward")
    return summ


def training_options_path(device, card, default=None, parent=None):
    """The trainer's paste-front and depth-2 options on the card: K8's
    backward form at training's paste (k8_grad_checks) and K10's at depth
    2's coarse pass (k10_grad_check) against their plain versions, and
    training_path's runs "paste" (paste-front and Greg's monotonic-fixed
    term) and "depth2" (triplane_depth 2 and monotonic-detach), each one's
    card time (the device's busy ms of a profiled step of every phase) and
    host s/step against the default run's: ``default``, training_path's
    summary, or (None: --options-only) its run here. -> (kernel summaries,
    {run: launch counts}, summary)."""
    import torch

    t0 = time.perf_counter()
    counts, summary = {}, {}
    with torch.enable_grad():
        if default is None:
            counts["default"], default, _ = training_path(device, card)
            summary["default"] = default
        call = []
        counts["paste"], summary["paste"], _ = training_path(device, card, "paste", capture=call)
    checks = {"paste_front_grad": k8_grad_checks(call[0], card)}
    del call
    torch.cuda.empty_cache()
    with torch.enable_grad():
        counts["depth2"], summary["depth2"], _ = training_path(device, card, "depth2")
    checks["triplane_decode_deep_grad"] = k10_grad_check(device, card, parent or {})
    torch.cuda.empty_cache()
    base, base_busy = default["s_per_step_median"], default["profiled_step"]["busy_ms"]
    for run in ("paste", "depth2"):
        med, busy = summary[run]["s_per_step_median"], summary[run]["profiled_step"]["busy_ms"]
        summary[run]["vs_default_step"] = {"card_busy": busy / base_busy, "host_s": med / base}
        print(f"training ({' '.join(TRAIN_RUNS[run][0])}): a step of every phase busy {busy:.3f} "
              f"ms of card time against the default step's {base_busy:.3f} "
              f"({busy / base_busy:.2f}x); host s/step {med:.3f} against {base:.3f} "
              f"({med / base:.2f}x)  [{card}]")
    for name, run in (("paste_front_grad", "paste"), ("triplane_decode_deep_grad", "depth2")):
        checks[name]["launches_per_step"] = summary[run]["launches_per_step"][name]
        print(f"{name}: {checks[name]['launches_per_step']:g} launches a step")
    summary["seconds"] = time.perf_counter() - t0
    print(f"training options path: {summary['seconds']:.1f} s")
    return checks, counts, summary


GAN_METRICS = ("fid50k_full", "fid_clip", "kid50k_full", "pr50k3_full", "is50k", "ppl2_wend")
METRIC_ITEMS = 64          # the metrics CLI's and the trainer's --metric-items
METRIC_BATCH = 8           # the CLI's --batch (the trainer's default batch)
METRIC_TIMED_ITEMS = 512   # fid50k_full's timed fakes, from two pre-drawn batches cycled
METRIC_FEAT_TOL = 1e-4     # InceptionV3's features, card against CPU, of the largest feature
TF32_PIN_TOL = 1e-6        # the feature fn under the global TF32 flags on against off, relative


def inception_flops(net, x) -> float:
    """The f32 operations of InceptionV3's features on ``x``: 2 per
    multiply-add of each conv (their output shapes from one run), the
    pools and ReLUs left out."""
    from panic3d_tpu_torch.eval.inception import FConv

    total = [0.0]

    def hook(mod, inp, out):
        total[0] += 2.0 * out.numel() * mod.w[0].numel()

    handles = [m.register_forward_hook(hook) for m in net.modules() if isinstance(m, FConv)]
    try:
        net(x)
    finally:
        for h in handles:
            h.remove()
    return total[0]


def gan_metrics_path(device, card):
    """The GAN metrics on the card (eval/calc_metrics.py, training/
    metric_eval.py, the trainer's snapshot-time --metrics): a flagship
    snapshot at the trainer's defaults with seeded weights and a seeded
    InceptionV3 (convert_inception_v3 of a seeded torchvision-named state
    dict with BatchNorm statistics) written by save_checkpoint; calc_metrics.
    main with --synthetic --batch 8 --metric-items 64 and the six metrics,
    every value finite, each metric's seconds from its jsonl's timestamps;
    fid50k_full's card work apart from the host's synthetic draws (512 fakes
    from two pre-drawn batches, cycled: G_ema.f and InceptionV3, s per 1,000
    items), with the launch counts zeroed before and read after (K1-K5
    required), peak memory, InceptionV3's ms a batch of 8 at 299^2 and
    generate_fakes' ms a batch (CUDA events), and one batch's host waits (1:
    the features' copy to the host, for the statistics); the features of one
    fixed batch of 8 images at 512^2 on the card against the port on the CPU
    (METRIC_FEAT_TOL); the feature fn under the global TF32 flags on and
    off (equal within TF32_PIN_TOL, the caller's flags restored), and a
    TF32 forward's distance for reference; then trainer.main --synthetic
    --metrics fid50k_full --metric-items 64 to one in-loop snapshot, whose
    metric-fid50k_full.jsonl must hold a finite value. -> summary."""
    import itertools
    import shutil

    import torch

    from panic3d_tpu_torch.data.dataset import synthetic_batch
    from panic3d_tpu_torch.eval import calc_metrics
    from panic3d_tpu_torch.eval.inception import InceptionV3, seeded_state_dict
    from panic3d_tpu_torch.kernels import launch_counts, reset_launch_counts
    from panic3d_tpu_torch.runtime.checkpoint import (flax_from_state_dict, load_checkpoint,
                                                      save_checkpoint)
    from panic3d_tpu_torch.runtime.convert import convert_inception_v3
    from panic3d_tpu_torch.training import trainer
    from panic3d_tpu_torch.training.metric_eval import (f32_math, generate_fakes,
                                                        make_inception_feature_fn)

    root = os.path.join(BUILD_TMP, "gan_metrics")
    shutil.rmtree(root, ignore_errors=True)
    summary = {}

    # the snapshot and the detector's weights
    t0 = time.perf_counter()
    args = trainer.parse_args(["--name", "metrics"])
    G, D, chonk_ch, feat_dim, model_kwargs = trainer.build_models(args, device)
    del D
    G.init_weights(SEED).eval()
    snap = os.path.join(root, "run", "network-snapshot-000000")
    save_checkpoint(snap, flax_from_state_dict(G.state_dict()),
                    config=dict(vars(args), model_kwargs=model_kwargs))
    inc_dir = os.path.join(root, "inception")
    inc_vars = convert_inception_v3(seeded_state_dict(SEED))
    save_checkpoint(inc_dir, inc_vars)
    print(f"GAN metrics: flagship snapshot and InceptionV3 written in "
          f"{time.perf_counter() - t0:.3f} s")

    # calc_metrics.main, the six metrics
    run_dir = os.path.join(root, "run")
    t_cli = time.time()
    calc_metrics.main(["--ckpt", snap, "--synthetic", "--batch", str(METRIC_BATCH),
                       "--metric-items", str(METRIC_ITEMS), "--metrics", ",".join(GAN_METRICS),
                       "--inception-weights", inc_dir])
    values, seconds, prev = {}, {}, t_cli
    for name in GAN_METRICS:
        with open(os.path.join(run_dir, f"metric-{name}.jsonl")) as f:
            rec = json.loads(f.read().splitlines()[-1])
        seconds[name] = rec["timestamp"] - prev
        prev = rec["timestamp"]
        values.update(rec["results"])
    bad = {k: v for k, v in values.items() if not math.isfinite(v)}
    require(not bad, f"calc_metrics: values not finite: {bad}")
    print(f"calc_metrics (flagship, --synthetic --batch {METRIC_BATCH} --metric-items "
          f"{METRIC_ITEMS}, seeded nets): " + ", ".join(f"{k} {v:.6g}" for k, v in values.items())
          + "; seconds " + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items())
          + f" (the first with the snapshot's load; the host's synthetic draws included)  [{card}]")
    summary["cli"] = {"values": values, "seconds": seconds}

    # fid50k_full's card work: G_ema.f and InceptionV3 on pre-drawn batches
    fn = make_inception_feature_fn(load_checkpoint(inc_dir)[0], device=device)
    pre = [synthetic_batch(bs=METRIC_BATCH, size=G.img_resolution, chonk_ch=chonk_ch,
                           feat_dim=feat_dim, seed=i) for i in range(2)]
    batches = itertools.cycle(pre)
    gen = torch.Generator(device=device).manual_seed(SEED)
    for fakes in generate_fakes(G, batches, METRIC_BATCH, gen):
        fn(fakes)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t = time.perf_counter()
    n = 0
    for fakes in generate_fakes(G, batches, METRIC_TIMED_ITEMS, gen):
        n += len(fn(fakes))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    counts, peak = launch_counts(), torch.cuda.max_memory_allocated()
    require(n == METRIC_TIMED_ITEMS, f"fid50k_full fakes: {n} items")
    require_launched(counts, RENDER_KERNELS, "fid50k_full fakes")
    waits = count_syncs(lambda: [fn(f) for f in generate_fakes(G, batches, METRIC_BATCH, gen)])
    require(waits == 1, f"fid50k_full: {waits} host waits a batch, expected 1 (the features)")
    net = InceptionV3(device=device).load_variables(inc_vars).eval()
    x299 = torch.rand((METRIC_BATCH, 3, 299, 299), generator=gen, device=device) * 2 - 1
    with f32_math(), torch.no_grad():
        inc_ms = cuda_ms(lambda: net(x299))
        inc_flops = inception_flops(net, x299)
    inc_bound, inc_by = bound(0.0, inc_flops)
    fake_ms = cuda_ms(lambda: next(generate_fakes(G, batches, METRIC_BATCH, gen)))
    per_batch = {k: v * METRIC_BATCH / n for k, v in counts.items() if v}
    print(f"fid50k_full fakes ({n} items, batch {METRIC_BATCH}, two pre-drawn synthetic "
          f"batches cycled): {dt / n * 1e3:.3f} s per 1,000 items; InceptionV3 "
          f"{inc_ms:.3f} ms a batch of {METRIC_BATCH} at 299^2 ({inc_flops / 1e9:.3f} GFLOP: "
          f"{inc_flops / inc_ms / 1e9:.3f} TFLOP/s, bound {inc_bound:.6f} ms by f32 "
          f"{inc_by}); generate_fakes "
          f"{fake_ms:.3f} ms a batch; host waits a batch {waits}; peak memory "
          f"{peak / 2**30:.3f} GiB; launches a batch "
          + ", ".join(f"{k}={v:g}" for k, v in per_batch.items()) + f"  [{card}]")
    summary["fid50k_full_fakes"] = {
        "items": n, "s_per_1000_items": dt / n * 1e3, "inception_ms_batch8_299": inc_ms,
        "inception_gflop_batch8_299": inc_flops / 1e9, "inception_bound_ms": inc_bound,
        "generate_fakes_ms_batch": fake_ms, "host_waits_per_batch": waits,
        "peak_gib": peak / 2**30, "launches_per_batch": per_batch}

    # InceptionV3's features: the card against the CPU, and TF32 pinned off
    imgs = torch.rand((METRIC_BATCH, 3, 512, 512), generator=torch.Generator().manual_seed(SEED))
    want = make_inception_feature_fn(inc_vars, device="cpu")(imgs)
    got = fn(imgs)
    err = float(np.abs(got - want).max())
    check("InceptionV3 features, card vs CPU (of the largest feature)",
          err / float(np.abs(want).max()), METRIC_FEAT_TOL)
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        on = fn(imgs)
        kept = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        with torch.no_grad():
            tf32 = net(InceptionV3.preprocess(imgs.to(device), (0.0, 1.0))).cpu().numpy()
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        off = fn(imgs)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    require(kept == (True, True), f"the feature fn left the TF32 flags at {kept}")
    scale = float(np.abs(off).max())
    pin = float(np.abs(on - off).max()) / scale
    tf32_err = float(np.abs(tf32 - off).max()) / scale
    check("InceptionV3 feature fn, global TF32 flags on vs off (relative)", pin, TF32_PIN_TOL)
    print(f"  a TF32 forward lands {tf32_err:.3e} of the largest feature from f32; the card "
          f"vs the CPU {err / float(np.abs(want).max()):.3e}")
    summary["features"] = {"card_vs_cpu_rel": err / float(np.abs(want).max()),
                           "tf32_flags_on_vs_off_rel": pin, "tf32_forward_rel": tf32_err}
    del net, fn, G
    torch.cuda.empty_cache()

    # the trainer's snapshot-time metric, at one in-loop snapshot
    outdir = os.path.join(root, "train")
    t = time.perf_counter()
    with torch.enable_grad():
        out = trainer.main(["--name", "metrics", "--outdir", outdir, "--synthetic",
                            "--tick-steps", "1", "--snap", "1", "--max-steps", "2",
                            "--metrics", "fid50k_full", "--metric-items", str(METRIC_ITEMS),
                            "--inception-weights", inc_dir])
    train_s = time.perf_counter() - t
    with open(os.path.join(out["run_dir"], "metric-fid50k_full.jsonl")) as f:
        lines = [json.loads(x) for x in f.read().splitlines()]
    require(len(lines) == 1 and math.isfinite(lines[0]["results"]["fid50k_full"]),
            f"trainer --metrics fid50k_full: {lines}")
    print(f"trainer --metrics fid50k_full --metric-items {METRIC_ITEMS} (2 steps, a snapshot "
          f"after the second): fid50k_full {lines[0]['results']['fid50k_full']:.6g} at "
          f"{lines[0]['snapshot_pkl']}; {train_s:.3f} s in all  [{card}]")
    summary["trainer"] = {"fid50k_full": lines[0]["results"]["fid50k_full"],
                          "snapshot": lines[0]["snapshot_pkl"], "seconds": train_s}
    del out
    torch.cuda.empty_cache()
    return summary


def k4_grad_entry(checks, launches):
    """The kernels line's entry of K4's backward form (K4's own entry point
    on the transposed pass, counted under its grad_ variants)."""
    from panic3d_tpu_torch.kernels import KERNELS

    k = KERNELS["upfirdn2d"]
    return {"name": "upfirdn2d_grad", "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": launches, **checks["upfirdn2d_grad"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="also profile one ESS + paste request, one turntable portrait "
                         "and one deep-plane request into DIR, count the first two's "
                         "launches with the grid occlusion's old chain and K8's entry, and "
                         "split one EQ-R batch's device time by kernel")
    ap.add_argument("--kernels-only", action="store_true",
                    help="build and check the kernels, then stop")
    ap.add_argument("--keyed-only", action="store_true",
                    help="build, then run only the keyed forward path, its kernel forms' "
                         "checks (with --parent, the eval forms against the parent's kernels) "
                         "and the Hybrid8X card-vs-CPU check, then stop")
    ap.add_argument("--forms-only", action="store_true",
                    help="build, then check only K4's forms of the calls the generic kernel "
                         "lost (k4_form_checks), K4's 4x4 form at training's small-plane and "
                         "b512 calls in both directions (k4_fir4_calls) and K1's and K2's "
                         "backward forms "
                         "(k1_k2_grad_checks), with --parent against the parent's kernels, "
                         "then stop: a redesign's first short call")
    ap.add_argument("--k1-grad-parts", action="store_true",
                    help="with --forms-only or --decode-grad-only, also time K1's (and K10's) "
                         "backward form built with parts "
                         "left out (k1_grad_parts)")
    ap.add_argument("--training-only", action="store_true",
                    help="build, then run only the training path (trainer.main at the "
                         "flagship defaults) and its checks (the backward forms, R1 against "
                         "the plain ops, one step against the plain ops), then stop")
    ap.add_argument("--ada-only", action="store_true",
                    help="build, then run only K14's checks, augment_pipe on the card and ADA's "
                         "training path (--aug fixed, then --aug ada), then stop")
    ap.add_argument("--options-only", action="store_true",
                    help="build, then run only the grad-mode checks with the tiny G.f's "
                         "backward card against CPU (grad_guard_checks) and the trainer's "
                         "options path (K8's and K10's "
                         "backward forms against their plain versions, trainer.main with "
                         "paste-front and with triplane_depth 2, each with a monotonic Greg, "
                         "beside a run at the defaults), then stop")
    ap.add_argument("--metrics-only", action="store_true",
                    help="build, then run only the GAN metrics path (calc_metrics.main with "
                         "the six metrics, fid50k_full's card work timed, InceptionV3 card vs "
                         "CPU and under the TF32 flags, the trainer's --metrics), then stop")
    ap.add_argument("--decode-grad-only", action="store_true",
                    help="build, then run only K1's and K2's backward checks "
                         "(k1_k2_grad_checks) and K10's (k10_grad_check), with --parent each "
                         "against the parent's kernel; with --k1-grad-parts, the parts' times")
    ap.add_argument("--sg3-only", action="store_true",
                    help="build, then run only K11's checks (k11_checks: the 15 stylegan3-t "
                         "layers, stylegan3-r's radial ones, the general form; with --parent "
                         "each against the parent's K11) and the stylegan3-t layers path")
    ap.add_argument("--parent", metavar="DIR",
                    help="a directory of the parent commit's kernel sources (e.g. "
                         "upfirdn2d.cu, front_occlusion.cu, paste_front.cu): time this "
                         "tree's kernels against them (parent / this / this / parent) and "
                         "compare their outputs, K8's grid-occlusion entry against the "
                         "parent's K7b -> glue -> K8 chain")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    import torch

    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port has no CPU fallback here", file=sys.stderr)
        return 2
    card = card_line()
    print(f"card: {card}  ({torch.cuda.get_device_name(0)})")
    global SFU_OPS_PER_S, ISSUE_PER_S
    SFU_OPS_PER_S, ISSUE_PER_S = sfu_rate()
    device = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from panic3d_tpu_torch import configs
    from panic3d_tpu_torch.eval.generate import (
        INFERENCE_OPTS, eval_views, plane_cache_ok, planes_bundle, render_from_planes)
    from panic3d_tpu_torch.kernels import KERNELS, build, reset_launch_counts
    from panic3d_tpu_torch.ops.gather_dot import gather_dot

    t0 = time.perf_counter()
    per = build.build_all()
    print(f"built {len(per)} sources in {time.perf_counter() - t0:.1f} s "
          + " ".join(f"{k}={v:.1f}s" for k, v in per.items()))
    spilled = []
    for stem in per:
        for fn, regs, spill_st, spill_ld, _ in ptxas_report(
                build.build(stem).with_suffix(".log").read_text()):
            print(f"  {stem}: {fn} {regs} registers, spill stores/loads {spill_st}/{spill_ld}")
            if fn.startswith(NO_SPILL) and (spill_st or spill_ld):
                spilled.append(fn)
    require(not spilled, f"kernels that spill registers: {spilled}")
    parent = build_parent(args.parent)

    if args.forms_only:
        gen = torch.Generator(device=device).manual_seed(SEED)
        with torch.no_grad():
            forms = k4_form_checks(device, parent, gen)
            fir4 = k4_backward_checks(k4_fir4_calls(), device, parent)
        Gt = configs.flagship(device=device).init_weights(SEED)
        grads = k1_k2_grad_checks(Gt, device, parent)
        parts = k1_grad_parts(Gt, device) if args.k1_grad_parts else None
        print(f"wall time {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"upfirdn2d": forms, "upfirdn2d_grad": fir4, **grads,
                          "k1_grad_parts": parts}, default=str))
        print(card)
        return 0

    if args.decode_grad_only:
        Gt = configs.flagship(device=device).init_weights(SEED)
        grads = k1_k2_grad_checks(Gt, device, parent)
        grads["triplane_decode_deep_grad"] = k10_grad_check(device, card, parent)
        parts = k1_grad_parts(Gt, device) if args.k1_grad_parts else None
        print(f"wall time {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({**grads, "k1_grad_parts": parts}, default=str))
        print(card)
        return 0

    if args.sg3_only:
        with torch.no_grad():
            checks = k11_checks(device, parent)
            counts_sg3, sg3 = sg3_layers_path(device, card)
        kernels = [dict(name="filtered_lrelu", route="cuda",
                        source=KERNELS["filtered_lrelu"].source,
                        replaces=KERNELS["filtered_lrelu"].replaces,
                        launches=counts_sg3["filtered_lrelu"], **checks["filtered_lrelu"])]
        print(f"wall time {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"paths": {"stylegan3_t_layers": sg3}, "kernels": kernels},
                         default=str))
        print(card)
        return 0

    if args.ada_only:
        checks = k14_checks(device, parent)
        checks["grid_sample_2d"]["augment_pipe"] = augment_check(device, card)
        with torch.enable_grad():
            counts_ada, ada = ada_training_path(device, card)
        kernels = [dict(name=n, route="cuda", source=KERNELS[n].source,
                        replaces=KERNELS[n].replaces, launches=counts_ada[n], **checks[n])
                   for n in ("grid_sample_2d", "grid_sample_2d_grad")]
        print(f"wall time {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"paths": {"ada_training": ada}, "kernels": kernels}, default=str))
        print(card)
        return 0

    if args.options_only:
        grad_guard_checks(device)
        checks, counts_opts, options = training_options_path(device, card, parent=parent)
        kernels = [dict(name=n, route="cuda", source=KERNELS[n].source,
                        replaces=KERNELS[n].replaces, launches=counts_opts[run][n], **checks[n])
                   for n, run in (("paste_front_grad", "paste"),
                                  ("triplane_decode_deep_grad", "depth2"))]
        print(f"wall time {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"paths": {"training_options": options}, "kernels": kernels},
                         default=str))
        print(card)
        return 0

    if args.metrics_only:
        gan = gan_metrics_path(device, card)
        print(f"wall time {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"paths": {"gan_metrics": gan}}, default=str))
        print(card)
        return 0

    G = configs.flagship(eval_mode=True).init_weights(SEED).eval()
    with torch.no_grad():
        G.decoder.net[2].bias[0] += 2.5   # so that something renders (as test_flagship_parity)
    Ge = configs.flagship(eval_mode=True, ess=True).eval()
    Ge.load_state_dict(G.state_dict())
    Gd = configs.flagship(eval_mode=True, rendering_kwargs=dict(triplane_depth=DEEP_DEPTH))
    Gd = Gd.init_weights(SEED).eval()
    with torch.no_grad():
        Gd.decoder.net[2].bias[0] += 2.5
    paste = INFERENCE_OPTS["paste_params"]

    if args.keyed_only:
        with torch.no_grad():
            keyed, keyed_inputs_, _ = keyed_forward_path(device, card)
            forms = keyed_form_checks(keyed_inputs_, keyed)
            parent_keyed = keyed_parent_checks(parent, keyed_inputs_)
            hybrid = hybrid8x_check(device, card)
        print(json.dumps({"paths": {"keyed_forward": keyed, "hybrid8x": hybrid},
                          "kernel_forms": forms, "parent": parent_keyed}, default=str))
        print(card)
        return 0

    if args.training_only:
        checks, counts_train, training, _ = training_checks(device, card, parent)
        kernels = [dict(name=n, route="cuda", source=KERNELS[n].source,
                        replaces=KERNELS[n].replaces, launches=counts_train[n], **checks[n])
                   for n in BACKWARD_KERNELS]
        kernels.append(k4_grad_entry(checks, training["k4_grad_launches"]))
        print(f"wall time {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"paths": {"training": training}, "kernels": kernels}, default=str))
        print(card)
        return 0

    with torch.no_grad():
        x = flagship_inputs(G, device)
        checks = kernel_checks(G, device)
        checks.update(k4_checks(G, x, device, parent))
        checks.update(ess_paste_kernel_checks(Ge, x, device, parent))
        k3 = checks["importance_sample"]
        k3_ess = checks.pop("importance_sample_ess")
        k3["shapes"] = {k3["samples"]: dict(k3), k3_ess["samples"]: k3_ess}
        checks.update(epilogue_kernel_checks(device))
        volume_checks, levels = volume_kernel_checks(Ge, device, parent)
        # K1's second form on a path (the geometry path's vertex colours)
        checks["triplane_decode"]["vertex_colours"] = volume_checks.pop(
            "triplane_decode_vertex_colours")
        checks.update(volume_checks)
        checks.update(k13_checks(device))
        checks.update(k10_checks(Gd, device, parent))
        checks.update(k11_checks(device, parent))
        checks.update(k14_checks(device, parent))
        checks["grid_sample_2d"]["augment_pipe"] = augment_check(device, card)
        grad_guard_checks(device)
        if args.kernels_only:
            print(json.dumps({"kernels": [dict(name=n, **checks[n]) for n in KERNELS
                                          if n in checks]}))
            print(card)
            return 0
        tiny_end_to_end(device, ess_paste=False)
        tiny_end_to_end(device, ess_paste=True)
        tiny_end_to_end(device, ess_paste=False, deep=True)

        # path 1: settings parity (ESS off, 96+96, paste off)
        out, counts_parity, parity = drive(
            f"settings-parity (ess off, 96+96, paste off, bs={BATCH})", lambda: G.f(x),
            BATCH, REQUESTS, card)
        check_outputs(out, (BATCH, 3, 512, 512))
        require_launched(counts_parity, RENDER_KERNELS, "settings-parity")
        require_k4_polyphase(parity, "settings-parity")
        bf16_closeness(G, x, out, lambda **kw: configs.flagship(eval_mode=True, **kw))
        del out

        # path 2: ESS + paste, per call
        xp = dict(x, paste_params=paste)
        out, counts_main, per_call = drive(
            f"ESS + paste per call (48+48, bs={BATCH})", lambda: Ge.f(xp), BATCH, REQUESTS,
            card)
        check_outputs(out, (BATCH, 3, 512, 512))
        require_launched(counts_main, ESS_PASTE_KERNELS, "ESS + paste per call")
        require_absent(counts_main, GRID_PASTE_ABSENT, "ESS + paste per call")
        require_k4_polyphase(per_call, "ESS + paste per call")
        for k in PASTE_KEYS:
            print(f"  {k} passes {float(out['paste'][k].mean()):.4f}")
        bf16_closeness(Ge, xp, out, lambda **kw: configs.flagship(eval_mode=True, ess=True,
                                                                   **kw))
        del out

        # path 3: the per-portrait turntable (bench.py:202-264)
        require(plane_cache_ok(Ge), "flagship eval mapping must be camera-free")
        opts = dict(triplane_crop=0.1, cull_clouds=0.5, paste_params=paste)
        cond1 = {k: v[:1] for k, v in x["cond"].items()}
        views = eval_views()

        def portrait():
            bundle = planes_bundle(Ge, SEED, cond1, opts)
            last = None
            for i in range(0, len(views), BATCH):
                cc = views[i:i + BATCH]
                cc = cc + [cc[-1]] * (BATCH - len(cc))
                last = render_from_planes(Ge, opts, bundle, [c[2] for c in cc],
                                          [c[3] for c in cc], [c[4] for c in cc], cond1)
            return last

        out, counts_turn, turn = drive(
            f"per-portrait turntable ({len(views)} views, view batch {BATCH})", portrait,
            len(views), PORTRAITS, card)
        check_outputs(out, (BATCH, 3, 512, 512))
        require_launched(counts_turn, ESS_PASTE_KERNELS, "turntable")
        require_absent(counts_turn, GRID_PASTE_ABSENT, "turntable")
        require_k4_polyphase(turn, "turntable")
        print(f"  {turn['ms_per_run'] / 1e3:.4f} s/portrait")
        del out

        # the keyed forward (training's G.f: random noise, a render key),
        # its kernel forms alone, and a Hybrid8X flagship with random SR noise
        keyed, keyed_in, _ = keyed_forward_path(device, card)
        for name, forms in keyed_form_checks(keyed_in, keyed).items():
            checks[name].update(forms)
        for name, summ in keyed_parent_checks(parent, keyed_in).items():
            checks[name]["eval_form_vs_parent"] = summ
        del keyed_in
        hybrid = hybrid8x_check(device, card)

        # training: trainer.main at the flagship defaults, the backward
        # forms at its shapes, R1 and one step against the plain ops
        train_checks, counts_train, training, counts_ada = training_checks(device, card, parent)
        checks.update(train_checks)
        # the trainer's options: paste-front and depth 2 (K8's and K10's
        # backward forms), each with a monotonic Greg
        opt_checks, counts_opts, options = training_options_path(device, card, training, parent)
        checks.update(opt_checks)
        for name in ("grid_sample_2d", "grid_sample_2d_grad"):
            checks[name]["launches_per_ada_step"] = training["ada"]["ada"][
                "launches_per_step"].get(name, 0)

        # the GAN metrics: calc_metrics, fid50k_full's card work, the
        # trainer's snapshot-time --metrics
        gan = gan_metrics_path(device, card)

        # K5's bound summed over a request's and a portrait's calls
        k5_sums = {}
        for label, fn in (("ess_paste_request", lambda: Ge.f(xp)),
                          ("turntable_portrait", portrait)):
            n, b = k5_bound_sum(fn)
            k5_sums[label] = {"calls": n, "bound_ms": b}
            print(f"K5 over one {label.replace('_', ' ')}: {n} calls, bound summed {b:.6f} ms")
        checks["modconv_epilogue"]["bound_ms_summed"] = k5_sums

        # K12's own path: the gather-decode probe at its shapes
        gen = torch.Generator(device=device).manual_seed(SEED)
        table = torch.randn((4096, 128), generator=gen, device=device)
        w = torch.randn((128, 64), generator=gen, device=device) * 0.1
        idx = torch.randint(0, 4096, (131072,), generator=gen, device=device,
                            dtype=torch.int32)
        _, counts_probe, probe = drive("gather-decode probe (131072 rows)",
                                       lambda: gather_dot(idx, table, w), 1, REQUESTS, card,
                                       unit="calls")
        require_launched(counts_probe, ("gather_dot",), "probe")

        # path 4: the deep-plane generator (triplane_depth 2) per call, per
        # portrait and through the mesh
        deep, counts_deep = deep_plane_paths(Gd, x, device, card)
        for name in ("triplane_decode_deep", "volume_density_deep"):
            checks[name]["launches_per_path"] = {
                k: v["launches_per_run"].get(name, 0) for k, v in deep.items()}
            print(f"K10 {name} launches per run: " + ", ".join(
                f"{k} {n:g}" for k, n in checks[name]["launches_per_path"].items()))

        geometry, counts_geom = geometry_path(Ge, device, card, levels)
        eval_cli, counts_eval = eval_cli_path(Ge, device, card)
        ckpt = checkpoint_path(Ge, cond1, device, card, eval_cli["mesh_level"])

        # the alias-free layers (K11), then the equivariance metrics (K4's
        # large-filter form)
        counts_sg3, sg3_path = sg3_layers_path(device, card)
        counts_eq, equivariance = equivariance_path(device, card)

        if args.profile:
            from pathlib import Path

            from torch.profiler import ProfilerActivity, profile

            Path(args.profile).mkdir(parents=True, exist_ok=True)
            xpd = dict(xp, paste_params=dict(paste, occ_impl="render"))
            for name, fn in (("ess_paste", lambda: Ge.f(xp)), ("turntable", portrait),
                             ("deep_per_call", lambda: Gd.f(xpd))):
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    fn()
                    torch.cuda.synchronize()
                table_txt = prof.key_averages().table(sort_by="cuda_time_total", row_limit=50)
                (Path(args.profile) / f"{name}_profile.txt").write_text(table_txt)
                trace = Path(args.profile) / f"{name}_trace.json"
                prof.export_chrome_trace(str(trace))
                what = {"ess_paste": "ESS + paste request", "turntable": "turntable portrait",
                        "deep_per_call": "deep-plane request (render paste)"}[name]
                print(f"profile of one {what}:")
                print("\n".join(table_txt.splitlines()[:40]))
                trace_json = json.loads(trace.read_text())
                print(device_busy(trace_json) + f"  [{card}]")
                print(device_time_by_kind(trace_json) + f"  [{card}]")
            # the grid occlusion before and after K8 took it in: an ESS +
            # paste request and a turntable portrait with the chain it
            # replaced (paste_chain; with --parent the parent's K7b and K8)
            # and with K8's grid-occlusion entry, chain / fused / fused /
            # chain: device launches, host ops, device busy time
            import contextlib

            for label, fn, summ in (("ESS + paste request", lambda: Ge.f(xp), per_call),
                                    ("turntable portrait", portrait, turn)):
                rows = []
                for tag in ("chain", "fused", "fused", "chain"):
                    with chained_paste(parent) if tag == "chain" else contextlib.nullcontext():
                        rows.append(dict(trace_counts(fn, runs=1), paste=tag))
                summ["paste_chain_vs_fused"] = rows
                print(f"{label}, the grid occlusion by the K7b -> glue -> K8 chain / K8's "
                      "entry / K8's entry / the chain: device launches "
                      + " / ".join(f"{r['device_launches']:g}" for r in rows)
                      + ", of them the libraries' "
                      + " / ".join(f"{r['library_launches']:g}" for r in rows) + "; host ops "
                      + " / ".join(f"{r['host_ops']:g}" for r in rows) + "; busy ms "
                      + " / ".join(f"{r['busy_ms']:.3f}" for r in rows) + " of "
                      + " / ".join(f"{r['span_ms']:.3f}" for r in rows) + f"  [{card}]")
            equivariance["eqr50k"]["batch_profile"] = eqr_profile(device)
            if "ess" in parent:
                # a turntable portrait's device busy time with the parent's
                # K6a and with this tree's, parent / this / this / parent

                libs = {"ess_occupancy": parent["ess"][0]}
                tmp = Path(args.profile) / "busy_trace.json"
                busy = []
                for tag in ("parent", "this", "this", "parent"):
                    with contextlib.ExitStack() as stack:
                        if tag == "parent":
                            stack.enter_context(parent_entries(libs))
                        with profile(activities=[ProfilerActivity.CPU,
                                                 ProfilerActivity.CUDA]) as prof:
                            portrait()
                            torch.cuda.synchronize()
                    prof.export_chrome_trace(str(tmp))
                    busy.append(busy_span(json.loads(tmp.read_text()))[0])
                tmp.unlink()
                turn["busy_ms_parent_this_this_parent"] = busy
                print("turntable portrait, device busy ms with the parent's K6a / this "
                      "tree's / this tree's / the parent's: "
                      + " / ".join(f"{b:.3f}" for b in busy) + f"  [{card}]")

    reset_launch_counts()
    paths = {"settings_parity": parity, "ess_paste_per_call": per_call, "turntable": turn,
             "keyed_forward": keyed, "hybrid8x_keyed": hybrid,
             "probe": probe, **deep, **geometry, "eval_cli": eval_cli, "checkpoint": ckpt,
             "stylegan3_t_layers": sg3_path, "equivariance": equivariance,
             "training": training, "training_options": options, "gan_metrics": gan}
    print(json.dumps({"paths": paths, "card": card}, default=str))
    # each kernel's launches on the path that launches it: the ESS + paste
    # request, else the geometry path, else eval measure, else the probe,
    # else the deep-plane request, else the deep-plane mesh, else the
    # stylegan3-t layers, else EQ-R (K14's forward, a run of 16 batches),
    # else training (the backward forms), else ADA's training run (K14's
    # backward, ADA_STEPS steps), else the options' paste run (K8's
    # backward), else their depth-2 run (K10's backward), each 1 +
    # TRAIN_STEPS steps; 0 for a kernel of CHECK_ONLY
    sources = (counts_main, counts_geom, counts_eval, counts_probe, *counts_deep, counts_sg3,
               counts_eq, counts_train, counts_ada, counts_opts["paste"], counts_opts["depth2"])
    launches = {name: next((c[name] for c in sources if c[name]), 0) for name in KERNELS}
    require_launched(launches, [k for k in KERNELS if k not in CHECK_ONLY], "all paths")
    summary = {"kernels": [
        {"name": name, "route": "cuda", "source": k.source, "replaces": k.replaces,
         "launches": launches[name], **checks[name]}
        for name, k in KERNELS.items()] + [k4_grad_entry(checks, training["k4_grad_launches"])]}
    print(f"wall time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(summary))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
