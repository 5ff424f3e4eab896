"""Snapshot-time GAN metric evaluation (panic3d_tpu/training/metric_eval.py).

Role of the training loop's metric pass (training_loop_v0.py:487-498 and
src/calc_metrics.py): at a snapshot, generate samples with G_ema, extract
the features of reals and fakes, compute the registered metrics
(eval/gan_metrics.py, numpy on the host) and append metric-<name>.jsonl in
the run directory.

The feature nets (InceptionV3, CLIP) and LPIPS run on the generator's
device in f32: each call turns cuDNN's and cuBLAS's TF32 off for its
duration and restores the caller's flags (``f32_math``), as the reference
turns TF32 off in training (training_loop_v0.py:141-143). Without converted
weights the nets are seeded: exact in architecture, relative values only.
Features come back to the host once a batch (one host wait), as numpy, for
the statistics.

The z of the fakes is drawn through utils/draws.py:normal from an explicit
``generator``: a torch.Generator on the generator's device, or a Replay of
draws made elsewhere (the JAX package's, in its order).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from ..eval.gan_metrics import FeatureStats, cached_dataset_stats, frechet_distance, report_metric
from ..utils import draws
from ..utils.device import to_device


@contextlib.contextmanager
def f32_math():
    """cuDNN's and cuBLAS's TF32 off inside, the caller's flags restored
    after (PyTorch's default leaves cuDNN's TF32 on)."""
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def _on(images, device) -> torch.Tensor:
    """A batch of images (numpy on the host, or a tensor) as f32 on ``device``."""
    if torch.is_tensor(images):
        return images.to(device=device, dtype=torch.float32)
    return to_device(images, device)


def make_inception_feature_fn(variables=None, probs: bool = False, device=None):
    """The reference's FID / KID / PR / IS detector (metric_utils.py:209-263):
    InceptionV3's pool features [N,2048], or the 1008-way softmax
    (``probs``, no_output_bias as inception_score.py:23). ``variables`` are
    convert_inception_v3's; None seeds the net."""
    from ..eval.inception import InceptionV3

    net = InceptionV3(device=device).eval()
    if variables is None:
        net.init_weights()
    else:
        net.load_variables(variables)
    dev = net.fc_w.device

    def feature_fn(images01):
        """[N,3,H,W] in [0,1] -> [N,2048] features (or [N,1008] probabilities), numpy."""
        with f32_math(), torch.no_grad():
            x = InceptionV3.preprocess(_on(images01, dev), in_range=(0.0, 1.0))
            out = net(x, return_features=not probs, no_output_bias=probs)
        return out.cpu().numpy()

    return feature_fn


def make_clip_feature_fn(variables=None, device=None):
    """The CLIP tower's unit embeddings [N,512] (eval/metrics2d.py:
    CLIPSimilarity.embed), the fid_clip variant's features; None seeds the
    tower."""
    from ..eval.metrics2d import CLIPSimilarity

    sim = CLIPSimilarity(variables, device=device)
    dev = sim.mean.device

    def feature_fn(images01):
        """[N,3,H,W] in [0,1] -> [N,512] features, numpy."""
        with f32_math(), torch.no_grad():
            z = sim.embed(_on(images01, dev))
        return z.cpu().numpy()

    return feature_fn


def _batch_inputs(batch, device, n: Optional[int] = None):
    """A host batch's cameras and conditions on ``device`` (the first n)."""
    cam = to_device(batch["camera"][:n], device)
    cond = {k: to_device(v[:n], device) for k, v in batch["cond"].items()}
    return cam, cond


def generate_fakes(G, batch_iter: Iterator, n_items: int, generator) -> Iterator[torch.Tensor]:
    """G_ema's images batch by batch, [-1,1] -> [0,1], on G's device
    (metric_utils' role): z drawn from ``generator`` for each batch, the
    batch's cameras and conditions, const noise, normalize_images."""
    done = 0
    while done < n_items:
        batch = next(batch_iter)
        cam, cond = _batch_inputs(batch, G.device)
        z = draws.normal((cam.shape[0], G.z_dim), generator, G.device, "generate_fakes")
        with torch.no_grad():
            out = G.f({"z": z, "camera_params": cam, "cond": cond, "normalize_images": True},
                      noise_mode="const")
        yield out["image"].float() * 0.5 + 0.5
        done += cam.shape[0]


def _pool256(img):
    factor = img.shape[-1] // 256
    if factor > 1:
        N, C, H, W = img.shape
        img = img.reshape(N, C, H // factor, factor, W // factor, factor).mean((3, 5))
    return img


def compute_ppl(G, batch_iter_factory: Callable[[], Iterator], lpips_fn: Callable,
                num_samples: int = 200, epsilon: float = 1e-4, batch_size: int = 2,
                generator=None) -> np.ndarray:
    """Perceptual path length with w-space endpoint sampling (the
    reference's ppl2_wend: perceptual_path_length.py PPLSampler with
    space='w', sampling='end', crop=False, eps 1e-4): for each pair of z
    (z0 then z1, from ``generator``), w0 and w0 + (w1 - w0) eps rendered with
    const noise at both ends (perceptual_path_length.py:71: any noise
    difference would dominate after the division), mean-pooled to 256^2
    (:80-82), LPIPS / eps^2. -> [num_samples] distances, numpy."""
    dev = G.device
    c_iter = batch_iter_factory()
    dists, n = [], 0
    while n < num_samples:
        cam, cond = _batch_inputs(next(c_iter), dev, batch_size)
        z0 = draws.normal((cam.shape[0], G.z_dim), generator, dev, "compute_ppl")
        z1 = draws.normal((cam.shape[0], G.z_dim), generator, dev, "compute_ppl")
        with torch.no_grad():
            w0 = G.mapping(z0, cam, cond)
            w1 = G.mapping(z1, cam, cond)
            imgs = [_pool256(G.f({"ws": ws, "camera_params": cam, "cond": cond,
                                  "normalize_images": True}, noise_mode="const")["image"])
                    for ws in (w0, w0 + (w1 - w0) * epsilon)]
            dists.append(lpips_fn(*imgs) / epsilon ** 2)
        n += cam.shape[0]
    return torch.cat(dists)[:num_samples].cpu().numpy()


def evaluate_fid(G, batch_iter_factory: Callable[[], Iterator], feature_fn: Callable,
                 n_items: int = 50000, run_dir: Optional[str] = None,
                 snapshot_name: Optional[str] = None, cache_dir: Optional[str] = None,
                 dataset_key=None, metric_name: str = "fid50k_full", generator=None) -> dict:
    """The fid50k_full protocol: the dataset's statistics (of the condition
    images, cached under ``cache_dir``) against n_items fakes. metric_name
    labels the report: 'fid50k_full' rides InceptionV3 (the paper's
    protocol), 'fid_clip' the CLIP features."""

    def compute_real():
        st = FeatureStats(max_items=n_items)
        for batch in batch_iter_factory():
            st.append(feature_fn(batch["cond"]["image"]))   # [0,1] already
            if st.is_full:
                break
        return st

    if cache_dir is not None:
        real_stats = cached_dataset_stats(cache_dir, ("fid_real", dataset_key, n_items),
                                          compute_real)
    else:
        real_stats = compute_real()

    gen_stats = FeatureStats(max_items=n_items)
    for fakes in generate_fakes(G, batch_iter_factory(), n_items, generator):
        gen_stats.append(feature_fn(fakes))
        if gen_stats.is_full:
            break
    gs, rs = gen_stats.get_mean_cov(), real_stats.get_mean_cov()
    result = {"results": {metric_name: frechet_distance(rs[0], rs[1], gs[0], gs[1])},
              "metric": metric_name, "total_time": 0.0}
    report_metric(result, run_dir=run_dir, snapshot_pkl=snapshot_name)
    return result
