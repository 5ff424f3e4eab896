"""GAN quality metrics (panic3d_tpu/eval/gan_metrics.py): the registry,
JSONL reporting, the dataset feature-stat cache, and the FID, KID,
precision/recall, IS, PPL and equivariance statistics.

A copy of the JAX module, which is numpy and scipy: the feature extractor
is the caller's (``gen_features`` / ``real_features``). The equivariance
entries take ``generator=`` (a CPU torch.Generator for the shifts and
angles) where the JAX module takes a PRNG ``key``.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Callable, Dict, Optional

import numpy as np

_metric_registry: Dict[str, Callable] = {}


def register_metric(fn: Callable) -> Callable:
    _metric_registry[fn.__name__] = fn
    return fn


def is_valid_metric(name: str) -> bool:
    return name in _metric_registry


def list_valid_metrics():
    return sorted(_metric_registry)


def calc_metric(metric: str, **kwargs) -> dict:
    start = time.time()
    results = _metric_registry[metric](**kwargs)
    return dict(
        results={metric: results} if not isinstance(results, dict) else results,
        metric=metric,
        total_time=time.time() - start,
    )


def report_metric(result_dict: dict, run_dir: Optional[str] = None,
                  snapshot_pkl: Optional[str] = None):
    """metric_main.py:72-84: append one JSONL line per metric."""
    jsonl = dict(result_dict, snapshot_pkl=snapshot_pkl, timestamp=time.time())
    line = json.dumps(jsonl, default=float)
    print(line)
    if run_dir is not None:
        with open(
            os.path.join(run_dir, f"metric-{result_dict['metric']}.jsonl"), "at"
        ) as f:
            f.write(line + "\n")


# ---------------------------------------------------------------------------
# statistics

class FeatureStats:
    """Streaming mean/cov accumulator (metric_utils.FeatureStats role)."""

    def __init__(self, max_items: Optional[int] = None, capture_all=False):
        self.max_items = max_items
        self.capture_all = capture_all
        self.num_items = 0
        self._all = []
        self._sum = None
        self._sumsq = None

    def append(self, x: np.ndarray):
        x = np.asarray(x, dtype=np.float64)
        if self.max_items is not None:
            x = x[: max(self.max_items - self.num_items, 0)]
        if x.size == 0:
            return
        if self.capture_all:
            self._all.append(x)
        if self._sum is None:
            self._sum = np.zeros(x.shape[1])
            self._sumsq = np.zeros((x.shape[1], x.shape[1]))
        self._sum += x.sum(axis=0)
        self._sumsq += x.T @ x
        self.num_items += len(x)

    @property
    def is_full(self):
        return self.max_items is not None and self.num_items >= self.max_items

    def get_mean_cov(self):
        mean = self._sum / self.num_items
        cov = self._sumsq / self.num_items - np.outer(mean, mean)
        return mean, cov

    def get_all(self):
        return np.concatenate(self._all)


def frechet_distance(mu1, cov1, mu2, cov2) -> float:
    """FID core (frechet_inception_distance.py)."""
    import scipy.linalg

    m = np.square(mu1 - mu2).sum()
    s = scipy.linalg.sqrtm(np.dot(cov1, cov2))  # may be complex near-singular
    return float(np.real(m + np.trace(cov1 + cov2 - s * 2)))


def kid_mmd(feat_real: np.ndarray, feat_gen: np.ndarray, num_subsets=100,
            max_subset_size=1000, seed=0) -> float:
    """KID polynomial-kernel MMD (kernel_inception_distance.py)."""
    rng = np.random.RandomState(seed)
    n = feat_real.shape[1]
    m = min(min(feat_real.shape[0], feat_gen.shape[0]), max_subset_size)
    t = 0.0
    for _ in range(num_subsets):
        x = feat_gen[rng.choice(feat_gen.shape[0], m, replace=False)]
        y = feat_real[rng.choice(feat_real.shape[0], m, replace=False)]
        a = (x @ x.T / n + 1) ** 3 + (y @ y.T / n + 1) ** 3
        b = (x @ y.T / n + 1) ** 3
        t += (a.sum() - np.trace(a)) / (m - 1) - b.sum() * 2 / m
    return float(t / num_subsets / m)


# ---------------------------------------------------------------------------
# feature-stat cache (metric_utils.py:214-234 role)

def cached_dataset_stats(cache_dir: str, key_parts, compute_fn) -> FeatureStats:
    key = hashlib.md5(repr(key_parts).encode()).hexdigest()
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, f"stats-{key}.npz")
    if os.path.isfile(path):
        data = np.load(path)
        st = FeatureStats()
        st._sum = data["sum"]
        st._sumsq = data["sumsq"]
        st.num_items = int(data["num"])
        return st
    st = compute_fn()
    np.savez(path, sum=st._sum, sumsq=st._sumsq, num=st.num_items)
    return st


# ---------------------------------------------------------------------------
# registered metrics

@register_metric
def fid50k_full(gen_features: np.ndarray = None, real_features: np.ndarray = None,
                real_stats: FeatureStats = None, **kwargs) -> dict:
    """FID between generator and dataset features (metric_main.py:87-92).

    Callers supply features from a pluggable extractor; 50k generated items
    is the reference protocol."""
    gs = FeatureStats()
    gs.append(gen_features)
    if real_stats is None:
        real_stats = FeatureStats()
        real_stats.append(real_features)
    mu_g, cov_g = gs.get_mean_cov()
    mu_r, cov_r = real_stats.get_mean_cov()
    return {"fid50k_full": frechet_distance(mu_r, cov_r, mu_g, cov_g)}


@register_metric
def kid50k_full(gen_features: np.ndarray = None, real_features: np.ndarray = None,
                **kwargs) -> dict:
    return {"kid50k_full": kid_mmd(real_features, gen_features)}


# ---------------------------------------------------------------------------
# improved precision/recall (precision_recall.py, Kynkäänniemi et al.)

def _chunked_cdist(rows: np.ndarray, cols: np.ndarray, col_batch: int):
    """Pairwise L2 distances [R, C], streamed over column chunks
    (precision_recall.py:21-34 compute_distances, single-process)."""
    outs = []
    r2 = np.sum(rows**2, axis=1, keepdims=True)
    for i in range(0, cols.shape[0], col_batch):
        cb = cols[i : i + col_batch]
        d2 = r2 + np.sum(cb**2, axis=1)[None, :] - 2.0 * rows @ cb.T
        outs.append(np.sqrt(np.maximum(d2, 0.0)))
    return np.concatenate(outs, axis=1)


def knn_precision_recall(
    real_features: np.ndarray,
    gen_features: np.ndarray,
    nhood_size: int = 3,
    row_batch_size: int = 10000,
    col_batch_size: int = 10000,
):
    """k-NN manifold precision/recall (precision_recall.py:38-63): a probe
    counts as covered if it lies within ANY manifold point's k-th-neighbor
    radius (k = nhood_size, excluding self)."""
    real_features = np.asarray(real_features, np.float32)
    gen_features = np.asarray(gen_features, np.float32)
    results = {}
    for name, manifold, probes in [
        ("precision", real_features, gen_features),
        ("recall", gen_features, real_features),
    ]:
        kth = []
        for i in range(0, manifold.shape[0], row_batch_size):
            d = _chunked_cdist(manifold[i : i + row_batch_size], manifold,
                               col_batch_size)
            # kth smallest including the self-distance 0 => index nhood_size
            kth.append(np.partition(d, nhood_size, axis=1)[:, nhood_size])
        kth = np.concatenate(kth)
        pred = []
        for i in range(0, probes.shape[0], row_batch_size):
            d = _chunked_cdist(probes[i : i + row_batch_size], manifold,
                               col_batch_size)
            pred.append(np.any(d <= kth[None, :], axis=1))
        results[name] = float(np.concatenate(pred).mean())
    return results["precision"], results["recall"]


@register_metric
def pr50k3_full(gen_features: np.ndarray = None, real_features: np.ndarray = None,
                **kwargs) -> dict:
    """metric_main.py:106-109 protocol: nhood 3, 200k real / 50k gen caps
    (callers supply however many features they have)."""
    p, r = knn_precision_recall(real_features, gen_features, nhood_size=3)
    return {"pr50k3_full_precision": p, "pr50k3_full_recall": r}


# ---------------------------------------------------------------------------
# inception score (inception_score.py)

@register_metric
def is50k(gen_probs: np.ndarray = None, num_splits: int = 10, **kwargs) -> dict:
    """IS over class-probability rows (inception_score.py:21-40)."""
    gen_probs = np.asarray(gen_probs, np.float64)
    n = len(gen_probs)
    scores = []
    for i in range(num_splits):
        part = gen_probs[i * n // num_splits : (i + 1) * n // num_splits]
        kl = part * (np.log(part) - np.log(np.mean(part, axis=0, keepdims=True)))
        scores.append(np.exp(np.mean(np.sum(kl, axis=1))))
    return {"is50k_mean": float(np.mean(scores)), "is50k_std": float(np.std(scores))}


# ---------------------------------------------------------------------------
# equivariance (equivariance.py; registry entries metric_main.py:117-132)

def _eq_metric(name, flag, synthesis_fn, ws_iter, num_samples, img_resolution,
               generator):
    from .equivariance import compute_equivariance_metrics

    psnr = compute_equivariance_metrics(
        synthesis_fn, ws_iter, num_samples=num_samples,
        img_resolution=img_resolution, generator=generator, **{flag: True},
    )
    return {name: float(psnr)}


@register_metric
def eqt50k_int(synthesis_fn=None, ws_iter=None, num_samples=50000,
               img_resolution=None, generator=None, **kwargs) -> dict:
    """EQ-T integer-translation PSNR (metric_main.py:117-121 protocol)."""
    return _eq_metric("eqt50k_int", "compute_eqt_int", synthesis_fn, ws_iter,
                      num_samples, img_resolution, generator)


@register_metric
def eqt50k_frac(synthesis_fn=None, ws_iter=None, num_samples=50000,
                img_resolution=None, generator=None, **kwargs) -> dict:
    """EQ-T_frac subpixel-translation PSNR (metric_main.py:123-126)."""
    return _eq_metric("eqt50k_frac", "compute_eqt_frac", synthesis_fn, ws_iter,
                      num_samples, img_resolution, generator)


@register_metric
def eqr50k(synthesis_fn=None, ws_iter=None, num_samples=50000,
           img_resolution=None, generator=None, **kwargs) -> dict:
    """EQ-R rotation PSNR (metric_main.py:128-132)."""
    return _eq_metric("eqr50k", "compute_eqr", synthesis_fn, ws_iter,
                      num_samples, img_resolution, generator)


# ---------------------------------------------------------------------------
# perceptual path length (perceptual_path_length.py)

def ppl_from_distances(dist: np.ndarray) -> float:
    """Percentile-filtered mean of the squared differential perceptual
    distances (perceptual_path_length.py:118-125)."""
    dist = np.asarray(dist, np.float64)
    lo = np.percentile(dist, 1, method="lower")
    hi = np.percentile(dist, 99, method="higher")
    return float(np.extract((dist >= lo) & (dist <= hi), dist).mean())


@register_metric
def ppl2_wend(ppl_distances: np.ndarray = None, **kwargs) -> dict:
    """metric_main.py:112-114 protocol: distances from metric_eval.compute_ppl
    (w-space, endpoint sampling, eps 1e-4)."""
    return {"ppl2_wend": ppl_from_distances(ppl_distances)}
