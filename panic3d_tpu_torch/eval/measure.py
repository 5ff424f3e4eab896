"""The geometry metrics of eval measure (panic3d_tpu/eval/measure.py):
chamfer distance and F1 between a predicted mesh and a reference mesh,
with the reference's ROI filter, coordinate conventions (the x-flip of the
predicted vertices, the cv <-> world conjugation of the reference) and
10,000 surface samples per side. The point -> mesh distances run through
kernel K9 on the card. The 2-D metrics and the dataset loop of ``main``
are not ported yet: they need the GT heads, subsets and alignment data,
and the CLIP / LPIPS weights.

Kept quirk: the reference assigns (does not append) each portrait's F1
(measure.py:200-201), so its reported F1 is the last portrait's;
``geometry_metrics`` returns one portrait's values and leaves that to the
caller.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .mesh_metrics import distances, sample_points_on_mesh

F1_THRESHOLDS = (0.005, 0.01, 0.05, 0.1, 0.5)


def filter_mesh(v, f, roi, bw, size=512):
    """measure.py:54-76."""
    (fcx, fcy), (fsx, fsy) = roi
    fcx, fcy, fsx, fsy = fcx / size, fcy / size, fsx / size, fsy / size
    cx, cy = (-bw / 2 + fcy * bw, bw / 2 - fcx * bw)
    sx, sy = bw * fsy, bw * fsx
    wv = (
        (cx < v[:, 0]) & (v[:, 0] < cx + sx)
        & (cy - sy < v[:, 1]) & (v[:, 1] < cy)
    )
    wf = wv[f].all(axis=1)
    faces = (np.cumsum(wv) - 1)[f[wf]]
    return {"verts": v[wv], "faces": faces}


def point_mesh_f1(p2s, s2p, thresh):
    pre = (p2s <= thresh).mean()
    rec = (s2p <= thresh).mean()
    f1 = 2 * pre * rec / (pre + rec) if not pre == rec == 0.0 else 0.0
    return dict(precision=pre, recall=rec, threshold=thresh, f1=f1)


CV2WORLD = np.asarray(
    [[-1, 0, 0, 0], [0, 1, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1]], dtype=np.float64
)


def geometry_metrics(mesh_pred: dict, mesh_gt: dict, roi, bw: float = 0.7,
                     n_sample: int = 10000, seed: int = 0, device="cuda",
                     timings: Optional[dict] = None) -> dict:
    """measure.py:181-215 for one portrait: ``mesh_pred`` is extract_mesh's
    output (verts in box_warp units), ``mesh_gt`` the reference head
    ({'verts', 'faces'} in the cv frame), ``roi`` its alignment box
    ((cx, cy), (sx, sy)) in 512-pixel space. -> p2s and s2p (the mean
    distances), cd, and f1_005 ... f1_500 (F1 at 0.005 ... 0.5). With
    ``timings`` (a dict), the seconds of each direction's distances are
    recorded under p2s and s2p."""
    import time

    verts = mesh_pred["verts"] * np.asarray([-1, 1, 1])[None]
    pred = filter_mesh(verts, mesh_pred["faces"], roi, bw)
    points_pred = sample_points_on_mesh(pred["verts"], pred["faces"], n_sample, seed=seed)
    gt = filter_mesh(mesh_gt["verts"], mesh_gt["faces"], roi, bw)
    inv = np.linalg.inv(CV2WORLD)[:3, :3]
    points_gt = (inv @ sample_points_on_mesh(gt["verts"], gt["faces"], n_sample,
                                             seed=seed).T).T.astype(np.float32)
    gt_verts_w = (inv @ gt["verts"].T).T.astype(np.float32)
    t0 = time.perf_counter()
    p2s = distances(points_pred, gt_verts_w, gt["faces"], device)
    t1 = time.perf_counter()
    s2p = distances(points_gt, pred["verts"], pred["faces"], device)
    if timings is not None:
        timings.update(p2s=t1 - t0, s2p=time.perf_counter() - t1)
    out = {"p2s": float(p2s.mean()), "s2p": float(s2p.mean()),
           "cd": float((p2s.mean() + s2p.mean()) / 2)}
    for th in F1_THRESHOLDS:
        out[f"f1_{int(th * 1000):03d}"] = float(point_mesh_f1(p2s, s2p, th)["f1"])
    return out
