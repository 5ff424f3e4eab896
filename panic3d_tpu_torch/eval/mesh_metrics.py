"""Point / mesh geometry metrics: chamfer distance and F1
(panic3d_tpu/eval/mesh_metrics.py).

The reference's igl calls (``_scripts/eval/measure.py:77-99,186-201``) are
brute force here, as in the JAX package: every point against every
triangle. ``point_mesh_distance_sq`` is the wrapper of CUDA kernel K9
(csrc/mesh_distance.cu); ``point_mesh_distance_sq_plain`` is the same
function in PyTorch, one op per multiply, add and divide (the kernel repeats
each rounding): the CPU path and the kernel's oracle.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import KERNELS
from ..kernels import build as kb


def _dot3(u, v):
    return u[..., 0] * v[..., 0] + u[..., 1] * v[..., 1] + u[..., 2] * v[..., 2]


def _cross(u, v):
    return torch.stack([u[..., 1] * v[..., 2] - u[..., 2] * v[..., 1],
                        u[..., 2] * v[..., 0] - u[..., 0] * v[..., 2],
                        u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0]], -1)


def point_triangle_distance_sq(p, a, b, c):
    """Squared distance from points p [P,3] to triangles (a, b, c) [T,3]
    -> [P,T] (mesh_metrics.py:23): the minimum over the three clipped edge
    segments, or the plane distance where the projection lands inside a
    triangle of non-zero area."""

    def seg_d(s, e):
        se = e - s
        len2 = _dot3(se, se)
        sp = p[:, None] - s[None]
        t = (_dot3(sp, se[None]) / torch.where(len2 == 0, 1.0, len2)).clamp(0.0, 1.0)
        d = p[:, None] - (s[None] + t[..., None] * se[None])
        return _dot3(d, d)

    d_edges = torch.minimum(torch.minimum(seg_d(a, b), seg_d(a, c)), seg_d(b, c))
    ab, ac = b - a, c - a
    n = _cross(ab, ac)
    n2 = _dot3(n, n)
    safe = torch.where(n2 == 0, 1.0, n2)
    ap = p[:, None] - a[None]
    dot_n = _dot3(ap, n[None])
    d_plane = dot_n * dot_n / safe
    gamma = _dot3(_cross(ab[None].expand_as(ap), ap), n[None]) / safe
    beta = _dot3(_cross(ap, ac[None].expand_as(ap)), n[None]) / safe
    inside = (beta >= 0) & (gamma >= 0) & (beta + gamma <= 1) & (n2 > 0)[None]
    return torch.where(inside, d_plane, d_edges)


def point_mesh_distance_sq_plain(points, verts, faces, tri_chunk: int = 2048):
    """Min squared distance from each point [P,3] to the mesh (verts [V,3],
    faces [T,3]), ``tri_chunk`` triangles at a time -> [P] (+inf without
    triangles)."""
    tris = verts[faces.long()]
    out = torch.full((points.shape[0],), float("inf"), dtype=torch.float32,
                     device=points.device)
    for t0 in range(0, tris.shape[0], tri_chunk):
        t = tris[t0:t0 + tri_chunk]
        d = point_triangle_distance_sq(points, t[:, 0], t[:, 1], t[:, 2])
        out = torch.minimum(out, d.min(1).values)
    return out


_K9_ARGS = (kb.PTR,) * 4 + (kb.INT, kb.INT, kb.PTR)


def point_mesh_distance_sq_kernel(points, verts, faces):
    """Launch K9 on CUDA tensors: same contract as
    :func:`point_mesh_distance_sq_plain`."""
    dev = points.device
    if not (points.ndim == verts.ndim == faces.ndim == 2 and points.shape[1] == verts.shape[1]
            == faces.shape[1] == 3):
        raise ValueError("K9 takes points [P,3], verts [V,3] and faces [T,3]")
    if verts.device != dev or faces.device != dev:
        raise ValueError("K9 inputs must share a device")
    points = points.to(torch.float32).contiguous()
    verts = verts.to(torch.float32).contiguous()
    faces = faces.to(torch.int32).contiguous()
    out = torch.full((points.shape[0],), float("inf"), dtype=torch.float32, device=dev)
    if points.shape[0] == 0 or faces.shape[0] == 0:
        return out
    kb.launch("point_mesh_distance", _K9_ARGS, points.data_ptr(), verts.data_ptr(),
              faces.data_ptr(), out.data_ptr(), points.shape[0], faces.shape[0],
              torch.cuda.current_stream(dev).cuda_stream)
    KERNELS["point_mesh_distance"].launches += 1
    return out


def point_mesh_distance_sq(points, verts, faces):
    """Min squared distance from each point to the mesh -> [P]: the plain
    version on CPU tensors, K9 on CUDA tensors."""
    if points.device.type == "cpu":
        return point_mesh_distance_sq_plain(points, verts, faces)
    if points.device.type == "cuda":
        return point_mesh_distance_sq_kernel(points, verts, faces)
    raise RuntimeError(f"point_mesh_distance_sq: no path for device {points.device}")


def sample_points_on_mesh(verts, faces, n: int, seed: int = 0):
    """Area-weighted surface sampling (igl.random_points_on_mesh role), with
    numpy's RandomState as in the JAX package, so both draw the same points."""
    rng = np.random.RandomState(seed)
    v = np.asarray(verts)
    f = np.asarray(faces)
    a, b, c = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    area = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
    total = area.sum()
    if total <= 0:
        return np.zeros((n, 3), np.float32)
    probs = area / total
    idx = rng.choice(len(f), size=n, p=probs)
    u = rng.rand(n, 1)
    w = rng.rand(n, 1)
    flip = (u + w) > 1
    u = np.where(flip, 1 - u, u)
    w = np.where(flip, 1 - w, w)
    pts = a[idx] + u * (b[idx] - a[idx]) + w * (c[idx] - a[idx])
    return pts.astype(np.float32)


def _to(a, dtype, device) -> torch.Tensor:
    """A host array on ``device``, through pinned memory to a CUDA device
    (an asynchronous copy)."""
    t = a if torch.is_tensor(a) else torch.from_numpy(np.ascontiguousarray(a))
    t = t.to(dtype)
    if torch.device(device).type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def distances(points, verts, faces, device) -> np.ndarray:
    """Unsigned point -> mesh distances [P] (numpy f32) computed on
    ``device`` (K9 on a CUDA device)."""
    d2 = point_mesh_distance_sq(_to(points, torch.float32, device),
                                _to(verts, torch.float32, device),
                                _to(faces, torch.int32, device))
    return np.sqrt(d2.cpu().numpy())


def chamfer_and_f1(pred_pts, pred_mesh, gt_pts, gt_mesh, thresholds=(0.005, 0.010),
                   device="cuda"):
    """Symmetric point -> mesh distances -> chamfer and F1@k
    (mesh_metrics.py:99; measure.py:186-201: cd = mean of both directions,
    F1 from precision and recall at k/1000). The twin of the JAX package's
    helper, kept for its callers; the geometry path scores through
    measure.geometry_metrics, which counts F1 with ``<=`` as measure.py
    does (point_mesh_f1), where this helper counts ``<``."""
    d_p2g = distances(pred_pts, *gt_mesh, device)
    d_g2p = distances(gt_pts, *pred_mesh, device)
    cd = (d_p2g.mean() + d_g2p.mean()) / 2
    out = {"cd": float(cd), "p2s": d_p2g, "s2p": d_g2p}
    for t in thresholds:
        precision = (d_p2g < t).mean()
        recall = (d_g2p < t).mean()
        f1 = 2 * precision * recall / (precision + recall) if (precision + recall) > 0 else 0.0
        out[f"f1@{int(t*1000)}"] = float(f1)
    return out
