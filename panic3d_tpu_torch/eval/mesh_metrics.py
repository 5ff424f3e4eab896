"""Point / mesh geometry metrics: chamfer distance and F1
(panic3d_tpu/eval/mesh_metrics.py).

The reference's igl calls (``_scripts/eval/measure.py:77-99,186-201``) are
brute force here, as in the JAX package: every point against every
triangle. ``point_mesh_distance_sq`` is the wrapper of CUDA kernel K9
(csrc/mesh_distance.cu); ``point_mesh_distance_sq_plain`` is the same
function in PyTorch, one op per multiply, add and divide (the kernel repeats
each rounding): the CPU path and the kernel's oracle.
``point_triangle_distance_sq_branches`` makes K9's decisions (which pairs
divide, which evaluate the edges) in PyTorch, for the CPU proof that they
change no rounding (tests/test_torch_mesh_distance_branches.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import KERNELS, require_no_grad
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


def inside_threshold(safe):
    """The least numerator of beta or gamma that K9 takes to a division:
    -(safe * 2^-100). A quotient num / safe is >= 0 exactly when num >= 0,
    or when num < 0 and the quotient underflows to -0.0, which needs
    |num| <= safe * 2^-150; every such num is >= this threshold."""
    return -(safe * 2.0 ** -100)


def _fma(x, y, z):
    """fmaf(x, y, z) in f32, through f64 (x * y is exact there)."""
    return (x.double() * y.double() + z.double()).float()


def _fma_dot(u, m):
    """K9's filter value fma(u.x, m.x, fma(u.y, m.y, u.z * m.z))."""
    return _fma(u[..., 0], m[..., 0], _fma(u[..., 1], m[..., 1], u[..., 2] * m[..., 2]))


def point_triangle_distance_sq_branches(p, a, b, c):
    """point_triangle_distance_sq as K9 decides it (csrc/mesh_distance.cu,
    tri_d): each edge's t exactly 0 where dot <= 0 and exactly 1 where
    dot >= len2 (len2 replaced by 1 where it is 0), the quotient only in
    between; at t = 0 an edge's distance is the squared distance to its
    start vertex, and at t = 1 to its end vertex where s + (e - s) rounds
    back to e, each vertex's computed once; the inside test only for the
    pairs that a fused multiply-add filter of the barycentric numerators
    puts in or near the prism ("near", fma emulated in f64), then from the
    exact numerators: a candidate has n2 > 0, both numerators at least
    inside_threshold and their sum at most safe (1 + 2^-20), and only a
    candidate's quotients and d_plane are used. Every value it keeps is
    rounded as the plain version rounds it, so the result is bit-identical
    to point_triangle_distance_sq.
    -> (d [P,T], near [P,T] bool, candidates [P,T] bool)."""

    def vertex_d(v):
        d = p[:, None] - v[None]
        return _dot3(d, d)

    dd = {"a": vertex_d(a), "b": vertex_d(b), "c": vertex_d(c)}

    def seg_d(s, e, ks, ke):
        se = e - s
        len2 = _dot3(se, se)
        den = torch.where(len2 == 0, 1.0, len2)
        sp = p[:, None] - s[None]
        dt = _dot3(sp, se[None])
        t = torch.where(dt >= den, 1.0, dt / den)
        d = p[:, None] - (s[None] + t[..., None] * se[None])
        general = _dot3(d, d)
        eq = ((s + se) == e).all(-1)[None]
        return torch.where(dt <= 0, dd[ks], torch.where((dt >= den) & eq, dd[ke], general))

    ab, ac = b - a, c - a
    n = _cross(ab, ac)
    n2 = _dot3(n, n)
    safe = torch.where(n2 == 0, 1.0, n2)
    ap = p[:, None] - a[None]
    # the filter: k_e = 2^-17 |n|_inf |e|_inf, d_tri = safe 2^-99 + 2^-100
    l1 = ap.abs()[..., 0] + ap.abs()[..., 1] + ap.abs()[..., 2]
    n_inf = n.abs().amax(-1)
    dtri = _fma(safe, torch.full_like(safe, 2.0 ** -99), torch.full_like(safe, 2.0 ** -100))
    eg = _fma(l1, (n_inf * ab.abs().amax(-1) * 2.0 ** -17)[None], dtri[None])
    eb = _fma(l1, (n_inf * ac.abs().amax(-1) * 2.0 ** -17)[None], dtri[None])
    ug, ub = _fma_dot(ap, _cross(n, ab)[None]), _fma_dot(ap, _cross(ac, n)[None])
    safe_hi = safe * (1 + 2.0 ** -20)
    s_hi = _fma(torch.full_like(dtri, 2.0), dtri, safe_hi)
    near = ((n2 > 0)[None] & (ug >= -eg) & (ub >= -eb)
            & (ug + ub <= eg + eb + s_hi[None]))
    num_g = _dot3(_cross(ab[None].expand_as(ap), ap), n[None])
    num_b = _dot3(_cross(ap, ac[None].expand_as(ap)), n[None])
    thr = inside_threshold(safe)[None]
    cand = near & (num_g >= thr) & (num_b >= thr) & (num_g + num_b <= safe_hi[None])
    gamma, beta = num_g / safe, num_b / safe
    inside = cand & (beta >= 0) & (gamma >= 0) & (beta + gamma <= 1)
    dot_n = _dot3(ap, n[None])
    d_edges = torch.minimum(torch.minimum(seg_d(a, b, "a", "b"), seg_d(a, c, "a", "c")),
                            seg_d(b, c, "b", "c"))
    return torch.where(inside, dot_n * dot_n / safe, d_edges), near, cand


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


def _spread10(v):
    """The low 10 bits of each int64 in v, moved to every third bit."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    return (v | (v << 2)) & 0x09249249


def morton_order(points) -> torch.Tensor:
    """A permutation of points [P,3] along the Morton (z-order) curve of
    their bounding box at 1024 cells a side: neighbours in the order are
    neighbours in space. K9 takes its points in this order, so that a
    warp's points see a triangle from nearly one direction and take the
    same branches; on the device, without a host wait."""
    lo, hi = points.amin(0), points.amax(0)
    q = ((points - lo) / (hi - lo).clamp_min(1e-30) * 1023).to(torch.int64).clamp(0, 1023)
    code = _spread10(q[:, 0]) | (_spread10(q[:, 1]) << 1) | (_spread10(q[:, 2]) << 2)
    return torch.argsort(code)


_K9_ARGS = (kb.PTR,) * 5 + (kb.INT, kb.INT, kb.PTR)
K9_RECORD_FLOATS = 40    # csrc/mesh_distance.cu: one triangle's constants


def point_mesh_distance_sq_kernel(points, verts, faces):
    """Launch K9 on CUDA tensors: same contract as
    :func:`point_mesh_distance_sq_plain`. The points go to the kernel in
    Morton order (each point's distance does not depend on the order) and
    come back in theirs; two device launches: the triangle records (scratch
    of this call, 160 bytes a triangle), then the distances."""
    require_no_grad("point_mesh_distance", points, verts, faces)
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
    order = morton_order(points)
    points = points[order]
    rec = torch.empty((faces.shape[0], K9_RECORD_FLOATS), dtype=torch.float32, device=dev)
    kb.launch("point_mesh_distance", _K9_ARGS, points.data_ptr(), verts.data_ptr(),
              faces.data_ptr(), rec.data_ptr(), out.data_ptr(), points.shape[0], faces.shape[0],
              torch.cuda.current_stream(dev).cuda_stream)
    KERNELS["point_mesh_distance"].launches += 1
    return torch.empty_like(out).index_copy_(0, order, out)


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
