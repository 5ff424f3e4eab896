"""The port's geometry metrics (eval/mesh_metrics.py, eval/measure.py) vs the
JAX package's, on the CPU.

- point_triangle_distance_sq and point_mesh_distance_sq (K9's plain
  version) on random points and triangles, with zero-area and
  zero-length-edge triangles and points exactly on a vertex, an edge and a
  face: rtol 1e-5 on the squared distances d^2, plus 4e-6 * d for the
  cancellation near a surface (d^2 = (ap.n)^2 / |n|^2 and XLA sums ap.n in
  another order: the f32 error of d is about 6 eps |ap| <= 2e-6 at these
  extents), plus 1e-12 for the distances that are zero in exact arithmetic;
- sample_points_on_mesh draws the same points (numpy RandomState);
- chamfer_and_f1, filter_mesh, point_mesh_f1 and geometry_metrics against
  the JAX / numpy originals (geometry_metrics against measure.py:181-215
  written out with the JAX package's functions).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panic3d_tpu.eval import measure as jmeasure
from panic3d_tpu.eval import mesh_metrics as jmm
from panic3d_tpu_torch.eval import measure as tmeasure
from panic3d_tpu_torch.eval import mesh_metrics as tmm
from panic3d_tpu_torch.kernels import launch_counts
from torch_one_thread import torch_one_thread  # noqa: F401  (autouse)


def assert_close_sq(got, want):
    tol = 1e-5 * want + 4e-6 * np.sqrt(want) + 1e-12
    bad = np.abs(got - want) > tol
    assert not bad.any(), (got[bad][:5], want[bad][:5])


def triangles_and_points(seed=0, n_tri=40, n_pts=60):
    r = np.random.RandomState(seed)
    a, b, c = (r.randn(n_tri, 3).astype(np.float32) for _ in range(3))
    b[0] = a[0]                                    # zero-length edge
    c[1] = a[1] + 0.5 * (b[1] - a[1])              # zero area (collinear)
    b[2] = c[2] = a[2]                             # a point triangle
    p = r.randn(n_pts, 3).astype(np.float32)
    p[0] = a[5]                                    # on a vertex
    p[1] = 0.5 * (a[6] + b[6])                     # on an edge
    p[2] = (a[7] + b[7] + c[7]) / 3                # on a face
    p[3] = a[0]                                    # on the zero-length edge
    return p, a, b, c


def test_point_triangle_distance_matches_jax():
    p, a, b, c = triangles_and_points()
    want = np.asarray(jmm.point_triangle_distance_sq(*map(jnp.asarray, (p, a, b, c))))
    got = tmm.point_triangle_distance_sq(*map(torch.from_numpy, (p, a, b, c))).numpy()
    assert_close_sq(got, want)
    assert got[0, 5] < 1e-12 and got[1, 6] < 1e-12 and got[2, 7] < 1e-12
    assert np.isfinite(got).all()


def random_mesh(seed, n_verts=200, n_faces=300):
    r = np.random.RandomState(seed)
    verts = (r.rand(n_verts, 3) * 0.7 - 0.35).astype(np.float32)
    faces = r.randint(0, n_verts, (n_faces, 3)).astype(np.int32)
    faces[0, 1] = faces[0, 0]                      # a degenerate face
    return verts, faces


@pytest.mark.parametrize("n_faces", [300, 5000], ids=["one-chunk", "three-chunks"])
def test_point_mesh_distance_matches_jax(n_faces):
    verts, faces = random_mesh(1, n_faces=n_faces)
    pts = (np.random.RandomState(2).rand(500, 3) * 0.8 - 0.4).astype(np.float32)
    pts[:3] = verts[faces[5]]                      # on the mesh
    want = np.asarray(jmm.point_mesh_distance_sq(jnp.asarray(pts), jnp.asarray(verts),
                                                 jnp.asarray(faces)))
    got = tmm.point_mesh_distance_sq(*map(torch.from_numpy, (pts, verts, faces)))
    assert_close_sq(got.numpy(), want)
    assert sum(launch_counts().values()) == 0


def test_sample_points_on_mesh_identical():
    verts, faces = random_mesh(3)
    np.testing.assert_array_equal(tmm.sample_points_on_mesh(verts, faces, 1000, seed=7),
                                  jmm.sample_points_on_mesh(verts, faces, 1000, seed=7))
    np.testing.assert_array_equal(tmm.sample_points_on_mesh(verts, faces[:1] * 0, 10),
                                  np.zeros((10, 3), np.float32))


def test_chamfer_and_f1_matches_jax():
    pred, gt = random_mesh(4), random_mesh(5)
    pp = jmm.sample_points_on_mesh(*pred, 800, seed=1)
    gp = jmm.sample_points_on_mesh(*gt, 800, seed=2)
    want = jmm.chamfer_and_f1(pp, pred, gp, gt, thresholds=(0.005, 0.01, 0.05))
    got = tmm.chamfer_and_f1(pp, pred, gp, gt, thresholds=(0.005, 0.01, 0.05), device="cpu")
    assert set(got) == set(want)
    np.testing.assert_allclose(got["p2s"], want["p2s"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["s2p"], want["s2p"], rtol=1e-5, atol=1e-6)
    for k in ("cd", "f1@5", "f1@10", "f1@50"):
        assert got[k] == pytest.approx(want[k], rel=1e-5, abs=1e-7), k


ROIS = [((0, 0), (512, 512)), ((96, 140), (300, 260))]


@pytest.mark.parametrize("roi", ROIS, ids=["full-frame", "aligned-box"])
def test_filter_mesh_and_f1_match_jax(roi):
    verts, faces = random_mesh(6, n_faces=2000)
    want = jmeasure.filter_mesh(verts, faces, roi, 0.7)
    got = tmeasure.filter_mesh(verts, faces, roi, 0.7)
    np.testing.assert_array_equal(got["verts"], want["verts"])
    np.testing.assert_array_equal(got["faces"], want["faces"])
    d = np.random.RandomState(0).rand(2, 300) * 0.1
    for th in tmeasure.F1_THRESHOLDS:
        assert tmeasure.point_mesh_f1(d[0], d[1], th) == jmeasure.point_mesh_f1(d[0], d[1], th)
    np.testing.assert_array_equal(tmeasure.CV2WORLD, jmeasure.CV2WORLD)


def jax_geometry_metrics(mc, mesh_gt, roi, bw=0.7, n_sample=10000, seed=0):
    """measure.py:181-215 with the JAX package's functions, as main runs it."""
    verts = mc["verts"] * np.asarray([-1, 1, 1])[None]
    mesh_pred = jmeasure.filter_mesh(verts, mc["faces"], roi, bw)
    points_pred = jmm.sample_points_on_mesh(mesh_pred["verts"], mesh_pred["faces"], n_sample,
                                            seed=seed)
    gt = jmeasure.filter_mesh(mesh_gt["verts"], mesh_gt["faces"], roi, bw)
    inv = np.linalg.inv(jmeasure.CV2WORLD)[:3, :3]
    points_gt = (inv @ jmm.sample_points_on_mesh(gt["verts"], gt["faces"], n_sample,
                                                 seed=seed).T).T.astype(np.float32)
    gt_verts_w = (inv @ gt["verts"].T).T.astype(np.float32)
    p2s = np.sqrt(np.asarray(jmm.point_mesh_distance_sq(
        jnp.asarray(points_pred), jnp.asarray(gt_verts_w), jnp.asarray(gt["faces"]))))
    s2p = np.sqrt(np.asarray(jmm.point_mesh_distance_sq(
        jnp.asarray(points_gt), jnp.asarray(mesh_pred["verts"]),
        jnp.asarray(mesh_pred["faces"]))))
    out = {"p2s": p2s.mean(), "s2p": s2p.mean(), "cd": (p2s.mean() + s2p.mean()) / 2}
    for th in (0.005, 0.01, 0.05, 0.1, 0.5):
        out[f"f1_{int(th * 1000):03d}"] = jmeasure.point_mesh_f1(p2s, s2p, th)["f1"]
    return out


@pytest.mark.parametrize("roi", ROIS, ids=["full-frame", "aligned-box"])
def test_geometry_metrics_matches_measure(roi):
    pred = dict(zip(("verts", "faces"), random_mesh(7, n_faces=1500)))
    gt = dict(zip(("verts", "faces"), random_mesh(8, n_faces=1500)))
    want = jax_geometry_metrics(pred, gt, roi, n_sample=2000, seed=3)
    timings = {}
    got = tmeasure.geometry_metrics(pred, gt, roi, n_sample=2000, seed=3, device="cpu",
                                    timings=timings)
    assert set(got) == set(want) and set(timings) == {"p2s", "s2p"}
    for k in want:
        assert got[k] == pytest.approx(float(want[k]), rel=1e-5, abs=1e-7), k
