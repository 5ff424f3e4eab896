"""K9's branch structure (csrc/mesh_distance.cu), proved on the CPU.

K9 takes each edge's clamp from ``dot`` against ``len2`` and divides only
in between, reading a clamped edge's distance from the vertex distances;
it runs the inside test only for the pairs that a fused multiply-add
filter of the barycentric numerators puts near the triangle's prism, and
divides only for the candidates that the exact numerators' signs and sum
leave.
``eval/mesh_metrics.py:point_triangle_distance_sq_branches`` makes the same
decisions in PyTorch. Here it must equal the plain
``point_triangle_distance_sq`` bit for bit, and the JAX function within
tests/test_torch_mesh_metrics.py's tolerance, on random pairs, degenerate
triangles (n2 == 0, len2 == 0), points on edges and vertices, points in a
triangle's prism, beta + gamma exactly 1 and numerators whose quotient
underflows to -0.0. The JAX function is jitted once per case.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panic3d_tpu.eval import mesh_metrics as jmm
from panic3d_tpu_torch.eval import mesh_metrics as tmm

_jax_d = jax.jit(jmm.point_triangle_distance_sq)


def assert_close_sq(got, want):
    tol = 1e-5 * want + 4e-6 * np.sqrt(want) + 1e-12
    bad = np.abs(got - want) > tol
    assert not bad.any(), (got[bad][:5], want[bad][:5])


def case_random(r):
    a, b, c = (r.randn(64, 3).astype(np.float32) for _ in range(3))
    return r.randn(96, 3).astype(np.float32), a, b, c


def case_degenerate(r):
    a, b, c = (r.randn(16, 3).astype(np.float32) for _ in range(3))
    b[0] = a[0]                                    # len2 == 0 on ab
    c[1] = b[1]                                    # len2 == 0 on bc
    c[2] = a[2] + 0.5 * (b[2] - a[2])              # collinear: n2 == 0
    b[3] = c[3] = a[3]                             # a point triangle
    b[4] = a[4] + np.float32(1e-30)                # len2 underflows to 0, the edge is not 0
    c[4] = a[4] + np.float32(2e-30)
    p = r.randn(24, 3).astype(np.float32)
    p[:5] = a[:5]
    p[5:8] = 0.5 * (a[2] + c[2]), b[0], c[1]
    return p, a, b, c


def case_on_edges_and_vertices(r):
    a, b, c = (r.randn(12, 3).astype(np.float32) for _ in range(3))
    u = r.rand(12, 1).astype(np.float32)
    p = np.concatenate([a, b, c, a + u * (b - a), a + u * (c - a), b + u * (c - b),
                        0.5 * (a + b), 0.5 * (b + c)]).astype(np.float32)
    return p, a, b, c


def case_in_prism(r):
    a, b, c = (r.randn(12, 3).astype(np.float32) for _ in range(3))
    n = np.cross(b - a, c - a)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    u, v = r.rand(2, 12, 1).astype(np.float32) * 0.5
    h = r.randn(12, 1).astype(np.float32) * 0.3
    p = (a + u * (b - a) + v * (c - a) + h * n).astype(np.float32)
    return np.concatenate([p, a + u * (b - a) + v * (c - a)]).astype(np.float32), a, b, c


def case_sum_one(r):
    # right triangles with power-of-two legs: beta + gamma is exactly 1 on
    # the hypotenuse, just above and below it near it
    s = np.float32(2.0) ** r.randint(-4, 5, (8, 1)).astype(np.float32)
    o = r.randn(8, 3).astype(np.float32)
    a = o
    b = o + s * np.array([1, 0, 0], np.float32)
    c = o + s * np.array([0, 1, 0], np.float32)
    h = np.array([[0.0], [0.25], [-0.5], [1.0], [0.0], [2.0], [-1.0], [0.125]], np.float32)
    fr = np.array([0.25, 0.5, 0.75, 0.125, 0.5, 0.25, 0.625, 0.875], np.float32)[:, None]
    on = o + s * np.concatenate([fr, 1 - fr, h], 1)
    eps = np.float32(2.0 ** -20)
    p = np.concatenate([on, on + s * eps, on - s * eps]).astype(np.float32)
    return p, a, b, c


def case_underflow(r):
    # n2 = 2^80: numerators of magnitude 2^-80 give quotients of 2^-160,
    # which round to (-)0.0; beta >= 0 then holds for a negative numerator
    L = np.float32(2.0 ** 20)
    a = np.zeros((3, 3), np.float32)
    b = np.array([[L, 0, 0]] * 3, np.float32)
    c = np.array([[0, L, 0]] * 3, np.float32)
    tiny = np.float32(2.0 ** -140)
    p = np.array([[-tiny, 1.0, 0.5], [1.0, -tiny, -0.5], [-tiny, -tiny, 0.0],
                  [-1.0, 1.0, 0.0], [tiny, tiny, 3.0]], np.float32)
    return p, a, b, c


CASES = {"random": case_random, "degenerate": case_degenerate,
         "edges-vertices": case_on_edges_and_vertices, "prism": case_in_prism,
         "beta-gamma-one": case_sum_one, "underflow": case_underflow}


def plain_inside(p, a, b, c):
    """The plain version's inside test, written out with its own quotients."""
    ab, ac = b - a, c - a
    n = tmm._cross(ab, ac)
    n2 = tmm._dot3(n, n)
    safe = torch.where(n2 == 0, 1.0, n2)
    ap = p[:, None] - a[None]
    gamma = tmm._dot3(tmm._cross(ab[None].expand_as(ap), ap), n[None]) / safe
    beta = tmm._dot3(tmm._cross(ap, ac[None].expand_as(ap)), n[None]) / safe
    return (beta >= 0) & (gamma >= 0) & (beta + gamma <= 1) & (n2 > 0)[None]


@pytest.mark.parametrize("name", list(CASES))
def test_branches_bit_identical(name):
    p, a, b, c = CASES[name](np.random.RandomState(sorted(CASES).index(name)))
    pt, at, bt, ct = map(torch.from_numpy, (p, a, b, c))
    want = tmm.point_triangle_distance_sq(pt, at, bt, ct)
    got, near, cand = tmm.point_triangle_distance_sq_branches(pt, at, bt, ct)
    assert torch.equal(got, want)
    # inside (plain) <= candidates <= near: the filters drop no inside pair
    assert not (plain_inside(pt, at, bt, ct) & ~cand).any()
    assert not (cand & ~near).any()
    if name == "random":                     # the filter leaves most pairs out
        assert float(near.float().mean()) < 0.5
    assert_close_sq(got.numpy(), np.asarray(_jax_d(*map(jnp.asarray, (p, a, b, c)))))


def test_branch_counts():
    """The prism points pass both filters of their own triangle; in the
    underflow case a negative numerator gives the quotient -0.0, the plain
    test calls the pair inside, and both filters pass it."""
    p, a, b, c = case_in_prism(np.random.RandomState(0))
    _, near, cand = tmm.point_triangle_distance_sq_branches(
        *map(torch.from_numpy, (p, a, b, c)))
    assert bool(cand[np.arange(12), np.arange(12)].all())
    pt, at, bt, ct = map(torch.from_numpy, case_underflow(np.random.RandomState(0)))
    ap = pt[:, None] - at[None]
    n = tmm._cross(bt - at, ct - at)
    num_b = tmm._dot3(tmm._cross(ap, (ct - at)[None].expand_as(ap)), n[None])
    underflow = (num_b < 0) & (num_b / tmm._dot3(n, n)[None] == 0)
    assert bool(underflow.any())
    _, near, cand = tmm.point_triangle_distance_sq_branches(pt, at, bt, ct)
    assert bool(cand[underflow].all() and near[underflow].all())
    assert bool(plain_inside(pt, at, bt, ct)[underflow].any())


def test_morton_order_is_a_local_permutation():
    """K9's point order: a permutation whose neighbours are near in space."""
    pts = torch.from_numpy(np.random.RandomState(0).rand(4000, 3).astype(np.float32))
    order = tmm.morton_order(pts)
    assert torch.equal(order.sort().values, torch.arange(4000))
    step = (pts[order][1:] - pts[order][:-1]).norm(dim=1).mean()
    assert step < 0.25 * (pts[1:] - pts[:-1]).norm(dim=1).mean()
