"""K13's order of summation (csrc/winding_number.cu), proved on the CPU.

The kernel sums each query's terms in f32 a tile of 32 triangles at a time,
folds each tile's partial into its split's running sum with Kahan's
compensation, and adds the splits in order, compensated again.
``eval/gltf.py:winding_numbers_tiled`` does the same in PyTorch. Here it
and ``winding_numbers_plain`` are held against the JAX package's
``winding_numbers`` and against the f64 plain version, on two closed
icosphere shells and flat open "hair card" quads that cross them, with
every vertex a query, points in the plane of a shell face or of a card but
outside it, and the centre:

- the error against f64 at most 2x the plain f32 version's (the bound
  chip_smoke.py holds the kernel to);
- no atan2 branch flip (|w - w'| >= 0.25) against the plain version, JAX
  or f64;
- the keep/drop decisions at 1.3 the plain version's and JAX's wherever
  |w_f64 - 1.3| >= 1e-3;
- on single triangles seen from their own vertices, zeros of the plain
  version's sign (JAX's einsum gives some of them as -0.0: the same value).

The JAX function is jitted once per chunk of queries.
"""

import numpy as np
import pytest
import torch

from panic3d_tpu.eval import gltf as jgltf
from panic3d_tpu_torch.eval import gltf as tgltf
from test_torch_gltf import two_shells

FLIP = 0.25   # a winding number off by >= this took another atan2 branch


def hair_cards(rng, n=6, cells=(3, 2)):
    """Flat quads of cells[0] x cells[1] squares (two triangles each) through
    the head, at random orientations -> (verts, faces, in-plane points
    outside each card)."""
    verts, faces, outside = [], [], []
    for _ in range(n):
        u, v = np.linalg.qr(rng.randn(3, 2))[0].T
        corner = np.asarray([0.0, 0.2, 0.0]) + 0.12 * rng.randn(3)
        du, dv = 0.3 / cells[0], 0.2 / cells[1]
        base = sum(len(x) for x in verts)
        grid = [corner + i * du * u + j * dv * v
                for j in range(cells[1] + 1) for i in range(cells[0] + 1)]
        verts.append(np.asarray(grid))
        for j in range(cells[1]):
            for i in range(cells[0]):
                a = base + j * (cells[0] + 1) + i
                b, c, d = a + 1, a + cells[0] + 1, a + cells[0] + 2
                faces += [(a, b, d), (a, d, c)]
        s = rng.uniform(1.2, 2.0, (8, 1)) * np.where(rng.rand(8, 1) < 0.5, 1, -0.6)
        t = rng.uniform(-0.5, 1.5, (8, 1))
        outside.append(corner + s * 0.3 * u + t * 0.2 * v)
    return (np.concatenate(verts).astype(np.float32), np.asarray(faces, np.int64),
            np.concatenate(outside).astype(np.float32))


def scene():
    """Two shells (642 + 162 vertices) and 6 cards -> (verts, faces,
    queries)."""
    rng = np.random.RandomState(8)
    (vo, fo), (vi, fi) = two_shells(3, 2, (0.0, 0.0, 0.0))
    vc, fc, card_plane = hair_cards(rng)
    verts = np.concatenate([vo, vi, vc])
    faces = np.concatenate([fo, fi + len(vo), fc + len(vo) + len(vi)])
    # points in the plane of a shell face, outside it: a + s (b - a) + t (c - a)
    tri = verts[fo[rng.randint(0, len(fo), 64)]]
    s, t = rng.rand(64, 1) + 1.0, rng.rand(64, 1) - 0.5
    shell_plane = tri[:, 0] + s * (tri[:, 1] - tri[:, 0]) + t * (tri[:, 2] - tri[:, 0])
    centre = np.asarray([[0.0, 0.1, 0.0]])
    queries = np.concatenate([verts, shell_plane, card_plane, centre]).astype(np.float32)
    return verts, faces, queries


@pytest.fixture(scope="module")
def winding():
    verts, faces, queries = scene()
    v, f, q = (torch.from_numpy(a) for a in (verts, faces, queries))
    return {
        "verts": v, "faces": f, "queries": q,
        "f64": tgltf.winding_numbers_plain(v, f, q, dtype=torch.float64).numpy(),
        "plain": tgltf.winding_numbers_plain(v, f, q).numpy(),
        "jax": jgltf.winding_numbers(verts, faces, queries),
    }


@pytest.mark.parametrize("tile,splits", [(32, 1), (32, 3), (8, 7)])
def test_tiled_order_against_f64_plain_and_jax(winding, tile, splits):
    w = winding
    got = tgltf.winding_numbers_tiled(w["verts"], w["faces"], w["queries"], tile=tile,
                                      splits=splits)
    assert got.dtype == torch.float32 and got.shape == w["plain"].shape
    got = got.numpy()
    f64, plain, jx = w["f64"], w["plain"], w["jax"]
    for other in (plain, jx, f64):
        assert int((np.abs(got - other) >= FLIP).sum()) == 0
    err = np.abs(got - f64).max()
    err_plain = np.abs(plain - f64).max()
    assert err <= 2 * err_plain, (err, err_plain)
    outside_band = np.abs(f64 - 1.3) >= 1e-3
    for other in (plain, jx):
        assert ((got < 1.3) == (other < 1.3))[outside_band].all()
    # both decisions occur (the cards shift the shells' numbers off 0.5 and 1.5)
    kept = got[outside_band] < 1.3
    assert kept.any() and not kept.all()


def test_tiled_order_signed_zeros_on_own_vertices():
    rng = np.random.RandomState(3)
    f = torch.tensor([[0, 1, 2]])
    for _ in range(32):
        v = rng.randn(3, 3).astype(np.float32)
        vt = torch.from_numpy(v)
        got = tgltf.winding_numbers_tiled(vt, f, vt)
        want = tgltf.winding_numbers_plain(vt, f, vt)
        assert torch.equal(got, want) and (got == 0).all()
        assert torch.equal(torch.signbit(got), torch.signbit(want))
        np.testing.assert_array_equal(got.numpy(), jgltf.winding_numbers(v, f.numpy(), v))
