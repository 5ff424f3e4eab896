"""The port's PNG codec and GT-mesh loader against the JAX package, on the
CPU, with inputs made from a numpy seed:

- utils/imglib.py's PNG: a round trip of 8-bit grey, RGB and RGBA; rows
  written with each of the five filter types, read back exactly and, where
  Pillow imports, as Pillow decodes them; other PNGs refused;
- eval/gltf.py's GLB, LustrousGLTF, head_bone_location and
  LustrousGLTFDecapitated on a .vrm written here (two primitives, an
  interleaved POSITION accessor read through its byte stride, uint16 and
  uint32 indices, a head bone with a translation): exactly equal;
- winding_numbers_plain against JAX's winding_numbers on two nested
  icospheres (162 + 42 vertices), with the vertices as queries and points
  in the plane of a face but outside it, within 1e-5; remove_innards'
  verts and faces equal, the inner sphere dropped.
"""

import json
import os
import struct
import zlib

import numpy as np
import pytest
import torch

from panic3d_tpu.eval import gltf as jgltf
from panic3d_tpu_torch.eval import gltf as tgltf
from panic3d_tpu_torch.kernels import launch_counts
from panic3d_tpu_torch.utils import imglib


def icosphere(level: int, radius: float = 1.0, center=(0.0, 0.0, 0.0)):
    """Icosphere with outward (counter-clockwise from outside) faces ->
    (verts [V,3] f32, faces [T,3] int64); level 0 has 12 vertices, each
    level multiplies the faces by 4."""
    t = (1 + 5 ** 0.5) / 2
    v = [(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0), (0, -1, t), (0, 1, t), (0, -1, -t),
         (0, 1, -t), (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1)]
    f = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11), (1, 5, 9), (5, 11, 4),
         (11, 10, 2), (10, 7, 6), (7, 1, 8), (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8),
         (3, 8, 9), (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    v = [np.asarray(p, np.float64) / np.linalg.norm(p) for p in v]
    for _ in range(level):
        mids, nf = {}, []

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in mids:
                m = v[a] + v[b]
                v.append(m / np.linalg.norm(m))
                mids[key] = len(v) - 1
            return mids[key]

        for a, b, c in f:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            nf += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        f = nf
    verts = np.asarray(v) * radius + np.asarray(center)
    return verts.astype(np.float32), np.asarray(f, np.int64)


def write_vrm(path, prims, head=(0.0, 0.0, 0.0), interleave=(), index_dtype=None):
    """A binary glTF with one mesh of ``prims`` [(verts, faces)] and a VRM
    head bone at ``head`` (its inverse bind matrix translates by -head).
    The primitives whose index is in ``interleave`` store POSITION
    interleaved with a fourth float (byteStride 16); ``index_dtype[i]``
    (np.uint16 or np.uint32, default uint32) is primitive i's index type."""
    index_dtype = index_dtype or {}
    parts, views, accessors, primitives = [], [], [], []

    def add(data, stride=None):
        off = sum(len(p) for p in parts)
        parts.append(data + b"\0" * ((-len(data)) % 4))
        view = {"buffer": 0, "byteOffset": off, "byteLength": len(data)}
        if stride:
            view["byteStride"] = stride
        views.append(view)
        return len(views) - 1

    for i, (verts, faces) in enumerate(prims):
        verts = np.asarray(verts, np.float32)
        if i in interleave:
            extra = np.full((len(verts), 1), 7.5, np.float32)
            bv = add(np.concatenate([verts, extra], axis=1).tobytes(), stride=16)
        else:
            bv = add(verts.tobytes())
        accessors.append({"bufferView": bv, "componentType": 5126, "count": len(verts),
                          "type": "VEC3"})
        dt = index_dtype.get(i, np.uint32)
        accessors.append({"bufferView": add(np.asarray(faces, dt).tobytes()),
                          "componentType": 5123 if dt == np.uint16 else 5125,
                          "count": int(np.asarray(faces).size), "type": "SCALAR"})
        primitives.append({"attributes": {"POSITION": len(accessors) - 2},
                           "indices": len(accessors) - 1, "mode": 4})
    ibm = np.stack([np.eye(4, dtype=np.float32)] * 2)
    ibm[1, :3, 3] = -np.asarray(head, np.float32)       # the head: node 1
    accessors.append({"bufferView": add(ibm.transpose(0, 2, 1).tobytes()),
                      "componentType": 5126, "count": 2, "type": "MAT4"})
    blob = b"".join(parts)
    gltf = {
        "asset": {"version": "2.0"},
        "buffers": [{"byteLength": len(blob)}],
        "bufferViews": views,
        "accessors": accessors,
        "meshes": [{"primitives": primitives}],
        "nodes": [{"name": "hips"}, {"name": "head"}],
        "skins": [{"joints": [0, 1], "inverseBindMatrices": len(accessors) - 1}],
        "extensions": {"VRM": {"humanoid": {"humanBones": [
            {"bone": "hips", "node": 0}, {"bone": "head", "node": 1}]}}},
    }
    js = json.dumps(gltf).encode()
    js += b" " * ((-len(js)) % 4)
    total = 12 + 8 + len(js) + 8 + len(blob)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, total))
        f.write(struct.pack("<II", len(js), 0x4E4F534A) + js)
        f.write(struct.pack("<II", len(blob), 0x004E4942) + blob)


def two_shells(level_outer=2, level_inner=1, head=(0.0, 0.1, 0.0)):
    """An outer and an inner icosphere about the decapitation centre
    (head bone + (0, 0.1, 0)): the inner one's vertices wind to ~1.3-1.5."""
    c = (head[0], head[1] + 0.1, head[2])
    return icosphere(level_outer, 0.15, c), icosphere(level_inner, 0.09, c)


# ---------------------------------------------------------------------------
# PNG


def _filter_rows(pix, bpp):
    """PNG rows of pix [h, stride] uint8, row y filtered with type y % 5."""
    h, stride = pix.shape
    p = pix.astype(np.int64)
    out = []
    for y in range(h):
        ft = y % 5
        row, up = p[y], (p[y - 1] if y else np.zeros(stride, np.int64))
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        if ft == 0:
            f = row
        elif ft == 1:
            f = row - left
        elif ft == 2:
            f = row - up
        elif ft == 3:
            f = row - (left + up) // 2
        else:
            pa, pb, pc = (np.abs(up - ul), np.abs(left - ul), np.abs(left + up - 2 * ul))
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
            f = row - pred
        out.append(bytes([ft]) + (f & 0xFF).astype(np.uint8).tobytes())
    return b"".join(out)


def _write_filtered_png(path, hwc):
    h, w, c = hwc.shape
    raw = _filter_rows(hwc.reshape(h, w * c), c)
    header = struct.pack(">IIBBBBB", w, h, 8, {1: 0, 3: 2, 4: 6}[c], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(imglib.PNG_SIGNATURE + imglib._chunk(b"IHDR", header)
                + imglib._chunk(b"IDAT", zlib.compress(raw)) + imglib._chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_round_trip(tmp_path, channels):
    rng = np.random.RandomState(channels)
    data = rng.randint(0, 256, (channels, 13, 17)).astype(np.uint8)
    path = str(tmp_path / "a.png")
    imglib.Img(data).save(path)
    got = imglib.read_png(path)
    want = data[0] if channels == 1 else data.transpose(1, 2, 0)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(imglib.Img(path).numpy_uint8(), data)
    try:
        from PIL import Image
    except ImportError:
        return
    np.testing.assert_array_equal(np.asarray(Image.open(path)), want)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_filters_match_pillow(tmp_path, channels):
    rng = np.random.RandomState(10 + channels)
    # smooth rows and noise, so the predictors see both
    base = np.cumsum(rng.randint(0, 9, (11, 19, channels)), axis=1)
    hwc = ((base + rng.randint(0, 256, (11, 19, channels)) * (rng.rand(11, 19, 1) < 0.3))
           % 256).astype(np.uint8)
    path = str(tmp_path / "f.png")
    _write_filtered_png(path, hwc)
    got = imglib.read_png(path)
    np.testing.assert_array_equal(got, hwc[..., 0] if channels == 1 else hwc)
    try:
        from PIL import Image
    except ImportError:
        return
    np.testing.assert_array_equal(np.asarray(Image.open(path)), got)


def test_png_refuses_other_formats(tmp_path):
    path = str(tmp_path / "x.png")
    with open(path, "wb") as f:   # 16-bit RGB
        f.write(imglib.PNG_SIGNATURE
                + imglib._chunk(b"IHDR", struct.pack(">IIBBBBB", 2, 2, 16, 2, 0, 0, 0))
                + imglib._chunk(b"IDAT", zlib.compress(bytes(2 * 13)))
                + imglib._chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="only 8-bit"):
        imglib.read_png(path)


# ---------------------------------------------------------------------------
# glTF


@pytest.fixture(scope="module")
def vrm(tmp_path_factory):
    rng = np.random.RandomState(3)
    head = (0.02, 1.31, -0.04)
    (vo, fo), (vi, fi) = two_shells(2, 1, head)
    # a third primitive of random triangles, some outside the head box
    vr_ = (rng.rand(40, 3) - 0.5).astype(np.float32) * 0.8 + np.asarray(head, np.float32)
    fr = rng.randint(0, 40, (25, 3))
    path = str(tmp_path_factory.mktemp("vrm") / "h.vrm")
    write_vrm(path, [(vo, fo), (vi, fi), (vr_, fr)], head=head, interleave=(0, 2),
              index_dtype={1: np.uint16})
    return path


def test_glb_accessors_equal(vrm):
    jg, tg = jgltf.GLB(vrm), tgltf.GLB(vrm)
    assert jg.json == tg.json
    strided = 0
    for i, acc in enumerate(jg.json["accessors"]):
        a, b = jg.accessor(i), tg.accessor(i)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
        strided += "byteStride" in jg.json["bufferViews"][acc["bufferView"]]
    assert strided == 2


def test_lustrous_gltf_and_decapitation_equal(vrm):
    j, t = jgltf.LustrousGLTF(vrm), tgltf.LustrousGLTF(vrm)
    np.testing.assert_array_equal(t.verts, j.verts)
    np.testing.assert_array_equal(t.faces, j.faces)
    assert t.faces.dtype == j.faces.dtype == np.int64
    np.testing.assert_array_equal(t.head_bone_location(), j.head_bone_location())
    np.testing.assert_allclose(t.head_bone_location(), [0.02, 1.31, -0.04], atol=1e-6)
    jd, td = jgltf.LustrousGLTFDecapitated(j), tgltf.LustrousGLTFDecapitated(t)
    np.testing.assert_array_equal(td.verts, jd.verts)
    np.testing.assert_array_equal(td.faces, jd.faces)
    assert 0 < len(td.faces) < len(t.faces)


def test_remove_innards_equal(vrm):
    j = jgltf.LustrousGLTF(vrm).remove_innards()
    t = tgltf.LustrousGLTF(vrm).remove_innards(device="cpu")
    np.testing.assert_array_equal(t.verts, j.verts)
    np.testing.assert_array_equal(t.faces, j.faces)
    assert sum(launch_counts().values()) == 0


def test_winding_numbers_plain_matches_jax():
    (vo, fo), (vi, fi) = two_shells(2, 1, (0.0, 0.0, 0.0))
    assert (len(vo), len(vi)) == (162, 42)
    verts = np.concatenate([vo, vi])
    faces = np.concatenate([fo, fi + len(vo)])
    # points in the plane of a face, outside it: a + s (b - a) + t (c - a)
    rng = np.random.RandomState(5)
    tri = verts[faces[rng.randint(0, len(faces), 64)]]
    s, t = rng.rand(64, 1) + 1.0, rng.rand(64, 1) - 0.5
    plane = (tri[:, 0] + s * (tri[:, 1] - tri[:, 0]) + t * (tri[:, 2] - tri[:, 0]))
    centre = np.asarray([[0.0, 0.1, 0.0]], np.float32)
    queries = np.concatenate([verts, plane.astype(np.float32), centre])
    want = jgltf.winding_numbers(verts, faces, queries)
    got = tgltf.winding_numbers(torch.from_numpy(verts), torch.from_numpy(faces),
                                torch.from_numpy(queries)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[-1], 2.0, atol=1e-5)              # inside both shells
    assert (got[:162] < 1.3).all() and (got[162:204] > 1.3).all()   # outer kept, inner dropped
    v, f = tgltf.remove_innards(verts, faces, device="cpu")
    jv, jf = jgltf.remove_innards(verts, faces)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_array_equal(v, vo)
    np.testing.assert_array_equal(f, fo)
