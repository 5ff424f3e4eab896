"""Binary glTF (.glb / .vrm) mesh loading, head decapitation and innard
removal (panic3d_tpu/eval/gltf.py).

The container, the accessors, the concatenated triangle soup, the VRM head
bone and the head-box crop are numpy code, as in the JAX package. The
winding numbers that ``remove_innards`` thresholds are CUDA kernel K13
(csrc/winding_number.cu) on the card; ``winding_numbers_plain`` is the same
sum in PyTorch, chunked over the queries as the JAX package's: the CPU path
and the kernel's oracle (in f64 too, for chip_smoke.py). The distances of
``get_point_distance`` go through K9 (eval/mesh_metrics.py).
"""

from __future__ import annotations

import json
import math
import struct
from typing import Optional

import numpy as np
import torch

from ..kernels import KERNELS, require_no_grad
from ..kernels import build as kb

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16, 5123: np.uint16,
    5125: np.uint32, 5126: np.float32,
}
_TYPE_NCOMP = {
    "SCALAR": (1,), "VEC2": (2,), "VEC3": (3,), "VEC4": (4,),
    "MAT2": (2, 2), "MAT3": (3, 3), "MAT4": (4, 4),
}


class GLB:
    """Minimal binary-glTF container (pygltflib role)."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            data = f.read()
        magic, version, length = struct.unpack_from("<III", data, 0)
        assert magic == 0x46546C67, "not a glb/vrm file"
        off = 12
        self.json: dict = {}
        self.bin = b""
        while off < length:
            clen, ctype = struct.unpack_from("<II", data, off)
            off += 8
            chunk = data[off : off + clen]
            off += clen
            if ctype == 0x4E4F534A:
                self.json = json.loads(chunk.decode("utf-8"))
            elif ctype == 0x004E4942:
                self.bin = chunk

    def accessor(self, idx: int) -> np.ndarray:
        """The accessor's elements as an array [count, *ncomp]. Interleaved
        (strided) data is read as one strided view of the buffer's bytes,
        copied."""
        acc = self.json["accessors"][idx]
        bv = self.json["bufferViews"][acc["bufferView"]]
        ncomp = _TYPE_NCOMP[acc["type"]]
        dtype = np.dtype(_COMPONENT_DTYPES[acc["componentType"]])
        count = acc["count"]
        n = int(np.prod(ncomp))
        base = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
        stride = bv.get("byteStride")
        elem_size = n * dtype.itemsize
        if stride and stride != elem_size:
            raw = np.frombuffer(self.bin, dtype=np.uint8)
            if count and base + (count - 1) * stride + elem_size > raw.size:
                raise ValueError(f"accessor {idx} reads past the end of the buffer")
            rows = np.lib.stride_tricks.as_strided(
                raw[base:], shape=(count, elem_size), strides=(stride, 1), writeable=False)
            return np.ascontiguousarray(rows).view(dtype).reshape(count, *ncomp)
        return np.frombuffer(
            self.bin, dtype=dtype, count=count * n, offset=base
        ).reshape(count, *ncomp)


def winding_numbers_plain(verts, faces, queries, chunk: int = 1024,
                          dtype=torch.float32) -> torch.Tensor:
    """The exact generalised winding number of each query [Q,3] with
    respect to the mesh (verts [V,3], faces [T,3]) -> [Q]: the sum over the
    triangles of 2 atan2(num, den) / 4 pi (van Oosterom-Strackee), ``chunk``
    queries at a time, term by term as gltf.py:77 computes it, in ``dtype``
    (f32 as the JAX package; f64 for a reference)."""
    tris = verts.to(dtype)[faces.long()]
    A, B, C = tris[:, 0], tris[:, 1], tris[:, 2]
    queries = queries.to(dtype)
    out = []
    for i in range(0, queries.shape[0], chunk):
        q = queries[i:i + chunk, None]
        a, b, c = A[None] - q, B[None] - q, C[None] - q
        la = torch.sqrt((a * a).sum(-1))
        lb = torch.sqrt((b * b).sum(-1))
        lc = torch.sqrt((c * c).sum(-1))
        num = (a * torch.linalg.cross(b, c, dim=-1)).sum(-1)
        den = la * lb * lc + (a * b).sum(-1) * lc + (b * c).sum(-1) * la + (c * a).sum(-1) * lb
        out.append((2 * torch.atan2(num, den)).sum(1))
    if not out:
        return torch.zeros(0, dtype=dtype, device=queries.device)
    return torch.cat(out) / (4 * math.pi)


_K13_ARGS = (kb.PTR,) * 5 + (kb.INT, kb.INT, kb.INT, kb.PTR)


def winding_numbers_kernel(verts, faces, queries) -> torch.Tensor:
    """Launch K13 on CUDA tensors: same contract as
    :func:`winding_numbers_plain` in f32. Two device launches: the
    triangles' corners gathered into scratch of this call, then the sums.
    The faces go to the kernel as int32 (V must be below 2^31)."""
    require_no_grad("winding_number", verts, faces, queries)
    dev = queries.device
    if not (verts.ndim == faces.ndim == queries.ndim == 2
            and verts.shape[1] == faces.shape[1] == queries.shape[1] == 3):
        raise ValueError("K13 takes verts [V,3], faces [T,3] and queries [Q,3]")
    if verts.device != dev or faces.device != dev:
        raise ValueError("K13 inputs must share a device")
    V, T, Q = verts.shape[0], faces.shape[0], queries.shape[0]
    if max(V, T, Q) >= 2**31:
        raise ValueError("K13 takes at most 2^31 - 1 vertices, faces and queries")
    out = torch.zeros((Q,), dtype=torch.float32, device=dev)
    if Q == 0 or T == 0:
        return out
    verts = verts.to(torch.float32).contiguous()
    faces = faces.to(torch.int32).contiguous()
    queries = queries.to(torch.float32).contiguous()
    tris = torch.empty(((9 * T + 3) // 4 * 4,), dtype=torch.float32, device=dev)
    kb.launch("winding_number", _K13_ARGS, verts.data_ptr(), faces.data_ptr(),
              queries.data_ptr(), tris.data_ptr(), out.data_ptr(), V, T, Q,
              torch.cuda.current_stream(dev).cuda_stream)
    KERNELS["winding_number"].launches += 1
    return out


def winding_numbers(verts, faces, queries) -> torch.Tensor:
    """Winding numbers [Q] of the queries with respect to the mesh: the
    plain version on CPU tensors, K13 on CUDA tensors."""
    if queries.device.type == "cpu":
        return winding_numbers_plain(verts, faces, queries)
    if queries.device.type == "cuda":
        return winding_numbers_kernel(verts, faces, queries)
    raise RuntimeError(f"winding_numbers: no path for device {queries.device}")


def remove_innards(verts, faces, n: int = 1, thresh: float = 1.3, device="cuda"):
    """Strip interior geometry (lustrous_gltf_v0_measurable.py:118-140):
    keep the vertices whose winding number (every vertex a query, on
    ``device``) is below ``thresh``, and reindex the faces; numpy in and
    out."""
    dev = torch.device(device)
    for _ in range(n):
        v_t = torch.from_numpy(np.ascontiguousarray(verts, np.float32)).to(dev)
        f_t = torch.from_numpy(np.ascontiguousarray(faces, np.int64)).to(dev)
        with torch.no_grad():
            wind = winding_numbers(v_t, f_t, v_t).cpu().numpy()
        wv = wind < thresh
        wf = wv[faces].all(axis=1)
        faces = (np.cumsum(wv) - 1)[faces[wf]]
        verts = verts[wv]
    return verts, faces


class LustrousGLTF:
    """Concatenated triangle soup of all mesh primitives."""

    def __init__(self, path: str):
        self.glb = GLB(path)
        g = self.glb.json
        _verts, _faces = [], []
        vc = 0
        for mesh in g.get("meshes", []):
            for prim in mesh["primitives"]:
                assert prim.get("mode", 4) == 4, "triangles only"
                verts = self.glb.accessor(prim["attributes"]["POSITION"])
                faces = self.glb.accessor(prim["indices"]).reshape(-1, 3).astype(np.int64) + vc
                _verts.append(np.asarray(verts, dtype=np.float32))
                _faces.append(faces)
                vc += len(verts)
        self.verts = np.concatenate(_verts) if _verts else np.zeros((0, 3), np.float32)
        self.faces = np.concatenate(_faces) if _faces else np.zeros((0, 3), np.int64)

    def remove_innards(self, n: int = 1, thresh: float = 1.3, device="cuda"):
        self.verts, self.faces = remove_innards(self.verts, self.faces, n, thresh, device)
        return self

    def head_bone_location(self) -> np.ndarray:
        """VRM head bone world location via inverse bind matrices
        (lustrous_gltf_v0_measurable.py:142-180)."""
        g = self.glb.json
        hbones = g["extensions"]["VRM"]["humanoid"]["humanBones"]
        head_node = None
        for hb in hbones:
            if hb["bone"] == "head":
                head_node = hb["node"]
        assert head_node is not None
        skin = g["skins"][0]
        ibms = np.transpose(
            self.glb.accessor(skin["inverseBindMatrices"]), (0, 2, 1)
        )
        ibm_head = ibms[skin["joints"].index(head_node)]
        return -ibm_head[:3, -1]


class LustrousGLTFDecapitated:
    """Crop to head box (lustrous_gltf_v0_measurable.py:269-300)."""

    def __init__(self, gltf: LustrousGLTF, offset_head=(0, 0.1, 0), boxwarp=0.5):
        self.boxwarp = boxwarp
        loc = gltf.head_bone_location() + np.asarray(offset_head)
        verts = gltf.verts - loc[None]
        vkeep = (np.abs(verts) <= boxwarp / 2).all(axis=1)
        fkeep = vkeep[gltf.faces].all(axis=1)
        self.verts = verts.astype(np.float32)
        self.faces = gltf.faces[fkeep].astype(np.int64)

    def sample_points_near_surface(self, n: int, sigma: float, seed: Optional[int] = None,
                                   clip=True):
        from .mesh_metrics import sample_points_on_mesh

        pts = sample_points_on_mesh(self.verts, self.faces, n,
                                    seed=0 if seed is None else seed)
        rng = np.random.RandomState(seed)
        pts = pts + sigma * rng.randn(*pts.shape).astype(np.float32)
        if clip:
            h = self.boxwarp / 2
            pts = np.clip(pts, -h, h)
        return pts

    def get_point_distance(self, queries, device="cuda") -> np.ndarray:
        """Distance [Q,1] from each query to the head's surface (K9 on
        ``device``)."""
        from .mesh_metrics import point_mesh_distance_sq

        dev = torch.device(device)
        with torch.no_grad():
            d2 = point_mesh_distance_sq(
                torch.from_numpy(np.ascontiguousarray(queries, np.float32)).to(dev),
                torch.from_numpy(self.verts).to(dev),
                torch.from_numpy(self.faces).to(dev))
        return np.sqrt(d2.cpu().numpy())[..., None]
