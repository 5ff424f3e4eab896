"""Host-side C++ ops, built with g++ at first use and loaded with ctypes
(panic3d_tpu/runtime/native_ops.py).

The source is the repository's ``native/mesh_extract.cpp`` (marching
tetrahedra), built where it is into ``build/native/<name>-<hash>.so``, keyed
by the source's content, so a fresh checkout builds it the first time a mesh
is extracted.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from functools import lru_cache
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
NATIVE_DIR = ROOT / "native"
BUILD_DIR = ROOT / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def build(name: str) -> Path:
    """Compile native/<name>.cpp into a cached shared library."""
    src = NATIVE_DIR / f"{name}.cpp"
    key = hashlib.sha256(src.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"{name}-{key}.so"
    if not so.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.tmp{os.getpid()}")
        proc = subprocess.run(["g++", *GXX_FLAGS, str(src), "-o", str(tmp)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {src.name}:\n{proc.stderr}")
        os.replace(tmp, so)
    return so


@lru_cache(maxsize=1)
def _mesh_lib():
    lib = ctypes.CDLL(str(build("mesh_extract")))
    lib.marching_tetrahedra.restype = ctypes.c_int
    lib.marching_tetrahedra.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.mt_free.argtypes = [ctypes.c_void_p]
    return lib


def marching_tetrahedra(grid: np.ndarray, level: float):
    """Iso-surface of a [nx,ny,nz] float32 grid at ``level`` ->
    (verts [V,3] float32 in index units, faces [T,3] int32)."""
    grid = np.ascontiguousarray(grid, dtype=np.float32)
    if grid.ndim != 3:
        raise ValueError(f"marching_tetrahedra takes a 3-D grid, got {grid.shape}")
    lib = _mesh_lib()
    pv = ctypes.POINTER(ctypes.c_float)()
    pt = ctypes.POINTER(ctypes.c_int32)()
    nv = ctypes.c_int64()
    nt = ctypes.c_int64()
    ret = lib.marching_tetrahedra(
        grid.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        grid.shape[0], grid.shape[1], grid.shape[2], ctypes.c_float(level),
        ctypes.byref(pv), ctypes.byref(nv), ctypes.byref(pt), ctypes.byref(nt))
    if ret != 0:
        raise RuntimeError("marching_tetrahedra failed")
    try:
        verts = (np.ctypeslib.as_array(pv, shape=(nv.value, 3)).copy() if nv.value
                 else np.zeros((0, 3), np.float32))
        faces = (np.ctypeslib.as_array(pt, shape=(nt.value, 3)).copy() if nt.value
                 else np.zeros((0, 3), np.int32))
    finally:
        lib.mt_free(pv)
        lib.mt_free(pt)
    return verts, faces
