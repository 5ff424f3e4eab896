"""Build the CUDA kernels with nvcc and load them with ctypes.

The pattern of ``panic3d_tpu/runtime/native_ops.py`` (hash-keyed build
cache, ctypes loading), pointed at nvcc: each ``csrc/<stem>.cu`` becomes
``build/kernels/<stem>-<hash>.so`` at first use (a source may hold more
than one entry point), so a fresh checkout builds
everything the first time a kernel is called. The sources expose a plain C
interface (no PyTorch headers), which keeps a build to seconds. Each C entry
point launches on the stream it is given and returns ``cudaGetLastError()``;
:func:`launch` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from . import CHECK_ENTRIES, KERNELS, sources

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.isfile(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build only where the CUDA "
            "toolkit is installed (set CUDA_HOME or put nvcc on PATH)")
    return path


def build(stem: str) -> Path:
    """Compile csrc/<stem>.cu (plus the shared headers) into a cached .so.
    The compiler's resource report (-Xptxas -v) is kept beside it as .log."""
    src = CSRC / f"{stem}.cu"
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in (src, *sorted(CSRC.glob("*.cuh"))):
        h.update(p.read_bytes())
    so = BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"
    if so.is_file():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.tmp{os.getpid()}")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, f"-I{CSRC}", str(src), "-o", str(tmp)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src.name}:\n{proc.stderr}")
    so.with_suffix(".log").write_text(proc.stderr)
    os.replace(tmp, so)
    return so


def build_all() -> dict:
    """Build every source (one nvcc each, all started together);
    -> {stem: seconds}."""
    def one(stem):
        t0 = time.perf_counter()
        build(stem)
        return stem, time.perf_counter() - t0

    stems = [Path(src).stem for src in sources()]
    with ThreadPoolExecutor(len(stems)) as ex:
        return dict(f.result() for f in [ex.submit(one, s) for s in stems])


@functools.lru_cache(maxsize=None)
def _entry(name: str, argtypes: tuple):
    lib = ctypes.CDLL(str(build(Path(KERNELS[CHECK_ENTRIES.get(name, name)].source).stem)))
    lib.panic3d_error_string.restype = ctypes.c_char_p
    lib.panic3d_error_string.argtypes = [ctypes.c_int]
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = list(argtypes)
    return lib, fn


def launch(name: str, argtypes: tuple, *args) -> None:
    """Call the C entry point ``name`` (from its registered source); raise on
    a CUDA error it reports (a refused launch never runs, and a later synchronize
    would not report it)."""
    lib, fn = _entry(name, argtypes)
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(
            f"{name}: CUDA error {rc}: {lib.panic3d_error_string(rc).decode()}")


def call(name: str, argtypes: tuple, *args) -> int:
    """Call the C entry point ``name`` that returns a plain int (a launch
    parameter, such as K13's split of the triangles), not a CUDA status."""
    return _entry(name, argtypes)[1](*args)


def f32_array(values) -> ctypes.Array:
    """Host float array for small by-value kernel parameters."""
    values = [float(v) for v in values]
    return (ctypes.c_float * len(values))(*values)


# ctypes argument types of the C entry points: pointers and the stream are
# c_void_p (a plain int would be cut to 32 bits)
PTR = ctypes.c_void_p
INT = ctypes.c_int
LONG = ctypes.c_longlong
FLOAT = ctypes.c_float
DOUBLE = ctypes.c_double
