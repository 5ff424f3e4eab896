"""Checkpoints of the port (panic3d_tpu/runtime/checkpoint.py), with no
flax, no msgpack package and nothing of the JAX package.

- The native format: a directory holding ``state.msgpack`` (flax's msgpack
  serialisation of a variables tree) and ``config.json`` (the snapshot
  config). ``to_bytes`` / ``msgpack_restore`` read and write flax's layout
  in pure Python (struct over a memoryview), ``save_checkpoint`` /
  ``load_checkpoint`` the directory, ``extract_generator_variables`` takes
  G_ema out of a trainer snapshot.
- The reference's ``network-snapshot-*.pkl``: ``extract_reference_generator``
  unpickles it without running its embedded source (the persistence hook
  ``_reconstruct_persistent_obj`` becomes a plain carrier of the module's
  state), ``generator_config_from_init_kwargs`` rebuilds the constructor
  kwargs, ``load_generator_state`` loads the state_dict into the port's
  TriPlaneGenerator; ``save_reference_pickle`` writes that layout.
- The name mapping between the flax tree and the torch state_dict
  (panic3d_tpu/runtime/checkpoint.py:226-291). The flax variables keep the
  reference's torch shapes, so a mapping is a pure rename:
  ``decoder.net.{0,2}.x`` <-> ``decoder/net{0,2}/x``, ``noise_const``,
  ``w_avg`` and the alias-free layer's ``magnitude_ema`` live in the
  'buffers' collection, everything else in 'params'. The
  ``resample_filter`` buffers and the alias-free layer's ``up_filter`` and
  ``down_filter`` are recomputed and have no entry.

A trainer snapshot holds the JAX package's GANTrainState tree (flax's
to_state_dict of it): vars_G / vars_D / vars_Gema, the two optimizers as
optax's chain state ``{"0": {"count", "mu", "nu"}, "1": {}}``, cur_nimg,
aug_p and pl_mean. ``train_state_tree`` writes the port's
training/loop.py:GANTrainState in that layout and ``load_train_state``
reads it back into one (panic3d_tpu/runtime/checkpoint.py:111), so a
snapshot of either package resumes in the other.

The ResNet, the line filler and the metric nets (LPIPS, CLIP) keep the
flax tree's own names in the port (``module_state_from_flax``), so their
variables, and the ``.npz`` files of flax paths that carry converted
weights (``load_flax_npz``), load without a mapping.
"""

from __future__ import annotations

import json
import os
import pickle
import struct
from collections import OrderedDict
from collections.abc import Mapping
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


# ---------------------------------------------------------------------------
# flax's msgpack layout (flax/serialization.py): a map tree whose arrays are
# ExtType(1, packb((shape, dtype name, C-order bytes))), numpy scalars
# ExtType(3, the same of the 0-d array), complex numbers
# ExtType(2, packb((real, imag))); an array over MAX_CHUNK_SIZE bytes is a
# map of flat chunks.

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"
MAX_CHUNK_SIZE = 2 ** 30

# fixed-width formats: byte -> (struct format, size)
_SCALARS = {0xca: (">f", 4), 0xcb: (">d", 8), 0xcc: (">B", 1), 0xcd: (">H", 2),
            0xce: (">I", 4), 0xcf: (">Q", 8), 0xd0: (">b", 1), 0xd1: (">h", 2),
            0xd2: (">i", 4), 0xd3: (">q", 8)}
# variable-length formats: byte -> (kind, struct format of the length)
_SIZED = {0xc4: ("bin", ">B"), 0xc5: ("bin", ">H"), 0xc6: ("bin", ">I"),
          0xc7: ("ext", ">B"), 0xc8: ("ext", ">H"), 0xc9: ("ext", ">I"),
          0xd9: ("str", ">B"), 0xda: ("str", ">H"), 0xdb: ("str", ">I"),
          0xdc: ("array", ">H"), 0xdd: ("array", ">I"),
          0xde: ("map", ">H"), 0xdf: ("map", ">I")}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class _Reader:
    """msgpack decoding over a memoryview: every read is a struct unpack or
    a slice, so array payloads are never copied byte by byte."""

    def __init__(self, data):
        self.buf = memoryview(data).cast("B")
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        start, end = self.pos, self.pos + n
        if end > len(self.buf):
            raise ValueError(f"msgpack: {n} bytes wanted at offset {start}, "
                             f"{len(self.buf) - start} left")
        self.pos = end
        return self.buf[start:end]

    def _unpack(self, fmt: str, n: int):
        return struct.unpack(fmt, self._take(n))[0]

    def read(self):
        at = self.pos
        b = self._take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if b <= 0x8f:
            return self._map(b & 0x0f)
        if b <= 0x9f:
            return self._array(b & 0x0f)
        if b <= 0xbf:
            return str(self._take(b & 0x1f), "utf-8")
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in _SCALARS:
            return self._unpack(*_SCALARS[b])
        if b in _FIXEXT:
            return self._ext(_FIXEXT[b])
        if b in _SIZED:
            kind, fmt = _SIZED[b]
            n = self._unpack(fmt, struct.calcsize(fmt))
            if kind == "bin":
                return bytes(self._take(n))
            if kind == "str":
                return str(self._take(n), "utf-8")
            if kind == "ext":
                return self._ext(n)
            return self._array(n) if kind == "array" else self._map(n)
        raise ValueError(f"msgpack: unsupported format byte 0x{b:02x} at offset {at}")

    def _array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def _ext(self, n: int):
        at = self.pos
        code = self._unpack(">b", 1)
        payload = self._take(n)
        if code == _EXT_NDARRAY:
            return _ndarray_from_bytes(payload)
        if code == _EXT_NPSCALAR:
            arr = _ndarray_from_bytes(payload)
            return arr if isinstance(arr, torch.Tensor) else arr[()]
        if code == _EXT_COMPLEX:
            real, imag = _Reader(payload).read()
            return complex(real, imag)
        raise ValueError(f"msgpack: unsupported ext type {code} at offset {at - 1}")


def _ndarray_from_bytes(payload):
    """(shape, dtype name, C-order bytes) -> a numpy array (a read-only view
    of the payload), or a torch tensor for bfloat16, which numpy lacks."""
    shape, name, buf = _Reader(payload).read()
    shape = tuple(shape)
    if name == "bfloat16":
        raw = np.frombuffer(buf, dtype=np.int16).copy()
        return torch.from_numpy(raw).view(torch.bfloat16).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)


def _unchunk(tree):
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        if isinstance(chunks[0], torch.Tensor):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data) -> Any:
    """flax.serialization.msgpack_restore without flax: msgpack bytes -> the
    tree of dicts, lists and leaves (numpy arrays and scalars; bfloat16
    arrays as torch tensors), chunked arrays joined."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError(f"msgpack: {len(reader.buf) - reader.pos} trailing bytes")
    return _unchunk(tree)


def _state_dict(tree):
    """flax.serialization.to_state_dict on plain containers: dict keys as
    strings, lists and tuples as maps of their indices."""
    if isinstance(tree, Mapping):
        out = {str(k): _state_dict(v) for k, v in tree.items()}
        if len(out) != len(tree):
            raise ValueError(f"keys without a unique string form: {list(tree)}")
        return out
    if isinstance(tree, (list, tuple)):
        return {str(i): _state_dict(v) for i, v in enumerate(tree)}
    return tree


def _array_payload(arr) -> Tuple[np.ndarray, str]:
    """A numpy array or torch tensor -> (its C-order numpy data, flax's dtype
    name); bfloat16 travels as its 16-bit patterns."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        return t.numpy(), str(t.numpy().dtype)
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not serialisable")
    return arr, arr.dtype.name


def _chunk_leaves(tree):
    """flax's _chunk_array_leaves_in_place: an array leaf over
    MAX_CHUNK_SIZE bytes -> a map of its flat chunks."""
    if isinstance(tree, dict):
        return {k: _chunk_leaves(v) for k, v in tree.items()}
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        nbytes = tree.numel() * tree.element_size() if isinstance(tree, torch.Tensor) \
            else tree.nbytes
        if nbytes > MAX_CHUNK_SIZE:
            item = tree.element_size() if isinstance(tree, torch.Tensor) else tree.itemsize
            size = max(1, int(MAX_CHUNK_SIZE / item))
            flat = tree.reshape(-1)
            return {_CHUNKED: True, "shape": {str(i): d for i, d in enumerate(tree.shape)},
                    "chunks": {str(i): flat[j:j + size]
                               for i, j in enumerate(range(0, flat.shape[0], size))}}
    return tree


_BIN = ((0xc4, ">B", 2 ** 8), (0xc5, ">H", 2 ** 16), (0xc6, ">I", 2 ** 32))
_STR = ((0xd9, ">B", 2 ** 8), (0xda, ">H", 2 ** 16), (0xdb, ">I", 2 ** 32))
_ARRAY = ((0xdc, ">H", 2 ** 16), (0xdd, ">I", 2 ** 32))
_MAP = ((0xde, ">H", 2 ** 16), (0xdf, ">I", 2 ** 32))
_EXT = ((0xc7, ">B", 2 ** 8), (0xc8, ">H", 2 ** 16), (0xc9, ">I", 2 ** 32))
_FIXEXT_BYTE = {n: b for b, n in _FIXEXT.items()}


def _pack_header(out: bytearray, n: int, formats, fix_limit: int = 0, fix_byte: int = 0):
    """The smallest header for a length n: the fix form below fix_limit,
    else the first of ``formats`` (byte, struct format, limit) that holds it."""
    if n < fix_limit:
        out.append(fix_byte | n)
        return
    for byte, fmt, limit in formats:
        if n < limit:
            out.append(byte)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack: length {n} too large")


def _pack_str(out: bytearray, s: str):
    raw = s.encode("utf-8")
    _pack_header(out, len(raw), _STR, 32, 0xa0)
    out += raw


def _pack_bin(out: bytearray, raw):
    _pack_header(out, len(raw), _BIN)
    out += raw


# integer formats past the fixints: (byte, struct format, low, high)
_INTS = ((0xcc, ">B", 0, 2 ** 8), (0xcd, ">H", 0, 2 ** 16), (0xce, ">I", 0, 2 ** 32),
         (0xcf, ">Q", 0, 2 ** 64), (0xd0, ">b", -2 ** 7, 0), (0xd1, ">h", -2 ** 15, 0),
         (0xd2, ">i", -2 ** 31, 0), (0xd3, ">q", -2 ** 63, 0))


def _pack_int(out: bytearray, v: int):
    if -32 <= v < 128:
        out += struct.pack(">b" if v < 0 else ">B", v)
        return
    for byte, fmt, lo, hi in _INTS:
        if lo <= v < hi:
            out.append(byte)
            out += struct.pack(fmt, v)
            return
    raise ValueError(f"msgpack: integer {v} out of range")


def _pack_ext(out: bytearray, code: int, payload: bytes):
    n = len(payload)
    if n in _FIXEXT_BYTE:
        out.append(_FIXEXT_BYTE[n])
    else:
        _pack_header(out, n, _EXT)
    out += struct.pack(">b", code)
    out += payload


def _ndarray_bytes(arr) -> bytes:
    data, name = _array_payload(arr)
    inner = bytearray([0x93])
    _pack_header(inner, len(data.shape), _ARRAY, 16, 0x90)
    for d in data.shape:
        _pack_int(inner, int(d))
    _pack_str(inner, name)
    _pack_bin(inner, data.tobytes("C"))
    return bytes(inner)


def _pack(out: bytearray, obj):
    """msgpack.packb(obj, default=flax's _msgpack_ext_pack, strict_types=True,
    use_bin_type=True): exact types only, as flax packs them."""
    t = type(obj)
    if obj is None:
        out.append(0xc0)
    elif t is bool:
        out.append(0xc3 if obj else 0xc2)
    elif t is int:
        _pack_int(out, obj)
    elif t is float:
        out.append(0xcb)
        out += struct.pack(">d", obj)
    elif t is str:
        _pack_str(out, obj)
    elif t is bytes:
        _pack_bin(out, obj)
    elif t is dict:
        _pack_header(out, len(obj), _MAP, 16, 0x80)
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    elif t is list:
        _pack_header(out, len(obj), _ARRAY, 16, 0x90)
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        _pack_ext(out, _EXT_NDARRAY, _ndarray_bytes(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj)))
    elif t is complex:
        inner = bytearray([0x92, 0xcb]) + struct.pack(">d", obj.real)
        inner += bytes([0xcb]) + struct.pack(">d", obj.imag)
        _pack_ext(out, _EXT_COMPLEX, bytes(inner))
    else:
        raise TypeError(f"msgpack: cannot serialise {t.__name__}")


def to_bytes(tree) -> bytes:
    """flax.serialization.to_bytes without flax, for trees of dicts, lists,
    tuples, Python scalars, strings, numpy arrays and scalars and torch
    tensors: the same bytes flax writes for the same tree."""
    out = bytearray()
    _pack(out, _chunk_leaves(_state_dict(tree)))
    return bytes(out)


def save_checkpoint(path: str, variables, config: Optional[dict] = None):
    """``path``/state.msgpack (and config.json), each written to a temporary
    file and renamed, so that a crash never leaves a truncated file."""
    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, "state.msgpack")
    with open(final + ".tmp", "wb") as f:
        f.write(to_bytes(variables))
    os.replace(final + ".tmp", final)
    if config is not None:
        cfg = os.path.join(path, "config.json")
        with open(cfg + ".tmp", "w") as f:
            json.dump(config, f, indent=1, default=str)
        os.replace(cfg + ".tmp", cfg)


def load_checkpoint(path: str):
    """A checkpoint directory -> (the state tree, the config dict or None)."""
    with open(os.path.join(path, "state.msgpack"), "rb") as f:
        data = f.read()
    config = None
    cfg = os.path.join(path, "config.json")
    if os.path.isfile(cfg):
        with open(cfg) as f:
            config = json.load(f)
    return msgpack_restore(data), config


def extract_generator_variables(state):
    """Bare G variables from any checkpoint layout: a trainer snapshot's
    ``vars_Gema`` (the reference's G_ema pickle key) when present, else the
    tree itself."""
    if isinstance(state, dict) and "vars_Gema" in state:
        return state["vars_Gema"]
    return state


# ---------------------------------------------------------------------------
# the reference's pickles, read without running their embedded code

class _PersistentStub:
    """Carrier for a persisted torch module's raw state."""

    def __init__(self, meta):
        self.meta = meta

    @property
    def state(self):
        return self.meta["state"]


def _stub_reconstruct(meta):
    return _PersistentStub(meta)


class _RefUnpickler(pickle.Unpickler):
    """Unpickles reference snapshots with persistence and dnnlib shimmed out."""

    def find_class(self, module, name):
        if name == "_reconstruct_persistent_obj":
            return _stub_reconstruct
        if module.startswith("torch"):
            return super().find_class(module, name)
        if module == "dnnlib" or module.startswith("dnnlib."):
            return dict if name == "EasyDict" else super().find_class("builtins", "dict")
        return super().find_class(module, name)


def load_reference_pickle(path: str) -> dict:
    with open(path, "rb") as f:
        return _RefUnpickler(f).load()


def _walk_torch_module_state(stub, prefix="", out=None):
    """Flatten a _PersistentStub tree (nn.Module's _parameters / _buffers /
    _modules) into {dotted name: np.ndarray}. Nodes are stubs (persistent
    classes), dicts, or live torch modules (state in __dict__)."""
    out = {} if out is None else out
    if isinstance(stub, _PersistentStub):
        state = stub.state
    elif isinstance(stub, dict):
        state = stub
    else:
        state = getattr(stub, "__dict__", {})
    params = state.get("_parameters", {}) or {}
    buffers = state.get("_buffers", {}) or {}
    modules = state.get("_modules", {}) or {}
    for k, v in {**params, **buffers}.items():
        if v is None:
            continue
        out[prefix + k] = v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
    for k, v in modules.items():
        if v is not None:
            _walk_torch_module_state(v, prefix + k + ".", out)
    return out


def extract_reference_generator(path: str, key: str = "G_ema"):
    """-> (state_dict {torch name: array}, init_args, init_kwargs, extras).

    The persistence decorator keeps the constructor arguments as
    ``_init_args`` / ``_init_kwargs`` (persistence.py:141-143), and
    meta['state'] is the module's __getstate__ dict."""
    data = load_reference_pickle(path)
    stub = data[key]
    st = stub.state if isinstance(stub, _PersistentStub) else stub.__dict__
    state_dict = _walk_torch_module_state(stub)
    init_args = tuple(st.get("_init_args", st.get("init_args", ())))
    init_kwargs = dict(st.get("_init_kwargs", st.get("init_kwargs", {})))
    extras = {k: st[k] for k in ("neural_rendering_resolution", "rendering_kwargs") if k in st}
    return state_dict, init_args, init_kwargs, extras


# the reference TriPlaneGenerator's named constructor parameters
# (triplane.py:30-46); anything else in init_kwargs fell into
# **synthesis_kwargs there and does here too
_GEN_NAMED_KWARGS = (
    "z_dim", "c_dim", "w_dim", "img_resolution", "img_channels",
    "sr_num_fp16_res", "mapping_kwargs", "rendering_kwargs", "cond_mode",
    "triplane_width", "sr_channels_hidden", "backbone_resolution",
)


def generator_config_from_init_kwargs(init_kwargs: dict,
                                      extras: Optional[dict] = None) -> dict:
    """Reference init_kwargs -> the port's TriPlaneGenerator kwargs: the
    reference's rebuild ``TriPlaneGenerator(**G.init_kwargs)`` with its
    neural_rendering_resolution and rendering_kwargs attributes carried over
    (eg3dc_v0.py:46-52). Every SR module of the JAX package, its cond
    modes and ray_start='auto' build and render; an SR module neither
    package has fails at construction (KeyError)."""
    kw = dict(init_kwargs)
    out: Dict[str, Any] = {}
    for k in _GEN_NAMED_KWARGS:
        if k in kw:
            v = kw.pop(k)
            out[k] = dict(v) if isinstance(v, dict) else v
    sr_kwargs = kw.pop("sr_kwargs", {})
    if sr_kwargs:
        raise NotImplementedError(f"sr_kwargs in a snapshot are not ported: {sr_kwargs}")
    if kw:
        out["synthesis_kwargs"] = kw
    for k in ("neural_rendering_resolution", "rendering_kwargs"):
        if extras and k in extras:
            v = extras[k]
            out[k] = dict(v) if isinstance(v, dict) else v
    return out


def _reconstruct_persistent_obj(meta):
    """The reference's persistence hook, under its own name, for the pickles
    ``save_reference_pickle`` writes: readers map it to _PersistentStub by
    name, so no code of the snapshot runs."""
    return _PersistentStub(meta)


class _Persistent:
    """Pickles as a persistent module of the reference does:
    ``_reconstruct_persistent_obj(meta)``, its state in meta['state']."""

    def __init__(self, class_name: str, state: dict):
        self.class_name, self.state = class_name, state

    def __reduce__(self):
        meta = dict(type="class", version=4, module_src="", class_name=self.class_name,
                    state=self.state)
        return _reconstruct_persistent_obj, (meta,)


def _persistent_tree(module: torch.nn.Module) -> _Persistent:
    params = OrderedDict((k, torch.nn.Parameter(p.detach().cpu().clone(), requires_grad=False))
                         for k, p in module._parameters.items() if p is not None)
    buffers = OrderedDict((k, b.detach().cpu().clone())
                          for k, b in module._buffers.items()
                          if b is not None and k not in module._non_persistent_buffers_set)
    children = OrderedDict((k, _persistent_tree(m)) for k, m in module._modules.items()
                           if m is not None)
    return _Persistent(type(module).__name__, dict(_parameters=params, _buffers=buffers,
                                                   _modules=children))


def save_reference_pickle(path: str, G: torch.nn.Module, ctor_kwargs: dict,
                          key: str = "G_ema"):
    """Write ``G`` in the layout of the reference's network-snapshot-*.pkl
    (training_loop_v0.py:470-485): ``{key: persistent G}``, whose state holds
    _parameters, _buffers, _modules (each submodule persistent in turn),
    _init_args, _init_kwargs (``ctor_kwargs`` of the port's constructor,
    synthesis_kwargs spread out as the reference's **synthesis_kwargs, and
    without force_sigmoid, which the reference sets after construction),
    neural_rendering_resolution and rendering_kwargs."""
    kw = dict(ctor_kwargs)
    kw.pop("force_sigmoid", None)
    nrr = kw.pop("neural_rendering_resolution", G.neural_rendering_resolution)
    init_kwargs = {**{k: v for k, v in kw.items() if k != "synthesis_kwargs"},
                   **kw.get("synthesis_kwargs", {})}
    root = _persistent_tree(G)
    root.state.update(_init_args=(), _init_kwargs=init_kwargs,
                      neural_rendering_resolution=nrr, rendering_kwargs=dict(G.rk))
    with open(path + ".tmp", "wb") as f:
        pickle.dump({key: root}, f)
    os.replace(path + ".tmp", path)


_BUFFERS = ("noise_const", "w_avg", "magnitude_ema")
_RECOMPUTED = ("resample_filter", "up_filter", "down_filter")


def flax_path_from_torch(name: str) -> Optional[Tuple[str, ...]]:
    """Reference state_dict name -> (collection, *path), or None for the
    recomputed filter constants."""
    parts = name.split(".")
    if parts[-1] in _RECOMPUTED:
        return None
    collection = "buffers" if parts[-1] in _BUFFERS else "params"
    if len(parts) >= 4 and parts[0] == "decoder" and parts[1] == "net":
        return (collection, "decoder", f"net{parts[2]}", parts[3])
    return (collection, *parts)


def torch_name_from_flax(path: Tuple[str, ...]) -> str:
    """(collection, *path) -> state_dict name; inverse of flax_path_from_torch."""
    parts = list(path[1:])
    if len(parts) == 3 and parts[0] == "decoder" and parts[1].startswith("net"):
        parts = ["decoder", "net", parts[1][3:], parts[2]]
    return ".".join(parts)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _tensor(leaf, dtype=None) -> torch.Tensor:
    """A leaf of a loaded tree (numpy array or scalar, or a torch tensor for
    bfloat16) -> a torch tensor of its own, optionally cast."""
    t = leaf.detach().clone() if isinstance(leaf, torch.Tensor) \
        else torch.from_numpy(np.array(leaf, copy=True))
    return t if dtype is None else t.to(dtype)


def state_dict_from_flax(variables) -> Dict[str, torch.Tensor]:
    """flax variables {'params': ..., 'buffers': ...} (nested mappings of
    arrays) -> torch state_dict; values are copied as they are (no
    transposes: the flax tree keeps torch shapes)."""
    out = {}
    for collection in ("params", "buffers"):
        for path, leaf in _leaves(variables.get(collection, {}), (collection,)):
            out[torch_name_from_flax(path)] = _tensor(leaf)
    return out


def _put(tree: dict, path, value):
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def flax_from_state_dict(state_dict) -> dict:
    """The port generator's state_dict -> the flax variables tree
    {'params': ..., 'buffers': ...} of numpy arrays (the inverse of
    state_dict_from_flax), as the JAX package saves G."""
    out: dict = {}
    for name, t in state_dict.items():
        path = flax_path_from_torch(name)
        if path is not None:
            _put(out, path, t.detach().cpu().numpy())
    return out


def module_variables(module: torch.nn.Module) -> dict:
    """A port module with flax names (the ResNet, the line filler) -> its
    flax variables: parameters under 'params', buffers (the BatchNorm
    running statistics) under 'batch_stats', paths split at '.'."""
    out: dict = {}
    for collection, items in (("params", module.named_parameters()),
                              ("batch_stats", module.named_buffers())):
        for name, t in items:
            _put(out.setdefault(collection, {}), name.split("."), t.detach().cpu().numpy())
    return out


def module_state_from_flax(variables) -> Dict[str, torch.Tensor]:
    """A flax variable tree of the ResNet, the line filler or the metric
    nets (nested mappings of arrays; every collection: 'params',
    'batch_stats') -> the state_dict of the port's module of the same
    structure, whose names are the flax paths joined by '.' and whose
    shapes are flax's (a Dense kernel stays [in, out])."""
    out = {}
    for collection, tree in variables.items():
        for path, leaf in _leaves(tree):
            name = ".".join(path)
            if name in out:
                raise ValueError(f"{name} is in two collections")
            out[name] = _tensor(leaf, torch.float32)
    return out


def convert_generator_state(state_dict, G: torch.nn.Module):
    """A reference-named state_dict {name: array} (a snapshot's, or
    extract_reference_generator's) -> (the port's state_dict for ``G``,
    missing names, unexpected names) (panic3d_tpu/runtime/checkpoint.py:
    244-291). The recomputed filter buffers are dropped, as
    flax_path_from_torch drops them; a shape that differs from G's raises."""
    own = G.state_dict()
    out = {}
    for name, arr in state_dict.items():
        if name.split(".")[-1] in _RECOMPUTED or name not in own:
            continue
        shape = tuple(arr.shape)
        if shape != tuple(own[name].shape):
            raise ValueError(f"{name}: shape {shape}, the port's generator has "
                             f"{tuple(own[name].shape)}")
        out[name] = _tensor(arr, own[name].dtype)
    missing = sorted(set(own) - set(out))
    unexpected = sorted(k for k in state_dict
                        if k not in own and k.split(".")[-1] not in _RECOMPUTED)
    return out, missing, unexpected


def load_generator_state(G: torch.nn.Module, state_dict) -> torch.nn.Module:
    """Load a reference-named state_dict into the port's TriPlaneGenerator;
    refused (ValueError) unless every name of G is given and no other."""
    state, missing, unexpected = convert_generator_state(state_dict, G)
    if missing or unexpected:
        raise ValueError(f"state_dict does not fit the generator: missing {missing}, "
                         f"unexpected {unexpected}")
    G.load_state_dict(state, strict=True)
    return G


def load_flax_npz(path: str) -> dict:
    """An .npz keyed by flax paths ('alex/conv1_w', 'block0/ln_1/scale') ->
    the variables tree {'params': {...}} of numpy arrays, as the JAX
    package's load_lpips_params and load_clip_params build it."""
    data = np.load(path)
    params: dict = {}
    for k in data.files:
        node = params
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(data[k])
    return {"params": params}


# ---------------------------------------------------------------------------
# trainer snapshots: the JAX package's GANTrainState tree

_TRAIN_FIELDS = ("vars_G", "vars_D", "vars_Gema", "opt_G", "opt_D", "cur_nimg", "aug_p",
                 "pl_mean")


def _adam_tree(opt) -> dict:
    """An optimizer (training/loop.py:Adam) as optax's adam chain state."""
    def params(moments):
        return flax_from_state_dict(moments).get("params", {})
    return {"0": {"count": np.asarray(opt.count, np.int32), "mu": params(opt.mu),
                  "nu": params(opt.nu)}, "1": {}}


def train_state_tree(state) -> dict:
    """training/loop.py:GANTrainState -> the JAX package's train-state tree
    (numpy leaves), as its save_checkpoint writes a GANTrainState."""
    return {
        "vars_G": flax_from_state_dict(state.G.state_dict()),
        "vars_D": flax_from_state_dict(state.D.state_dict()),
        "vars_Gema": flax_from_state_dict(state.G_ema.state_dict()),
        "opt_G": _adam_tree(state.opt_G),
        "opt_D": _adam_tree(state.opt_D),
        "cur_nimg": np.asarray(state.cur_nimg, np.int32),
        "aug_p": np.asarray(state.aug_p, np.float32),
        "pl_mean": np.asarray(state.pl_mean, np.float32),
    }


def _load_module(module: torch.nn.Module, variables) -> None:
    own = module.state_dict()
    module.load_state_dict({n: t.to(own[n].dtype) for n, t in
                            state_dict_from_flax(variables).items()}, strict=True)


def _load_adam(opt, tree) -> None:
    opt.count = int(np.asarray(tree["0"]["count"]))
    for key, moments in (("mu", opt.mu), ("nu", opt.nu)):
        given = state_dict_from_flax({"params": tree["0"][key]})
        if set(given) != set(moments):
            raise ValueError(f"optimizer {key}: the snapshot's parameters differ from the "
                             f"model's: {sorted(set(given) ^ set(moments))[:5]}")
        with torch.no_grad():
            for n, t in moments.items():
                t.copy_(given[n].to(t.dtype))


def load_train_state(path: str, state):
    """Restore a trainer snapshot (either package's) into the port's
    GANTrainState ``state`` in place, tolerating fields the snapshot
    predates (they keep ``state``'s values); a field the state does not
    know is an error. -> (state, the snapshot's config)."""
    raw, config = load_checkpoint(path)
    unknown = set(raw) - set(_TRAIN_FIELDS)
    if unknown:
        raise ValueError(f"snapshot has unknown state fields: {sorted(unknown)}")
    for field, module in (("vars_G", state.G), ("vars_D", state.D), ("vars_Gema", state.G_ema)):
        if field in raw:
            _load_module(module, raw[field])
    for field, opt in (("opt_G", state.opt_G), ("opt_D", state.opt_D)):
        if field in raw:
            _load_adam(opt, raw[field])
    if "cur_nimg" in raw:
        state.cur_nimg = int(np.asarray(raw["cur_nimg"]))
    for field in ("aug_p", "pl_mean"):
        if field in raw:
            setattr(state, field, float(np.asarray(raw[field])))
    return state, config
