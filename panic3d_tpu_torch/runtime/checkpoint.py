"""Parameter-name mapping between the flax tree and the torch state_dict
(panic3d_tpu/runtime/checkpoint.py:226-291).

The flax variables keep the reference's torch shapes, so a mapping is a pure
rename: ``decoder.net.{0,2}.x`` <-> ``decoder/net{0,2}/x``, ``noise_const``,
``w_avg`` and the alias-free layer's ``magnitude_ema`` live in the 'buffers'
collection, everything else in 'params'. The ``resample_filter`` buffers
and the alias-free layer's ``up_filter`` and ``down_filter`` are recomputed
and have no entry.

The ResNet and the metric nets (LPIPS, CLIP) keep the flax tree's own
names in the port (``module_state_from_flax``), so their variables, and
the ``.npz`` files of flax paths that carry converted weights
(``load_flax_npz``), load without a mapping.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Optional, Tuple

import numpy as np
import torch


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


def state_dict_from_flax(variables) -> Dict[str, torch.Tensor]:
    """flax variables {'params': ..., 'buffers': ...} (nested mappings of
    arrays) -> torch state_dict; values are copied as they are (no
    transposes: the flax tree keeps torch shapes)."""
    out = {}
    for collection in ("params", "buffers"):
        for path, leaf in _leaves(variables.get(collection, {}), (collection,)):
            out[torch_name_from_flax(path)] = torch.from_numpy(np.array(leaf, copy=True))
    return out


def module_state_from_flax(variables) -> Dict[str, torch.Tensor]:
    """A flax variable tree of the ResNet or the metric nets (nested
    mappings of arrays; every collection: 'params', 'batch_stats') -> the
    state_dict of the port's module of the same structure, whose names are
    the flax paths joined by '.' and whose shapes are flax's (a Dense
    kernel stays [in, out])."""
    out = {}
    for collection, tree in variables.items():
        for path, leaf in _leaves(tree):
            name = ".".join(path)
            if name in out:
                raise ValueError(f"{name} is in two collections")
            out[name] = torch.from_numpy(np.array(leaf, dtype=np.float32, copy=True))
    return out


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
