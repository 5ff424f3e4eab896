"""Parameter-name mapping between the flax tree and the torch state_dict
(panic3d_tpu/runtime/checkpoint.py:226-291).

The flax variables keep the reference's torch shapes, so a mapping is a pure
rename: ``decoder.net.{0,2}.x`` <-> ``decoder/net{0,2}/x``, ``noise_const``
and ``w_avg`` live in the 'buffers' collection, everything else in
'params'. ``resample_filter`` buffers are recomputed and have no entry.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Optional, Tuple

import numpy as np
import torch


def flax_path_from_torch(name: str) -> Optional[Tuple[str, ...]]:
    """Reference state_dict name -> (collection, *path), or None for the
    recomputed resample_filter constants."""
    parts = name.split(".")
    if parts[-1] == "resample_filter":
        return None
    collection = "buffers" if parts[-1] in ("noise_const", "w_avg") else "params"
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
