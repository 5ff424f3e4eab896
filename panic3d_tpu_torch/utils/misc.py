"""Module audits (panic3d_tpu/utils/misc.py, the pieces the trainer uses):
the parameter count, and a content hash of a module's state for the
snapshot lines (the JAX package's tree_hash). Its cross-replica check has
nothing to audit here: the port trains in one process on one device."""

from __future__ import annotations

import hashlib

import numpy as np
import torch


def count_params(module: torch.nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


def state_hash(module: torch.nn.Module) -> str:
    """Content hash of a module's state_dict (names and bytes, in name order)."""
    h = hashlib.md5()
    for name, t in sorted(module.state_dict().items()):
        h.update(name.encode())
        h.update(np.ascontiguousarray(t.detach().float().cpu().numpy()).tobytes())
    return h.hexdigest()
