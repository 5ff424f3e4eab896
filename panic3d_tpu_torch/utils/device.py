"""Host values on a device without holding up the host.

A host-to-device copy from pageable memory makes the host wait for the work
already queued on the stream, so a constant built from a Python list inside
the forward would cost one full synchronisation per use. ``constant`` makes
small f32 constants once per device and value (the cached tensors are
shared: callers must not write into them); ``to_device`` copies an array
that changes from call to call through pinned memory.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=256)
def _constant(values: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=device)


def constant(values, device) -> torch.Tensor:
    """A 1-D f32 tensor of ``values`` (a short sequence of numbers) on
    ``device``, cached."""
    return _constant(tuple(float(v) for v in values), torch.device(device))


def to_device(array, device) -> torch.Tensor:
    """``array`` as an f32 tensor on ``device``; to a CUDA device through
    pinned memory with an asynchronous copy, which does not wait for the
    stream."""
    t = torch.from_numpy(np.ascontiguousarray(array, dtype=np.float32))
    device = torch.device(device)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
