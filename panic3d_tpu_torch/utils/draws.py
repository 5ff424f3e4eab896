"""Random draws of the keyed forward (the JAX package's ``noise`` rng and
``render_key``), of the loss phases and of ADA's augment pipe.

Every function of the port that draws takes ``generator=``; the keyed
forward also takes the draw itself as an optional tensor (a layer's
``noise`` [N,1,H,W], the stratified ``jitter`` [N,M,S,1], the importance
``u`` [R,K]), in the shapes of the JAX package's draws. ``generator`` is a
``torch.Generator`` on the tensors' device, or a :class:`Replay` of draws
made elsewhere (a test feeds the JAX package's own numbers back in the
order that package drew them). Without a generator and without the draw, a
random mode raises: no default seed is ever picked.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch


class Replay:
    """Draws made elsewhere, handed out in order, each kind from its own
    queue: ``normal`` ones (the noised layers, the backbone's then the
    superresolution's), ``uniform`` ones (the render's jitter and u; a
    ranged draw as the values it took, minval and maxval applied) and, when
    given, ``randint`` ones. Each draw must have the shape asked for."""

    def __init__(self, normal=(), uniform=(), randint=None):
        self._queues = {"normal": deque(normal), "uniform": deque(uniform)}
        if randint is not None:
            self._queues["randint"] = deque(randint)

    def take(self, kind: str, shape, device) -> torch.Tensor:
        queue = self._queues.get(kind)
        if not queue:
            raise ValueError(f"Replay: no {kind} draw left for shape {tuple(shape)}")
        item = queue.popleft()   # a tensor, or an array (copied: it may be read-only)
        t = torch.as_tensor(item if torch.is_tensor(item) else np.array(item),
                            dtype=torch.int64 if kind == "randint" else torch.float32)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"Replay: the next {kind} draw is {tuple(t.shape)}, "
                             f"asked for {tuple(shape)}")
        return t.to(device)

    def left(self) -> dict:
        """The draws not handed out yet, by kind."""
        return {k: len(q) for k, q in self._queues.items()}


def _draw(kind: str, shape, generator, device, what: str) -> torch.Tensor:
    if generator is None:
        raise ValueError(f"{what}: a random draw needs generator= (a torch.Generator "
                         "on the tensors' device, or a Replay) or the draw itself")
    if isinstance(generator, Replay):
        return generator.take(kind, shape, device)
    fn = torch.randn if kind == "normal" else torch.rand
    return fn(tuple(shape), generator=generator, device=device, dtype=torch.float32)


def normal(shape, generator, device, what: str) -> torch.Tensor:
    """A standard normal f32 draw of ``shape`` (jax.random.normal)."""
    return _draw("normal", shape, generator, device, what)


def uniform(shape, generator, device, what: str, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """A uniform [minval, maxval) f32 draw of ``shape`` (jax.random.uniform:
    u (maxval - minval) + minval)."""
    u = _draw("uniform", shape, generator, device, what)
    if isinstance(generator, Replay) or (minval, maxval) == (0.0, 1.0):
        return u
    return u * (maxval - minval) + minval


def randint(shape, generator, device, what: str, low: int, high: int) -> torch.Tensor:
    """An int64 draw of ``shape`` from [low, high) (jax.random.randint)."""
    if generator is None or isinstance(generator, Replay):
        return _draw("randint", shape, generator, device, what)
    return torch.randint(low, high, tuple(shape), generator=generator, device=device)
