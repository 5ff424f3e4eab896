"""Random draws of the keyed forward (the JAX package's ``noise`` rng and
``render_key``).

Every function of the port that draws takes ``generator=`` and the draw
itself as an optional tensor (a layer's ``noise`` [N,1,H,W], the stratified
``jitter`` [N,M,S,1], the importance ``u`` [R,K]), in the shapes of the JAX
package's draws. ``generator`` is a ``torch.Generator`` on the tensors'
device, or a :class:`Replay` of draws made elsewhere (a test feeds the JAX
package's own numbers back in the order that package drew them). Without a
generator and without the draw, a random mode raises: no default seed is
ever picked.
"""

from __future__ import annotations

from collections import deque

import torch


class Replay:
    """Draws made elsewhere, handed out in order: ``normal`` ones to the
    noised layers (the backbone's, then the superresolution's), ``uniform``
    ones to the render (each pass's jitter, then its u). Each draw must have
    the shape asked for."""

    def __init__(self, normal=(), uniform=()):
        self._queues = {"normal": deque(normal), "uniform": deque(uniform)}

    def take(self, kind: str, shape, device) -> torch.Tensor:
        queue = self._queues[kind]
        if not queue:
            raise ValueError(f"Replay: no {kind} draw left for shape {tuple(shape)}")
        t = torch.as_tensor(queue.popleft(), dtype=torch.float32)
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


def uniform(shape, generator, device, what: str) -> torch.Tensor:
    """A uniform [0, 1) f32 draw of ``shape`` (jax.random.uniform)."""
    return _draw("uniform", shape, generator, device, what)
