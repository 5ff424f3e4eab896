"""Phase-based GAN train step and state (panic3d_tpu/training/loop.py).

Role of `src/training/training_loop_v0.py:99-539` and the phase setup of
`trainers/train_eclustrousC.py`:
- the phases Gmain/Gcond/Gside-*/Grand/Greg/Dmain/Dreg, each its own Adam
  step of the module's optimizer (training_loop_v0.py:221-266);
- the lazy-regularisation scaling of lr and betas by
  reg_interval/(reg_interval+1) (training_loop_v0.py:226-229);
- the gradients' nan_to_num (training_loop_v0.py:371);
- accumulation over micro-batches of ``batch_gpu`` (mean, or the
  reference's sum under ``accum_sum``) and the frozen D layers;
- the G_ema lerp with beta 0.5^(batch/ema_nimg) (training_loop_v0.py:381-392).

The state holds the modules themselves; a step updates them in place. The
optimizer is :class:`Adam`, optax.adam's update written out (the same
moments, bias corrections and order of operations, in f32), so that one
step agrees with the JAX package's. A step draws from one generator: the
latents first, then each phase in order (each micro-batch in order), as the
JAX step splits its key. With ADA, Gmain, Dmain and Dreg augment D's inputs
at ``state.aug_p``, which :func:`ada_update` moves between steps. The
fused recon phases (Grecon-fused, Grecon-seq) and the path-length phase
(Gpl) are not ported: they raise, naming ROADMAP Queue 1 item 5 (the
trainer refuses remat, the JAX TrainConfig's other field, before it builds
one).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils import draws
from .loss import OrthoCondLoss

NOT_PORTED = "not ported to the H100 yet (ROADMAP Queue 1 item 5)"


class Adam:
    """optax.adam(lr, b1, b2, eps) over a module's named parameters: count,
    mu and nu as optax keeps them (ScaleByAdamState), and its update

        mu = (1 - b1) g + b1 mu,  nu = (1 - b2) g^2 + b2 nu,
        p += -lr * (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps)

    in f32, in that order."""

    def __init__(self, module: torch.nn.Module, lr: float, b1: float, b2: float, eps: float):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.params = dict(module.named_parameters())
        self.count = 0
        self.mu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in self.params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        """One update of every parameter, as torch._foreach ops over the
        module's tensors (a few launches, not a few per tensor), in optax's
        order of operations."""
        self.count += 1
        b1, b2 = self.b1, self.b2
        # the bias corrections in f32, as optax takes them, passed as Python
        # scalars (exact f32 values: no copy to the device, no wait)
        f32 = np.float32
        bc1 = float(f32(1) - f32(b1) ** f32(self.count))
        bc2 = float(f32(1) - f32(b2) ** f32(self.count))
        names = list(self.params)
        g = [grads[n] for n in names]
        mu = [self.mu[n] for n in names]
        nu = [self.nu[n] for n in names]
        new_mu = torch._foreach_add(torch._foreach_mul(g, 1 - b1), torch._foreach_mul(mu, b1))
        new_nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2),
                                    torch._foreach_mul(nu, b2))
        torch._foreach_copy_(mu, new_mu)
        torch._foreach_copy_(nu, new_nu)
        den = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(new_nu, bc2)), self.eps)
        upd = torch._foreach_div(torch._foreach_div(new_mu, bc1), den)
        torch._foreach_add_([self.params[n] for n in names], torch._foreach_mul(upd, -self.lr))


@dataclasses.dataclass
class GANTrainState:
    G: torch.nn.Module
    D: torch.nn.Module
    G_ema: torch.nn.Module
    opt_G: Adam
    opt_D: Adam
    cur_nimg: int = 0
    aug_p: float = 0.0    # ADA's p, an f32 value on the host (ada_update)
    pl_mean: float = 0.0  # the path-length mean (the JAX state's field; Gpl is not ported)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 4
    batch_gpu: Optional[int] = None
    accum_sum: bool = False
    d_frozen: Tuple = ()
    g_lr: float = 0.0025
    d_lr: float = 0.002
    betas: Tuple[float, float] = (0.0, 0.99)
    eps: float = 1e-8
    g_reg_interval: int = 4
    d_reg_interval: int = 16
    ema_kimg: float = 1.25
    ema_rampup: Optional[float] = None
    phases: Tuple[str, ...] = ("Gmain", "Gcond", "Gside-left", "Gside-right", "Gside-back",
                               "Grand", "Greg", "Dmain", "Dreg")

    @property
    def n_micro(self) -> int:
        if self.batch_gpu is None:
            return 1
        if self.batch_size % self.batch_gpu:
            raise ValueError(f"batch {self.batch_size} is not a multiple of batch_gpu "
                             f"{self.batch_gpu}")
        return self.batch_size // self.batch_gpu


def _scaled_adam(module, lr, betas, eps, reg_interval) -> Adam:
    """Lazy-reg Adam scaling (training_loop_v0.py:226-229)."""
    mb = reg_interval / (reg_interval + 1)
    return Adam(module, lr * mb, betas[0] ** mb, betas[1] ** mb, eps)


def init_state(G, D, cfg: TrainConfig) -> GANTrainState:
    G_ema = copy.deepcopy(G).requires_grad_(False)
    return GANTrainState(
        G=G, D=D, G_ema=G_ema,
        opt_G=_scaled_adam(G, cfg.g_lr, cfg.betas, cfg.eps, cfg.g_reg_interval),
        opt_D=_scaled_adam(D, cfg.d_lr, cfg.betas, cfg.eps, cfg.d_reg_interval))


def _slice(tree, i, n):
    if isinstance(tree, dict):
        return {k: _slice(v, i, n) for k, v in tree.items()}
    return tree[i::n]


def _frozen(name: str, d_frozen) -> bool:
    parts = name.split(".")
    return any((parts[k], parts[k + 1]) in d_frozen for k in range(len(parts) - 1))


def build_train_step(loss: OrthoCondLoss, train_cfg: TrainConfig, z_dim: int,
                     active_phases: Sequence[str]):
    """One multi-phase step for a phase subset (the host loop picks the
    subset by step: the reg phases run every g/d_reg_interval steps);
    -> train_step(state, batch, generator) -> stats, updating ``state``."""
    for ph in active_phases:
        if ph in ("Grecon-fused", "Grecon-seq", "Gpl"):
            raise NotImplementedError(f"phase {ph} is {NOT_PORTED}")
    n_micro = train_cfg.n_micro
    frozen = {tuple(p) for p in train_cfg.d_frozen}
    views = {"Gcond": "front", "Gside-left": "left", "Gside-right": "right",
             "Gside-back": "back", "Grand": "rand"}

    def accumulate(phase_fn, params: dict, batch, gen_z, gen_c, generator):
        """Micro-batched gradients (training_loop_v0.py:336-347): micro-batch
        i is the strided slice [i::n_micro]; gradients and stats summed,
        then averaged unless accum_sum (the stats always)."""
        names, leaves = list(params), list(params.values())
        total_g, total_s = None, None
        for i in range(n_micro):
            mb = batch if n_micro == 1 else _slice(batch, i, n_micro)
            z = gen_z if n_micro == 1 else gen_z[i::n_micro]
            c = gen_c if n_micro == 1 else gen_c[i::n_micro]
            value, stats = phase_fn(mb, z, c, generator)
            grads = torch.autograd.grad(value, leaves, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
            stats = {k: v.detach() if torch.is_tensor(v) else torch.tensor(v)
                     for k, v in stats.items()}
            if total_g is None:
                total_g, total_s = grads, stats
            else:
                total_g = [a + b for a, b in zip(total_g, grads)]
                total_s = {k: total_s[k] + stats[k] for k in total_s}
        if n_micro > 1:
            if not train_cfg.accum_sum:
                total_g = [g / n_micro for g in total_g]
            total_s = {k: v / n_micro for k, v in total_s.items()}
        return {n: torch.nan_to_num(g) for n, g in zip(names, total_g)}, total_s

    def train_step(state: GANTrainState, batch, generator, on_phase=None) -> dict:
        """One step; ``on_phase(phase)``, when given, is called after each
        phase's optimizer step (chip_smoke.py records a CUDA event there)."""
        stats = {}
        cur_nimg, aug_p = state.cur_nimg, state.aug_p
        bs = batch["image"].shape[0]
        gen_z = draws.normal((bs, z_dim), generator, batch["image"].device, "step z")
        gen_c = batch["camera"]
        for phase in active_phases:
            if phase == "Gmain":
                def fn(mb, z, c, g):
                    return loss.g_main_loss(mb, z, c, g, cur_nimg, aug_p=aug_p)
            elif phase in views:
                def fn(mb, z, c, g, v=views[phase]):
                    return loss.g_cond_loss(mb, z, g, view=v)
            elif phase == "Greg":
                def fn(mb, z, c, g):
                    return loss.g_reg_loss(mb, z, c, g, cur_nimg,
                                           gain=float(train_cfg.g_reg_interval))
            elif phase == "Dmain":
                def fn(mb, z, c, g):
                    return loss.d_main_loss(mb, z, c, g, cur_nimg, aug_p=aug_p)
            elif phase == "Dreg":
                def fn(mb, z, c, g):
                    return loss.d_reg_loss(mb, c, g, cur_nimg,
                                           gain=float(train_cfg.d_reg_interval), aug_p=aug_p)
            else:
                raise ValueError(phase)
            opt = state.opt_D if phase.startswith("D") else state.opt_G
            grads, s = accumulate(fn, opt.params, batch, gen_z, gen_c, generator)
            if phase.startswith("D") and frozen:
                grads = {n: torch.zeros_like(g) if _frozen(n, frozen) else g
                         for n, g in grads.items()}
            opt.step(grads)
            stats.update(s)
            if on_phase is not None:
                on_phase(phase)
        update_ema(state, train_cfg)
        state.cur_nimg += train_cfg.batch_size
        return stats

    return train_step


@torch.no_grad()
def update_ema(state: GANTrainState, train_cfg: TrainConfig) -> None:
    """G_ema lerp (training_loop_v0.py:381-392): params p + (e - p) * beta,
    buffers copied from G; beta = 0.5^(batch / ema_nimg) in f32, as the
    JAX step computes it, passed as a Python scalar."""
    f32 = np.float32
    ema_nimg = f32(train_cfg.ema_kimg * 1000)
    if train_cfg.ema_rampup is not None:
        ema_nimg = min(ema_nimg, f32(state.cur_nimg) * f32(train_cfg.ema_rampup))
    beta = float(f32(0.5) ** (f32(train_cfg.batch_size) / max(ema_nimg, f32(1e-8))))
    ema = dict(state.G_ema.named_parameters())
    names = [n for n, _ in state.G.named_parameters()]
    p = [t for _, t in state.G.named_parameters()]
    e = [ema[n] for n in names]
    torch._foreach_copy_(e, torch._foreach_add(p, torch._foreach_mul(torch._foreach_sub(e, p),
                                                                      beta)))
    ema_buf = dict(state.G_ema.named_buffers())
    for n, b in state.G.named_buffers():
        ema_buf[n].copy_(b)


def ada_update(state: GANTrainState, signs_real: float, ada_target: float, batch_size: int,
               ada_interval: int, ada_kimg: float) -> None:
    """The ADA heuristic (training_loop_v0.py:398-402): p moves toward the
    target rate of positive real logits by sign(signs_real - target) x
    batch x interval / (kimg x 1000), clamped at 0, in f32 as the JAX
    package's state keeps it."""
    f32 = np.float32
    adjust = float(np.sign(signs_real - ada_target)) * (batch_size * ada_interval) / (
        ada_kimg * 1000)
    state.aug_p = float(max(f32(state.aug_p) + f32(adjust), f32(0.0)))


def phases_for_step(step: int, cfg: TrainConfig) -> Tuple[str, ...]:
    """Which phases run at this step (interval gating)."""
    out = []
    for ph in cfg.phases:
        if ph in ("Greg", "Gpl"):
            if step % cfg.g_reg_interval == 0:
                out.append(ph)
        elif ph == "Dreg":
            if step % cfg.d_reg_interval == 0:
                out.append(ph)
        else:
            out.append(ph)
    return tuple(out)
