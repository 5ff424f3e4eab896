"""The tiny training rig shared by the port's training tests
(tests/test_training.py:40-92, cut to the train-step canary's render size):
one numpy-seeded set of G, D and LPIPS weights in the flax trees' shapes,
loaded into both packages (the port through state_dict_from_flax), the JAX
package's synthetic batch, and both packages' loss phases over them. Pinned
to f32 (no bf16 blocks, an f32 render) with the backbone's const noise and
the key-free render (midpoint depths, linspace u): the draws left are the
step's latents and the density regulariser's points, which the tests take
from the JAX package (a spy on jax.random.normal / uniform) and hand to the
port as a utils/draws.Replay (ROADMAP F6)."""

import contextlib
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from panic3d_tpu import configs as jcfg
from panic3d_tpu.data.dataset import synthetic_batch
from panic3d_tpu.models.dual_discriminator import DualDiscriminator as JD
from panic3d_tpu.models.triplane import TriPlaneGenerator as JG
from panic3d_tpu.training import LossConfig as JLossConfig
from panic3d_tpu.eval.lpips import LPIPS as JLPIPS
from panic3d_tpu.training.setup import make_loss as j_make_loss
from panic3d_tpu_torch import configs as tcfg
from panic3d_tpu_torch.eval.lpips import LPIPS
from panic3d_tpu_torch.models.dual_discriminator import DualDiscriminator as TD
from panic3d_tpu_torch.runtime.checkpoint import state_dict_from_flax
from panic3d_tpu_torch.training.loss import LossConfig as TLossConfig
from panic3d_tpu_torch.training.setup import make_loss as t_make_loss

torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def torch_threads(n: int):
    """torch on ``n`` threads for the duration (beside the other test
    workers, torch's default threads oversubscribe the cores: ROADMAP
    "Tier-1 time"), then back."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)

BS, IMG, RAW = 2, 128, 8
G_KW = dict(
    img_resolution=IMG, backbone_resolution=32, neural_rendering_resolution=RAW,
    cond_mode="ortho_front.add_4.reschonk_add_16",
    synthesis_kwargs=dict(channel_base=2048, channel_max=64, num_fp16_res=0),
    sr_num_fp16_res=0,
    rendering_kwargs=dict(
        superresolution_module="training.superresolution.SuperresolutionHybrid2X",
        depth_resolution=4, depth_resolution_importance=4, box_warp=0.7, ray_start=0.5,
        ray_end=1.5, white_back=True, use_triplane=True, render_dtype="float32"),
)
D_KW = dict(c_dim=25, img_resolution=IMG, img_channels=3, channel_base=1024, channel_max=32,
            num_fp16_res=0, epilogue_kwargs=dict(mbstd_group_size=2))
LOSS_KW = dict(r1_gamma=4.0, neural_rendering_resolution_initial=RAW)


def g_kw(depth: int = 1) -> dict:
    """G_KW at triplane_depth ``depth`` (deep planes when > 1)."""
    if depth == 1:
        return G_KW
    return dict(G_KW, rendering_kwargs=dict(G_KW["rendering_kwargs"], triplane_depth=depth))


def fill(seed):
    """N(0,1) weights, biases 0.1 N(0,1) (around 1 for the affines),
    noise strengths 0.1 N(0,1), +2.5 on sigma's bias."""
    r = np.random.RandomState(seed)

    def one(path, leaf):
        names = [p.key for p in path]
        a = np.asarray(r.randn(*leaf.shape), np.float32)
        if names[-1] == "bias":
            a = a * 0.1 + (1.0 if names[-2] == "affine" else 0.0)
        elif names[-1] == "noise_strength":
            a = a * 0.1
        if names[-3:] == ["decoder", "net2", "bias"]:
            a[0] += 2.5
        return a
    return one


def jax_batch():
    return jax.tree_util.tree_map(jnp.asarray, synthetic_batch(bs=BS, size=IMG, chonk_ch=16,
                                                               feat_dim=32))


def torch_tree(tree):
    if isinstance(tree, dict):
        return {k: torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32))


def rig(depth: int = 1):
    """(g, d, vars_G, vars_D, lpips_vars, batch) of the JAX package, numpy;
    G at triplane_depth ``depth``; built once a depth (rig() and rig(1) are
    one rig)."""
    return _rig(depth)


@functools.lru_cache(maxsize=None)
def _rig(depth):
    g, d = jcfg.tiny(**g_kw(depth)), JD(**D_KW)
    batch = jax_batch()
    xin = {"z": jnp.zeros((BS, g.z_dim)), "camera_params": batch["camera"],
           "cond": batch["cond"]}
    sg = jax.eval_shape(lambda: g.init({"params": jax.random.PRNGKey(0)}, xin, method=JG.f,
                                       noise_mode="const"))
    img = {"image": batch["image"], "image_raw": jnp.zeros((BS, 3, RAW, RAW))}
    sd = jax.eval_shape(lambda: d.init({"params": jax.random.PRNGKey(0)}, img, batch["camera"],
                                       batch["cond"]))
    vars_G = jax.tree_util.tree_map_with_path(fill(0), sg)
    vars_D = jax.tree_util.tree_map_with_path(fill(1), sd)
    x = jnp.zeros((1, 3, 64, 64))
    sl = jax.eval_shape(lambda: JLPIPS().init(jax.random.PRNGKey(0), x, x))
    r = np.random.RandomState(2)

    def lpips_leaf(path, leaf):   # He-scaled convs, small biases, heads around 0.1
        a = r.randn(*leaf.shape).astype(np.float32)
        if len(leaf.shape) == 4:
            return a * np.float32(np.sqrt(2.0 / np.prod(leaf.shape[1:])))
        return a * np.float32(0.01) + (np.float32(0.1) if path[-1].key.startswith("lin") else 0)
    lpips_vars = jax.tree_util.tree_map_with_path(lpips_leaf, sl)
    return g, d, vars_G, vars_D, lpips_vars, batch


def jax_loss(depth: int = 1, **loss_kw):
    g, d, _, _, lpips_vars, _ = rig(depth)
    cfg = JLossConfig(**dict(LOSS_KW, **loss_kw))
    return j_make_loss(g, d, lpips_vars, cfg, noise_mode="const", deterministic=True)


def torch_models(depth: int = 1):
    """The port's G, D and LPIPS with the rig's weights (CPU, f32)."""
    _, _, vars_G, vars_D, lpips_vars, _ = rig(depth)
    G = tcfg.tiny(device="cpu", **g_kw(depth))
    G.load_state_dict(state_dict_from_flax(vars_G), strict=True)
    D = TD(**D_KW)
    D.load_state_dict(state_dict_from_flax(vars_D), strict=True)
    lp = LPIPS(device="cpu").load_variables(lpips_vars)
    return G, D, lp


def torch_loss(G, D, lp, **loss_kw):
    cfg = TLossConfig(**dict(LOSS_KW, **loss_kw))
    return t_make_loss(G, D, lp, cfg, noise_mode="const", deterministic=True)


def torch_batch():
    return torch_tree(jax.tree_util.tree_map(np.asarray, rig()[5]))


class Spy:
    """Records the values jax.random.normal / uniform return to the JAX
    package's training code (training/loss.py and loop.py: the step's
    latents, the regulariser's points; flax's parameter shape checks draw
    too, inside eval_shape, and are left out) while a JAX function is
    traced, in order by kind (return them from the jitted function beside
    its outputs)."""

    CALLERS = ("panic3d_tpu/training/loss.py", "panic3d_tpu/training/loop.py")

    def __init__(self, monkeypatch):
        self.rec = {"normal": [], "uniform": []}
        for kind in self.rec:
            real = getattr(jax.random, kind)

            def spy(*args, _real=real, _kind=kind, **kwargs):
                out = _real(*args, **kwargs)
                if sys._getframe(1).f_code.co_filename.endswith(self.CALLERS):
                    self.rec[_kind].append(out)
                return out
            monkeypatch.setattr(jax.random, kind, spy)

    def clear(self):
        for v in self.rec.values():
            v.clear()

    def taken(self):
        return {k: list(v) for k, v in self.rec.items()}


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def flat_params(tree, prefix=()):
    """A flax params tree -> {torch name: array} (the bridge's names)."""
    sd = state_dict_from_flax({"params": jax.tree_util.tree_map(np.asarray, tree)})
    return {k: v.numpy() for k, v in sd.items()}


def check_grads(got: dict, want: dict, rel: float = 1e-4, floor_rel: float = 2e-4):
    """Per parameter tensor: a relative L2 error <= ``rel``; a tensor whose
    gradient norm is under 5 % of the largest one of the phase (sums that
    nearly cancel: noise strengths, biases whose terms cancel) is held to
    an L2 error <= ``floor_rel`` x that largest norm instead. -> (the
    number of tensors compared, the number held by the floor)."""
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    big = max(float(np.linalg.norm(w)) for w in want.values())
    assert big > 0
    floored = 0
    for n, w in want.items():
        g = got[n]
        err = float(np.linalg.norm(np.asarray(g, np.float64) - np.asarray(w, np.float64)))
        norm = float(np.linalg.norm(w))
        if norm >= 0.05 * big:
            assert err <= rel * norm, f"{n}: relative L2 error {err / norm:.3g} > {rel}"
        else:
            floored += 1
            assert err <= floor_rel * big, f"{n}: L2 error {err:.3g} > {floor_rel} x {big:.3g}"
    return len(want), floored


def torch_grads(module, value):
    """{name: gradient of ``value``} over the module's parameters (zeros
    where it does not reach)."""
    params = dict(module.named_parameters())
    grads = torch.autograd.grad(value, list(params.values()), allow_unused=True)
    return {n: (torch.zeros_like(p) if g is None else g).detach().numpy()
            for (n, p), g in zip(params.items(), grads)}
