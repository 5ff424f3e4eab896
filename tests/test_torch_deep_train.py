"""Training at triplane_depth 2 in the port against the JAX package (CPU,
f32):

- K10's backward form's plain version (autograd of the deep decode:
  sample_from_planes' trilinear sample in zeros padding, the plane mean,
  OSGDecoder and the density filters) against jax.vjp of the JAX
  sample_from_planes at depth 2 plus the decode and the filters, under the
  same random output gradients: the gradient to the planes (brought back
  from K10's channels-last volumes) and to the decoder's four tensors, at
  points whose projected depth straddles the volumes' zero padding; and
  TriplaneDecodeDeep on CPU tensors, the volumes made from planes that
  require grad by deep_volumes_cl, gives the planes the same gradient
  through the permute;
- one train step of the tiny rig at triplane_depth 2 (tests/
  torch_train_rig.py; const noise, the key-free render) against the JAX
  step, as tests/test_torch_train_step.py holds the depth-1 step: the JAX
  step's latents and regulariser points replayed, Adam's moments, the
  counts, the parameters and G_ema.

Tolerances: the decode's gradients within 1e-5 relative L2 (f32 on both
sides, sums in another order); the step's as test_torch_train_step.py's
(moments within 1e-3 relative L2 a tensor, parameters within 2.5e-2 x lr,
Adam's eps 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_train_rig as R
from panic3d_tpu.models.triplane import OSGDecoder as JDecoder
from panic3d_tpu.models.volumetric import renderer as jvr
from panic3d_tpu.training import TrainConfig as JTrainConfig
from panic3d_tpu.training import build_train_step as j_build_train_step
from panic3d_tpu.training import init_state as j_init_state
from panic3d_tpu_torch.kernels import launch_counts
from panic3d_tpu_torch.models.volumetric import renderer as tvr
from panic3d_tpu_torch.training import TrainConfig, build_train_step, init_state
from panic3d_tpu_torch.utils.draws import Replay
from torch_one_thread import torch_one_thread  # noqa: F401  (autouse)

DEPTH = 2
BW = 0.7
FILTERS = (0.1, 0.5)   # the crop and the cull: their sigmas take no gradient


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_deep_decode_gradient_matches_jax_vjp():
    r = np.random.RandomState(41)
    N, C, H, W, M = 2, 8, 9, 7, 400
    planes = r.randn(N, 3, C * DEPTH, H, W).astype(np.float32)
    # world points up to 0.45 from the centre: up to 1.29 after 2 / box_warp,
    # so the projected depth of many lies in the volumes' zero padding
    coords = r.uniform(-0.45, 0.45, (N, M, 3)).astype(np.float32)
    p = {"net0": {"weight": r.randn(64, C).astype(np.float32),
                  "bias": (r.randn(64) * 0.1).astype(np.float32)},
         "net2": {"weight": r.randn(33, 64).astype(np.float32),
                  "bias": (r.randn(33) * 0.1 + np.eye(33)[0] * 2.5).astype(np.float32)}}
    g_rgb = r.randn(N, M, 32).astype(np.float32)
    g_sigma = r.randn(N, M, 1).astype(np.float32)
    axes = jvr.generate_plane_axes(True)
    dec = JDecoder(C)

    def decode(planes_, params):
        fn = lambda feats, **kw: dec.apply({"params": params}, feats, force_sigmoid=True,  # noqa
                                           **kw)
        rgb, sigma = jvr.run_model(axes, planes_, fn, jnp.asarray(coords), BW, DEPTH)
        return rgb, jvr._apply_density_filters(sigma, jnp.asarray(coords), BW, *FILTERS, None)

    @jax.jit
    def vjp(planes_, params):
        _, f = jax.vjp(decode, planes_, params)
        return f((jnp.asarray(g_rgb), jnp.asarray(g_sigma)))

    want_planes, want_dec = vjp(jnp.asarray(planes), jax.tree_util.tree_map(jnp.asarray, p))
    # at least a fifth of the points have a projected depth in the padding
    # on some plane, and the planes' gradient reaches both depth slices
    depth_coord = np.abs(coords * 2 / BW).max(-1)
    assert (depth_coord > 0.5).mean() > 0.2

    t = torch.from_numpy
    tdec = tvr.Decoder(t(p["net0"]["weight"]), t(p["net0"]["bias"]), t(p["net2"]["weight"]),
                       t(p["net2"]["bias"]), 1.0, True)
    filters = tvr.DensityFilters(*FILTERS)
    taxes = tvr.generate_plane_axes(True)
    vols = tvr.deep_volumes_cl(t(planes), DEPTH)
    g_vols, *g_dec = tvr.triplane_decode_deep_grad_plain(vols, t(coords), tdec, BW, taxes,
                                                         filters, t(g_rgb), t(g_sigma))
    got_planes = g_vols.permute(0, 4, 1, 2, 3).reshape(planes.shape)
    assert rel_l2(got_planes, want_planes) <= 1e-5
    assert np.abs(np.asarray(want_planes)[:, :, 1::DEPTH]).max() > 0   # the second slice
    for got, (layer, name) in zip(g_dec, (("net0", "weight"), ("net0", "bias"),
                                          ("net2", "weight"), ("net2", "bias"))):
        assert rel_l2(got, want_dec[layer][name]) <= 1e-5, (layer, name)

    # the autograd.Function on CPU tensors: the planes' gradient through
    # deep_volumes_cl's permute
    leaf = t(planes).requires_grad_(True)
    rgb, sigma = tvr.TriplaneDecodeDeep.apply(
        tvr.deep_volumes_cl(leaf, DEPTH), t(coords), tdec.w0, tdec.b0, tdec.w1, tdec.b1,
        (1.0, True, BW, taxes, filters))
    (g_leaf,) = torch.autograd.grad((rgb, sigma), leaf, (t(g_rgb), t(g_sigma)))
    assert rel_l2(g_leaf, want_planes) <= 1e-5
    assert sum(launch_counts().values()) == 0


PHASES = ("Greg", "Gmain", "Gcond", "Dmain")   # Dreg (R1) runs no G code: left out for the clock
EPS = 1e-4   # Adam's eps, above the rounding-sized gradients (test_torch_train_step.py)


def _moments(opt, key):
    return {n: getattr(opt, key)[n].numpy() for n in opt.params}


def test_depth2_train_step_matches_jax(monkeypatch):
    g, d, vG, vD, _, batch = R.rig(DEPTH)
    assert g.triplane_depth == DEPTH
    spy = R.Spy(monkeypatch)
    jcfg = JTrainConfig(batch_size=R.BS, phases=PHASES, eps=EPS)
    jstep = j_build_train_step(R.jax_loss(DEPTH), jcfg, g.z_dim, PHASES)

    @jax.jit
    def run(state, key):
        spy.clear()
        new, _ = jstep(state, batch, key)
        return new, spy.taken()

    jstate, taken = run(j_init_state(vG, vD, jcfg), jax.random.PRNGKey(3))
    G, D, lp = R.torch_models(DEPTH)
    assert G.triplane_depth == DEPTH
    before = {n: p.detach().clone() for n, p in G.named_parameters()}
    cfg = TrainConfig(batch_size=R.BS, phases=PHASES, eps=EPS)
    state = init_state(G, D, cfg)
    step = build_train_step(R.torch_loss(G, D, lp), cfg, G.z_dim, PHASES)
    gen = Replay(normal=[np.asarray(x) for x in taken["normal"]],
                 uniform=[np.asarray(x) for x in taken["uniform"]])
    stats = step(state, R.torch_batch(), gen)
    assert gen.left() == {"normal": 0, "uniform": 0}
    assert np.isfinite([float(v) for v in stats.values()]).all()
    assert state.cur_nimg == int(jstate.cur_nimg) == R.BS
    assert state.opt_G.count == 3 and state.opt_D.count == 1
    for opt, jopt in ((state.opt_G, jstate.opt_G), (state.opt_D, jstate.opt_D)):
        assert int(jopt[0].count) == opt.count
        for key in ("mu", "nu"):
            R.check_grads(_moments(opt, key), R.flat_params(getattr(jopt[0], key)), rel=1e-3)
    lr = {"G": 0.0025 * 4 / 5, "D": 0.002 * 16 / 17}
    for name, got, want in (("G", G, jstate.vars_G["params"]), ("D", D, jstate.vars_D["params"]),
                            ("G", state.G_ema, jstate.vars_Gema["params"])):
        want = R.flat_params(want)
        diffs = np.concatenate([np.abs(p.detach().numpy() - want[n]).ravel()
                                for n, p in got.named_parameters()])
        assert diffs.max() <= 2.5e-2 * lr[name], (name, diffs.max())
    moved = [float((p.detach() - before[n]).abs().max()) for n, p in G.named_parameters()]
    assert max(moved) > 0.5 * lr["G"]
