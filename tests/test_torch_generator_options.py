"""The generator options the port took over from the JAX package, against
that package on the CPU (f32).

The backbone alone (stylegan2.Generator at 16^2, 64 channels) for every
cond-mode token and each architecture, on numpy-seeded variables in the
flax tree's shapes loaded through state_dict_from_flax; the z+
mapping; a synthesis layer with noise_mode='random' fed the JAX draw; the
three superresolution modules the port had lacked; the tiny G.f keyed as
training runs it (random backbone and SR noise, a render key) with the JAX
draws recorded and fed back in order (utils/draws.Replay); the configs of
a trainer's --tiny snapshot and of the flat legacy form, and the --tiny
one's G.f on the JAX package's own initialisation; and
Reconstructor(ckpt=) on a tiny snapshot the JAX save_checkpoint wrote with
the trainer's model_kwargs. The draws are recorded by a spy on
jax.random.normal / uniform inside the jitted JAX function, which returns
them beside its outputs.
"""

import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panic3d_tpu import configs as jcfg
from panic3d_tpu.api import Reconstructor as JRec
from panic3d_tpu.models import stylegan2 as js
from panic3d_tpu.models import superresolution as jsr
from panic3d_tpu.models.triplane import TriPlaneGenerator as JG
from panic3d_tpu.runtime import checkpoint as jck
from panic3d_tpu_torch import configs as tcfg
from panic3d_tpu_torch.api import Reconstructor
from panic3d_tpu_torch.models import stylegan2 as ts
from panic3d_tpu_torch.models import superresolution as tsr
from panic3d_tpu_torch.runtime.checkpoint import state_dict_from_flax
from panic3d_tpu_torch.utils import draws

from test_torch_api import jax_views
from test_torch_generator import F32, IMAGE_TOL, STAGE_TOL, seeded_variables
from torch_one_thread import torch_one_thread  # noqa: F401  (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)      # one network, f32 on both sides
BS = 2
# the backbone at 16^2: three levels of 64 channels, a 16^2 front image
BACKBONE = dict(z_dim=16, c_dim=4, w_dim=16, img_resolution=16, img_channels=6,
                mapping_kwargs=dict(num_layers=2),
                synthesis_kwargs=dict(channel_base=1024, channel_max=64, num_fp16_res=0))


def cond_inputs(seed=0, size=16):
    r = np.random.RandomState(seed)

    def img():
        return r.rand(BS, 3, size, size).astype(np.float32)

    return {"image_ortho_front": img(), "image_ortho_left": img(), "image_ortho_right": img(),
            "image_dorthoA_left": img(), "image_dorthoA_right": img(),
            "resnet_chonk": r.randn(BS, 16, 8, 8).astype(np.float32),
            "resnet_feats": r.randn(BS, 8).astype(np.float32)}


@pytest.fixture
def recorded(monkeypatch):
    """-> start(): installs spies on jax.random.normal and uniform and
    returns the draws they record while a JAX function is traced, by kind
    and in order. The parameters' init functions (lambdas, which flax
    traces to check shapes in apply too) are not recorded."""
    rec = {"normal": [], "uniform": []}

    def start():
        for kind in rec:
            real = getattr(jax.random, kind)

            def spy(*args, _real=real, _kind=kind, **kwargs):
                out = _real(*args, **kwargs)
                if sys._getframe(1).f_code.co_name != "<lambda>":
                    rec[_kind].append(out)
                return out

            monkeypatch.setattr(jax.random, kind, spy)
        return rec

    return start


def numpy_variables(module, *args, seed=0, **kwargs):
    """Seeded variables in ``module``'s flax tree shapes (jax.eval_shape of
    its init, no compile): N(0,1) weights, small biases (the affines' around
    1) and noise strengths, so that every path carries a signal."""
    shapes = jax.eval_shape(lambda: module.init({"params": jax.random.PRNGKey(0)}, *args,
                                                **kwargs))
    r = np.random.RandomState(seed)

    def fill(path, leaf):
        names = [p.key for p in path]
        a = np.asarray(r.randn(*leaf.shape), np.float32)
        if names[-1] == "bias":
            a = a * 0.1 + (1.0 if names[-2] == "affine" else 0.0)
        elif names[-1] == "noise_strength":
            a = a * 0.1
        return a

    return jax.tree_util.tree_map_with_path(fill, shapes)


# each token of panic3d_tpu/models/stylegan2.py:_apply_cond and the
# mapping's resnetcond_N, each in at least one mode
COND_MODES = [
    "ortho_front.add_4.reschonk_add_16",
    "ortho_front.gt_sides.add_4",
    "ortho_front.dorthoA.cond_img_norm_4.add_4",
    "ortho_front.concatfront",
    "ortho_front.add_shuffle2_4.reschonk_add_16",
    "ortho_front.mult_shuffle2_4",
    "ortho_front.add_4.inj_6b_4",
    "ortho_front.add_4.crossavg_4.resnetcond_8",
    "crossavgt_38",
]
ARCHITECTURES = ["skip", "resnet", "orig"]
# (cond mode, architecture) of every backbone case
BACKBONE_CASES = {**{f"cond:{cm}": (cm, "skip") for cm in COND_MODES},
                  **{f"arch:{a}": ("none", a) for a in ARCHITECTURES}}


def backbone_kwargs(case):
    cond_mode, architecture = BACKBONE_CASES[case]
    return dict(BACKBONE, cond_mode=cond_mode,
                synthesis_kwargs=dict(BACKBONE["synthesis_kwargs"], architecture=architecture))


def backbone_inputs():
    r = np.random.RandomState(1)
    return r.randn(BS, 16).astype(np.float32), r.randn(BS, 4).astype(np.float32), cond_inputs()


@functools.lru_cache(maxsize=1)
def jax_backbones():
    """Every backbone case's variables and JAX output, the outputs from one
    jitted function (one compile for all cases). -> ({case: variables},
    {case: output})."""
    z, c, cond = backbone_inputs()
    jz, jc_ = jnp.asarray(z), jnp.asarray(c)
    jcond = {k: jnp.asarray(v) for k, v in cond.items()}
    gens = {case: js.Generator(**backbone_kwargs(case)) for case in BACKBONE_CASES}
    variables = {case: numpy_variables(g, jz, jc_, jcond, noise_mode="const")
                 for case, g in gens.items()}
    outs = jax.jit(lambda vs: {case: g.apply(vs[case], jz, jc_, jcond, noise_mode="const")
                               for case, g in gens.items()})(variables)
    return variables, {case: np.asarray(o) for case, o in outs.items()}


def backbone_pair(case):
    """The port's backbone of ``case`` on the JAX case's variables, and the
    JAX output. -> (port output, JAX output)."""
    variables, outs = jax_backbones()
    G = ts.Generator(**backbone_kwargs(case)).eval()
    G.load_state_dict(state_dict_from_flax(variables[case]), strict=True)
    z, c, cond = backbone_inputs()
    with torch.no_grad():
        got = G(torch.from_numpy(z), torch.from_numpy(c),
                {k: torch.from_numpy(v) for k, v in cond.items()}, noise_mode="const")
    return got, outs[case]


@pytest.mark.parametrize("cond_mode", COND_MODES)
def test_cond_mode_matches_jax(cond_mode):
    got, want = backbone_pair(f"cond:{cond_mode}")
    assert got.shape == want.shape == (BS, 6, 16, 16)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("architecture", ARCHITECTURES)
def test_architecture_matches_jax(architecture):
    got, want = backbone_pair(f"arch:{architecture}")
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    G = ts.Generator(**dict(BACKBONE, synthesis_kwargs=dict(
        BACKBONE["synthesis_kwargs"], architecture=architecture)))
    names = set(G.state_dict())
    assert ("synthesis.b8.skip.weight" in names) == (architecture == "resnet")
    assert ("synthesis.b8.torgb.weight" in names) == (architecture == "skip")
    assert "synthesis.b16.torgb.weight" in names


def test_zplus_mapping_and_stop_level_match_jax():
    kw = dict(BACKBONE, cond_mode="ortho_front.add_4.resnetcond_8")
    g = js.Generator(**kw)
    r = np.random.RandomState(2)
    zs = r.randn(BS, 6, 16).astype(np.float32)
    c = r.randn(BS, 4).astype(np.float32)
    cond = cond_inputs(3)
    jc = {k: jnp.asarray(v) for k, v in cond.items()}
    variables = numpy_variables(g, jnp.asarray(zs[:, 0]), jnp.asarray(c), jc, seed=1,
                                noise_mode="const")
    G = ts.Generator(**kw).eval()
    G.load_state_dict(state_dict_from_flax(variables), strict=True)
    assert G.num_ws == 6
    # mapping_zplus's diagonal: slot i from z_i (triplane.py:123-143)
    zs6 = zs

    def zplus(v, zs_):
        c_new = jnp.repeat(jnp.asarray(c)[:, None], 6, 1).reshape(BS * 6, -1)
        cn = dict(jc, resnet_feats=jnp.repeat(jc["resnet_feats"][:, None], 6, 1).reshape(BS * 6, -1))
        w = g.apply(v, zs_.reshape(BS * 6, 16), c_new, cn, method=lambda m, *a: m.mapping(*a))
        return w.reshape(BS, 6, 6, -1)[:, jnp.arange(6), jnp.arange(6)]

    want = np.asarray(jax.jit(zplus)(variables, jnp.asarray(zs6)))
    tc = {k: torch.from_numpy(v) for k, v in cond.items()}
    tG = tcfg.tiny(device="cpu")          # mapping_zplus lives on the TriPlaneGenerator
    tG.backbone = G
    tG.rk["c_gen_conditioning_zero"], tG.rk["c_scale"] = False, 1.0
    with torch.no_grad():
        got = tG.mapping_zplus(torch.from_numpy(zs6), torch.from_numpy(c), tc)
        img = G.synthesis(got, tc, stop_level=1)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    want_img = jax.jit(lambda v, w: g.apply(v, w, jc, stop_level=1, noise_mode="const",
                                            method=lambda m, *a, **k: m.synthesis(*a, **k)))(
        variables, jnp.asarray(got.numpy()))
    np.testing.assert_allclose(img.numpy(), np.asarray(want_img), **TOL)


def test_random_noise_layer_with_jax_draw(recorded):
    layer = js.SynthesisLayer(8, 8, w_dim=16, resolution=8, up=2)
    r = np.random.RandomState(4)
    x, w = r.randn(BS, 8, 4, 4).astype(np.float32), r.randn(BS, 16).astype(np.float32)
    variables = numpy_variables(layer, jnp.asarray(x), jnp.asarray(w), seed=2, noise_mode="const")
    variables["params"]["noise_strength"] = np.float32(0.7)
    recorded = recorded()

    def run(v, key):
        recorded["normal"].clear()
        out = layer.apply(v, jnp.asarray(x), jnp.asarray(w), noise_mode="random",
                          rngs={"noise": key})
        return out, list(recorded["normal"])

    want, (noise,) = jax.jit(run)(variables, jax.random.PRNGKey(5))
    assert noise.shape == (BS, 1, 8, 8)
    t_layer = ts.SynthesisLayer(8, 8, w_dim=16, resolution=8, up=2).eval()
    t_layer.load_state_dict(state_dict_from_flax(variables), strict=True)
    with torch.no_grad():
        got = t_layer(torch.from_numpy(x), torch.from_numpy(w), noise_mode="random",
                      noise=torch.from_numpy(np.asarray(noise)))
        const = t_layer(torch.from_numpy(x), torch.from_numpy(w), noise_mode="const")
        again = t_layer(torch.from_numpy(x), torch.from_numpy(w), noise_mode="random",
                        generator=draws.Replay(normal=[np.asarray(noise)]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert torch.equal(got, again) and not torch.equal(got, const)
    with pytest.raises(ValueError, match="generator"):
        t_layer(torch.from_numpy(x), torch.from_numpy(w), noise_mode="random")


@pytest.mark.parametrize("name", ["SuperresolutionHybrid8X", "SuperresolutionHybrid4X",
                                  "SuperresolutionHybridDeepfp32"])
def test_superresolution_module_matches_jax(name):
    # the JAX package's shape check (tests/test_metrics_extra.py:95), and
    # the output against it on the same weights
    out_res = 512 if name.endswith("8X") else 256
    kw = dict(channels=16, img_resolution=out_res, w_dim=16)
    r = np.random.RandomState(6)
    rgb = r.rand(1, 3, 64, 64).astype(np.float32)
    x = r.randn(1, 16, 64, 64).astype(np.float32)
    ws = r.randn(1, 5, 16).astype(np.float32)
    jm = jsr.SR_MODULES[name](**kw)
    variables = numpy_variables(jm, jnp.asarray(rgb), jnp.asarray(x), jnp.asarray(ws), seed=3,
                                noise_mode="const")
    want = jax.jit(lambda v: jm.apply(v, jnp.asarray(rgb), jnp.asarray(x), jnp.asarray(ws),
                                      noise_mode="const"))(variables)
    for key in (name, f"training.superresolution.{name}"):
        assert tsr.SR_MODULES[key] is tsr.SR_MODULES[name]
    tm = tsr.SR_MODULES[name](**kw).eval()
    tm.load_state_dict(state_dict_from_flax(variables), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(rgb), torch.from_numpy(x), torch.from_numpy(ws),
                 noise_mode="const")
    assert got.shape == want.shape == (1, 3, out_res, out_res)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_keyed_tiny_forward_with_jax_draws(recorded):
    """G.f as training runs it: random backbone and SR noise, a render key."""
    rk = dict(F32["rendering_kwargs"], superresolution_noise_mode="random")
    kw = dict(F32, rendering_kwargs=rk)
    g = jcfg.tiny(**kw)
    r = np.random.RandomState(7)
    a = {"z": r.randn(BS, 64).astype(np.float32),
         "image_ortho_front": r.rand(BS, 3, 64, 64).astype(np.float32),
         "resnet_chonk": r.randn(BS, 16, 8, 8).astype(np.float32)}
    xj = {"z": jnp.asarray(a["z"]), "elevations": jnp.asarray([0.0, 20.0]),
          "azimuths": jnp.asarray([0.0, 330.0]),
          "cond": {"image_ortho_front": jnp.asarray(a["image_ortho_front"]),
                   "resnet_chonk": jnp.asarray(a["resnet_chonk"])}}
    variables = seeded_variables(g, xj)
    recorded = recorded()

    def run(v, x, key):
        for q in recorded.values():
            q.clear()
        k_noise, k_render = jax.random.split(key)
        out = g.apply(v, dict(x, cull_clouds=0.5), method=JG.f, rngs={"noise": k_noise},
                      noise_mode="random", render_key=k_render)
        return out, dict(recorded)

    out_j, rec = jax.jit(run)(variables, xj, jax.random.PRNGKey(9))
    normal, uniform = [np.asarray(d) for d in rec["normal"]], [np.asarray(d) for d in rec["uniform"]]
    assert len(normal) == 9 + 4 and len(uniform) == 2     # 9 backbone layers, 4 SR layers
    G = tcfg.tiny(device="cpu", **kw).eval()
    G.load_state_dict(state_dict_from_flax(variables), strict=True)
    xt = {"z": torch.from_numpy(a["z"]), "elevations": torch.tensor([0.0, 20.0]),
          "azimuths": torch.tensor([0.0, 330.0]), "cull_clouds": 0.5,
          "cond": {k: torch.from_numpy(a[k]) for k in ("image_ortho_front", "resnet_chonk")}}
    rep = draws.Replay(normal=normal, uniform=uniform)
    with torch.no_grad():
        out_t = G.f(xt, noise_mode="random", generator=rep)
        other = G.f(xt, noise_mode="random", generator=torch.Generator().manual_seed(0))
    assert rep.left() == {"normal": 0, "uniform": 0}
    np.testing.assert_allclose(out_t["triplane"].numpy(), np.asarray(out_j["triplane"]),
                               **STAGE_TOL)
    for k in ("image_raw", "image_depth", "image_weights", "image"):
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]), err_msg=k,
                                   **IMAGE_TOL)
    assert not torch.equal(out_t["image"], other["image"])
    # a random mode without a generator or the draws raises
    with pytest.raises(ValueError, match="generator"):
        with torch.no_grad():
            G.f(xt, noise_mode="random")


def test_snapshot_configs_build_the_jax_packages():
    def same(gt, gj):
        for k in ("triplane_depth", "triplane_width", "img_resolution", "backbone_resolution",
                  "cond_mode", "force_sigmoid", "num_ws"):
            assert getattr(gt, k) == getattr(gj, k), k
        assert gt.rk == gj.rk

    legacy = {"cond_mode": "ortho_front.add_4.reschonk_add_512", "triplane_width": 16,
              "resolution": 256}
    with torch.device("meta"):
        gt = tcfg.from_snapshot_config(legacy, device="meta")
    gj = jcfg.from_snapshot_config(legacy)
    same(gt, gj)
    assert gt.backbone.synthesis.cond_mode == gj.cond_mode
    gt = tcfg.from_snapshot_config({"tiny": True}, eval_mode=True, device="cpu")
    gj = jcfg.from_snapshot_config({"tiny": True}, eval_mode=True)
    same(gt, gj)
    assert gt.cond_mode == "ortho_front.add_4.reschonk_add_16" and gt.force_sigmoid
    # its G.f on the JAX package's own initialisation (the sigma bias raised
    # so that something renders): the images within IMAGE_TOL; the planes
    # come out of bf16 blocks (num_fp16_res 4), within 2 % of their range
    r = np.random.RandomState(3)
    z, front = r.randn(BS, 64).astype(np.float32), r.rand(BS, 3, 64, 64).astype(np.float32)
    chonk = r.randn(BS, 16, 8, 8).astype(np.float32)
    xj = {"z": jnp.asarray(z), "elevations": jnp.asarray([0.0, 20.0]),
          "azimuths": jnp.asarray([0.0, 330.0]),
          "cond": {"image_ortho_front": jnp.asarray(front), "resnet_chonk": jnp.asarray(chonk)}}
    init = jax.jit(lambda key, x: gj.init({"params": key}, x, method=JG.f, noise_mode="const"))
    variables = jax.tree_util.tree_map(np.array, init(jax.random.PRNGKey(0), xj))
    variables["params"]["decoder"]["net2"]["bias"][0] += 2.5
    out_j = jax.jit(lambda v, x: gj.apply(v, x, method=JG.f, noise_mode="const"))(variables, xj)
    gt.eval().load_state_dict(state_dict_from_flax(variables), strict=True)
    xt = {"z": torch.from_numpy(z), "elevations": torch.tensor([0.0, 20.0]),
          "azimuths": torch.tensor([0.0, 330.0]),
          "cond": {"image_ortho_front": torch.from_numpy(front),
                   "resnet_chonk": torch.from_numpy(chonk)}}
    with torch.no_grad():
        out_t = gt.f(xt)
    planes_j = np.asarray(out_j["triplane"], np.float32)
    np.testing.assert_allclose(out_t["triplane"].float().numpy(), planes_j, rtol=0,
                               atol=0.02 * float(np.abs(planes_j).max()))
    for k in ("image_raw", "image_depth", "image_weights", "image"):
        np.testing.assert_allclose(out_t[k].float().numpy(), np.asarray(out_j[k], np.float32),
                                   err_msg=k, **IMAGE_TOL)


def test_reconstructor_ckpt_of_a_trainer_tiny_snapshot(tmp_path):
    """The trainer's --tiny snapshot (model_kwargs of trainer.py:258-261, the
    add_4 cond mode, bf16 blocks) written by the JAX save_checkpoint, on
    seeded weights in the flax tree: the port loads it exactly and renders it
    within the JAX package's bf16 bounds (test_reference_parity's
    test_bf16_close: 0.05 on the raw image and depth, 0.08 on the image)."""
    mk = dict(family="tiny", cond_mode="ortho_front.add_4.reschonk_add_16")
    g = jcfg.from_snapshot_config({"model_kwargs": mk}, eval_mode=True)
    img = np.random.RandomState(6).rand(3, 64, 64).astype(np.float32)
    cond = JRec(model=g, variables=None).preprocess(img)
    x = {"z": jnp.zeros((1, 64)), "elevations": jnp.zeros(1), "azimuths": jnp.zeros(1),
         "fovs": jnp.full((1,), 30.0), "cond": cond}
    variables = jax.tree_util.tree_map(np.array, seeded_variables(g, x, seed=4))
    path = str(tmp_path / "G")
    jck.save_checkpoint(path, {"vars_Gema": variables}, {"model_kwargs": mk})
    jrec = JRec(ckpt=path, seed=0)
    rec = Reconstructor(ckpt=path, seed=0, device="cpu")
    assert rec.g.cond_mode == mk["cond_mode"]
    want_sd = state_dict_from_flax(variables)
    assert set(rec.g.state_dict()) == set(want_sd)
    for k, v in want_sd.items():
        assert torch.equal(rec.g.state_dict()[k], v), k
    cond_t = rec.preprocess(img)
    want = jax_views(jrec, jrec.preprocess(img), [0.0], [30.0], [30.0])
    got = rec.views(cond_t, [0.0], [30.0], [30.0])
    for k, tol in (("image_raw", 0.05), ("image", 0.08), ("image_depth", 0.05)):
        if k in got:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol, err_msg=k)
