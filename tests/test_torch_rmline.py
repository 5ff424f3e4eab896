"""The port's line filler and ResNet-PCA loading (utils/sketchers.py,
models/rmlinegan.py, runtime/convert.py, models/resnet.py:load_pca_extractor)
and eval generate with a checkpoint, against the JAX package on the CPU:

- gaussian_blur2d and batch_dog within 2e-6 (XLA's conv and F.conv2d sum
  in other orders); facehull exactly, on random keypoints, keypoints off
  the image and collinear eyes;
- RMLineGenerator on 64^2 with the JAX module's variables (random BatchNorm
  statistics), through module_state_from_flax, within 1e-5;
- RMLineWrapper end to end: the DoG pixels that cross the 0.5 threshold in
  one package and not the other are counted apart (each within 1e-5 of
  it, at most 4), the line masks equal elsewhere, the filled image within
  1e-5 where the masks agree;
- convert_rmline and convert_resnet50 give the JAX converters' trees;
- load_pca_extractor and the JAX one read the same weights and basis from
  one directory written by the JAX package's save_checkpoint;
- generate.main --ckpt (tiny, 16^3 mesh, --device cpu) with ``rmline/`` and
  ``resnet/`` beside the G directory: its cond equals the JAX pieces called
  as panic3d_tpu/eval/generate.py:281-296 calls them (the filled image
  within 1e-5 with mask flips counted, the features within 1e-4 of their
  scale), its stages include 'rmline', and Reconstructor.preprocess with
  the same pieces gives the same cond;
- F14: the JAX Reconstructor.preprocess calls the extractor with
  ``img * 2 - 1`` of shape [1,3,H,W] and fails (jax.eval_shape), while the
  extractor's own contract, [3,H,W], gives [2, 512, 8, 8].
"""

import argparse
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panic3d_tpu import configs as jcfg
from panic3d_tpu.api import Reconstructor as JRec
from panic3d_tpu.eval import generate as jgen
from panic3d_tpu.models import resnet as jres
from panic3d_tpu.models import rmlinegan as jrm
from panic3d_tpu.runtime import checkpoint as jck
from panic3d_tpu.runtime import convert as jconv
from panic3d_tpu.utils import sketchers as jsk
from panic3d_tpu_torch import configs as tcfg
from panic3d_tpu_torch.api import Reconstructor
from panic3d_tpu_torch.eval import generate
from panic3d_tpu_torch.models import resnet as tres
from panic3d_tpu_torch.models import rmlinegan as trm
from panic3d_tpu_torch.runtime import checkpoint as tck
from panic3d_tpu_torch.runtime import convert as tconv
from panic3d_tpu_torch.utils import sketchers as tsk

from test_torch_eval_cli import BN, build_tree
from torch_one_thread import torch_one_thread  # noqa: F401  (autouse)

FLIP_TOL = 1e-5     # a threshold flip counts only this close to the threshold
MAX_FLIPS = 4


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def portrait(size=64, seed=0):
    """Smooth colour ramps with noise and a few dark strokes, in [0, 1]."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size] / (size - 1.0)
    img = np.stack([xx, yy, 1 - xx]) * rng.rand(3, 1, 1) + 0.15 * rng.rand(3, size, size)
    for _ in range(6):
        r, c = rng.randint(0, size, 2)
        img[:, r, max(0, c - 8):c + 8] = 0.05
    return img.clip(0, 1).astype(np.float32)


def keypoints(size=64, seed=1):
    return (np.random.RandomState(seed).rand(28, 2) * (size - 1)).astype(np.float64)


def rmline_variables(seed=2, size=76):
    """The JAX RMLineGenerator's variables with random BatchNorm affine
    parameters and running statistics."""
    v = jax.jit(jrm.RMLineGenerator().init)(jax.random.PRNGKey(seed),
                                            jnp.zeros((1, 4, size, size)))
    v = jax.tree_util.tree_map(np.array, v)
    rng = np.random.RandomState(seed)
    for i in range(5):
        v["params"][f"conv{i}_b"] = (0.1 * rng.randn(32)).astype(np.float32)
        v["params"][f"bn{i}"] = {"scale": (0.5 + rng.rand(32)).astype(np.float32),
                                 "bias": (0.1 * rng.randn(32)).astype(np.float32)}
        v["batch_stats"][f"bn{i}"] = {"mean": (0.1 * rng.randn(32)).astype(np.float32),
                                      "var": (0.5 + rng.rand(32)).astype(np.float32)}
    return v


def flips(dog_t, dog_j):
    """Pixels on which `> 0.5` differs; each must lie within FLIP_TOL of 0.5."""
    a, b = np.asarray(dog_t), np.asarray(dog_j)
    bad = (a > 0.5) != (b > 0.5)
    assert np.all(np.abs(b[bad] - 0.5) <= FLIP_TOL)
    return int(bad.sum())


def test_dog_and_blur_match_jax():
    img = portrait()[None]
    for kern, sigma in ((5, 0.5), (7, 0.8), (3, 2.0)):
        got = tsk.gaussian_blur2d(torch.from_numpy(img), kern, sigma).numpy()
        want = np.asarray(jax.jit(jsk.gaussian_blur2d, static_argnums=(1, 2))(
            jnp.asarray(img), kern, sigma))
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    for kw in (dict(t=1.0, sigma=0.5, k=1.6, epsilon=0.01, kernel_factor=4), dict(clip=False)):
        got = tsk.batch_dog(torch.from_numpy(img), **kw).numpy()
        want = np.asarray(jsk.batch_dog(jnp.asarray(img), **kw))
        assert got.shape == want.shape == (1, 1, 64, 64)
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    gray = portrait()[None, :1]
    np.testing.assert_allclose(tsk.batch_dog(torch.from_numpy(gray)).numpy(),
                               np.asarray(jsk.batch_dog(jnp.asarray(gray))), rtol=0, atol=2e-6)


def test_facehull_exact():
    cases = [keypoints(), keypoints(seed=3) * 1.4 - 10]   # some off the image
    collinear = keypoints(seed=4)
    collinear[trm.KEYPOINT_GROUPS["eye_left"]] = [[5, 5 + i] for i in range(6)]
    cases.append(collinear)
    for kp in cases:
        got = trm.facehull((64, 48), kp).numpy()
        want = jrm.facehull((64, 48), kp)
        assert got.dtype == np.float32 and got.shape == (1, 1, 64, 48)
        np.testing.assert_array_equal(got, want)
    assert got.sum() > 0


def test_generator_matches_jax():
    v = rmline_variables()
    x = np.random.RandomState(5).rand(1, 4, 64, 64).astype(np.float32)
    want = np.asarray(jax.jit(jrm.RMLineGenerator().apply)(v, jnp.asarray(x)))
    gen = trm.RMLineGenerator(device="cpu").load_variables(v).eval()
    with torch.no_grad():
        got = gen(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 3, 52, 52)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def check_filled(got, want):
    """(filled, mask, hull) of both packages: mask flips come only from DoG
    flips at the threshold; the filled images agree where the masks do."""
    (f_t, m_t, h_t), (f_j, m_j, h_j) = got, want
    np.testing.assert_array_equal(h_t, h_j)
    differ = np.asarray(m_t) != np.asarray(m_j)
    agree = np.broadcast_to(~differ, np.shape(f_j))
    np.testing.assert_allclose(np.asarray(f_t)[agree], np.asarray(f_j)[agree], rtol=0, atol=1e-5)
    return int(differ.sum())


def test_wrapper_matches_jax():
    v = rmline_variables()
    img, kp = portrait()[None], keypoints()
    want = jrm.RMLineWrapper(jrm.RMLineGenerator(), v)(jnp.asarray(img), kp)
    wrap = trm.RMLineWrapper(trm.RMLineGenerator(device="cpu").load_variables(v))
    got = tuple(t.numpy() for t in wrap(torch.from_numpy(img), kp))
    n_dog = flips(tsk.batch_dog(torch.from_numpy(img), t=1.0, sigma=0.5, k=1.6).numpy(),
                  jsk.batch_dog(jnp.asarray(img), t=1.0, sigma=0.5, k=1.6))
    n_mask = check_filled(got, want)
    assert n_dog <= MAX_FLIPS and (n_mask == 0 if n_dog == 0 else n_mask <= 4 * n_dog)
    assert 0 < float(got[1].mean()) < 1, "the portrait has lines to fill"
    assert not np.array_equal(got[0], img)


def rmline_state_dict():
    """A rmlineganA Lightning state_dict as tests/test_convert.py writes one."""
    rng = np.random.RandomState(0)
    sd = {}
    for i in range(6):
        ci, cout = i * 3, (32 if i != 5 else 3)
        sd[f"generator.{ci}.weight"] = rng.randn(cout, 4 if i == 0 else 32, 3, 3).astype(
            np.float32) * 0.1
        sd[f"generator.{ci}.bias"] = rng.randn(cout).astype(np.float32)
        if i != 5:
            bi = ci + 2
            for k, f in (("weight", 1.0), ("bias", 0.1), ("running_mean", 0.1)):
                sd[f"generator.{bi}.{k}"] = (f * rng.randn(32)).astype(np.float32)
            sd[f"generator.{bi}.running_var"] = (0.5 + rng.rand(32)).astype(np.float32)
    sd["discriminator.0.weight"] = rng.randn(16, 4, 3, 3).astype(np.float32)
    return sd


def resnet_state_dict():
    """A torchvision resnet50 state_dict with the tagger's `resnet.` prefix."""
    rng = np.random.RandomState(0)
    sd = {}

    def conv_bn(conv, bn, cout, cin, k):
        sd[f"resnet.{conv}.weight"] = rng.randn(cout, cin, k, k).astype(np.float32) * 0.01
        for name in ("weight", "bias", "running_mean", "running_var"):
            sd[f"resnet.{bn}.{name}"] = rng.rand(cout).astype(np.float32)

    conv_bn("conv1", "bn1", 64, 3, 7)
    cin = 64
    for li, (width, blocks) in enumerate([(64, 3), (128, 4), (256, 6), (512, 3)], start=1):
        for bi in range(blocks):
            b = f"layer{li}.{bi}"
            conv_bn(f"{b}.conv1", f"{b}.bn1", width, cin, 1)
            conv_bn(f"{b}.conv2", f"{b}.bn2", width, width, 3)
            conv_bn(f"{b}.conv3", f"{b}.bn3", width * 4, width, 1)
            if bi == 0:
                conv_bn(f"{b}.downsample.0", f"{b}.downsample.1", width * 4, cin, 1)
            cin = width * 4
    sd["resnet.fc.weight"] = rng.randn(1000, 2048).astype(np.float32) * 0.01
    sd["resnet.fc.bias"] = rng.rand(1000).astype(np.float32)
    return sd


def assert_same_tree(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            assert_same_tree(a[k], b[k])
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_converters_match_jax():
    sd = rmline_state_dict()
    got = tconv.convert_rmline(sd)
    assert_same_tree(got, jconv.convert_rmline(sd))
    gen = trm.RMLineGenerator(device="cpu").load_variables(got)   # the tree loads strict
    assert torch.equal(gen.bn0.var, torch.from_numpy(sd["generator.2.running_var"]))
    assert_same_tree(tconv.convert_rmline({k: torch.from_numpy(v) for k, v in sd.items()}),
                     jconv.convert_rmline(sd))
    sd = resnet_state_dict()
    got = tconv.convert_resnet50(sd)
    assert_same_tree(got, jconv.convert_resnet50(sd))
    tres.ResNet50(device="cpu").load_variables(got)


@pytest.fixture(scope="module")
def ckpt_dirs(tmp_path_factory):
    """A checkpoint root written by the JAX package's save_checkpoint: the
    tiny G (the port's seeded weights as flax variables), ``rmline/`` (the
    JAX generator's variables) and ``resnet/`` (a converted ResNet with a
    seeded PCA basis and mean)."""
    root = tmp_path_factory.mktemp("ckpt")
    G = tcfg.tiny(device="cpu").init_weights(0)
    # a camera-free mapping, as the flagship's: one planes bundle (and one
    # paste occlusion volume) a portrait
    rk = dict(tcfg.tiny_kwargs()["rendering_kwargs"], c_gen_conditioning_zero=True)
    jck.save_checkpoint(str(root / "G"), tck.flax_from_state_dict(G.state_dict()),
                        {"model_kwargs": {"family": "tiny", "rendering_kwargs": rk}})
    jck.save_checkpoint(str(root / "rmline"), rmline_variables())
    jck.save_checkpoint(str(root / "resnet"), jconv.convert_resnet50(resnet_state_dict()))
    rng = np.random.RandomState(7)
    np.savez(str(root / "resnet" / "pca.npz"),
             components=(0.05 * rng.randn(512, 2048)).astype(np.float32),
             mean=(0.1 * rng.randn(2048)).astype(np.float32))
    return root


def test_load_pca_extractor_matches_jax(ckpt_dirs):
    path = str(ckpt_dirs / "resnet")
    want = jres.load_pca_extractor(path)
    got = tres.load_pca_extractor(path, device="cpu")
    np.testing.assert_array_equal(got.pw.numpy(), np.asarray(want.pw))
    np.testing.assert_array_equal(got.pb.numpy(), np.asarray(want.pb))
    sd = got.resnet.state_dict()
    ref = tck.module_state_from_flax(want.variables)
    assert set(sd) == set(ref)
    for k in ref:
        assert torch.equal(sd[k], ref[k]), k


@pytest.fixture(scope="module")
def generated(ckpt_dirs, tmp_path_factory):
    """generate.main --ckpt of the port on a 64^2 tree, its cond caught."""
    root = build_tree(str(tmp_path_factory.mktemp("tree")), np.random.RandomState(1))
    conds, stages = [], {}
    real = generate.generate_portrait

    def spy(*args, **kwargs):
        conds.append(real(*args, **kwargs))
        return conds[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(generate, "generate_portrait", spy)
        generate.main(["--ckpt", str(ckpt_dirs / "G"), "--data", root,
                       "--out", str(ckpt_dirs / "out"), "--mesh-res", "16", "--level", "0.17",
                       "--no-filters", "--device", "cpu"], stages=stages)
    return root, conds, stages


@pytest.fixture(scope="module")
def jax_cond(generated, ckpt_dirs):
    """The JAX pieces as panic3d_tpu/eval/generate.py:281-296 calls them:
    -> ((filled, mask, hull), chonk, the white-background RGB, alignment)."""
    from panic3d_tpu.data.databack import DatabackendMinna as JData

    root = generated[0]
    img = JData(root)[BN]["image"]
    with open(os.path.join(root, "_data/lustrous/renders/daredemoE/"
                                 "fandom_align_alignment.pkl"), "rb") as f:
        align = pickle.load(f)[BN]
    rvars, _ = jck.load_checkpoint(str(ckpt_dirs / "rmline"))
    wrap = jrm.RMLineWrapper(jrm.RMLineGenerator(), rvars)
    rgb = jnp.asarray(img.bg("w").convert("RGB").t())[None]
    filled = wrap(rgb, jgen._aligned_keypoints(align))
    chonk = jres.load_pca_extractor(str(ckpt_dirs / "resnet"))(
        jnp.asarray(img.bg("k").convert("RGB").t()))
    return filled, chonk, rgb, align


def test_generate_ckpt_cond_matches_jax(generated, jax_cond, ckpt_dirs):
    _, conds, stages = generated
    assert len(conds) == 1
    assert list(stages) == ["load", "rmline", "features", "mesh", "views", "write"]
    assert os.path.isfile(os.path.join(str(ckpt_dirs / "out"),
                                       BN.replace("fandom_align", "marching_cubes") + ".pkl"))
    filled, chonk, rgb, align = jax_cond
    cond = conds[0]
    # the filler's mask, run again in the port on the same input, to compare
    wrap = generate._load_rmline(argparse.Namespace(ckpt=str(ckpt_dirs / "G")), "cpu")
    f_t, m_t, h_t = wrap(torch.from_numpy(np.asarray(rgb)), generate._aligned_keypoints(align))
    assert torch.equal(f_t, cond["image_ortho_front"])
    n_mask = check_filled((f_t.numpy(), m_t.numpy(), h_t.numpy()), filled)
    assert n_mask <= 4 * MAX_FLIPS
    assert float(m_t.mean()) > 0
    want = np.asarray(chonk)[None, 0, :16]
    got = cond["resnet_chonk"].numpy()
    assert got.shape == want.shape == (1, 16, 8, 8)
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= 1e-4 * scale


def test_reconstructor_preprocess_with_filler_and_features(generated, jax_cond, ckpt_dirs):
    conds = generated[1]
    rgb, align = jax_cond[2:]
    args = argparse.Namespace(ckpt=str(ckpt_dirs / "G"))
    rec = Reconstructor(ckpt=str(ckpt_dirs / "G"), device="cpu",
                        rmline=generate._load_rmline(args, "cpu"),
                        resnet=generate._load_resnet(args, "cpu"))
    img = np.asarray(rgb)[0]
    with pytest.raises(ValueError, match="keypoints"):
        rec.preprocess(img)
    cond = rec.preprocess(img, generate._aligned_keypoints(align))
    # the portrait's white-background RGB feeds both pieces here
    torch.testing.assert_close(cond["image_ortho_front"], conds[0]["image_ortho_front"],
                               rtol=0, atol=0)
    want = rec.resnet(torch.from_numpy(img))[None, 0, :16]
    assert torch.equal(cond["resnet_chonk"], want)


def test_f14_jax_preprocess_fails_where_generate_does_not(ckpt_dirs):
    ext = jres.load_pca_extractor(str(ckpt_dirs / "resnet"))
    g = jcfg.tiny(force_sigmoid=True)
    rec = JRec(model=g, variables=None, resnet=ext)
    img = jnp.zeros((3, 64, 64), jnp.float32)
    with pytest.raises(TypeError, match="lhs and rhs ndim to be equal"):
        jax.eval_shape(rec.preprocess, img)
    assert jax.eval_shape(ext, img).shape == (2, 512, 8, 8)
