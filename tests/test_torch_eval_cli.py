"""The port's eval CLIs (eval/measure.py:main, eval/generate.py) against
the JAX package's, on the CPU, on a synthetic daredemoE tree written here:
a 64^2 portrait, its GT ortho and rgb60 renders, the metadata JSON, the
alignment pickle with a 512-space ROI, a one-line subset, and a .vrm whose
head holds two concentric icospheres (remove_innards drops the inner one).

- measure.main of both packages, in one process (so that the salted
  ``hash(bn)`` seeding the point samples agrees, F10), on one set of
  predicted outputs (128^2 PNGs, which run2d resizes to the GT's 64^2, and
  a marching-cubes pickle of an icosphere), with the same LPIPS and CLIP
  weight files (eval/goldens.py's seeded state_dicts through
  runtime/convert.py): every row of ans2d and ans3d within 1e-4 relative,
  and the same printed table. The JAX CLIPSimilarity.embed is jitted here
  (its eager ViT takes ~1 s a call on the CPU); the numbers are the same
  function's.
- marked slow, as tests/test_eval_cli.py:145: generate.main --tiny then
  measure.main of the port end to end (the file layout, every metric
  finite), and generate_portrait against the JAX pieces of generate.py's
  loop with the same tiny weights (state_dict_from_flax), ResNet variables
  (module_state_from_flax) and PCA basis: the mesh pickle's keys, faces and
  vertices, and the PNG views.
"""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from panic3d_tpu.cameras.conventions import camsubs
from panic3d_tpu.eval import measure as jmeasure
from panic3d_tpu.eval import metrics2d as jm2d
from panic3d_tpu.eval.goldens import seeded_clip_state_dict, seeded_lpips_state_dict
from panic3d_tpu.runtime.convert import convert_clip_vit_b32, convert_lpips_alex
from panic3d_tpu_torch.eval import measure as tmeasure
from panic3d_tpu_torch.utils.imglib import Img

from test_torch_gltf import icosphere, two_shells, write_vrm
from test_torch_metricnets import save_flax_npz

SIZE, PRED = 64, 128
FRANCH, IDX = "frn", "0007"
BN = f"daredemoE/fandom_align/{FRANCH}/{IDX}/front"
ROI = ((128, 128), (256, 256))


def build_tree(root, rng):
    """The synthetic daredemoE tree under root -> root."""
    base = os.path.join(root, "_data", "lustrous")
    meta = {}

    def put_png(dtype, view, fov):
        d = os.path.join(base, "renders", "daredemoE", dtype, FRANCH, IDX)
        Img(rng.rand(4, SIZE, SIZE).astype(np.float32)).save(os.path.join(d, f"{view}.png"))
        key = f"daredemoE/{dtype}/{FRANCH}/{IDX}/{view}"
        meta[key] = {"render_params": dict(elev=0.0, azim=0.0, dist=1.0, fov=fov)}

    put_png("fandom_align", "front", -1)
    for view in ("front", "left", "right", "back"):
        put_png("ortho", view, -1)
    for v in camsubs["spin12"]:
        put_png("rgb60", f"{v:04d}", 30)
    with open(os.path.join(base, "renders", "daredemoE", "daredemoE_meta.json"), "w") as f:
        json.dump(meta, f)
    kpts = np.concatenate([rng.rand(28, 2) * (SIZE - 1), np.ones((28, 1))], axis=1)
    align = {BN: {"area_of_interest": ROI, "transformation": np.eye(3, dtype=np.float32),
                  "_alignment": {"source": {"keypoints": kpts[None].astype(np.float32),
                                            "_detection_used": 0}}}}
    with open(os.path.join(base, "renders", "daredemoE", "fandom_align_alignment.pkl"),
              "wb") as f:
        pickle.dump(align, f)
    os.makedirs(os.path.join(base, "subsets"), exist_ok=True)
    with open(os.path.join(base, "subsets", "daredemoE_test.csv"), "w") as f:
        f.write(f"{FRANCH}/{IDX}\n")
    write_vrm(os.path.join(base, "raw", "dssc", FRANCH, f"{IDX}.vrm"),
              list(two_shells(2, 1, (0.0, 0.0, 0.0))))
    return root


def write_predictions(out, rng):
    """Predicted views (PRED^2 RGB PNGs) and a marching-cubes pickle."""
    for sub, views in (("ortho", ("front", "left", "right", "back")),
                       ("rgb60", [f"{v:04d}" for v in camsubs["spin12"]])):
        for view in views:
            path = os.path.join(out, BN.replace("fandom_align", sub).replace("/front", f"/{view}"))
            Img(rng.rand(3, PRED, PRED).astype(np.float32)).save(path + ".png")
    v, f = icosphere(2, 0.13, (0.01, 0.12, 0.0))
    v = v + (0.004 * rng.randn(*v.shape)).astype(np.float32)
    path = os.path.join(out, BN.replace("fandom_align", "marching_cubes") + ".pkl")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as fh:
        pickle.dump(dict(verts=v, faces=f.astype(np.int32), normals=None, values=None,
                         colors=rng.rand(len(v), 3).astype(np.float32)), fh)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("daredemo"))
    rng = np.random.RandomState(0)
    build_tree(root, rng)
    out = os.path.join(root, "evalout")
    write_predictions(out, rng)
    lpips = save_flax_npz(os.path.join(root, "lpips.npz"),
                          convert_lpips_alex(seeded_lpips_state_dict()))
    clip = save_flax_npz(os.path.join(root, "clip.npz"),
                         convert_clip_vit_b32(seeded_clip_state_dict()))
    return root, out, lpips, clip


@pytest.fixture
def jitted_jax_clip(monkeypatch):
    """CLIPSimilarity.embed of the JAX package, jitted with the variables as
    an argument."""
    embed = jm2d.CLIPSimilarity.embed

    def jitted(self, img):
        if not hasattr(self, "_embed_jit"):
            def fn(variables, img):
                sim = object.__new__(jm2d.CLIPSimilarity)
                sim.module, sim.variables = self.module, variables
                return embed(sim, img)

            self._embed_jit = jax.jit(fn)
        return self._embed_jit(self.variables, img)

    monkeypatch.setattr(jm2d.CLIPSimilarity, "embed", jitted)


def test_measure_main_matches_jax(tree, jitted_jax_clip, capsys):
    root, out, lpips, clip = tree
    argv = ["--data", root, "--out", out, "--lpips-weights", lpips, "--clip-weights", clip]
    want2d, want3d = jmeasure.main(argv)
    jax_table = capsys.readouterr().out.split(f"{BN} measured\n")[-1]
    stages = {}
    got2d, got3d = tmeasure.main(argv + ["--device", "cpu"], stages=stages)
    port_table = capsys.readouterr().out.split(f"{BN} measured\n")[-1]
    assert set(got2d) == set(want2d) == {"front", "back", "360"}
    for subset in want2d:
        assert set(got2d[subset]) == set(want2d[subset]) == {"clip", "lpips", "psnr"}
        for metric in want2d[subset]:
            np.testing.assert_allclose(got2d[subset][metric], want2d[subset][metric],
                                       rtol=1e-4, err_msg=f"{subset} {metric}")
    assert set(got3d) == set(want3d)
    for k in want3d:
        np.testing.assert_allclose(got3d[k], want3d[k], rtol=1e-4, err_msg=k)
    assert 0 < want3d["cd"][0] < 1 and 0 < want3d["f1_050_mean"][0]
    assert port_table == jax_table
    assert set(stages) == {"2d", "vrm_load", "remove_innards", "decapitate", "filter",
                           "sampling", "p2s", "s2p"}


def test_measure_refuses_random_nets_unless_allowed(tree):
    root, out, _, _ = tree
    with pytest.raises(SystemExit, match="refusing"):
        tmeasure.main(["--data", root, "--out", out, "--device", "cpu"])


@pytest.mark.slow
def test_generate_then_measure(tmp_path):
    from panic3d_tpu_torch.eval import generate

    root = build_tree(str(tmp_path / "tree"), np.random.RandomState(1))
    out = str(tmp_path / "evalout")
    generate.main(["--tiny", "--data", root, "--out", out, "--skip-rmline", "--mesh-res", "24",
                   "--level", "0.17", "--no-filters", "--device", "cpu"])
    base = os.path.join(out, "daredemoE")
    assert os.path.isfile(os.path.join(base, "marching_cubes", FRANCH, IDX, "front.pkl"))
    for view in ("front", "left", "right", "back"):
        for sub in ("ortho", "ortho_xyza"):
            assert os.path.isfile(os.path.join(base, sub, FRANCH, IDX, f"{view}.png"))
    for sub in ("rgb60", "xyza60"):
        assert len(os.listdir(os.path.join(base, sub, FRANCH, IDX))) == 12
    with pytest.raises(NotImplementedError, match="checkpoint"):
        generate.main(["--ckpt", "x", "--data", root, "--out", out, "--device", "cpu"])
    with open(os.path.join(base, "marching_cubes", FRANCH, IDX, "front.pkl"), "rb") as f:
        mc = pickle.load(f)
    assert len(mc["faces"]), "measure needs a predicted surface"
    ans2d, ans3d = tmeasure.main(["--data", root, "--out", out, "--allow-random-metrics",
                                  "--device", "cpu"])
    for subset in ("front", "back", "360"):
        for metric in ("clip", "lpips", "psnr"):
            assert np.isfinite(np.mean(ans2d[subset][metric])), (subset, metric)
    assert np.isfinite(np.mean(ans3d["cd"]))


@pytest.mark.slow
def test_generate_portrait_matches_jax(tmp_path):
    from panic3d_tpu import configs as jcfg
    from panic3d_tpu.data.databack import DatabackendMinna as JData
    from panic3d_tpu.eval import generate as jgen
    from panic3d_tpu.eval.volume import extract_mesh as jextract
    from panic3d_tpu.models import resnet as jres
    from panic3d_tpu_torch import configs as tcfg
    from panic3d_tpu_torch.data.databack import DatabackendMinna
    from panic3d_tpu_torch.eval import generate
    from panic3d_tpu_torch.models import resnet as tres
    from panic3d_tpu_torch.runtime.checkpoint import state_dict_from_flax

    from test_torch_generator import F32, seeded_variables

    root = build_tree(str(tmp_path / "tree"), np.random.RandomState(2))
    opts = dict(generate.INFERENCE_OPTS)
    opts.pop("triplane_crop"), opts.pop("cull_clouds")
    seed, level, res = 3, 0.17, 24
    # the ResNet-PCA extractor with the same weights in both packages
    module = jres.ResNet50()
    rvars = jax.tree_util.tree_map(np.array, module.init(jax.random.PRNGKey(0),
                                                         jnp.zeros((1, 3, 64, 64))))
    basis = np.random.RandomState(0).randn(512, 2048).astype(np.float32)
    jext = jres.ResnetFeatureExtractorPCA(module, rvars, basis, np.zeros(2048, np.float32))
    text = tres.ResnetFeatureExtractorPCA(tres.ResNet50(device="cpu").load_variables(rvars),
                                          basis, np.zeros(2048, np.float32))
    x = JData(root)[BN]
    img = x["image"]
    cond_j = {"image_ortho_front": jnp.asarray(img.bg("w").convert("RGB").t())[None],
              "resnet_chonk": jext(jnp.asarray(img.bg("k").convert("RGB").t()))[None, 0, :16]}
    g = jcfg.tiny(force_sigmoid=True, **F32)
    variables = jax.tree_util.tree_map(np.array, seeded_variables(
        g, {"seeds": [seed], "elevations": jnp.zeros(1), "azimuths": jnp.zeros(1),
            "cond": cond_j}))
    G = tcfg.tiny(device="cpu", force_sigmoid=True, **F32).eval()
    G.load_state_dict(state_dict_from_flax(variables), strict=True)
    out = str(tmp_path / "out")
    cond_t = generate.generate_portrait(G, text, DatabackendMinna(root)[BN], None, opts, seed,
                                        2, out, level=level, mesh_res=res)
    for k in cond_j:
        np.testing.assert_allclose(cond_t[k].numpy(), np.asarray(cond_j[k]), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    mc_j = dict(jextract(g, variables, {"cond": cond_j, "seeds": [seed], **opts}, level=level,
                         resolution=res))
    with open(os.path.join(out, BN.replace("fandom_align", "marching_cubes") + ".pkl"),
              "rb") as f:
        mc_t = pickle.load(f)
    assert set(mc_t) == set(mc_j)
    np.testing.assert_array_equal(mc_t["faces"], mc_j["faces"])
    np.testing.assert_allclose(mc_t["verts"], mc_j["verts"], rtol=0, atol=1e-5)
    # the views: the JAX loop's render of each batch, as PNG bytes
    render = jgen._get_render_jit(g, opts, seed, 2)
    views = generate.eval_views()
    for i in range(0, len(views), 2):
        cc = views[i:i + 2]
        o = render(variables, *(jnp.asarray([float(c[j]) for c in cc]) for j in (2, 3, 4)),
                   cond_j)
        for k, (cm, name, *_r) in enumerate(cc):
            sub = "ortho" if cm == "camO" else "rgb60"
            path = os.path.join(out, BN.replace("fandom_align", sub).replace("/front", f"/{name}"))
            got = Img(path + ".png").numpy_uint8().astype(int)
            want = Img(np.clip(np.asarray(o["image"][k]), 0, 1)).numpy_uint8().astype(int)
            assert np.abs(got - want).max() <= 1, (sub, name)
