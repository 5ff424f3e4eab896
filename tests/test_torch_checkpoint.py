"""The port's checkpoints (runtime/checkpoint.py) against flax and the JAX
package, on the CPU:

- the pure-Python msgpack reader on flax.serialization.to_bytes of the JAX
  tiny G's variables inside a trainer-snapshot dict (``vars_Gema``) with a
  numpy scalar, a bfloat16 leaf, a 0-d and an empty array, nested lists,
  strings, integers of every width, a complex and bytes: every value equal;
  lists that flax.msgpack_serialize keeps as msgpack arrays; arrays over
  the chunk limit (lowered here in both packages); a format byte msgpack
  never uses is refused by name;
- the writer gives the bytes of flax's to_bytes for the same tree, and
  flax's msgpack_restore reads them back;
- Reconstructor(ckpt=) of the port against the JAX Reconstructor(ckpt=) on
  one directory written by the JAX package's save_checkpoint (tiny, f32):
  the state_dict equal to the variables, preprocess equal, views within
  test_torch_api.py's image bounds (2e-3), the mesh's faces identical;
- a reference-layout network-snapshot pickle written by
  save_reference_pickle, read by both packages' extract_reference_generator:
  state_dicts, init_args, init_kwargs, extras and
  generator_config_from_init_kwargs equal; the port generator rebuilt from
  it equals the source's state_dict and G.f bit for bit; the options the
  port refuses fail with their own errors;
- load_generator_state refuses a missing name, an unexpected one and a
  wrong shape, and drops the recomputed filter buffers.
"""

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panic3d_tpu import configs as jcfg
from panic3d_tpu.api import Reconstructor as JRec
from panic3d_tpu.runtime import checkpoint as jck
from panic3d_tpu_torch import configs as tcfg
from panic3d_tpu_torch.api import Reconstructor
from panic3d_tpu_torch.models.triplane import TriPlaneGenerator
from panic3d_tpu_torch.runtime import checkpoint as tck

from test_torch_api import SIGMA_BIAS, jax_views
from test_torch_generator import F32, IMAGE_TOL, seeded_variables
from torch_one_thread import torch_one_thread  # noqa: F401  (autouse)

SEED = 3


def assert_tree_equal(got, want, path=""):
    """Leaf by leaf: arrays with dtype and shape (the port reads bfloat16 as
    a torch tensor), scalars with their type, containers key by key."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            assert_tree_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_tree_equal(g, w, f"{path}/{i}")
    elif isinstance(want, (np.ndarray, jax.Array)) and str(want.dtype) == "bfloat16":
        bits = got.view(torch.int16).numpy() if isinstance(got, torch.Tensor) \
            else np.asarray(got).view(np.int16)
        assert str(got.dtype) in ("torch.bfloat16", "bfloat16"), path
        assert tuple(got.shape) == want.shape, path
        np.testing.assert_array_equal(bits, np.asarray(want).view(np.int16), err_msg=path)
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype, path
        assert np.shape(got) == np.shape(want), path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, path


@pytest.fixture(scope="module")
def tiny_jax():
    """The JAX tiny G (f32) with numpy-seeded variables, the sigma bias raised
    so that the filtered mesh is not empty, and a portrait."""
    img = np.random.RandomState(6).rand(3, 64, 64).astype(np.float32)
    g = jcfg.tiny(force_sigmoid=True, **F32)
    cond = JRec(model=g, variables=None).preprocess(img)
    variables = jax.tree_util.tree_map(np.array, seeded_variables(
        g, {"seeds": [SEED], "elevations": jnp.zeros(1), "azimuths": jnp.zeros(1),
            "fovs": jnp.full((1,), 30.0), "cond": cond}))
    variables["params"]["decoder"]["net2"]["bias"][0] += SIGMA_BIAS
    return g, variables, img


def snapshot_tree(variables):
    return {
        "vars_Gema": variables,
        "step": np.int64(1200), "loss": np.float32(0.25),
        "bf16": jnp.arange(-3, 7, dtype=jnp.bfloat16).reshape(2, 5),
        "zero_d": np.array(2.5, np.float64), "empty": np.zeros((0, 4), np.float32),
        "ints": [0, 127, -32, -33, 255, 256, 65535, 65536, -129, -32769, 2 ** 40, -2 ** 40],
        "nested": [["a", "é" * 20, "x" * 300], (1.5, None, True, False)],
        "c": 1 - 2j, "raw": b"\x01" * 70000, "long": np.arange(70000, dtype=np.int32),
        "u8": np.arange(12, dtype=np.uint8).reshape(3, 4), "mask": np.array([True, False]),
    }


def test_reader_matches_flax(tiny_jax):
    _, variables, _ = tiny_jax
    data = fser.to_bytes(snapshot_tree(variables))
    assert_tree_equal(tck.msgpack_restore(data), fser.msgpack_restore(data))
    got = tck.extract_generator_variables(tck.msgpack_restore(data))
    assert_tree_equal(got, jax.tree_util.tree_map(np.asarray, variables))
    # lists that msgpack_serialize keeps as msgpack arrays, and map keys as
    # flax reads them
    tree = {"l": [1, [2.5, "s"], np.ones(3, np.float32)], "m": {"k": [None]}}
    data = fser.msgpack_serialize(tree)
    assert_tree_equal(tck.msgpack_restore(data), fser.msgpack_restore(data))
    assert isinstance(tck.msgpack_restore(data)["l"], list)


def test_writer_gives_flax_bytes(tiny_jax):
    _, variables, _ = tiny_jax
    tree = snapshot_tree(variables)
    want = fser.to_bytes(tree)
    ours = dict(tree, bf16=torch.arange(-3, 7, dtype=torch.bfloat16).reshape(2, 5))
    got = tck.to_bytes(ours)
    assert got == want
    assert_tree_equal(fser.msgpack_restore(got), fser.msgpack_restore(want))


def test_chunked_arrays(monkeypatch):
    """Arrays over MAX_CHUNK_SIZE (lowered to 64 bytes in both packages)."""
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(tck, "MAX_CHUNK_SIZE", 64)
    tree = {"a": np.arange(50, dtype=np.float32).reshape(5, 10), "b": {"c": np.ones(3)},
            "h": jnp.arange(40, dtype=jnp.bfloat16)}
    want = fser.to_bytes(tree)
    got = tck.to_bytes(dict(tree, h=torch.arange(40, dtype=torch.bfloat16)))
    assert got == want
    assert_tree_equal(tck.msgpack_restore(want), fser.msgpack_restore(want))


def test_reader_refuses_unknown_bytes():
    with pytest.raises(ValueError, match="0xc1"):
        tck.msgpack_restore(b"\x81\xa1a\xc1")
    with pytest.raises(ValueError, match="bytes wanted"):
        tck.msgpack_restore(fser.to_bytes({"a": np.ones(4)})[:-3])


def test_reconstructor_ckpt_matches_jax(tiny_jax, tmp_path):
    g, variables, img = tiny_jax
    path = str(tmp_path / "G")
    jck.save_checkpoint(path, {"vars_Gema": variables, "vars_G": variables},
                        {"model_kwargs": dict(family="tiny", **F32)})
    jrec = JRec(ckpt=path, opts=dict(triplane_crop=0.1, cull_clouds=0.5), seed=SEED)
    rec = Reconstructor(ckpt=path, opts=dict(triplane_crop=0.1, cull_clouds=0.5), seed=SEED,
                        device="cpu")
    want_sd = tck.state_dict_from_flax(variables)
    got_sd = rec.g.state_dict()
    assert set(got_sd) == set(want_sd)
    for k in want_sd:
        assert torch.equal(got_sd[k], want_sd[k]), k
    assert rec.g.force_sigmoid and not rec.g.training
    cond_j, cond_t = jrec.preprocess(img), rec.preprocess(img)
    for k in cond_j:
        np.testing.assert_array_equal(cond_t[k].numpy(), np.asarray(cond_j[k]), err_msg=k)
    el, az, fovs = [0.0, 10.0], [30.0, 200.0], [30.0, -1.0]
    want = jax_views(jrec, cond_j, el, az, fovs)
    got = rec.views(cond_t, el, az, fovs)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **IMAGE_TOL)
    mesh_j, mesh_t = jrec.mesh(cond_j, resolution=16), rec.mesh(cond_t, resolution=16)
    assert len(mesh_t["faces"]) > 0
    np.testing.assert_array_equal(mesh_t["faces"], mesh_j.faces)


def port_tiny(seed=SEED):
    kw = tcfg.tiny_kwargs(force_sigmoid=True, **F32)
    G = TriPlaneGenerator(**kw).init_weights(seed).eval()
    with torch.no_grad():
        G.decoder.net[2].bias[0] += 2.5
    return G, kw


def tiny_input(G):
    cond = {"image_ortho_front": torch.from_numpy(
                np.random.RandomState(4).rand(1, 3, 64, 64).astype(np.float32)),
            "resnet_chonk": torch.from_numpy(
                np.random.RandomState(5).randn(1, 16, 8, 8).astype(np.float32))}
    return {"seeds": [SEED], "elevations": [0.0], "azimuths": [30.0], "fovs": [30.0],
            "cond": cond}


def test_reference_pickle_both_packages(tmp_path):
    G, kw = port_tiny()
    path = str(tmp_path / "network-snapshot-000000.pkl")
    tck.save_reference_pickle(path, G, kw)
    sd_t, args_t, kw_t, ex_t = tck.extract_reference_generator(path)
    sd_j, args_j, kw_j, ex_j = jck.extract_reference_generator(path)
    assert list(sd_t) == list(sd_j) == list(G.state_dict())
    for k in sd_j:
        assert sd_t[k].dtype == sd_j[k].dtype and np.array_equal(sd_t[k], sd_j[k]), k
    assert args_t == args_j == ()
    assert kw_t == kw_j and ex_t == ex_j
    assert "force_sigmoid" not in kw_t and kw_t["channel_base"] == 2048
    cfg = tck.generator_config_from_init_kwargs(kw_t, ex_t)
    assert cfg == jck.generator_config_from_init_kwargs(kw_j, ex_j)
    assert cfg == {k: v for k, v in kw.items() if k not in ("force_sigmoid", "rendering_kwargs")} \
        | {"rendering_kwargs": G.rk}
    # the port generator rebuilt from the pickle equals the source
    G2 = tck.load_generator_state(TriPlaneGenerator(**cfg, force_sigmoid=True).eval(), sd_t)
    for k, v in G.state_dict().items():
        assert torch.equal(G2.state_dict()[k], v), k
    with torch.no_grad():
        a, b = G.f(tiny_input(G)), G2.f(tiny_input(G2))
    for k in ("image", "image_raw", "image_depth"):
        assert torch.equal(a[k], b[k]), k


def test_reference_pickle_refused_options(tmp_path):
    """Snapshots with the options the port once refused (the Hybrid4X SR
    module, ray_start = ray_end = 'auto') now load: the rebuilt generator
    has the source's state and renders the source's views bit for bit."""
    for rk in (dict(superresolution_module="training.superresolution.SuperresolutionHybrid4X"),
               dict(ray_start="auto", ray_end="auto")):
        kw = tcfg.tiny_kwargs(force_sigmoid=True, **dict(
            F32, rendering_kwargs=dict(F32["rendering_kwargs"], **rk)))
        G = TriPlaneGenerator(**kw).init_weights(SEED).eval()
        with torch.no_grad():
            G.decoder.net[2].bias[0] += 2.5
        path = str(tmp_path / "snap.pkl")
        tck.save_reference_pickle(path, G, kw)
        sd, _, kw_t, ex = tck.extract_reference_generator(path)
        assert {k: ex["rendering_kwargs"][k] for k in rk} == rk
        cfg = tck.generator_config_from_init_kwargs(kw_t, ex)
        G2 = tck.load_generator_state(TriPlaneGenerator(**cfg, force_sigmoid=True).eval(), sd)
        with torch.no_grad():
            a, b = G.f(tiny_input(G)), G2.f(tiny_input(G2))
        assert a["image"].shape[-1] == (256 if "superresolution_module" in rk else 128)
        for k in ("image", "image_raw", "image_depth"):
            assert torch.equal(a[k], b[k]), k


def test_state_loader_refuses_misfits():
    G, _ = port_tiny()
    sd = {k: v.numpy() for k, v in G.state_dict().items()}
    name = "backbone.synthesis.b8.conv0.weight"
    extra = dict(sd, **{"backbone.synthesis.b8.conv0.resample_filter": np.ones((4, 4))})
    G2 = tck.load_generator_state(port_tiny(seed=9)[0], extra)   # the filter is dropped
    assert torch.equal(G2.state_dict()[name], G.state_dict()[name])
    missing = {k: v for k, v in sd.items() if k != name}
    _, miss, unexp = tck.convert_generator_state(missing, G)
    assert miss == [name] and unexp == []
    with pytest.raises(ValueError, match="missing"):
        tck.load_generator_state(G, missing)
    with pytest.raises(ValueError, match="unexpected.*decoder.net.4.weight"):
        tck.load_generator_state(G, dict(sd, **{"decoder.net.4.weight": np.ones(3)}))
    with pytest.raises(ValueError, match=f"{name}: shape"):
        tck.load_generator_state(G, dict(sd, **{name: sd[name][:, :1]}))


def test_native_roundtrip_of_the_port_generator(tmp_path):
    """save_checkpoint of flax_from_state_dict, then load_checkpoint and
    state_dict_from_flax: the same tensors; the JAX reader agrees."""
    G, _ = port_tiny()
    path = str(tmp_path / "G")
    tck.save_checkpoint(path, tck.flax_from_state_dict(G.state_dict()), {"a": 1})
    state, config = tck.load_checkpoint(path)
    assert config == {"a": 1}
    back = tck.state_dict_from_flax(state)
    assert set(back) == set(G.state_dict())
    for k, v in G.state_dict().items():
        assert torch.equal(back[k], v), k
    jstate, _ = jck.load_checkpoint(path)
    assert_tree_equal(state, jstate)
