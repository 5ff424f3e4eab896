"""The port's ResNet50 and ResNet-PCA extractor (models/resnet.py) against
the JAX package's, on the CPU, with the JAX module's variables (numpy-seeded
in its tree's shapes: He-normal convolutions, BatchNorm scales, biases and
running statistics that move the activations) carried across by
runtime/checkpoint.py:module_state_from_flax:

- every tap (conv1, layer1..4, avgpool, fc) of a batch of two 64^2 images,
  within 1e-4 of each tap's largest magnitude;
- ResnetFeatureExtractorPCA's chonk and global features of a 300^2 portrait
  (an antialiased bilinear resize to 256^2 first) and of a 256^2 one,
  within 1e-4;
- the random-feature fallback of eval generate (a seeded ResNet and numpy's
  RandomState(0) PCA basis) has the JAX CLI's basis and the chonk shape.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panic3d_tpu.models import resnet as jres
from panic3d_tpu_torch.models import resnet as tres
from torch_one_thread import torch_one_thread  # noqa: F401  (autouse)


def close(got, want, tol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale, float(np.abs(got - want).max())


@pytest.fixture(scope="module")
def nets():
    module = jres.ResNet50()
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 3, 64, 64))))
    rng = np.random.RandomState(1)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "w":
            a = rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        elif name == "fc_w":
            a = 0.01 * rng.randn(*shape)
        elif name in ("scale", "var"):
            a = 0.5 + rng.rand(*shape)
        else:   # BatchNorm bias and mean, fc bias
            a = 0.1 * rng.randn(*shape)
        return a.astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(fill, shapes)
    port = tres.ResNet50(device="cpu").load_variables(variables).eval()
    apply = jax.jit(lambda v, x: module.apply(v, x, return_taps=True))
    return module, variables, apply, port


def test_taps_match_jax(nets):
    _, variables, apply, port = nets
    x = np.random.RandomState(2).rand(2, 3, 64, 64).astype(np.float32)
    want = apply(variables, x)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert set(got) == set(want)
    for k in want:
        close(got[k].numpy(), want[k])


@pytest.mark.parametrize("size", [300, 256])
def test_pca_extractor_matches_jax(nets, size):
    module, variables, apply, port = nets
    rng = np.random.RandomState(size)
    comps = rng.randn(64, 2048).astype(np.float32)
    mean = (0.1 * rng.randn(2048)).astype(np.float32)
    img = rng.rand(3, size, size).astype(np.float32)
    jext = jres.ResnetFeatureExtractorPCA(module, variables, comps, mean, 48)
    # the JAX extractor's trunk, jitted once (its __call__ runs it eagerly)
    jext.resnet = type("Jitted", (), {"apply": staticmethod(
        lambda v, x, return_taps=True: apply(v, x))})()
    text = tres.ResnetFeatureExtractorPCA(port, comps, mean, 48)
    close(text(img).numpy(), jext(jnp.asarray(img)))
    close(text.global_feats(img).numpy(), jext.global_feats(jnp.asarray(img)))
    assert text(img).shape == (2, 48, 8, 8)


def test_random_feature_extractor():
    ext = tres.random_feature_extractor(0, device="cpu")
    np.testing.assert_array_equal(ext.pw.numpy(),
                                  np.random.RandomState(0).randn(512, 2048).astype(np.float32))
    assert not ext.pb.any()
    chonk = ext(np.random.RandomState(3).rand(3, 64, 64).astype(np.float32))
    assert chonk.shape == (2, 512, 8, 8) and bool(torch.isfinite(chonk).all())
