"""The port's InceptionV3, the FID / KID / PR / IS detector
(panic3d_tpu_torch/eval/inception.py), against the JAX package's on the CPU.

The weights are convert_inception_v3 of a seeded torchvision-named state
dict with BatchNorm statistics (eval/inception.py:seeded_state_dict), in
both packages, never the JAX package's init_inception (a minute of flax's
unjitted init at 299^2). The JAX net is jitted once per input size,
returning the features and both softmax heads together. Held: the two
converters leaf for leaf (bit-equal: the same numpy arithmetic); the
features within 1e-5 and the probabilities within 5e-5 of their largest
value (cuDNN-free CPU convs in either package sum in their own orders:
measured 3e-7 to 1e-6 for the features, up to 7e-6 for the probabilities,
whose logits carry the features' error). preprocess (ops/resize.py's
bilinear without antialiasing) within 2.5e-7 of the f64 evaluation of its
weights, and of JAX's within F11's bound: jax.image.resize strays from its
own formula by XLA's contractions of the weights, 1.8e-6 of a [0,1] image
at 64^2 -> 224^2 (F11), up to 4e-6 at 512^2 -> 299^2 (measured here),
twice that on the detector's [-1, 1]."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panic3d_tpu.eval.inception import InceptionV3 as JInceptionV3
from panic3d_tpu.runtime.convert import convert_inception_v3 as j_convert
from panic3d_tpu_torch.eval.inception import InceptionV3, seeded_state_dict
from panic3d_tpu_torch.ops.resize import weight_mat
from panic3d_tpu_torch.runtime.convert import convert_inception_v3
from torch_one_thread import torch_one_thread  # noqa: F401  (autouse)

FEAT_TOL = 1e-5    # of the largest feature
PROB_TOL = 5e-5    # of the largest probability
F64_TOL = 2.5e-7   # preprocess against the f64 evaluation of its weights
RESIZE_TOL = 1e-5  # F11: jax.image.resize's weights, 4e-6 of [0,1] at 512^2 -> 299^2, x2


@functools.lru_cache(maxsize=1)
def weights():
    return convert_inception_v3(seeded_state_dict(0, aux_logits=True))


@functools.lru_cache(maxsize=1)
def jax_net():
    net = JInceptionV3()

    @jax.jit
    def run(variables, x):
        return (net.apply(variables, x),
                net.apply(variables, x, return_features=False),
                net.apply(variables, x, return_features=False, no_output_bias=True))
    return run


def torch_net():
    return InceptionV3(device="cpu").load_variables(weights()).eval()


def leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def heads(net, x):
    with torch.no_grad():
        xt = torch.from_numpy(x)
        return (net(xt), net(xt, return_features=False),
                net(xt, return_features=False, no_output_bias=True))


def assert_heads_close(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        tol = (FEAT_TOL if i == 0 else PROB_TOL) * np.abs(w).max()
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol, err_msg=f"head {i}")


@pytest.mark.parametrize("num_classes", [1008, 1000])
def test_convert_inception_v3_matches_jax(num_classes):
    sd = seeded_state_dict(1, num_classes=num_classes, aux_logits=True)
    got, want = dict(leaves(convert_inception_v3(sd))), dict(leaves(j_convert(sd)))
    assert got.keys() == want.keys() and len(got) == 2 * 94 + 2
    assert not any(p[1] == "AuxLogits" for p in got)
    for path, w in want.items():
        assert got[path].dtype == np.float32, path
        np.testing.assert_array_equal(got[path], np.asarray(w), err_msg=".".join(path))
    # every parameter of the port's net is named by the tree, and no other
    InceptionV3(num_classes=num_classes, device="cpu").load_variables(
        convert_inception_v3(sd))


def test_features_and_probs_match_jax_at_75():
    x = np.random.RandomState(3).uniform(-1, 1, (2, 3, 75, 75)).astype(np.float32)
    got = heads(torch_net(), x)
    want = jax_net()(weights(), jnp.asarray(x))
    assert got[0].shape == (2, 2048) and got[1].shape == got[2].shape == (2, 1008)
    np.testing.assert_allclose(got[1].sum(-1).numpy(), 1.0, rtol=1e-5)
    assert not torch.equal(got[1], got[2])   # the bias counts unless no_output_bias
    assert_heads_close(got, want)


@pytest.mark.parametrize("size", [512, 64])
def test_preprocess_matches_jax(size):
    img = np.random.RandomState(size).rand(2, 3, size, size).astype(np.float32)
    got = InceptionV3.preprocess(torch.from_numpy(img), in_range=(0.0, 1.0))
    want = JInceptionV3.preprocess(jnp.asarray(img), in_range=(0.0, 1.0))
    assert got.shape == (2, 3, 299, 299)
    w = weight_mat(size, 299, "bilinear", False, torch.device("cpu")).double().numpy()
    exact = w.T @ (img.astype(np.float64) * 2.0 - 1.0) @ w
    np.testing.assert_allclose(got.numpy(), exact, rtol=0, atol=F64_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=RESIZE_TOL)
    # at 299^2 only the range moves
    x = torch.rand((1, 3, 299, 299), generator=torch.Generator().manual_seed(size))
    np.testing.assert_array_equal(InceptionV3.preprocess(x, in_range=(0.0, 1.0)).numpy(),
                                  (x * 2.0 - 1.0).numpy())


def test_full_299_forward_matches_jax():
    img = np.random.RandomState(5).rand(2, 3, 512, 512).astype(np.float32)
    x = InceptionV3.preprocess(torch.from_numpy(img), in_range=(0.0, 1.0)).numpy()
    got = heads(torch_net(), x)
    want = jax_net()(weights(), jnp.asarray(x))
    assert np.isfinite(got[0].numpy()).all() and float(got[0].abs().max()) > 1.0
    assert_heads_close(got, want)
