"""ADA's augment pipe in the port (training/augment.py) against the JAX
package's on the CPU:

- ``HZ_FBANK`` equal; ``apply_imgfilter`` within 1e-5 (the grouped convs'
  sums in another order); ``execute_geometric_filtered`` within 2e-5 at a
  rotation, a scale and a shift (K4's and K14's plain versions; the 3x3
  products, the grid's einsum and the filters' sums round their own way);
- ``augment_pipe`` at p = 0 gives back its input within 1e-5 (the sym6 up
  and down passes of the whole filtered warp still run), in both packages;
- at p = 1 with the JAX draws replayed (a spy on jax.random.uniform /
  normal / randint inside the jitted JAX pipe, handed to the port as a
  utils/draws.Replay in the same order): 'bgc', 'bgcfnc' and the unfiltered
  warp, on 1, 3 and 6 channels, within 1e-5 x the output's largest value
  (cos / sin, the 3x3 inverse and the colour matrix's products in f32 move
  the sample points and the matrix by a few roundings);
- F17: the JAX pipe draws the hue gate from the scale gate's key, so the two
  gates are equal; the port draws every gate on its own.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panic3d_tpu.training import augment as ja
from panic3d_tpu_torch.training import augment as ta
from panic3d_tpu_torch.utils.draws import Replay

KINDS = ("uniform", "normal", "randint")


@pytest.fixture(scope="module", autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def spy(monkeypatch):
    """The values jax.random.uniform / normal / randint return to the JAX
    augment pipe, by kind, in order, while it is traced."""
    rec = {k: [] for k in KINDS}
    for kind in KINDS:
        real = getattr(jax.random, kind)

        def fn(*args, _real=real, _kind=kind, **kwargs):
            out = _real(*args, **kwargs)
            if sys._getframe(1).f_code.co_filename.endswith("panic3d_tpu/training/augment.py"):
                rec[_kind].append(out)
            return out
        monkeypatch.setattr(jax.random, kind, fn)
    return rec


def jax_pipe(spy, p, cfg):
    """The jitted JAX pipe -> fn(images, key) -> (output, its draws by kind)."""
    @jax.jit
    def run(images, key):
        for v in spy.values():
            v.clear()
        out = ja.augment_pipe(images, key, p, cfg)
        return out, {k: list(v) for k, v in spy.items()}
    return run


def images(n=3, c=3, h=16, w=16, seed=0):
    return np.random.RandomState(seed).uniform(-1, 1, (n, c, h, w)).astype(np.float32)


def test_fbank_and_imgfilter_match_jax():
    np.testing.assert_array_equal(ta.HZ_FBANK, ja.HZ_FBANK)
    x = images(c=3, h=26, w=24)
    gains = np.random.RandomState(1).uniform(0.3, 2.0, (3, 4)).astype(np.float32)
    want = jax.jit(ja.apply_imgfilter)(x, gains)
    got = ta.apply_imgfilter(torch.from_numpy(x), torch.from_numpy(gains))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def _affine(theta, s, tx, ty):
    c, sn = np.cos(theta), np.sin(theta)
    return np.asarray([[s * c, -s * sn, tx], [s * sn, s * c, ty], [0, 0, 1]], np.float32)


def test_execute_geometric_filtered_matches_jax():
    x = images(n=2, c=3, h=24, w=24, seed=2)
    G = np.stack([_affine(0.4, 1.1, 0.05, -0.1), _affine(-2.0, 0.8, -0.2, 0.0)])
    want = jax.jit(ja.execute_geometric_filtered)(x, G)
    got = ta.execute_geometric_filtered(torch.from_numpy(x), torch.from_numpy(G))
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)


def test_zero_p_is_the_identity():
    x = images(n=2, c=3, seed=3)
    got = ta.augment_pipe(torch.from_numpy(x), torch.Generator().manual_seed(0), 0.0)
    np.testing.assert_allclose(got.numpy(), x, rtol=0, atol=1e-5)
    want = ja.augment_pipe(jnp.asarray(x), jax.random.PRNGKey(0), p=0.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


CASES = {
    "bgc-c3": (ta.AugmentConfig.bgc(), 3, 16),
    "bgc-c6": (ta.AugmentConfig.bgc(), 6, 16),
    "bgc-c1": (ta.AugmentConfig.bgc(), 1, 16),
    # the image filter's reflect pad of 21 needs a side of 22 or more in torch
    "bgcfnc-c3": (ta.AugmentConfig.bgcfnc(), 3, 24),
    "bgcfnc-c6": (ta.AugmentConfig.bgcfnc(), 6, 24),
    "unfiltered-c3": (ta.AugmentConfig(xflip=1, rotate90=1, xint=1, scale=1, rotate=1, aniso=1,
                                       xfrac=1, brightness=1, lumaflip=1, filtered=False), 3,
                      16),
}


@pytest.mark.parametrize("case", list(CASES))
def test_full_p_with_jax_draws_replayed(spy, case):
    cfg, c, side = CASES[case]
    jcfg = ja.AugmentConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    x = images(n=4, c=c, h=side, w=side, seed=4)
    want, taken = jax_pipe(spy, 1.0, jcfg)(x, jax.random.PRNGKey(7))
    want = np.asarray(want)
    replay = Replay(**{k: [np.asarray(a) for a in v] for k, v in taken.items()})
    got = ta.augment_pipe(torch.from_numpy(x), replay, 1.0, cfg)
    assert replay.left() == {k: 0 for k in KINDS}
    assert got.shape == x.shape and not np.allclose(got.numpy(), x, atol=1e-2)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_f17_hue_gate_is_the_scale_gate_in_jax(spy, monkeypatch):
    """In the JAX pipe under 'bgc' the hue gate is drawn from the scale
    gate's key (keys[5]) and the saturation gate from the rotate gate's
    (keys[7]): equal draws. The port draws every gate on its own."""
    x = images(n=8, seed=5)
    _, taken = jax_pipe(spy, 0.5, ja.AugmentConfig.bgc())(x, jax.random.PRNGKey(3))
    u = [np.asarray(a) for a in taken["uniform"]]
    # the uniform draws in order: the xflip, rotate90 and xint gates, xint,
    # the scale and rotate gates, rotate, the aniso, xfrac, brightness,
    # contrast, lumaflip and hue gates, hue, the saturation gate
    assert len(u) == 15
    np.testing.assert_array_equal(u[4], u[12])      # scale gate = hue gate
    np.testing.assert_array_equal(u[5], u[14])      # rotate gate = saturation gate
    real, got = torch.rand, []

    def rand(*args, **kwargs):
        out = real(*args, **kwargs)
        got.append(out)
        return out
    monkeypatch.setattr(torch, "rand", rand)
    ta.augment_pipe(torch.from_numpy(x), torch.Generator().manual_seed(3), 0.5,
                    ta.AugmentConfig.bgc())
    assert len(got) == len(u)
    assert not torch.equal(got[4], got[12]) and not torch.equal(got[5], got[14])
