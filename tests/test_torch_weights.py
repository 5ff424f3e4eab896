"""The flax variable tree and the port's state_dict name the same tensors.

Every flax leaf of the generator maps to exactly one port tensor (the only
rename is decoder/net{0,2} <-> decoder.net.{0,2}), load_state_dict(strict)
reports nothing missing or unexpected, and the shapes are equal -- for the
tiny and the flagship configs. Shapes come from jax.eval_shape, so no
weights are initialized on the JAX side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from panic3d_tpu import configs as jcfg
from panic3d_tpu.models.triplane import TriPlaneGenerator as JG
from panic3d_tpu.runtime.checkpoint import flax_path_from_torch as j_flax_path
from panic3d_tpu_torch import configs as tcfg
from panic3d_tpu_torch.runtime.checkpoint import (
    flax_path_from_torch,
    state_dict_from_flax,
    torch_name_from_flax,
)

CONFIGS = {
    "tiny": (lambda m, **kw: m.tiny(**kw), 64, 16),
    "flagship": (lambda m, **kw: m.flagship(eval_mode=True, **kw), 512, 512),
}


def flax_shapes(name):
    make, img, chonk = CONFIGS[name]
    x = {"z": jnp.zeros((1, 512 if name == "flagship" else 64)),
         "elevations": jnp.zeros(1), "azimuths": jnp.zeros(1),
         "cond": {"image_ortho_front": jnp.zeros((1, 3, img, img)),
                  "resnet_chonk": jnp.zeros((1, chonk, 8, 8))}}
    g = make(jcfg)
    return jax.eval_shape(lambda: g.init({"params": jax.random.PRNGKey(0)}, x,
                                         method=JG.f, noise_mode="const"))


def leaves(tree):
    return {tuple(p.key for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("name", ["tiny", "flagship"])
def test_every_flax_leaf_maps_to_one_port_tensor(name):
    flat = leaves(flax_shapes(name))
    sd = CONFIGS[name][0](tcfg, device="cpu").state_dict()
    names = [torch_name_from_flax(path) for path in flat]
    assert len(set(names)) == len(names)                 # one to one
    assert set(names) == set(sd)                         # nothing left over either side
    for path, leaf in flat.items():
        tname = torch_name_from_flax(path)
        assert flax_path_from_torch(tname) == path
        assert j_flax_path(tname) == path                # the JAX package's own mapping
        assert tuple(sd[tname].shape) == tuple(leaf.shape), tname


def test_state_dict_from_flax_loads_strict():
    shapes = flax_shapes("tiny")
    r = np.random.RandomState(0)
    variables = jax.tree_util.tree_map(
        lambda s: np.asarray(r.randn(*s.shape), np.float32), shapes)
    G = tcfg.tiny(device="cpu")
    result = G.load_state_dict(state_dict_from_flax(variables), strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    got = G.state_dict()
    for path, leaf in leaves(variables).items():
        np.testing.assert_array_equal(got[torch_name_from_flax(path)].numpy(), leaf)
    assert flax_path_from_torch("backbone.synthesis.b8.resample_filter") is None
