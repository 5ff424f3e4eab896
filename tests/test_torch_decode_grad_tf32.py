"""K1's backward form's tensor-core arithmetic, emulated on the CPU.

csrc/triplane_decode_grad.cu redoes K1's decode and runs it backward on the
tensor cores: layer 1 and layer 2 again, dL/dh = dL/dout W1, dL/df =
dL/dpre W0, and the weight gradients dW0 = dL/dpre^T f and dW1 = dL/dout^T
h over each round of 64 points (4 warps x 16), each product in TF32 with
the 3xTF32 split (hi = v rounded to TF32 by cvt.rna, lo = (v - hi) rounded
to TF32; a_lo*b_hi + a_hi*b_lo + a_hi*b_hi with f32 accumulation). A
quad of 4 warps adds its rounds' products into its f32 partial; a second
launch sums the partials in order in f64 and applies the gains. Here the
same rounding is done on the f32 bits, the three products are f32
matmuls, the rounds go to the partials round-robin as the persistent grid's
quads take them, and the plane gradient is the sampler's transpose of
dL/df / 3 in f32. The grid itself (renderer.py:k1_grad_ctas) must hand
every round to exactly one quad.

At flagship widths (C=32, 64 hidden, 33 outputs; seeded weights at the
seeded flagship's scale, the +2.5 sigma bias) the emulation must stay
within the card's tolerances (chip_smoke.py:k1_grad_check) of jax.grad of
the JAX decode (panic3d_tpu/models/volumetric/renderer.py:run_model with
models/triplane.py:OSGDecoder): the plane gradient within 2^-7 of its max,
each weight gradient within 1e-4 of its max. And one TF32 pass in the
weight products alone must not hold the weight gradients there.
"""

import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panic3d_tpu.models.triplane import OSGDecoder as JDecoder
from panic3d_tpu.models.volumetric import renderer as jvr
from panic3d_tpu_torch.models.volumetric import renderer as tvr

C, HIDDEN, OUT = 32, 64, 33
BW = 0.7
N, M, H = 1, 1536, 24        # 24 rounds of 64 points
CTAS = 5                     # partials: rounds 0, 5, 10, ... go to quad 0
PLANE_TOL, WEIGHT_TOL = 2.0 ** -7, 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value, ties away from zero (cvt.rna.tf32.f32)."""
    bits = x.contiguous().view(torch.int32)
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    return ((bits & -0x80000000) | mag).view(torch.float32)


def matmul_3xtf32(a, b):
    a_hi, b_hi = tf32_rna(a), tf32_rna(b)
    a_lo, b_lo = tf32_rna(a - a_hi), tf32_rna(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def matmul_tf32(a, b):
    return tf32_rna(a) @ tf32_rna(b)


@pytest.fixture(scope="module")
def case():
    r = np.random.RandomState(0)
    p = {"net0": {"weight": r.randn(HIDDEN, C).astype(np.float32),
                  "bias": (r.randn(HIDDEN) * 0.1).astype(np.float32)},
         "net2": {"weight": r.randn(OUT, HIDDEN).astype(np.float32),
                  "bias": (r.randn(OUT) * 0.1 + np.eye(OUT)[0] * 2.5).astype(np.float32)}}
    planes = (r.randn(N, 3, C, H, H) * 0.5).astype(np.float32)
    coords = r.uniform(-0.34, 0.34, (N, M, 3)).astype(np.float32)
    coords[0, 64:112, :2] = coords[0, 64, :2]        # a ray along z (the ortho front view)
    g_rgb = r.randn(N, M, 32).astype(np.float32)
    g_sigma = r.randn(N, M, 1).astype(np.float32)
    return p, planes, coords, g_rgb, g_sigma


@pytest.fixture(scope="module")
def jax_grads(case):
    p, planes, coords, g_rgb, g_sigma = case
    axes = jvr.generate_plane_axes(True)
    dec = JDecoder(C)

    def loss(planes, params):
        rgb, sigma = jvr.run_model(axes, planes, lambda f, **kw: dec.apply(params, f, **kw),
                                   jnp.asarray(coords), BW)
        return jnp.sum(rgb * g_rgb) + jnp.sum(sigma * g_sigma)

    params = {"params": jax.tree_util.tree_map(jnp.asarray, p)}
    gp, gw = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(planes), params)
    gw = gw["params"]
    return (np.asarray(gp), np.asarray(gw["net0"]["weight"]), np.asarray(gw["net0"]["bias"]),
            np.asarray(gw["net2"]["weight"]), np.asarray(gw["net2"]["bias"]))


def emulated_grads(case, weight_matmul):
    """csrc/triplane_decode_grad.cu's arithmetic in f32 (the weight products
    by ``weight_matmul``) -> (g_planes [N,3,C,H,W], g_w0, g_b0, g_w1, g_b1)."""
    p, planes_np, coords_np, g_rgb_np, g_sigma_np = case
    t = torch.from_numpy
    w0 = t(p["net0"]["weight"]) / math.sqrt(C)
    w1 = t(p["net2"]["weight"]) / math.sqrt(HIDDEN)
    b0, b1 = t(p["net0"]["bias"]), t(p["net2"]["bias"])
    axes = tvr.generate_plane_axes(True)
    planes = t(planes_np).requires_grad_(True)
    feats = tvr.sample_from_planes(axes, planes, t(coords_np), BW)        # [N,3,M,C]
    f = ((feats[:, 0] + feats[:, 1]) + feats[:, 2]).detach().reshape(-1, C) / 3
    pre = matmul_3xtf32(f, w0.T) + b0
    h = torch.nn.functional.softplus(pre)
    o = matmul_3xtf32(h, w1.T) + b1
    s = torch.sigmoid(o[:, 1:])
    g_out = torch.cat([t(g_sigma_np).reshape(-1, 1),
                       t(g_rgb_np).reshape(-1, 32) * (s * (1 - s)) * 1.002], 1)
    g_pre = matmul_3xtf32(g_out, w1) * torch.sigmoid(pre)
    g_f = matmul_3xtf32(g_pre, w0)
    # the scatter: each plane sample's corners get weight x dL/df / 3
    feats.backward((g_f / 3).reshape(N, 1, M, C).expand(N, 3, M, C))
    sizes = (HIDDEN * C, OUT * HIDDEN, HIDDEN, OUT)
    parts = torch.zeros((CTAS, sum(sizes)))
    for rnd in range(M // 64):
        sl = slice(64 * rnd, 64 * rnd + 64)
        parts[rnd % CTAS] += torch.cat([weight_matmul(g_pre[sl].T, f[sl]).reshape(-1),
                                        weight_matmul(g_out[sl].T, h[sl]).reshape(-1),
                                        g_pre[sl].sum(0), g_out[sl].sum(0)])
    total = parts.double().sum(0)
    gains = torch.cat([torch.full((n,), g, dtype=torch.float64) for n, g in
                       zip(sizes, (1 / math.sqrt(C), 1 / math.sqrt(HIDDEN), 1.0, 1.0))])
    g_w0, g_w1, g_b0, g_b1 = (total * gains).float().split(sizes)
    return (planes.grad, g_w0.reshape(HIDDEN, C), g_b0, g_w1.reshape(OUT, HIDDEN), g_b1)


def rel_errors(got, want):
    return [float(np.abs(g.detach().numpy() - w).max() / np.abs(w).max())
            for g, w in zip(got, want)]


def test_3xtf32_backward_within_card_tolerances(case, jax_grads):
    errs = rel_errors(emulated_grads(case, matmul_3xtf32), jax_grads)
    assert errs[0] <= PLANE_TOL, errs
    assert max(errs[1:]) <= WEIGHT_TOL, errs


def test_one_tf32_pass_in_the_weight_products_is_not_enough(case, jax_grads):
    errs = rel_errors(emulated_grads(case, matmul_tf32), jax_grads)
    errs3 = rel_errors(emulated_grads(case, matmul_3xtf32), jax_grads)
    assert max(errs[1:]) > WEIGHT_TOL, errs
    assert max(errs3[1:]) < max(errs[1:]) / 10, (errs3, errs)


@pytest.mark.parametrize("points", [1_572_864, 786_432, 1536, 64 * 3 * 132 + 1, 1])
def test_persistent_grid_takes_every_round_once(points):
    """The wrapper's grid and partials (renderer.py:k1_grad_ctas,
    K1G_QUADS) against the kernel's loop (csrc/triplane_decode_grad.cu) on
    bf16 and f32 planes: the quads a CTA are the kernel's for the dtype
    (quads_of, which the entry points hold the wrapper to); quad qg = CTA x
    quads + quad takes rounds qg, qg + ctas x quads, ... and writes
    partial row qg, and the finish sums ctas x quads rows, so no quad
    writes past the scratch and no CTA is launched without a round; a
    grid of fewer CTAs than the SMs leaves no round for another."""
    src = (Path(tvr.__file__).resolve().parents[2] / "csrc" / "triplane_decode_grad.cu")
    m = re.search(r"quads_of\(\) \{ return sizeof\(T\) == 2 \? (\d+) : (\d+); \}",
                  src.read_text())
    assert m, "quads_of not found in triplane_decode_grad.cu"
    kernel_quads = {torch.bfloat16: int(m.group(1)), torch.float32: int(m.group(2))}
    assert tvr.K1G_QUADS == kernel_quads
    sms = 132
    rounds = -(-points // (16 * tvr.K1G_WARPS))
    for dtype, quads in tvr.K1G_QUADS.items():
        ctas = tvr.k1_grad_ctas(points, sms, quads)
        assert 1 <= ctas <= tvr.K1G_CTAS_PER_SM * sms
        rows = ctas * quads    # the wrapper's partials, the finish's sum
        taken = {}
        for qg in range(rows):
            for r in range(qg, rounds, rows):
                taken[r] = qg
        assert sorted(taken) == list(range(rounds))
        assert max(taken.values()) < rows
        # every CTA has a round: none launched for nothing
        assert all(b * quads < rounds for b in range(ctas)), dtype
        # a grid short of the SMs runs every round in one pass of its quads
        assert ctas == tvr.K1G_CTAS_PER_SM * sms or rounds <= rows, dtype
