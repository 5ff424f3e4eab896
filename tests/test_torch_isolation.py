"""The port stands alone: it imports with jax blocked, chip_smoke.py refuses
to run without a CUDA device (no CPU fallback), the constructors refuse to
build on the CPU unless asked to, and the kernel wrappers take their plain
versions on CPU tensors without counting a launch."""

import os
import subprocess
import sys

import torch

from panic3d_tpu_torch.eval import equivariance, gltf, mesh_metrics, volume
from panic3d_tpu_torch.kernels import KERNELS, launch_counts
from panic3d_tpu_torch.models.stylegan3 import AFSynthesisLayer
from panic3d_tpu_torch.models.triplane import paste_composite
from panic3d_tpu_torch.models.volumetric import lattice as vlat
from panic3d_tpu_torch.models.volumetric import renderer as vr
from panic3d_tpu_torch.ops import setup_filter, upfirdn2d
from panic3d_tpu_torch.ops.bias_act import modconv_epilogue
from panic3d_tpu_torch.ops.filtered_lrelu import filtered_lrelu
from panic3d_tpu_torch.ops.gather_dot import gather_dot
from panic3d_tpu_torch.ops.grid_sample import grid_sample_2d
from panic3d_tpu_torch.training.augment import AugmentConfig, augment_pipe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(code_or_args, timeout=240):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, *code_or_args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'panic3d_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import panic3d_tpu_torch, panic3d_tpu_torch.configs, panic3d_tpu_torch.ops\n"
        "import panic3d_tpu_torch.kernels.build, panic3d_tpu_torch.runtime.checkpoint\n"
        "from panic3d_tpu_torch.models.volumetric import lattice, renderer\n"
        "import panic3d_tpu_torch.eval.generate, panic3d_tpu_torch.utils.imageops\n"
        "import panic3d_tpu_torch.ops.gather_dot, panic3d_tpu_torch.cameras\n"
        "import panic3d_tpu_torch.api, panic3d_tpu_torch.eval.volume\n"
        "import panic3d_tpu_torch.eval.mesh_metrics, panic3d_tpu_torch.eval.measure\n"
        "import panic3d_tpu_torch.runtime.native_ops, panic3d_tpu_torch.ops.bias_act\n"
        "import panic3d_tpu_torch.eval.gltf, panic3d_tpu_torch.eval.lpips\n"
        "import panic3d_tpu_torch.eval.metrics2d, panic3d_tpu_torch.models.resnet\n"
        "import panic3d_tpu_torch.ops.resize, panic3d_tpu_torch.data.databack\n"
        "import panic3d_tpu_torch.utils.imglib, panic3d_tpu_torch.utils.table\n"
        "import panic3d_tpu_torch.utils.config\n"
        "import panic3d_tpu_torch.ops.filtered_lrelu, panic3d_tpu_torch.models.stylegan3\n"
        "import panic3d_tpu_torch.eval.equivariance, panic3d_tpu_torch.eval.gan_metrics\n"
        "from panic3d_tpu_torch.models.superresolution import AFSynthesisLayer\n"
        "import panic3d_tpu_torch.runtime.convert, panic3d_tpu_torch.utils.sketchers\n"
        "import panic3d_tpu_torch.models.rmlinegan\n"
        "import panic3d_tpu_torch.utils.draws, panic3d_tpu_torch.models.superresolution\n"
        "import panic3d_tpu_torch.models.stylegan2, panic3d_tpu_torch.models.triplane\n"
        "import panic3d_tpu_torch.models.dual_discriminator, panic3d_tpu_torch.data.dataset\n"
        "import panic3d_tpu_torch.training, panic3d_tpu_torch.training.loss\n"
        "import panic3d_tpu_torch.training.loop, panic3d_tpu_torch.training.setup\n"
        "import panic3d_tpu_torch.training.stats, panic3d_tpu_torch.training.trainer\n"
        "import panic3d_tpu_torch.utils.misc, panic3d_tpu_torch.training.augment\n"
        "import panic3d_tpu_torch.ops.grid_sample\n"
        "import panic3d_tpu_torch.configs as c\n"
        "c.tiny(device='cpu')\n"
        "from panic3d_tpu_torch.runtime import checkpoint as ck\n"
        "assert ck.msgpack_restore(ck.to_bytes({'a': [1.5]})) == {'a': {'0': 1.5}}\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'flax', 'msgpack', 'panic3d_tpu')\n"
        "       and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('isolated')\n"
    )
    proc = run(["-c", code])
    assert proc.returncode == 0, proc.stderr
    assert "isolated" in proc.stdout


def test_constructors_need_cuda_unless_asked_for_the_cpu():
    code = (
        "import panic3d_tpu_torch.configs as c\n"
        "try:\n"
        "    c.tiny()\n"
        "except RuntimeError as e:\n"
        "    print('refused:', e)\n"
        "c.tiny(device='cpu')\n"
    )
    proc = run(["-c", code])
    assert proc.returncode == 0, proc.stderr
    assert "refused: no CUDA device" in proc.stdout


def test_trainer_needs_cuda_unless_asked_for_the_cpu(tmp_path):
    proc = run(["-m", "panic3d_tpu_torch.training.trainer", "--name", "x", "--outdir",
                str(tmp_path), "--tiny", "--synthetic", "--max-steps", "1"])
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
    assert not os.path.exists(tmp_path / "x" / "network-snapshot-000008")


def test_chip_smoke_fails_without_cuda():
    proc = run(["chip_smoke.py"])
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_wrappers_count_no_launch_on_cpu():
    before = launch_counts()
    torch.manual_seed(0)
    C = 8
    planes_cl = torch.randn(1, 3, 6, 6, C)
    coords = torch.rand(1, 20, 3) - 0.5
    dec = vr.Decoder(torch.randn(64, C), torch.zeros(64), torch.randn(33, 64), torch.zeros(33))
    rgb, sigma = vr.triplane_decode(planes_cl, coords, dec, 0.7, vr.generate_plane_axes(True))
    assert rgb.shape == (1, 20, 32) and sigma.shape == (1, 20, 1)
    d = torch.linspace(0.5, 1.5, 8).expand(1, 4, 8)[..., None].contiguous()
    s = torch.randn(1, 4, 8, 1)
    fine = vr.importance_sample(d, s, 6)
    assert fine.shape == (1, 4, 6, 1)
    c = torch.rand(1, 4, 8, 5)
    x = torch.rand(1, 4, 8, 3)
    out = vr.ray_composite(d, c, s, x, fine, torch.rand(1, 4, 6, 5),
                           torch.randn(1, 4, 6, 1), torch.rand(1, 4, 6, 3), True)
    assert [tuple(o.shape) for o in out] == [(1, 4, 5), (1, 4, 1), (1, 4, 1), (1, 4, 3)]
    assert upfirdn2d(torch.randn(1, 2, 5, 5), setup_filter([1, 3, 3, 1]), up=2,
                     padding=[2, 1, 2, 1]).shape == (1, 2, 10, 10)
    # K6: occupancy from lattice terms, then the narrowing
    planes = torch.randn(1, 3, C, 8, 8)
    opts = dict(ess=dict(grid=4, taps=8))
    occ, occ_out = vr.ess_occupancy(vr.generate_plane_axes(True), planes, dec, 0.7, opts)
    assert occ.shape == (1, 4, 4, 4) and occ_out.shape == ()
    t0, t1, depths = vr.ess_narrow(occ, occ_out, torch.zeros(1, 4, 3) + 0.1,
                                   torch.tensor([0.0, 0.0, -1.0]).expand(1, 4, 3), 0.5, 1.5,
                                   0.7, opts, 6)
    assert t0.shape == t1.shape == (1, 4, 1) and depths.shape == (1, 4, 6, 1)
    # K7: the occlusion volume and its sampler
    vol = vlat.front_occlusion_volume(planes, dec, 0.7, {}, grid=(4, 4, 8))
    assert vol["A"].shape == (1, 4, 4, 8)
    assert vlat.sample_front_occlusion(vol, torch.rand(1, 5, 3) - 0.5, 0.01,
                                       1.0).shape == (1, 5, 1)
    # K8: the paste masks and blend
    out = paste_composite(torch.rand(1, 3, 16, 16), torch.rand(1, 3, 16, 16),
                          torch.rand(1, 1, 4, 4), torch.rand(1, 3, 4, 4) - 0.5,
                          torch.ones(1, 1, 4, 4), torch.zeros(1, 1, 4, 4), 0.7, 0.5, 0.02, 5e-6)
    assert out["image"].shape == (1, 3, 16, 16) and out["mask"].shape == (1, 1, 16, 16)
    # K12: gather + dot
    assert gather_dot(torch.tensor([0, 2, 1], dtype=torch.int32), torch.randn(3, 8),
                      torch.randn(8, 4)).shape == (3, 4)
    # K5: the modulated conv's epilogue, and a dense layer's bias + lrelu
    y = modconv_epilogue(torch.randn(2, 3, 4, 4), torch.rand(2, 3), torch.randn(4, 4),
                         torch.tensor(0.5), torch.randn(3), act="lrelu", gain=2 ** 0.5,
                         clamp=1.0)
    assert y.shape == (2, 3, 4, 4) and float(y.abs().max()) <= 1.0
    assert modconv_epilogue(torch.randn(2, 5), bias=torch.randn(5), act="lrelu").shape == (2, 5)
    # K1v: the density grid of one portrait's planes
    grid = volume.density_grid(torch.randn(1, 3, C, 8, 8), dec, 6, 0.7,
                               vr.generate_plane_axes(True), vr.DensityFilters(0.1, 0.5))
    assert grid.shape == (6, 6, 6) and grid.dtype == torch.float16
    # K10: the deep planes' decode, and their density grid
    vols = vr.deep_volumes_cl(torch.randn(1, 3, C * 2, 6, 6), 2)
    rgb, sigma = vr.triplane_decode_deep(vols, coords, dec, 0.7, vr.generate_plane_axes(True))
    assert rgb.shape == (1, 20, 32) and sigma.shape == (1, 20, 1)
    grid = volume.density_grid(torch.randn(1, 3, C * 2, 8, 8), dec, 6, 0.7,
                               vr.generate_plane_axes(True), vr.DensityFilters(0.1, 0.5),
                               triplane_depth=2)
    assert grid.shape == (6, 6, 6) and grid.dtype == torch.float16
    # K13: winding numbers of points with respect to one triangle
    w = gltf.winding_numbers(torch.rand(3, 3), torch.tensor([[0, 1, 2]]), torch.rand(5, 3))
    assert w.shape == (5,) and w.dtype == torch.float32
    # K11: the filtered leaky relu, through the alias-free layer; K4's
    # large-filter form, through the equivariance operators
    layer = AFSynthesisLayer(w_dim=4, is_torgb=False, is_critically_sampled=False,
                             use_fp16=False, in_channels=2, out_channels=3, in_size=8,
                             out_size=8, in_sampling_rate=8, out_sampling_rate=8, in_cutoff=2.0,
                             out_cutoff=2.0, in_half_width=2.0, out_half_width=2.0,
                             use_radial_filters=True, device="cpu")
    assert layer(torch.randn(1, 2, 8, 8), torch.randn(1, 4)).shape == (1, 3, 8, 8)
    assert filtered_lrelu(torch.randn(1, 2, 5, 5), b=torch.randn(2), slope=1.0, gain=1.0,
                          clamp=1.0).shape == (1, 2, 5, 5)
    z, m = equivariance.apply_fractional_rotation(torch.randn(1, 3, 16, 16), 0.3)
    assert z.shape == m.shape == (1, 3, 16, 16)
    # K9: point -> mesh distances
    d2 = mesh_metrics.point_mesh_distance_sq(torch.rand(7, 3), torch.rand(4, 3),
                                             torch.tensor([[0, 1, 2], [1, 2, 3]]))
    assert d2.shape == (7,) and bool((d2 >= 0).all())
    # K14: the grid sample, differentiated twice, and ADA's pipe around it
    img = torch.randn(2, 3, 24, 24, requires_grad=True)
    g = torch.rand(2, 5, 6, 2) * 2.2 - 1.1
    (gx,) = torch.autograd.grad(grid_sample_2d(img, g).square().sum(), img, create_graph=True)
    gx.square().sum().backward()
    assert img.grad.shape == img.shape
    aug = augment_pipe(torch.randn(2, 6, 24, 24), torch.Generator().manual_seed(0), 1.0,
                       AugmentConfig.bgcfnc())
    assert aug.shape == (2, 6, 24, 24) and bool(torch.isfinite(aug).all())
    assert launch_counts() == before == {name: 0 for name in KERNELS}
