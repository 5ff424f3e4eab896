"""The port stands alone: it imports with jax blocked, chip_smoke.py refuses
to run without a CUDA device (no CPU fallback), and the kernel wrappers take
their plain versions on CPU tensors without counting a launch."""

import os
import subprocess
import sys

import torch

from panic3d_tpu_torch.kernels import KERNELS, launch_counts
from panic3d_tpu_torch.models.volumetric import renderer as vr
from panic3d_tpu_torch.ops import setup_filter, upfirdn2d

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(code_or_args, timeout=240):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, *code_or_args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'panic3d_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import panic3d_tpu_torch, panic3d_tpu_torch.configs, panic3d_tpu_torch.ops\n"
        "import panic3d_tpu_torch.kernels.build, panic3d_tpu_torch.runtime.checkpoint\n"
        "from panic3d_tpu_torch.models.volumetric import renderer\n"
        "import panic3d_tpu_torch.configs as c\n"
        "c.tiny()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'panic3d_tpu')\n"
        "       and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('isolated')\n"
    )
    proc = run(["-c", code])
    assert proc.returncode == 0, proc.stderr
    assert "isolated" in proc.stdout


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
    assert launch_counts() == before == {name: 0 for name in KERNELS}
