"""panic3d_tpu_torch — the PyTorch + CUDA port of panic3d_tpu for NVIDIA Hopper.

The module layout mirrors ``panic3d_tpu`` so each counterpart is easy to find:

  ops/        upfirdn2d (CUDA kernel K4), bias_act and the modulated conv's
              fused epilogue (K5), conv2d_resample, modulated_conv2d, 2-D /
              3-D grid sampling, gather_dot (K12)
  cameras/    camera labels, orthographic and pinhole rays, the view grid
  models/     StyleGAN2 generator side, superresolution, the triplane
              generator with paste-front (K8), volumetric/renderer.py with
              K1-K3 and empty-space skipping (K6), and volumetric/lattice.py
              with the factorised lattice decode and occlusion volume (K7)
  eval/       the per-portrait turntable of eval generate, the volume and
              mesh path (the density grid K1v, marching tetrahedra), the
              point-to-mesh distance (K9), chamfer / F1 and the geometry
              metrics of eval measure
  api.py      Reconstructor: portrait -> views, turntable, mesh
  utils/      image ops (sobel, morphology, nearest resize), device constants
  kernels/    the nvcc builder and the launch-count registry
  csrc/       the hand-written CUDA sources (sm_90a)
  runtime/    checkpoint name mapping (flax tree <-> torch state_dict), the
              g++ build of native/mesh_extract.cpp (marching tetrahedra)

Nothing here imports jax, flax or panic3d_tpu. Every wrapper of a CUDA
kernel takes its plain PyTorch version only for tensors on the CPU; on a
CUDA tensor it launches the kernel or raises.
"""

__version__ = "0.1.0"
