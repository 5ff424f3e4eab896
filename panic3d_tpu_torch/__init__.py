"""panic3d_tpu_torch — the PyTorch + CUDA port of panic3d_tpu for NVIDIA Hopper.

The module layout mirrors ``panic3d_tpu`` so each counterpart is easy to find:

  ops/        upfirdn2d (CUDA kernel K4), bias_act, conv2d_resample,
              modulated_conv2d, grid_sample_2d_points
  cameras/    camera labels, orthographic and pinhole rays
  models/     StyleGAN2 generator side, superresolution, the triplane
              generator, and volumetric/renderer.py with kernels K1-K3
  kernels/    the nvcc builder and the launch-count registry
  csrc/       the hand-written CUDA sources (sm_90a)
  runtime/    checkpoint name mapping (flax tree <-> torch state_dict)

Nothing here imports jax, flax or panic3d_tpu. Every wrapper of a CUDA
kernel takes its plain PyTorch version only for tensors on the CPU; on a
CUDA tensor it launches the kernel or raises.
"""

__version__ = "0.1.0"
