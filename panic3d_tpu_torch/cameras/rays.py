"""Pinhole ray generation (panic3d_tpu/cameras/rays.py)."""

from __future__ import annotations

import torch


def sample_rays(cam2world_matrix, intrinsics, resolution: int):
    """cam2world [N,4,4], normalized OpenCV intrinsics [N,3,3] ->
    (ray_origins, ray_directions), each [N, resolution^2, 3], pixel-center
    uv grid, row-major (RaySampler.forward, ray_sampler.py:24-62)."""
    N = cam2world_matrix.shape[0]
    M = resolution * resolution
    dev = cam2world_matrix.device
    cam_pos = cam2world_matrix[:, :3, 3]
    fx = intrinsics[:, 0, 0][:, None]
    fy = intrinsics[:, 1, 1][:, None]
    cx = intrinsics[:, 0, 2][:, None]
    cy = intrinsics[:, 1, 2][:, None]
    sk = intrinsics[:, 0, 1][:, None]
    r = torch.arange(resolution, dtype=torch.float32, device=dev) / resolution + 0.5 / resolution
    gy, gx = torch.meshgrid(r, r, indexing="ij")
    x_cam = gx.reshape(1, M).expand(N, M)
    y_cam = gy.reshape(1, M).expand(N, M)
    z_cam = torch.ones((N, M), dtype=torch.float32, device=dev)
    x_lift = (x_cam - cx + cy * sk / fy - sk * y_cam / fy) / fx * z_cam
    y_lift = (y_cam - cy) / fy * z_cam
    cam_rel = torch.stack([x_lift, y_lift, z_cam, torch.ones_like(z_cam)], -1)
    world = torch.einsum("nij,nmj->nmi", cam2world_matrix, cam_rel)[..., :3]
    dirs = world - cam_pos[:, None, :]
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    return cam_pos[:, None, :].expand_as(dirs), dirs
