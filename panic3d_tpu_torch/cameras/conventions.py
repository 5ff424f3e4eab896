"""PAniC-3D camera conventions, batched (panic3d_tpu/cameras/conventions.py).

Camera labels (the 'eg3d_lustrousB' convention) and orthographic rays for
fov < 0 cameras, as batched tensor math on the inputs' device.
"""

from __future__ import annotations

import math

import torch


def _f32(v, device=None):
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _rot_x(a):
    c, s, o, z = torch.cos(a), torch.sin(a), torch.ones_like(a), torch.zeros_like(a)
    return torch.stack([torch.stack([o, z, z], -1), torch.stack([z, c, -s], -1),
                        torch.stack([z, s, c], -1)], -2)


def _rot_y(a):
    c, s, o, z = torch.cos(a), torch.sin(a), torch.ones_like(a), torch.zeros_like(a)
    return torch.stack([torch.stack([c, z, s], -1), torch.stack([z, o, z], -1),
                        torch.stack([-s, z, c], -1)], -2)


def _rot_z(a):
    c, s, o, z = torch.cos(a), torch.sin(a), torch.ones_like(a), torch.zeros_like(a)
    return torch.stack([torch.stack([c, -s, z], -1), torch.stack([s, c, z], -1),
                        torch.stack([z, z, o], -1)], -2)


def euler_xyz_matrix(x_deg, y_deg, z_deg):
    """Extrinsic-xyz Euler rotation R = Rz @ Ry @ Rx (scipy's
    Rotation.from_euler('xyz', ..., degrees=True)). Batched."""
    to_rad = math.pi / 180.0
    x, y, z = (_f32(v) * to_rad for v in (x_deg, y_deg, z_deg))
    return _rot_z(z) @ _rot_y(y) @ _rot_x(x)


def fov_to_focal(fov_deg):
    """Normalized focal length from a vertical FOV in degrees."""
    return 0.5 / torch.tan(_f32(fov_deg) / 2 * math.pi / 180.0)


def camera_label(elev, azim, dist, fov):
    """25-dim camera label: flattened 4x4 cam2world + 3x3 normalized
    intrinsics (lustrous_renders_v1.py:33-75). Negative fov marks an
    orthographic camera (intrinsics[0, 0] < 0)."""
    elev, azim, dist, fov = torch.broadcast_tensors(
        _f32(elev), _f32(azim), _f32(dist), _f32(fov))
    batch = elev.shape
    focal = fov_to_focal(fov)
    z, o = torch.zeros_like(focal), torch.ones_like(focal)
    intr = torch.stack([torch.stack([focal, z, 0.5 * o], -1),
                        torch.stack([z, focal, 0.5 * o], -1),
                        torch.stack([z, z, o], -1)], -2)
    rot = euler_xyz_matrix(elev, azim, torch.zeros_like(elev))
    # R4 = eye(4); R4[:3,:3] = rot.T; rows 0, 2 negated; R4[2,3] = -dist
    r4 = torch.zeros(batch + (4, 4), dtype=torch.float32, device=elev.device)
    r4[..., :3, :3] = rot.transpose(-1, -2)
    r4[..., 3, 3] = 1.0
    r4[..., 0, :] *= -1
    r4[..., 2, :] *= -1
    r4[..., 2, 3] = -dist
    flip_a = torch.diag(_f32([-1.0, 1.0, -1.0, 1.0], elev.device))
    flip_b = torch.diag(_f32([1.0, -1.0, -1.0, 1.0], elev.device))
    extr = flip_a @ torch.linalg.inv(r4) @ flip_b
    return torch.cat([extr.reshape(batch + (16,)), intr.reshape(batch + (9,))], -1)


def get_rays_ortho(elev, azim, dist, boxwarp, resolution):
    """Orthographic rays (lustrous_renders_v1.py:78-104): -> (ray_origins,
    ray_directions), each [..., 3, res, res]."""
    elev, azim, dist = torch.broadcast_tensors(_f32(elev), _f32(azim), _f32(dist))
    batch, dev = elev.shape, elev.device
    r, bw = resolution, boxwarp
    u = (torch.arange(r, dtype=torch.float32, device=dev) + 0.5) / r * bw - bw / 2
    gx, gy = torch.meshgrid(u, -u, indexing="xy")
    p0 = torch.stack([gx, gy, torch.zeros_like(gx)], 0)            # [3, r, r]
    p1 = p0 + _f32([0.0, 0.0, -1.0], dev)[:, None, None]
    dz = dist.reshape(batch + (1, 1, 1)) * _f32([0.0, 0.0, 1.0], dev).reshape(
        (1,) * len(batch) + (3, 1, 1))
    p0 = p0 + dz
    p1 = p1 + dz
    rot = euler_xyz_matrix(-elev, azim, torch.zeros_like(elev))     # [..., 3, 3]
    t0 = torch.einsum("...ij,...jhw->...ihw", rot, p0)
    t1 = torch.einsum("...ij,...jhw->...ihw", rot, p1)
    return t0, t1 - t0
