"""Camera / ray math (port of ``f2nerf_tpu/core/cameras.py``).

Pinhole back-projection with a half-pixel shift, OpenGL-style camera
(x right, y up, z back), and the world <-> NeRF axis conversion used by
the localizer (reference ``src/rays.cpp:7-29``,
``src/localizer.cpp:44-61,318-346``).
"""

from __future__ import annotations

import numpy as np
import torch


def rays_from_pose(pose: torch.Tensor, intrinsic: torch.Tensor,
                   ij: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Generate rays for pixel coordinates.

    Args:
      pose: [..., 3, 4] camera-to-world, camera looks down -z.
      intrinsic: [..., 3, 3] pinhole K.
      ij: [..., 2] pixel (row i, col j); the half-pixel shift is added here.

    Returns:
      (origins [..., 3], dirs [..., 3]); dirs are not normalized.
    """
    i = ij[..., 0].float() + 0.5
    j = ij[..., 1].float() + 0.5
    fx = intrinsic[..., 0, 0]
    fy = intrinsic[..., 1, 1]
    cx = intrinsic[..., 0, 2]
    cy = intrinsic[..., 1, 2]
    u = (j - cx) / fx
    v = -((i - cy) / fy)
    w = -torch.ones_like(u)
    dir_cam = torch.stack([u, v, w], dim=-1)                    # [..., 3]
    rot = pose[..., :3, :3]
    trans = pose[..., :3, 3]
    rays_d = (rot @ dir_cam[..., None])[..., 0]
    rays_o = torch.broadcast_to(trans, rays_d.shape)
    return rays_o, rays_d


def pixel_grid(h: int, w: int) -> np.ndarray:
    """All-pixel (i, j) grid, row-major — reference renderer.cpp:157-161."""
    ii, jj = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    return np.stack([ii.reshape(-1), jj.reshape(-1)], axis=-1)


# World coordinates (x front, y left, z up) <-> NeRF camera coords
# (x right, y up, z back). Reference src/localizer.cpp:50-61.
AXIS_CONVERT_MAT = np.array(
    [[0.0, 0.0, -1.0, 0.0],
     [-1.0, 0.0, 0.0, 0.0],
     [0.0, 1.0, 0.0, 0.0],
     [0.0, 0.0, 0.0, 1.0]], dtype=np.float32)


def world2camera(pose_in_world: torch.Tensor, center: torch.Tensor,
                 radius: float) -> torch.Tensor:
    """4x4 world pose -> normalized 3x4 NeRF pose (src/localizer.cpp:318-331)."""
    a = torch.as_tensor(AXIS_CONVERT_MAT, device=pose_in_world.device)
    x = a.T @ (pose_in_world @ a)
    x[:3, 3] = (x[:3, 3] - center) / radius
    return x[:3, :4]


def camera2world(pose_in_camera: torch.Tensor, center: torch.Tensor,
                 radius: float) -> torch.Tensor:
    """3x4 NeRF pose -> 4x4 world pose (src/localizer.cpp:333-346)."""
    dev = pose_in_camera.device
    a = torch.as_tensor(AXIS_CONVERT_MAT, device=dev)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], device=dev)
    x = torch.cat([pose_in_camera, bottom], dim=0)
    x[:3, 3] = x[:3, 3] * radius + center
    return a @ (x @ a.T)


def normalize_poses(poses: np.ndarray) -> tuple[np.ndarray, np.ndarray, float]:
    """Center the camera cloud and scale to unit max radius.

    Reference src/dataset.cpp:77-86. Returns (poses, center, radius).
    """
    poses = poses.copy()
    cam_pos = poses[:, :3, 3]
    center = cam_pos.mean(axis=0)
    bias = cam_pos - center
    radius = float(np.linalg.norm(bias, axis=-1).max())
    poses[:, :3, 3] = bias / radius
    return poses, center, radius
