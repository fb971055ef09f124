"""Plain reference of the localizer's frame: the node's resize, the
particle search of mode 0, the differential step of mode 1, and the
reply's full-frame render and score.

The algorithm is the reference fork's (``src/localizer.cpp``,
``ros2/src/ros2-f2-nerf/src/nerf_based_localizer.cpp``), in the draw
order of the port's localizer, which keeps the JAX package's: from the
localizer's numpy ``Generator``, each particle's position noise then its
rotation noise, then the pixels without replacement. Given the
generator's state, the prior pose and the previous score before a
frame, this module works the frame out again from the frame's image and
the map's weights alone.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as TF

from portbench.reference import field as F

BASE_SCORE = 100.0   # nerf_based_localizer.cpp base_score_
NOISE_POS = 0.025    # LocalizerParam noise_position_{x,y,z} (localizer.hpp)
NOISE_ROT = 2.5      # noise_rotation_{x,y,z}, degrees
RENDER_PIXELS = 256  # render_pixel_num
DIFF_LR = 1e-4       # the node's per-frame differential step
AXIS = np.array([[0.0, 0.0, -1.0, 0.0], [-1.0, 0.0, 0.0, 0.0],
                 [0.0, 1.0, 0.0, 0.0], [0.0, 0.0, 0.0, 1.0]], np.float32)


def resize(image: np.ndarray, h: int, w: int) -> np.ndarray:
    """The node's resize (PIL's antialiased bilinear of the uint8 frame,
    rounded to uint8; ``nerf_based_localizer.cpp:225-235``)."""
    q = np.clip(np.asarray(image) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    x = torch.from_numpy(q).permute(2, 0, 1)[None].float()
    y = TF.interpolate(x, size=(h, w), mode="bilinear", align_corners=False,
                       antialias=True)
    y = torch.clamp(torch.round(y), 0, 255).to(torch.uint8)
    return y[0].permute(1, 2, 0).numpy().astype(np.float32) / 255.0


def camera2world(pose: np.ndarray) -> np.ndarray:
    """3x4 NeRF pose -> 4x4 world pose, centre 0 and radius 1
    (``src/localizer.cpp:333-346``)."""
    x = np.concatenate([np.asarray(pose, np.float32),
                        np.array([[0, 0, 0, 1]], np.float32)], 0)
    return AXIS @ (x @ AXIS.T)


def world2camera(pose_world: np.ndarray) -> np.ndarray:
    return (AXIS.T @ (np.asarray(pose_world, np.float32) @ AXIS))[:3, :4]


def _euler(theta: np.ndarray) -> np.ndarray:
    """Rz @ Ry @ Rx of per-axis angles [..., 3] (src/localizer.cpp:100-118)."""
    c, s = np.cos(theta), np.sin(theta)
    one, zero = np.ones_like(c[..., 0]), np.zeros_like(c[..., 0])

    def mat(rows):
        return np.stack(rows, -1).reshape(*c.shape[:-1], 3, 3)

    rx = mat([one, zero, zero, zero, c[..., 0], -s[..., 0],
              zero, s[..., 0], c[..., 0]])
    ry = mat([c[..., 1], zero, s[..., 1], zero, one, zero,
              -s[..., 1], zero, c[..., 1]])
    rz = mat([c[..., 2], -s[..., 2], zero, s[..., 2], c[..., 2], zero,
              zero, zero, one])
    return rz @ ry @ rx


def _to_quat(m: np.ndarray) -> np.ndarray:
    """Rotation -> (x, y, z, w), Shepperd's method."""
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([(m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
                         (m[1, 0] - m[0, 1]) / s, 0.25 * s])
    i = int(np.argmax(np.diag(m)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(m[i, i] - m[j, j] - m[k, k] + 1.0) * 2
    q = np.zeros(4)
    q[i] = 0.25 * s
    q[j] = (m[j, i] + m[i, j]) / s
    q[k] = (m[k, i] + m[i, k]) / s
    q[3] = (m[k, j] - m[j, k]) / s
    return q


def _from_quat(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])


def fuse(poses: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """Weighted position, sign-aligned unweighted quaternion mean
    (src/localizer.cpp:254-316)."""
    pos = sum(w * p[:3, 3] for p, w in zip(poses, weights))
    quats = [_to_quat(np.asarray(p[:3, :3], np.float64)) for p in poses]
    acc = np.zeros(4)
    for q in quats:
        acc += -q if np.dot(q, quats[0]) < 0 else q
    out = np.zeros((3, 4), np.float32)
    out[:3, :3] = _from_quat(acc / len(quats))
    out[:3, 3] = pos
    return out


class Map:
    """The map a frame is localized against: weights, the configuration's
    ``field`` (``reference.field``), occupancy values and camera, read in
    ``dtype``."""

    def __init__(self, params, model, field, occ_vals, intrinsic, h, w,
                 dtype):
        self.params, self.model, self.occ = params, model, occ_vals
        self.field = field
        self.intr = torch.as_tensor(intrinsic, device=occ_vals.device)
        self.h, self.w, self.dtype = h, w, dtype

    def colors(self, pose: torch.Tensor, ij: torch.Tensor) -> torch.Tensor:
        rays_o, rays_d = F.rays_from_pose(pose, self.intr, ij)
        shape = rays_o.shape[:-1]
        return F.render_rays(self.params, rays_o.reshape(-1, 3),
                             rays_d.reshape(-1, 3), self.model, self.field,
                             self.dtype, self.occ).reshape(*shape, 3)

    def image(self, pose: np.ndarray) -> np.ndarray:
        pose_t = torch.as_tensor(np.asarray(pose, np.float32),
                                 device=self.occ.device)
        return F.render_image(self.params, pose_t, self.intr, self.h, self.w,
                              self.model, self.field, self.dtype,
                              self.occ).cpu().numpy()


def score(rendered: np.ndarray, image: np.ndarray) -> float:
    diff = np.asarray(rendered) - np.asarray(image)
    return float(diff.size / (np.sum(diff * diff) + 1e-12))


def mode0(mp: Map, rng_state: dict, prior: np.ndarray, prev_score: float,
          image: np.ndarray, particle_num: int) -> dict:
    """One mode-0 frame from the state before it: (particle weights
    [P], fused 3x4 pose)."""
    rng = np.random.Generator(np.random.PCG64())
    rng.bit_generator.state = rng_state
    coeff = float(np.clip(BASE_SCORE / max(prev_score, 1e-6), 1.0, 5.0))
    pos_std = np.full(3, NOISE_POS) * coeff
    rot_std = np.full(3, NOISE_ROT) * coeff
    poses = [np.asarray(prior, np.float32)]
    for _ in range(particle_num - 1):
        q = np.asarray(prior, np.float32).copy()
        q[:3, 3] += rng.normal(0.0, pos_std)
        theta = np.deg2rad(rng.normal(0.0, rot_std))
        q[:3, :3] = _euler(theta) @ q[:3, :3]
        poses.append(q)
    poses = np.stack(poses)
    pix = min(RENDER_PIXELS, mp.h * mp.w)
    sel = rng.choice(mp.h * mp.w, size=pix, replace=False)
    dev = mp.occ.device
    ij = torch.as_tensor(np.stack([sel // mp.w, sel % mp.w], -1)
                         .astype(np.float32), device=dev)
    poses_t = torch.as_tensor(poses, device=dev)
    pred = torch.clamp(mp.colors(poses_t[:, None], ij[None]), 0.0, 1.0)
    gt = torch.as_tensor(image.reshape(-1, 3)[sel], device=dev)[None]
    loss = torch.sum(torch.mean((pred - gt) ** 2, dim=-1), dim=-1)
    weights = torch.softmax(-5.0 * torch.log(loss + 1e-6), 0).cpu().numpy()
    return {"weights": weights, "pose": fuse(poses, weights)}


def pose_loss_grad(mp: Map, pose: np.ndarray, image: np.ndarray
                   ) -> tuple[float, np.ndarray]:
    """The differential loss sum((colour - gt)^2) / (3 n) over the whole
    frame at ``pose`` and its gradient [3, 4] (src/localizer.cpp:142-167)."""
    dev = mp.occ.device
    leaf = torch.tensor(np.asarray(pose, np.float32), device=dev,
                        requires_grad=True)
    ij = F.pixel_grid(mp.h, mp.w, dev)
    gt = torch.as_tensor(image.reshape(-1, 3), device=dev)
    rays_o, rays_d = F.rays_from_pose(leaf[None], mp.intr[None], ij)
    colors = F.render(mp.params, rays_o, rays_d, mp.model, mp.field,
                      mp.dtype, occ_vals=mp.occ).colors
    loss = torch.sum((colors - gt) ** 2) / (gt.numel())
    loss.backward()
    return float(loss.detach()), leaf.grad.cpu().numpy()


def adam_first_step(pose: np.ndarray, grad: np.ndarray,
                    lr: float = DIFF_LR) -> np.ndarray:
    """The pose after one fresh Adam step (betas 0.9 / 0.999, eps 1e-8),
    rotation rows kept as the node reports them."""
    g = np.asarray(grad, np.float64)
    out = np.asarray(pose, np.float32).copy()
    step = lr * g / (np.abs(g) + 1e-8)
    out[:, 3] = (np.asarray(pose, np.float64)[:, 3] - step[:, 3])
    return out
