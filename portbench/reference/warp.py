"""Plain reference of F2-NeRF's perspective warp (Wang et al., "F2-NeRF:
Fast Neural Radiance Field Training with Free Camera Trajectories", CVPR
2023), in the static-shape form that the port keeps from the JAX
package: it maps a world point into the hash domain [-2, 2]^3 through
the cameras that see it, so that the grid's resolution follows the
image-space sampling rate along a trajectory that does not orbit.

From the training cameras alone (:func:`charts`, NumPy float32):

* M anchor regions: the positions of M cameras taken at an even stride
  over the trajectory (``linspace(0, N - 1, M)`` rounded);
* each region's n cameras: the n camera positions nearest its anchor
  (the lower index first among equals);
* its chart F(x) = S · PCA · (proj(x) - mu). proj(x) stacks, camera by
  camera, the perspective projection (u, v) = (c_x, c_y) / max(-c_z,
  1e-2) of x in that camera's frame (it looks down -z). mu, PCA and S
  come from 256 probe points drawn N(anchor, spacing^2) per axis, region
  by region from one ``default_rng(init_seed + 13)``, where spacing is
  the median distance from the anchor to the region's other cameras, at
  least 0.25: mu is their mean projection, PCA the top three right
  singular vectors of the centred projections, and S maps 2.5 standard
  deviations of each component to 2;
* the charts' signs: region by region, each PCA component whose dot
  product with that of the nearest earlier region is negative turns
  round, so that neighbouring charts agree and a blend interpolates.

A point then takes the Shepard blend of its k nearest regions' charts
(:func:`warp`), weights (1 / d_i^2) / sum_j (1 / d_j^2), clamped to
±1.999. The distances are the sums of squared differences in x, y, z
order, not a matrix product ``|p|^2 - 2 p·a + |a|^2``: that rounds
otherwise and can flip which regions a point takes, which is a jump in
the blend. Each dot product of a chart is a chain of multiply-adds,
first term first (:func:`_dot`), and the blend sums its charts nearest
first: the refresh's grid corners near the contracted domain's edge
uncontract to points ~1e6 away, where a chart cancels terms of that
size to values of order one, so another order of the same sums gives
another warped point there (up to ~0.8 of the domain's 4, against
~1e-5 elsewhere), and another density.

It imports nothing of the program: the tables are built again from the
cameras, and nothing the program is handed is kept.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

PROBES = 256            # probe points a region
CLAMP = 1.999           # the warped coordinates' bound
Z_MIN = 1e-2            # a projection's least depth
SIGMAS = 2.5            # standard deviations mapped to the domain's edge


class Charts(NamedTuple):
    anchors: np.ndarray  # [M, 3] region anchors
    w2c: np.ndarray      # [M, n, 3, 4] each region's cameras, world to camera
    mean: np.ndarray     # [M, 2n] mu
    pca: np.ndarray      # [M, 3, 2n]
    scale: np.ndarray    # [M, 3] S


def project(x: np.ndarray, w2c: np.ndarray) -> np.ndarray:
    """[P, 3] points through [n, 3, 4] cameras -> [P, 2n] (u, v) a
    camera, camera by camera."""
    uv = []
    for cam in w2c:
        c = x @ cam[:, :3].T + cam[:, 3]
        z = np.maximum(-c[:, 2], Z_MIN)
        uv += [c[:, 0] / z, c[:, 1] / z]
    return np.stack(uv, axis=1)


def charts(poses: np.ndarray, model) -> Charts:
    """The charts of the [N, 3, 4] camera-to-world ``poses`` for the
    model's ``warp_n_regions``, ``warp_n_cams`` and ``init_seed``."""
    poses = np.asarray(poses, np.float32)
    n_img = poses.shape[0]
    m = min(model.warp_n_regions, n_img)
    n = min(model.warp_n_cams, n_img)
    anchors = poses[np.linspace(0, n_img - 1, m).round().astype(int), :3, 3]
    positions = poses[:, :3, 3]
    rng = np.random.default_rng(model.init_seed + 13)
    w2c = np.zeros((m, n, 3, 4), np.float32)
    mean = np.zeros((m, 2 * n), np.float32)
    pca = np.zeros((m, 3, 2 * n), np.float32)
    scale = np.zeros((m, 3), np.float32)
    for k in range(m):
        dist = np.linalg.norm(positions - anchors[k], axis=-1)
        near = np.argsort(dist, kind="stable")[:n]
        spacing = max(float(np.median(dist[near][1:])) if n > 1 else 0.5,
                      0.25)
        for i, cam in enumerate(near):
            rot, origin = poses[cam, :, :3], poses[cam, :, 3]
            w2c[k, i, :, :3] = rot.T
            w2c[k, i, :, 3] = -rot.T @ origin
        probes = anchors[k] + rng.normal(0.0, spacing, (PROBES, 3)).astype(
            np.float32)
        uv = project(probes, w2c[k])
        mean[k] = uv.mean(axis=0)
        centred = uv - mean[k]
        pca[k] = np.linalg.svd(centred, full_matrices=False)[2][:3]
        spread = np.maximum((centred @ pca[k].T).std(axis=0), 1e-4)
        scale[k] = 2.0 / (SIGMAS * spread)
    for k in range(1, m):
        j = int(np.argmin(np.linalg.norm(anchors[:k] - anchors[k], axis=-1)))
        for c in range(3):
            if np.dot(pca[k, c], pca[j, c]) < 0:
                pca[k, c] = -pca[k, c]
    return Charts(anchors.astype(np.float32), w2c, mean, pca, scale)


def uncontract(points: torch.Tensor, radius: float = 1.0) -> torch.Tensor:
    """The inverse of the radial contraction on the open ball of radius
    2r (``src/hash_3d_anchored.cpp:79-82`` inverted; the contracted
    radius is held 1e-6 inside 2r)."""
    rho = torch.linalg.vector_norm(points, dim=-1, keepdim=True)
    safe_rho = torch.clamp_min(rho, 1e-12)
    r_world = radius / torch.clamp_min(1.0 + radius - safe_rho, 1e-6)
    return torch.where(rho <= radius, points, points / safe_rho * r_world)


def _dot(mat: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """sum_j mat[..., j] * vec[..., j] over the last axis, as the chain
    m_0 v_0, then + m_j v_j by one multiply-add each, j = 1, 2, ..."""
    acc = mat[..., 0] * vec[..., 0]
    for j in range(1, mat.shape[-1]):
        acc = torch.addcmul(acc, mat[..., j], vec[..., j])
    return acc


def warp(points: torch.Tensor, ch: Charts, blend_k: int) -> torch.Tensor:
    """[P, 3] world points -> [P, 3] coordinates in [-1.999, 1.999]^3:
    the Shepard blend of the ``blend_k`` nearest regions' charts (one
    region: its chart alone)."""
    dev = points.device

    def t(a):
        return torch.as_tensor(a, device=dev)

    anchors = t(ch.anchors)
    dx, dy, dz = (points[:, None, a] - anchors[None, :, a] for a in range(3))
    d2 = dx * dx + dy * dy + dz * dz                          # [P, M]
    k = min(max(int(blend_k), 1), anchors.shape[0])
    idx = torch.sort(d2, dim=-1, stable=True).indices[:, :k]  # [P, k]
    w2c = t(ch.w2c)[idx]                                      # [P, k, n, 3, 4]
    x = points[:, None, None, None, :]
    cam = _dot(w2c[..., :3], x) + w2c[..., 3]                 # [P, k, n, 3]
    z = torch.clamp_min(-cam[..., 2], Z_MIN)
    uv = torch.stack([cam[..., 0] / z, cam[..., 1] / z], -1).flatten(2)
    centred = (uv - t(ch.mean)[idx])[:, :, None, :]           # [P, k, 1, 2n]
    y = _dot(t(ch.pca)[idx], centred) * t(ch.scale)[idx]      # [P, k, 3]
    if k == 1:
        return torch.clamp(y[:, 0], -CLAMP, CLAMP)
    inv = 1.0 / torch.clamp_min(torch.gather(d2, 1, idx), 1e-10)
    w = inv / inv.sum(-1, keepdim=True)
    acc = w[:, 0, None] * y[:, 0]
    for j in range(1, k):
        acc = acc + w[:, j, None] * y[:, j]
    return torch.clamp(acc, -CLAMP, CLAMP)
