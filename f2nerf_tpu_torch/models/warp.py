"""Perspective warp: image-space-adaptive input warping (port of
``f2nerf_tpu/models/warp.py``).

F2-NeRF warps space before hashing so that grid resolution follows the
image-space sampling rate of the training cameras. Static-shape form:

* M anchor regions = a stride-subsample of the training cameras; a point
  belongs to its nearest anchor (a [P, M] argmin, or the k nearest for
  the blend).
* Each region has n fixed cameras (the anchors nearest it). Its chart is
  F_k(x) = S_k · PCA_k · (proj_k(x) - mu_k), where proj_k(x) stacks the
  n perspective projections (u, v) = (c_x, c_y) / max(-c_z, 1e-2) in
  each camera's frame; PCA_k, mu_k and S_k come from probe points, so
  the warped coordinates land in the hash domain [-2, 2]^3.
* A region's constants pack into one [128] row:
  w2c [n, 3, 4] | mean [2n] | pca [3, 2n] | scale [3] (20n + 3 used).
* ``blend_k = 1``: the nearest anchor's chart (discontinuous across
  region boundaries). ``blend_k > 1``: a partition-of-unity blend of the
  k nearest charts with Shepard weights w_i = (1/d_i^2) / sum_j 1/d_j^2;
  ``build_warp`` sign-aligns the charts so that the blend interpolates.

The tables are built in numpy (bitwise the JAX package's, same seed) and
held as non-trained constants, ``consts["field"]["warp_anchors"]``
[M, 3] and ``consts["field"]["warp_rows"]`` [M, 128]. The warp itself is
plain PyTorch and differentiable in the points (pose gradients).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

WARP_ROW = 128  # lane-padded packed region row


class WarpTables(NamedTuple):
    anchors: np.ndarray | torch.Tensor  # [M, 3] region anchor positions
    rows: np.ndarray | torch.Tensor     # [M, 128] packed (w2c|mean|pca|scale)
    n_cams: int


def _pack_rows(w2c: np.ndarray, mean: np.ndarray, pca: np.ndarray,
               scale: np.ndarray) -> np.ndarray:
    """w2c [M, n, 3, 4], mean [M, 2n], pca [M, 3, 2n], scale [M, 3]
    -> [M, 128] rows."""
    m, n = w2c.shape[0], w2c.shape[1]
    flat = np.concatenate([
        w2c.reshape(m, n * 12), mean, pca.reshape(m, 6 * n),
        scale], axis=1)
    assert flat.shape[1] <= WARP_ROW, flat.shape
    out = np.zeros((m, WARP_ROW), np.float32)
    out[:, :flat.shape[1]] = flat
    return out


def build_warp(poses: np.ndarray, cfg) -> WarpTables:
    """Precompute the warp tables (numpy float32) from (normalized)
    camera poses.

    Args:
      poses: [N, 3, 4] camera-to-world (scene-normalized).
      cfg: ModelConfig (warp_n_regions, warp_n_cams, init_seed).

    ``n_cams`` is ``min(warp_n_cams, N)``, while :func:`warp_points` is
    called with ``cfg.warp_n_cams`` by the field, as in the JAX package:
    the two differ when a scene has fewer views than ``warp_n_cams``.
    """
    n_images = poses.shape[0]
    m = min(cfg.warp_n_regions, n_images)
    n = min(cfg.warp_n_cams, n_images)
    sel = np.linspace(0, n_images - 1, m).round().astype(int)
    anchors = poses[sel, :3, 3]                          # [M, 3]
    cam_pos = poses[:, :3, 3]

    rng = np.random.default_rng(cfg.init_seed + 13)
    w2c_all = np.zeros((m, n, 3, 4), np.float32)
    means = np.zeros((m, 2 * n), np.float32)
    pcas = np.zeros((m, 3, 2 * n), np.float32)
    scales = np.zeros((m, 3), np.float32)

    for k in range(m):
        d = np.linalg.norm(cam_pos - anchors[k], axis=-1)
        cams = np.argsort(d)[:n]
        # typical camera spacing sets the probe region extent
        spacing = max(float(np.median(d[cams][1:])) if n > 1 else 0.5,
                      0.25)
        for i, ci in enumerate(cams):
            r = poses[ci, :3, :3]
            t = poses[ci, :3, 3]
            w2c_all[k, i, :, :3] = r.T
            w2c_all[k, i, :, 3] = -r.T @ t

        # probe points around the anchor (region scale ~ 2x spacing)
        probes = anchors[k] + rng.normal(
            0.0, spacing, (256, 3)).astype(np.float32)
        v = _project_np(probes, w2c_all[k])              # [256, 2n]
        mu = v.mean(axis=0)
        vc = v - mu
        # top-3 principal directions
        _, s, vt = np.linalg.svd(vc, full_matrices=False)
        pca = vt[:3]                                      # [3, 2n]
        y = vc @ pca.T                                    # [256, 3]
        std = np.maximum(y.std(axis=0), 1e-4)
        means[k] = mu
        pcas[k] = pca
        # map ~2.5 sigma to the edge of the hash domain [-2, 2]
        scales[k] = 2.0 / (2.5 * std)

    # sign-align charts for blending: each region's PCA component signs
    # follow its nearest already-aligned region, so neighbouring charts
    # agree in orientation and the blend interpolates instead of
    # cancelling
    for k in range(1, m):
        d_prev = np.linalg.norm(anchors[:k] - anchors[k], axis=-1)
        j = int(np.argmin(d_prev))
        for c in range(3):
            if np.dot(pcas[k, c], pcas[j, c]) < 0:
                pcas[k, c] = -pcas[k, c]

    return WarpTables(anchors=anchors.astype(np.float32),
                      rows=_pack_rows(w2c_all, means, pcas, scales),
                      n_cams=n)


def _project_np(x: np.ndarray, w2c: np.ndarray) -> np.ndarray:
    """x [P, 3], w2c [n, 3, 4] -> stacked (u, v) [P, 2n] (numpy)."""
    outs = []
    for i in range(w2c.shape[0]):
        c = x @ w2c[i, :, :3].T + w2c[i, :, 3]
        z = np.maximum(-c[:, 2], 1e-2)
        outs.append(np.stack([c[:, 0] / z, c[:, 1] / z], -1))
    return np.concatenate(outs, axis=1)


def warp_consts(poses: np.ndarray, cfg, device: torch.device | str
                ) -> dict:
    """The field's non-trained constants for ``cfg``: the warp tables of
    ``poses`` as f32 tensors on ``device`` in perspective mode
    (``{"field": {"warp_anchors", "warp_rows"}}``), else ``{}``."""
    if cfg.warp_mode != "perspective":
        return {}
    tables = build_warp(np.asarray(poses), cfg)
    return {"field": {
        "warp_anchors": torch.tensor(tables.anchors, device=device),
        "warp_rows": torch.tensor(tables.rows, device=device)}}


def _dot(mat: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """mat [I, J, ...] · vec [J, ...] -> [I, ...] as the chain m0 v0,
    then + m_j v_j by fused multiply-adds (``addcmul``) in order
    j = 1..J-1: the order and rounding of XLA's small dot products up to
    J = 6, so that the CPU path agrees with the JAX package to the bit
    (XLA sums J = 8 as a tree, ~1 ulp apart)."""
    acc = mat[:, 0] * vec[0]
    for j in range(1, mat.shape[1]):
        acc = torch.addcmul(acc, mat[:, j], vec[j])
    return acc


def _chart_apply(cols: torch.Tensor, points: torch.Tensor,
                 n: int) -> torch.Tensor:
    """Apply one packed chart per point, component-major: cols
    [20n+3, ...] (a chart's used columns), points [3, ...] -> warped
    [3, ...] (unclipped). Each component is a contiguous [...] slab, so
    every elementwise op reads coalesced memory."""
    lead = cols.shape[1:]
    w2c = cols[:12 * n].reshape(n, 3, 4, *lead)
    mean = cols[12 * n:14 * n]
    pca = cols[14 * n:20 * n].reshape(3, 2 * n, *lead)
    scale = cols[20 * n:20 * n + 3]
    c = _dot(w2c[:, :, :3].reshape(3 * n, 3, *lead), points)
    c = c.reshape(n, 3, *lead) + w2c[:, :, 3]              # [n, 3, ...]
    z = torch.clamp_min(-c[:, 2], 1e-2)
    uv = torch.stack([c[:, 0] / z, c[:, 1] / z], dim=1).reshape(2 * n, *lead)
    return _dot(pca, uv - mean) * scale


def _nearest(d2: torch.Tensor, k: int) -> torch.Tensor:
    """[P, M] squared distances -> [P, k] indices of the k smallest,
    nearest first, the lower index first among equals
    (``jax.lax.top_k(-d2, k)``'s order): k argmin passes, each masking
    its pick (cheaper than ``torch.topk`` for a small M, whose order
    among equals is unspecified)."""
    idx = []
    d = d2.detach()
    for _ in range(k):
        i = torch.argmin(d, dim=-1, keepdim=True)
        idx.append(i)
        d = d.scatter(-1, i, float("inf"))
    return torch.cat(idx, dim=-1)


def warp_points(points: torch.Tensor, tables: WarpTables,
                blend_k: int = 1) -> torch.Tensor:
    """[P, 3] world points -> [P, 3] warped coords in ~[-2, 2]^3.

    ``blend_k=1``: the nearest anchor's chart. ``blend_k>1``: the
    Shepard blend of the k nearest charts, nearest first, summed in that
    order. Only the 20n+3 used columns of the rows are gathered, into a
    component-major [20n+3, P, k] block.
    """
    with torch.profiler.record_function("warp_points"):
        n = tables.n_cams
        m = tables.anchors.shape[0]
        cols = tables.rows[:, :20 * n + 3].t()                # [20n+3, M]
        # the sum of squared differences in JAX's order (a matrix-product
        # distance rounds differently and can flip the region choice)
        pt = points.t()                                       # [3, P]
        dx, dy, dz = (pt[a][:, None] - tables.anchors[None, :, a]
                      for a in range(3))                      # [P, M] each
        d2 = dx * dx + dy * dy + dz * dz
        k = min(max(int(blend_k), 1), m)
        idx = _nearest(d2, k)                                 # [P, K]
        y = _chart_apply(cols[:, idx], pt[:, :, None], n)     # [3, P, K]
        if k == 1:
            return torch.clamp(y[..., 0].t(), -1.999, 1.999)
        inv = 1.0 / torch.clamp_min(torch.gather(d2, -1, idx), 1e-10)
        w = inv / torch.sum(inv, dim=-1, keepdim=True)
        acc = w[:, 0] * y[..., 0]
        for j in range(1, k):
            acc = acc + w[:, j] * y[..., j]
        return torch.clamp(acc.t(), -1.999, 1.999)
