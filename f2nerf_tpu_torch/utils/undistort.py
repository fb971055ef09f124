"""Image undistortion (Brown-Conrady k1, k2, p1, p2); a numpy copy of
``f2nerf_tpu/utils/undistort.py``, whose outputs it gives bitwise.

The reference loads distortion params but never applies them in the
renderer (SURVEY.md N12); its ROS2 ``my_image_proc`` UndistortNode does
the undistortion with an OpenCV remap LUT
(ros2/src/my_image_proc/src/undistort_node.cpp). This is the numpy
equivalent: build the remap LUT once, bilinear-sample per frame.
"""

from __future__ import annotations

import numpy as np


def build_undistort_map(intrinsic: np.ndarray, dist: np.ndarray,
                        h: int, w: int) -> tuple[np.ndarray, np.ndarray]:
    """LUT mapping undistorted pixel -> source (distorted) pixel coords.

    Args:
      intrinsic: [3, 3] K.
      dist: [4] (k1, k2, p1, p2).
    Returns:
      (map_i [H, W], map_j [H, W]) float32 source coordinates.
    """
    fx, fy = intrinsic[0, 0], intrinsic[1, 1]
    cx, cy = intrinsic[0, 2], intrinsic[1, 2]
    k1, k2, p1, p2 = [float(v) for v in dist[:4]]

    jj, ii = np.meshgrid(np.arange(w, dtype=np.float64),
                         np.arange(h, dtype=np.float64))
    x = (jj + 0.5 - cx) / fx
    y = (ii + 0.5 - cy) / fy
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    map_j = (xd * fx + cx - 0.5).astype(np.float32)
    map_i = (yd * fy + cy - 0.5).astype(np.float32)
    return map_i, map_j


def remap_bilinear(image: np.ndarray, map_i: np.ndarray,
                   map_j: np.ndarray) -> np.ndarray:
    """Sample image at fractional (map_i, map_j); out-of-range clamps."""
    h, w = image.shape[:2]
    i0 = np.clip(np.floor(map_i).astype(np.int32), 0, h - 1)
    j0 = np.clip(np.floor(map_j).astype(np.int32), 0, w - 1)
    i1 = np.clip(i0 + 1, 0, h - 1)
    j1 = np.clip(j0 + 1, 0, w - 1)
    fi = np.clip(map_i - i0, 0.0, 1.0)[..., None]
    fj = np.clip(map_j - j0, 0.0, 1.0)[..., None]
    top = image[i0, j0] * (1 - fj) + image[i0, j1] * fj
    bot = image[i1, j0] * (1 - fj) + image[i1, j1] * fj
    return (top * (1 - fi) + bot * fi).astype(image.dtype)


def undistort_image(image: np.ndarray, intrinsic: np.ndarray,
                    dist: np.ndarray) -> np.ndarray:
    """One-shot undistort (builds the LUT; cache the maps for streams)."""
    h, w = image.shape[:2]
    map_i, map_j = build_undistort_map(intrinsic, dist, h, w)
    return remap_bilinear(image, map_i, map_j)
