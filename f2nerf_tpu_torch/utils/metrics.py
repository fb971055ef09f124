"""Image quality metrics (port of ``f2nerf_tpu/utils/metrics.py``:
``psnr``, ``image_score``)."""

from __future__ import annotations

import numpy as np


def psnr(pred: np.ndarray, gt: np.ndarray) -> float:
    """Peak signal-to-noise ratio for images in [0, 1]."""
    mse = float(np.mean((np.asarray(pred) - np.asarray(gt)) ** 2))
    if mse == 0:
        return float("inf")
    return float(20.0 * np.log10(1.0 / np.sqrt(mse)))


def image_score(pred: np.ndarray, gt: np.ndarray) -> float:
    """numel / sum((pred-gt)^2) — reference utils::calc_loss."""
    diff = np.asarray(pred) - np.asarray(gt)
    return float(diff.size / (np.sum(diff * diff) + 1e-12))
