"""Image quality metrics (port of ``f2nerf_tpu/utils/metrics.py``:
``psnr``, ``image_score``, ``ssim``). LPIPS needs pretrained VGG weights
and is not ported."""

from __future__ import annotations

import numpy as np
import scipy.signal


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


def ssim(pred: np.ndarray, gt: np.ndarray, max_val: float = 1.0,
         filter_size: int = 11, filter_sigma: float = 1.5,
         k1: float = 0.01, k2: float = 0.03) -> float:
    """SSIM matching the MipNeRF implementation vendored by the
    reference (scripts/eval.py:24-60): Gaussian filter, per-channel,
    convolved separably with 'valid' padding."""
    pred = np.asarray(pred, dtype=np.float64)
    gt = np.asarray(gt, dtype=np.float64)
    hw = filter_size // 2
    shift = np.arange(filter_size) - hw
    f_i = ((shift / filter_sigma) ** 2) / 2.0
    filt = np.exp(-f_i)
    filt /= np.sum(filt)

    def convolve2d(z, f):
        return scipy.signal.convolve2d(z, f, mode="valid")

    def filt2(z):  # separable Gaussian over each channel
        out = []
        for c in range(z.shape[-1]):
            tmp = convolve2d(z[..., c], filt[:, None])
            out.append(convolve2d(tmp, filt[None, :]))
        return np.stack(out, axis=-1)

    mu0 = filt2(pred)
    mu1 = filt2(gt)
    mu00 = mu0 * mu0
    mu11 = mu1 * mu1
    mu01 = mu0 * mu1
    sigma00 = filt2(pred ** 2) - mu00
    sigma11 = filt2(gt ** 2) - mu11
    sigma01 = filt2(pred * gt) - mu01

    sigma00 = np.maximum(0.0, sigma00)
    sigma11 = np.maximum(0.0, sigma11)
    sigma01 = np.sign(sigma01) * np.minimum(
        np.sqrt(sigma00 * sigma11), np.abs(sigma01))

    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    numer = (2 * mu01 + c1) * (2 * sigma01 + c2)
    denom = (mu00 + mu11 + c1) * (sigma00 + sigma11 + c2)
    return float(np.mean(numer / denom))
