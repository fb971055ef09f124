"""Dense masked volume-rendering ops (port of
``f2nerf_tpu/ops/composite.py``: ``exclusive_cumsum``,
``density_activation``, ``composite`` and the two ray-spread losses
``weight_variance`` and ``distortion_loss``).

Samples live in a dense ``[n_rays, n_samples]`` layout; the reference's
early-stop keep mask (trans > eps) is a prefix of each ray, so masking
densities reproduces its compacted two-pass computation exactly
(reference ``src/renderer.cpp:58-122``). :func:`composite_weights` is
the compositing of already-masked densities, which the dense two-pass
renderer calls with its own mask.
"""

from __future__ import annotations

import torch

from f2nerf_tpu_torch.ops.trunc_exp import trunc_exp


def exclusive_cumsum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Per-row exclusive prefix sum (FlexOps::AccumulateSum include=false)."""
    return torch.cumsum(x, dim=dim) - x


def density_activation(raw: torch.Tensor, shift: float = 3.0) -> torch.Tensor:
    """sigma = TruncExp(raw - shift) — reference src/renderer.cpp:53-56."""
    return trunc_exp(raw - shift)


def composite(sec_density: torch.Tensor, colors: torch.Tensor,
              t: torch.Tensor, bg_color: torch.Tensor,
              trans_eps: float = 1e-4
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor]:
    """Alpha-composite a dense batch of rays.

    Args:
      sec_density: [R, S] sigma_i * dt_i.
      colors: [R, S, 3] per-sample RGB.
      t: [R, S] ray parameter of each sample.
      bg_color: [R, 3] background color.
      trans_eps: keep samples with transmittance > eps.

    Returns:
      (rgb [R, 3], depth [R], weights [R, S], mask [R, S] bool).
    """
    acc_all = exclusive_cumsum(sec_density)
    mask = torch.exp(-acc_all) > trans_eps                   # prefix mask
    rgb, depth, weights = composite_weights(sec_density * mask, colors, t,
                                            bg_color)
    return rgb, depth, weights, mask


def composite_weights(sd: torch.Tensor, colors: torch.Tensor,
                      t: torch.Tensor, bg_color: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Alpha-composite already-masked optical depths ``sd`` [R, S]
    (zero past each ray's keep prefix): (rgb [R, 3], depth [R],
    weights [R, S])."""
    acc = exclusive_cumsum(sd)
    trans = torch.exp(-acc)
    alpha = 1.0 - torch.exp(-sd)
    weights = trans * alpha                                  # [R, S]
    last_trans = torch.exp(-torch.sum(sd, dim=-1))           # [R]
    rgb = (torch.sum(weights[..., None] * colors, dim=-2)
           + last_trans[..., None] * bg_color)
    depth = (torch.sum(weights * (t + 1e-2), dim=-1)
             / (1.0 - last_trans + 1e-4))
    return rgb, depth, weights


def weight_variance(weights: torch.Tensor, mask: torch.Tensor,
                    scale: float = 16.0,
                    pos: torch.Tensor | None = None) -> torch.Tensor:
    """Per-ray variance [R] of the sample-weight distribution (reference
    src/CustomOps/CustomOps.cu:13-67, WeightVarLoss). Positions are
    i/scale for the i-th sample unless ``pos`` [R, S] is given (the train
    step passes t / (sample_l * 16), the spatial form the occupancy
    sampler needs)."""
    s = weights.shape[-1]
    if pos is None:
        pos = (torch.arange(s, dtype=torch.float32, device=weights.device)
               / scale)[None, :]
    w = weights * mask
    weight_sum = torch.sum(w, dim=-1) + 1e-6
    mean = torch.sum(w * pos, dim=-1) / weight_sum
    bias = pos - mean[..., None]
    return torch.sum(w * bias * bias, dim=-1)


def distortion_loss(weights: torch.Tensor, t: torch.Tensor, dt: torch.Tensor,
                    mask: torch.Tensor, march_len: float) -> torch.Tensor:
    """Normalized mip-NeRF-360-style distortion per ray [R]:
    sum_{i,j} w_i w_j |s_i - s_j| + (1/3) sum_i w_i^2 d_i, with s the
    interval midpoints and d the widths over ``march_len``, in O(S) by
    exclusive prefix sums (nonzero-weight positions are monotone along a
    ray)."""
    w = weights * mask
    s_mid = (t - 0.5 * dt) / march_len
    d = dt / march_len
    wm = w * s_mid
    cw = exclusive_cumsum(w)
    cwm = exclusive_cumsum(wm)
    loss_bi = 2.0 * torch.sum(w * (s_mid * cw - cwm), dim=-1)
    loss_uni = torch.sum(w * w * d, dim=-1) / 3.0
    return loss_bi + loss_uni
