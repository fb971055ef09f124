"""Occupancy grid: density-guided ray sampling (port of
``f2nerf_tpu/models/occupancy.py``, VALIDATE path).

A [2, G, G, G] density grid over the contracted domain [-2, 2)^3
(channel 0 a max-EMA that decides occupancy, channel 1 a mean-EMA for
transmittance-aware eligibility). Sampling splits each ray into
``occ_segments`` segments, looks up each midpoint's cell, and keeps
``occ_keep`` segments chosen evenly among the occupied, eligible ones,
each with ``occ_samples_per_segment`` samples. Static shapes throughout.

The grid refresh (``update_grid``) and the TRAIN sampling branches
(stratified jitter, explore slots) belong to the training slice.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from f2nerf_tpu_torch.core.config import ModelConfig
from f2nerf_tpu_torch.ops.contraction import contract

DOMAIN = 2.0  # contracted coords live in [-DOMAIN, DOMAIN)
# ceiling for the sigma-EMA (the TruncExp density is unbounded)
SIGMA_EMA_MAX = 1.0e4


class OccSamples(NamedTuple):
    pts: torch.Tensor    # [R, S, 3]
    dirs: torch.Tensor   # [R, 3]
    dt: torch.Tensor     # [R, S] local spacing (0 where invalid)
    t: torch.Tensor      # [R, S]
    valid: torch.Tensor  # [R, S] bool
    # occupied-but-transmittance-ineligible sample flag
    explore: torch.Tensor  # [R, S] bool


def init_grid(cfg: ModelConfig, device: torch.device) -> torch.Tensor:
    """[2, G, G, G]: max-EMA initialized above the threshold (training
    starts fully occupied), mean-EMA initialized 0."""
    g = cfg.occ_grid_res
    gmax = torch.full((g, g, g), 4.0 * sigma_threshold(cfg),
                      dtype=torch.float32, device=device)
    return torch.stack([gmax, torch.zeros_like(gmax)])


def _cell_index(pts: torch.Tensor, g: int) -> torch.Tensor:
    """Contracted [..., 3] -> flat cell index [...] (clamped)."""
    ijk = torch.clamp(((pts + DOMAIN) * (g / (2.0 * DOMAIN))).to(
        torch.int32), 0, g - 1).long()
    return (ijk[..., 0] * g + ijk[..., 1]) * g + ijk[..., 2]


def sigma_threshold(cfg: ModelConfig) -> float:
    """Density above which a segment's alpha contribution
    1 - exp(-sigma * seg_len) exceeds cfg.occ_thresh."""
    march = cfg.n_samples * cfg.sample_l
    seg_len = march / cfg.occ_segments
    return -math.log(max(1.0 - cfg.occ_thresh, 1e-9)) / seg_len


def occupancy_bits(grid: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Occupied where the density EMA beats min(alpha-threshold, grid
    mean); flat [G^3] bool."""
    gmax = grid[0] if grid.dim() == 4 else grid
    thresh = torch.clamp_max(torch.mean(gmax), sigma_threshold(cfg))
    return (gmax >= thresh * 0.999).reshape(-1)


def occ_values(grid: torch.Tensor, cfg: ModelConfig,
               warmup: bool = False) -> torch.Tensor:
    """[2, G^3]: channel 0 the occupancy decision (max-EMA where
    occupied, 0 elsewhere), channel 1 the mean-EMA sigma used for
    transmittance-aware eligibility."""
    gmax = grid[0] if grid.dim() == 4 else grid
    gmean = grid[1] if grid.dim() == 4 else grid
    occ = occupancy_bits(grid, cfg).reshape(gmax.shape)
    zero = torch.zeros((), dtype=gmax.dtype, device=gmax.device)
    vals = torch.where(occ, torch.clamp_min(gmax, 1e-12), zero)
    if warmup:
        vals = torch.clamp_min(vals, sigma_threshold(cfg))
    return torch.stack([vals.reshape(-1),
                        torch.clamp_max(gmean, SIGMA_EMA_MAX).reshape(-1)])


def update_grid(*args, **kwargs):
    raise NotImplementedError(
        "occupancy.update_grid belongs to the training slice, not yet "
        "ported")


def sample_rays_occ(rays_o: torch.Tensor, rays_d: torch.Tensor,
                    vals: torch.Tensor, cfg: ModelConfig,
                    key=None) -> OccSamples:
    """Occupancy-guided sampling at segment midpoints (VALIDATE).

    Args:
      rays_o/rays_d: [R, 3] (dirs normalized here).
      vals: [2, G^3] from :func:`occ_values` (a [G^3] bool/float grid
        also works: eligibility degrades to plain occupancy).
      key: must be None; TRAIN jitter and explore slots are not ported.
    """
    if key is not None:
        raise NotImplementedError(
            "TRAIN occupancy sampling belongs to the training slice")
    r = rays_o.shape[0]
    dev = rays_o.device
    n_seg = cfg.occ_segments
    keep = cfg.occ_keep
    sps = cfg.occ_samples_per_segment
    march = cfg.n_samples * cfg.sample_l
    seg_len = march / n_seg

    dirs = rays_d / torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True)

    # 1. occupancy of each segment (midpoint lookup, contracted space)
    t_mid = (cfg.sample_near
             + (torch.arange(n_seg, dtype=torch.float32, device=dev) + 0.5)
             * seg_len)
    mid = rays_o[:, None, :] + dirs[:, None, :] * t_mid[None, :, None]
    cell = _cell_index(contract(mid), cfg.occ_grid_res)  # [R, n_seg]
    if vals.dim() == 2:
        both = vals.float()[:, cell]
        occ_seg, elig_seg = both[0], both[1]
    else:
        occ_seg = elig_seg = vals.float()[cell]
    occ = occ_seg > 0.0                                  # [R, n_seg]
    occ_all_orig = occ
    if cfg.occ_trans_eps > 0.0:
        # transmittance-aware eligibility from the mean-sigma channel,
        # each segment's optical depth capped at occ_elig_tau_cap
        sig = torch.clamp_max(elig_seg, SIGMA_EMA_MAX)
        tau = torch.clamp_max(sig * seg_len, cfg.occ_elig_tau_cap)
        cum_tau = torch.cumsum(tau, dim=-1) - tau        # exclusive
        occ = occ & (torch.exp(-cum_tau) > cfg.occ_trans_eps)

    # 2. evenly spaced ranks among the M occupied segments
    cum = torch.cumsum(occ.to(torch.int32), dim=-1)      # [R, n_seg]
    m = cum[:, -1:]                                      # [R, 1]
    j = torch.arange(keep, dtype=torch.float32, device=dev)[None, :]
    u = 0.5
    ranks = torch.where(
        m > keep,
        torch.floor((j + u) * m.float() / keep),
        j.expand(r, keep)).to(torch.int32)               # [R, keep]
    valid_seg = ranks < m                                # [R, keep]

    # 3. rank -> segment index: unique s with occ[s] & cum[s] == rank+1
    hit = (cum[:, None, :] == (ranks + 1)[:, :, None]) & occ[:, None, :]
    seg_idx = torch.sum(
        hit * torch.arange(n_seg, dtype=torch.int32, device=dev),
        dim=-1)                                          # [R, keep]

    # 4. samples at the centres of sps equal parts of each kept segment
    base = cfg.sample_near + seg_idx.float()[..., None] * seg_len
    within = (torch.arange(sps, dtype=torch.float32, device=dev)
              + u) * (seg_len / sps)
    t = (base + within).reshape(r, keep * sps)           # [R, S]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    dt_local = torch.where(valid_seg[..., None],
                           torch.full((), seg_len / sps, device=dev), zero)
    dt = dt_local.expand(r, keep, sps).reshape(r, keep * sps)
    valid = valid_seg[..., None].expand(r, keep, sps).reshape(r, keep * sps)
    pts = rays_o[:, None, :] + dirs[:, None, :] * t[..., None]

    ineg = occ_all_orig & ~occ
    slot_ineg = torch.gather(ineg, 1, seg_idx.long()) & valid_seg
    explore = slot_ineg[..., None].expand(r, keep, sps).reshape(
        r, keep * sps)
    return OccSamples(pts=pts, dirs=dirs, dt=dt, t=t, valid=valid,
                      explore=explore)
