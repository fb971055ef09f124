"""Occupancy grid: density-guided ray sampling (port of
``f2nerf_tpu/models/occupancy.py``).

A [2, G, G, G] density grid over the contracted domain [-2, 2)^3
(channel 0 a max-EMA that decides occupancy, channel 1 a mean-EMA for
transmittance-aware eligibility), refreshed by :func:`update_grid` at
jittered cell centres, one strided 1/K of the cells per call. Sampling
splits each ray into ``occ_segments`` segments, looks up each midpoint's
cell, and keeps ``occ_keep`` segments chosen evenly among the occupied,
eligible ones, each with ``occ_samples_per_segment`` samples. TRAIN
jitters the ranks and the samples and adds the explore slots. Static
shapes throughout.
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


def refresh_points(cfg: ModelConfig) -> int:
    """Cells one :func:`update_grid` call queries: G^3 / K."""
    g, k_sub = cfg.occ_grid_res, cfg.occ_refresh_phases
    if (g ** 3) % k_sub:
        raise ValueError("occ_refresh_phases must divide occ_grid_res^3")
    return g ** 3 // k_sub


def update_grid(grid: torch.Tensor, density_fn, cfg: ModelConfig,
                u: torch.Tensor, phase: int = 0) -> torch.Tensor:
    """Phased EMA refresh (JAX ``update_grid``, ``occupancy.py:130-176``).

    Decays the whole max channel and queries ``density_fn`` ([M, 3]
    contracted points -> [M] sigma) at the jittered centres of the cells
    whose flat index is ``phase`` mod K; those cells get
    max(decay * max, sigma) and mean-EMA (1 - a) * mean + a * sigma.
    Non-finite or exploded sigma is clamped to ``SIGMA_EMA_MAX``. The
    jitter is (u - 0.5) * cell with ``u`` the U[0,1) draws [M, 3]
    (``train.step.draw_noise`` makes them). Returns the new grid;
    ``grid`` is not modified.
    """
    g = cfg.occ_grid_res
    k_sub = cfg.occ_refresh_phases
    m = refresh_points(cfg)
    dev = grid.device
    cell = 2.0 * DOMAIN / g
    flat = torch.arange(m, dtype=torch.int32, device=dev) * k_sub + phase
    ijk = torch.stack([flat // (g * g), (flat // g) % g, flat % g],
                      dim=-1).float()
    centers = (ijk + 0.5) * cell - DOMAIN
    sigma = density_fn(centers + (u - 0.5) * cell)
    sigma = torch.where(torch.isfinite(sigma), sigma,
                        torch.full((), SIGMA_EMA_MAX, device=dev))
    sigma = torch.clamp_max(sigma, SIGMA_EMA_MAX)             # [M]
    gmax = grid[0] if grid.dim() == 4 else grid
    new_max = (gmax * cfg.occ_decay).reshape(m, k_sub)
    new_max[:, phase] = torch.maximum(new_max[:, phase], sigma)
    new_max = new_max.reshape(g, g, g)
    if grid.dim() != 4:          # legacy single-channel grid
        return new_max
    a = cfg.occ_mean_ema
    new_mean = grid[1].reshape(m, k_sub).clone()
    new_mean[:, phase] = new_mean[:, phase] * (1.0 - a) + sigma * a
    return torch.stack([new_max, new_mean.reshape(g, g, g)])


def sample_rays_occ(rays_o: torch.Tensor, rays_d: torch.Tensor,
                    vals: torch.Tensor, cfg: ModelConfig,
                    rank_u: torch.Tensor | None = None,
                    within_u: torch.Tensor | None = None,
                    explore: torch.Tensor | None = None) -> OccSamples:
    """Occupancy-guided stratified sampling (static shapes).

    Args:
      rays_o/rays_d: [R, 3] (dirs normalized here).
      vals: [2, G^3] from :func:`occ_values` (a [G^3] bool/float grid
        also works: eligibility degrades to plain occupancy).
      rank_u, within_u: TRAIN draws U[0,1) [R, keep] (rank jitter) and
        [R, keep, sps] (within-segment jitter); both None is VALIDATE
        (midpoints, no explore slots).
      explore: TRAIN [R, 1] bool exploration rays, required when
        cfg.occ_explore_eps > 0 (they ignore the transmittance cut).
    """
    train = rank_u is not None
    if train and within_u is None:
        raise ValueError("TRAIN sampling needs both rank_u and within_u")
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
    occ_all = occ_all_orig = occ
    if cfg.occ_trans_eps > 0.0:
        # transmittance-aware eligibility from the mean-sigma channel,
        # each segment's optical depth capped at occ_elig_tau_cap
        sig = torch.clamp_max(elig_seg, SIGMA_EMA_MAX)
        tau = torch.clamp_max(sig * seg_len, cfg.occ_elig_tau_cap)
        cum_tau = torch.cumsum(tau, dim=-1) - tau        # exclusive
        occ = occ & (torch.exp(-cum_tau) > cfg.occ_trans_eps)

    # exploration rays (TRAIN only) ignore the transmittance cut
    if train and cfg.occ_explore_eps > 0.0:
        if explore is None:
            raise ValueError("occ_explore_eps > 0 needs the explore draws")
        occ = torch.where(explore, occ_all, occ)

    # 2. stratified ranks among the M occupied segments: slot j picks
    # occupied-rank floor((j + u) * M / K), u = 0.5 in VALIDATE. In
    # TRAIN the last occ_explore_slots slots stratify over the occupied
    # but ineligible segments instead (all occupied ones when there are
    # none, or when the explore is not targeted).
    n_exp = min(cfg.occ_explore_slots, keep - 1) if train else 0
    k_base = keep - n_exp
    cum = torch.cumsum(occ.to(torch.int32), dim=-1)      # [R, n_seg]
    m = cum[:, -1:]                                      # [R, 1]
    j = torch.arange(keep, dtype=torch.float32, device=dev)[None, :]
    u = rank_u if train else 0.5
    ranks = torch.where(
        m > k_base,
        torch.floor((j + u) * m.float() / k_base),
        j.expand(r, keep)).to(torch.int32)               # [R, keep]
    if n_exp:
        if cfg.occ_explore_targeted:
            occ_tgt = occ_all & ~occ
            has_tgt = torch.any(occ_tgt, dim=-1, keepdim=True)
            occ_all = torch.where(has_tgt, occ_tgt, occ_all)
        cum_all = torch.cumsum(occ_all.to(torch.int32), dim=-1)
        m_all = cum_all[:, -1:]
        ranks_exp = torch.floor(
            (j - k_base + u) * m_all.float() / n_exp).to(torch.int32)
        is_exp = (torch.arange(keep, device=dev) >= k_base)[None, :]
        ranks = torch.where(is_exp, ranks_exp, ranks)
        m_sel = torch.where(is_exp, m_all, m)            # [R, keep]
        cum_sel = torch.where(is_exp[:, :, None], cum_all[:, None, :],
                              cum[:, None, :])           # [R, keep, n_seg]
        occ_sel = torch.where(is_exp[:, :, None], occ_all[:, None, :],
                              occ[:, None, :])
    else:
        m_sel = m
        cum_sel = cum[:, None, :]
        occ_sel = occ[:, None, :]
    valid_seg = ranks < m_sel                            # [R, keep]

    # 3. rank -> segment index: unique s with occ[s] & cum[s] == rank+1
    hit = (cum_sel == (ranks + 1)[:, :, None]) & occ_sel
    seg_idx = torch.sum(
        hit * torch.arange(n_seg, dtype=torch.int32, device=dev),
        dim=-1)                                          # [R, keep]

    # 4. stratified samples inside each kept segment (the centres of sps
    # equal parts in VALIDATE)
    u = within_u if train else 0.5
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
