"""Uniform stratified ray sampler, dense layout (port of
``f2nerf_tpu/models/sampler.py``).

Fixed S samples per ray at step SAMPLE_L with jitter
``(U[0,1) - 0.5) + 1`` in TRAIN and 1.0 in VALIDATE, accumulated by a
cumulative sum; dt_i = t_i - t_{i-1} with dt_0 = 0 (reference
src/points_sampler.cpp).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from f2nerf_tpu_torch.core.config import ModelConfig


class Samples(NamedTuple):
    pts: torch.Tensor    # [R, S, 3]
    dirs: torch.Tensor   # [R, 3] unit direction per ray
    dt: torch.Tensor     # [R, S]
    t: torch.Tensor      # [R, S]


def sample_rays(rays_o: torch.Tensor, rays_d: torch.Tensor,
                cfg: ModelConfig, u: torch.Tensor | None = None) -> Samples:
    """Stratified-march rays. TRAIN jitters each step by the U[0,1)
    draws ``u`` [R, S] (``train.step.draw_noise`` makes them); ``u=None``
    is VALIDATE (no jitter)."""
    r = rays_o.shape[0]
    s = cfg.n_samples
    dirs = rays_d / torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True)
    if u is None:
        noise = torch.ones((r, s), dtype=torch.float32, device=rays_o.device)
    else:
        noise = u - 0.5 + 1.0
    t = cfg.sample_near + torch.cumsum(noise, dim=-1) * cfg.sample_l
    pts = rays_o[:, None, :] + dirs[:, None, :] * t[..., None]
    dt = torch.diff(t, dim=-1, prepend=t[:, :1])
    return Samples(pts=pts, dirs=dirs, dt=dt, t=t)
