"""Unbounded-scene radial contraction (port of
``f2nerf_tpu/ops/contraction.py``).

For ||x|| <= r the point passes through; outside, it maps onto the shell
(r, 2r): x -> (1 + r - r/||x||) * x/||x|| — reference
``src/hash_3d_anchored.cpp:79-82``.
"""

from __future__ import annotations

import torch


def contract(points: torch.Tensor, radius: float = 1.0) -> torch.Tensor:
    """[..., 3] -> [..., 3] radial contraction onto a ball of radius 2r."""
    norm = torch.linalg.vector_norm(points, dim=-1, keepdim=True)
    safe_norm = torch.clamp_min(norm, 1e-12)
    inside = norm <= radius
    outside_pts = (1.0 + radius - radius / safe_norm) * points / safe_norm
    return torch.where(inside, points, outside_pts)


def uncontract(points: torch.Tensor, radius: float = 1.0) -> torch.Tensor:
    """Inverse of :func:`contract` on the open ball of radius 2r."""
    rho = torch.linalg.vector_norm(points, dim=-1, keepdim=True)
    safe_rho = torch.clamp_min(rho, 1e-12)
    denom = torch.clamp_min(1.0 + radius - safe_rho, 1e-6)
    r_world = radius / denom
    outside = points / safe_rho * r_world
    return torch.where(rho <= radius, points, outside)
