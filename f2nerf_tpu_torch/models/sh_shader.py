"""Spherical-harmonics directional shader (port of
``f2nerf_tpu/models/sh_shader.py``).

16-d shading feature ++ SH(dirs) -> Linear(32->64) -> ReLU ->
Linear(64->3) -> widened sigmoid ``(1 + 2*eps) * sigmoid(x) - eps``,
eps=1e-3 (reference src/sh_shader.cpp:22-29). Weights keep the JAX
layout (``x @ w0``).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from f2nerf_tpu_torch.core.config import ModelConfig
from f2nerf_tpu_torch.ops.sh import sh_encode

Params = dict[str, Any]

_EPS = 1e-3


def init(generator: torch.Generator, cfg: ModelConfig,
         device: torch.device) -> Params:
    d_in = cfg.shader_in_dim
    d_hidden = cfg.shader_hidden_dim

    def uniform(bound, *shape):
        u = torch.rand(shape, generator=generator, device=device)
        return u * (2.0 * bound) - bound

    b0 = 1.0 / np.sqrt(d_in)
    b1 = 1.0 / np.sqrt(d_hidden)
    return {"w0": uniform(b0, d_in, d_hidden), "b0": uniform(b0, d_hidden),
            "w1": uniform(b1, d_hidden, 3), "b1": uniform(b1, 3)}


def query(params: Params, feats: torch.Tensor, dirs: torch.Tensor,
          cfg: ModelConfig) -> torch.Tensor:
    """[..., F] feats + [..., 3] unit dirs -> [..., 3] RGB in (-eps, 1+eps)."""
    enc = sh_encode(dirs, cfg.sh_degree)
    x = torch.cat([feats, enc], dim=-1)
    h = torch.relu(x @ params["w0"] + params["b0"])
    out = h @ params["w1"] + params["b1"]
    return (1.0 + 2.0 * _EPS) * torch.sigmoid(out) - _EPS
