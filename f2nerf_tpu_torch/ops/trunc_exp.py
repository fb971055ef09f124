"""Exponential with truncated gradient (port of
``f2nerf_tpu/ops/trunc_exp.py``).

Forward exp(x); backward g * exp(clamp(x, -100, 5)) — reference
``src/CustomOps/CustomOps.cpp:10-20`` (torch::autograd::TruncExp).
"""

from __future__ import annotations

import torch


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -100.0, 5.0))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    return _TruncExp.apply(x)
