"""Optimizer and LR schedule (port of ``f2nerf_tpu/train/optim.py``).

Adam with betas (0.9, 0.99) and eps 1e-15 (reference
src/hash_3d_anchored.cpp:90-114, src/sh_shader.cpp:31-40,
src/renderer.cpp:177-196), in two param groups: coupled weight decay 1e-6
on everything except the hash feature pool, ``feat_pool_weight_decay``
on the pool. torch's Adam ``weight_decay`` adds decay * param to the
gradient before the moments, which is optax's ``add_decayed_weights``
before ``scale_by_adam``. ``grad_clip_norm > 0`` clips by the global
norm first, with optax's formula.

LR: linear warmup over ``learning_rate_warm_up_end_iter`` updates, then
cosine decay to ``learning_rate_alpha * learning_rate`` at ``end_iter``
(reference train_manager.cpp:160-176). As in the JAX package
(``optax.scale_by_learning_rate`` keeps its own count), the schedule is
evaluated at the optimizer's own update count, which starts at 0 whatever
the training step: the first update of a fresh optimizer has lr 0, even
when training starts at a later step.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from f2nerf_tpu_torch.convert import flatten
from f2nerf_tpu_torch.core.config import TrainConfig


def lr_factor(cfg: TrainConfig, count: int) -> float:
    """Warmup-then-cosine factor of ``learning_rate`` at update ``count``."""
    warm = cfg.learning_rate_warm_up_end_iter
    alpha = cfg.learning_rate_alpha
    if count >= warm:
        progress = (count - warm) / max(cfg.end_iter - warm, 1)
        return (1.0 - alpha) * (math.cos(progress * math.pi) * 0.5
                                + 0.5) + alpha
    return count / warm


def lr_schedule(cfg: TrainConfig):
    """lr as a function of the update count (JAX ``lr_schedule``)."""
    return lambda count: cfg.learning_rate * lr_factor(cfg, count)


class Optimizer:
    """``torch.optim.Adam`` behind the JAX package's chain: global-norm
    clip, the two weight-decay groups, Adam, the scheduled lr.

    ``params`` is the nested params dict; its leaves are made to require
    grad and are updated in place by :meth:`step`.
    """

    def __init__(self, params: dict[str, Any], cfg: TrainConfig):
        self.cfg = cfg
        self.named = flatten(params)
        for p in self.named.values():
            p.requires_grad_(True)
        pool = [p for k, p in self.named.items()
                if k.rsplit("/", 1)[-1] == "feat_pool"]
        rest = [p for k, p in self.named.items()
                if k.rsplit("/", 1)[-1] != "feat_pool"]
        self.adam = torch.optim.Adam(
            [{"params": rest, "weight_decay": 1e-6},
             {"params": pool, "weight_decay": cfg.feat_pool_weight_decay}],
            lr=cfg.learning_rate, betas=(0.9, 0.99), eps=1e-15)
        self.schedule = torch.optim.lr_scheduler.LambdaLR(
            self.adam, lambda count: lr_factor(cfg, count))

    @property
    def count(self) -> int:
        """Updates taken (the schedule's count)."""
        return self.schedule.last_epoch

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> None:
        """One update from the leaves' ``.grad``. A leaf without a grad
        gets zeros, as JAX differentiates every leaf: weight decay still
        moves it."""
        grads = []
        for p in self.named.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        if self.cfg.grad_clip_norm > 0.0:
            clip_by_global_norm(grads, self.cfg.grad_clip_norm)
        self.adam.step()
        self.schedule.step()

    def set_count(self, count: int) -> None:
        """Move the schedule to update ``count`` (state carried across)."""
        self.schedule.last_epoch = count
        for group, base in zip(self.adam.param_groups,
                               self.schedule.base_lrs):
            group["lr"] = base * lr_factor(self.cfg, count)


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float) -> None:
    """In place: g <- g / norm * max_norm where the global norm is not
    below ``max_norm`` (optax ``clip_by_global_norm``); no host sync."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm) * max_norm))


def make_optimizer(params: dict[str, Any], cfg: TrainConfig) -> Optimizer:
    return Optimizer(params, cfg)
