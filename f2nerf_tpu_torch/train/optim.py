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
    grad and are updated in place by :meth:`step`. The lr each group
    holds is ``learning_rate * lr_factor(count)``. On a CUDA device Adam
    is ``capturable`` from the start, so that the train step's CUDA
    graphs and its eager steps share one arithmetic: the lr is one device
    scalar that every group shares and that :meth:`advance` and
    :meth:`set_count` write, the step counts live on the device and Adam
    computes its bias corrections there in float32 (as optax does). On
    the CPU the lr is a Python float and the bias corrections are
    Adam's host float64.
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
        dev = next(iter(self.named.values())).device
        self.capturable = _capturable(dev)
        self._count = 0
        self._lr = (torch.zeros((), dtype=torch.float32, device=dev)
                    if self.capturable else None)
        self.adam = torch.optim.Adam(
            [{"params": rest, "weight_decay": 1e-6},
             {"params": pool, "weight_decay": cfg.feat_pool_weight_decay}],
            lr=cfg.learning_rate if self._lr is None else self._lr,
            betas=(0.9, 0.99), eps=1e-15, capturable=self.capturable)
        self._write_lr()

    @property
    def count(self) -> int:
        """Updates taken (the schedule's count)."""
        return self._count

    def lr(self) -> float:
        """The lr of the next update."""
        return self.cfg.learning_rate * lr_factor(self.cfg, self._count)

    def _write_lr(self) -> None:
        if self._lr is not None:
            self._lr.fill_(self.lr())
            return
        for group in self.adam.param_groups:
            group["lr"] = self.lr()

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> None:
        """One update from the leaves' ``.grad``. A leaf without a grad
        gets zeros, as JAX differentiates every leaf: weight decay still
        moves it. Inside a CUDA graph's capture only the device work is
        recorded; the graph's caller then calls :meth:`advance` after
        each replay."""
        grads = []
        for p in self.named.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        if self.cfg.grad_clip_norm > 0.0:
            clip_by_global_norm(grads, self.cfg.grad_clip_norm)
        self.adam.step()
        if not _capturing(grads[0]):
            self.advance()

    def advance(self) -> None:
        """Count one update and write the next lr."""
        self._count += 1
        self._write_lr()

    def set_count(self, count: int) -> None:
        """Move the schedule to update ``count`` (state carried across)."""
        self._count = count
        self._write_lr()

    def state_dict(self) -> dict:
        """Adam's ``state_dict`` in the CPU's form (the lr a float,
        ``capturable`` off, the step counts on the CPU), whatever the
        device: what a checkpoint stores, loadable anywhere."""
        sd = self.adam.state_dict()
        for group in sd["param_groups"]:
            group["lr"] = self.lr()
            group["capturable"] = False
        # the state's dicts are the live ones: copy before changing
        sd["state"] = {k: {**v, "step": v["step"].cpu()}
                       for k, v in sd["state"].items()}
        return sd

    def load_state_dict(self, sd: dict) -> None:
        """Adam's state from ``sd`` (either form), kept in this
        optimizer's own form; the lr follows :attr:`count`."""
        self.adam.load_state_dict(sd)
        if self.capturable:
            for group in self.adam.param_groups:
                group["capturable"] = True
                group["lr"] = self._lr
            for p, state in self.adam.state.items():
                if "step" in state:
                    state["step"] = state["step"].to(p.device)
        self._write_lr()


def _capturable(device: torch.device) -> bool:
    """Whether Adam runs ``capturable`` on ``device``: on a CUDA one."""
    return device.type == "cuda"


def _capturing(t: torch.Tensor) -> bool:
    """True while a CUDA graph is captured on the current stream (never
    on the CPU, whose builds may lack the CUDA query)."""
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float) -> None:
    """In place: g <- g / norm * max_norm where the global norm is not
    below ``max_norm`` (optax ``clip_by_global_norm``); no host sync."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm) * max_norm))


def make_optimizer(params: dict[str, Any], cfg: TrainConfig) -> Optimizer:
    return Optimizer(params, cfg)
