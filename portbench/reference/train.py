"""Plain reference of the map trainer's step: the draws of a step, the
occupancy refresh, the loss and Adam, for the configurations the
benchmark runs (``grad_blocks`` 0, one device).

The step's randomness, loss ramps, refresh cadence and learning-rate
schedule are frozen copies of the port's (``f2nerf_tpu_torch/train/
step.py`` and ``train/optim.py``), which keep the JAX package's; the
reference fork's loop is ``src/main_functions/train_manager.cpp:58-176``
(Charbonnier colour loss, the ramped variance loss, warm-up then cosine
learning rate) with Adam at betas (0.9, 0.99), eps 1e-15 and weight
decay 1e-6 off the feature table (``src/hash_3d_anchored.cpp:90-114``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from portbench.reference import field as F

BETAS = (0.9, 0.99)
ADAM_EPS = 1e-15
WEIGHT_DECAY = 1e-6


class Noise(NamedTuple):
    refresh: torch.Tensor | None
    bg: torch.Tensor
    march: torch.Tensor | None
    rank: torch.Tensor | None
    within: torch.Tensor | None
    explore: torch.Tensor | None


def refresh_phase(model, step: int) -> int | None:
    if model.sampler_mode != "occ":
        return None
    k = model.occ_refresh_phases
    cadence = (max(model.occ_update_every // k, 1)
               if step < model.occ_refresh_warmup else model.occ_update_every)
    if step % cadence:
        return None
    return (step // cadence) % k


def draw_noise(model, train, step: int, n_rays: int, device) -> Noise:
    """A step's draws, from a generator seeded from (train seed, step)."""
    key = np.random.SeedSequence([train["seed"], step]).generate_state(
        1, np.uint64)[0]
    gen = torch.Generator(device=device).manual_seed(int(key))

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)

    g = model.occ_grid_res
    refresh = (rand(g ** 3 // model.occ_refresh_phases, 3)
               if refresh_phase(model, step) is not None else None)
    march = rank = within = explore = None
    bg = rand(n_rays, 3)
    if model.sampler_mode == "occ":
        if model.occ_explore_eps > 0.0:
            explore = rand(n_rays, 1) < model.occ_explore_eps
        rank = rand(n_rays, model.occ_keep)
        within = rand(n_rays, model.occ_keep, model.occ_samples_per_segment)
    else:
        march = rand(n_rays, model.n_samples)
    return Noise(refresh, bg, march, rank, within, explore)


def update_grid(grid, params, model, field, dtype, u, phase):
    """Phased max-EMA / mean-EMA refresh at jittered cell centres
    (``f2nerf_tpu_torch/models/occupancy.py:update_grid``)."""
    g, k = model.occ_grid_res, model.occ_refresh_phases
    m = g ** 3 // k
    dev = grid.device
    cell = 2.0 * F.DOMAIN / g
    flat = torch.arange(m, dtype=torch.int32, device=dev) * k + phase
    ijk = torch.stack([flat // (g * g), (flat // g) % g, flat % g], -1).float()
    centres = (ijk + 0.5) * cell - F.DOMAIN
    with torch.no_grad():
        raw = field(params, centres + (u - 0.5) * cell, dtype,
                    contracted=True)[:, 0]
        sigma = F.density(raw, model.density_shift)
    sigma = torch.where(torch.isfinite(sigma), sigma,
                        torch.full((), F.SIGMA_EMA_MAX, device=dev))
    sigma = torch.clamp_max(sigma, F.SIGMA_EMA_MAX)
    new_max = (grid[0] * model.occ_decay).reshape(m, k)
    new_max[:, phase] = torch.maximum(new_max[:, phase], sigma)
    a = model.occ_mean_ema
    new_mean = grid[1].reshape(m, k).clone()
    new_mean[:, phase] = new_mean[:, phase] * (1.0 - a) + sigma * a
    return torch.stack([new_max.reshape(g, g, g), new_mean.reshape(g, g, g)])


def var_loss_weight(train, step: int) -> float:
    if step > train["var_loss_end"]:
        return train["var_loss_weight"]
    if step > train["var_loss_start"]:
        return ((step - train["var_loss_start"])
                / max(train["var_loss_end"] - train["var_loss_start"], 1)
                * train["var_loss_weight"])
    return 0.0


def lr_factor(train, count: int) -> float:
    warm, alpha = train["learning_rate_warm_up_end_iter"], \
        train["learning_rate_alpha"]
    if count >= warm:
        progress = (count - warm) / max(train["end_iter"] - warm, 1)
        return (1.0 - alpha) * (math.cos(progress * math.pi) * 0.5 + 0.5) \
            + alpha
    return count / warm


def loss(params, model, train, field, dtype, poses, intr, cam, ij, gt,
         noise, step, occ_vals):
    """The step's loss: Charbonnier colour loss, the ramped variance or
    distortion term and the explore-sparsity term."""
    rays_o, rays_d = F.rays_from_pose(poses[cam], intr[cam], ij.float())
    res = F.render(params, rays_o, rays_d, model, field, dtype,
                   occ_vals=occ_vals, noise=noise,
                   emb_idx=cam if train["train_app_emb"] else None)
    total = torch.mean(torch.sqrt((res.colors - gt) ** 2 + 1e-4))
    if train["var_loss_mode"] == "distortion":
        var = torch.mean(F.distortion_loss(
            res.weights, res.t, res.dt, res.mask,
            model.n_samples * model.sample_l))
    else:
        var = torch.mean(torch.sqrt(F.weight_variance(
            res.weights, res.mask, res.t / (model.sample_l * 16.0)) + 1e-2))
    total = total + var * var_loss_weight(train, step)
    if train["explore_sparsity_weight"] > 0.0 and res.explore is not None:
        m = res.explore.float()
        fog = torch.log1p(torch.clamp(res.sec_density, 0.0, 1e4)) * m
        total = total + train["explore_sparsity_weight"] * (
            torch.sum(fog) / torch.clamp_min(torch.sum(m), 1.0))
    return total


def check_supported(train) -> None:
    for key, off in (("grad_blocks", 0), ("grad_clip_norm", 0.0),
                     ("occ_reg_weight", 0.0), ("global_sparsity_weight", 0.0),
                     ("level_anneal_end", 0), ("loss_scale", 1.0)):
        if train[key] != off:
            raise NotImplementedError(f"the reference step has no {key} "
                                      f"(got {train[key]})")


def steps(params0: dict, grid0, model, train, batches, poses, intr,
          first_step: int, count0: int, dtype, field) -> dict:
    """Run len(batches) steps from ``params0`` (flat name -> tensor) with
    a fresh Adam whose schedule stands at ``count0``, through the
    configuration's ``field`` (``reference.field``). Returns the losses,
    the first step's gradients as Adam takes them (weight decay added),
    the grid after each step and the params after the last."""
    check_supported(train)
    dev = poses.device
    flat = {k: v.detach().to(dev).clone().requires_grad_(True)
            for k, v in params0.items()}
    nested = unflatten(flat)
    m = {k: torch.zeros_like(v) for k, v in flat.items()}
    v2 = {k: torch.zeros_like(v) for k, v in flat.items()}
    grid = None if grid0 is None else grid0.to(dev)
    out = {"loss": [], "grid": []}
    for j, (cam, ij, gt) in enumerate(batches):
        step = first_step + j
        cam = torch.as_tensor(cam, device=dev).long()
        ij = torch.as_tensor(ij, device=dev)
        gt = torch.as_tensor(gt, device=dev)
        noise = draw_noise(model, train, step, cam.shape[0], dev)
        occ = None
        if model.sampler_mode == "occ":
            phase = refresh_phase(model, step)
            if phase is not None:
                grid = update_grid(grid, nested, model, field, dtype,
                                   noise.refresh, phase)
            occ = F.occ_values(grid, model,
                               warmup=step < model.occ_warmup_steps)
            out["grid"].append(grid.clone())
        total = loss(nested, model, train, field, dtype, poses, intr, cam,
                     ij, gt, noise, step, occ)
        grads = torch.autograd.grad(total, list(flat.values()),
                                    allow_unused=True)
        out["loss"].append(float(total.detach()))
        lr = train["learning_rate"] * lr_factor(train, count0 + j)
        t = j + 1
        with torch.no_grad():
            taken = {}
            for (name, p), g in zip(flat.items(), grads):
                g = torch.zeros_like(p) if g is None else g
                if not name.endswith("feat_pool"):
                    g = g + WEIGHT_DECAY * p
                elif train["feat_pool_weight_decay"]:
                    g = g + train["feat_pool_weight_decay"] * p
                taken[name] = g
                m[name].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                v2[name].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                denom = (v2[name].sqrt() / math.sqrt(1 - BETAS[1] ** t)
                         + ADAM_EPS)
                p.addcdiv_(m[name], denom, value=-lr / (1 - BETAS[0] ** t))
            if j == 0:
                out["grad"] = {k: g.detach().clone() for k, g in taken.items()}
    out["params"] = {k: p.detach() for k, p in flat.items()}
    return out


def flatten(tree: dict, prefix: str = "") -> dict:
    """Nested dict -> {"field/feat_pool": ..., "shader/w0": ...}."""
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            flat.update(flatten(v, f"{prefix}{k}/"))
        else:
            flat[f"{prefix}{k}"] = v
    return flat


def unflatten(flat: dict) -> dict:
    tree: dict = {}
    for name, v in flat.items():
        node = tree
        *path, leaf = name.split("/")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = v
    return tree
