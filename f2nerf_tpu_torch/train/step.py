"""The training step: rays -> render -> losses -> Adam update (port of
``f2nerf_tpu/train/step.py``).

Reference hot loop ``src/main_functions/train_manager.cpp:58-158``:
Charbonnier color loss (:78) plus a ramped weight-variance loss
(:80-93). Rays are generated inside the step from device-resident poses
and intrinsics; the host ships (cam_idx, ij, gt) per step. The step
number is a host int, so the occupancy cadence, the loss ramps and the
level anneal are decided on the host with no device sync; the metrics
stay device tensors (no ``.item()`` in the step). One path syncs: the
dense two-pass renderer (``dense_two_pass``) reads its survivor count
once per step to pick its bucket on the host, where JAX's
``lax.switch`` picks it on the device; a CUDA graph of such a step needs
one graph per bucket.

Randomness: one ``torch.Generator`` per step, seeded from
(``cfg.train.seed``, step), so a step's draws do not depend on how many
steps ran before it (the JAX step folds the step into its key). All of a
step's draws are made up front into a :class:`StepNoise`; a caller may
pass its own (the tests give the JAX package's draws).

``grad_blocks > 0`` (the shard-count-invariant multi-chip mode) is not
ported: it belongs to the multi-GPU item of the roadmap (ROADMAP A11).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from f2nerf_tpu_torch.core.cameras import rays_from_pose
from f2nerf_tpu_torch.core.config import Config
from f2nerf_tpu_torch.models import occupancy, renderer
from f2nerf_tpu_torch.ops.composite import distortion_loss, weight_variance
from f2nerf_tpu_torch.train.optim import Optimizer


class StepMetrics(NamedTuple):
    loss: torch.Tensor
    color_loss: torch.Tensor
    var_loss: torch.Tensor
    mse: torch.Tensor
    psnr: torch.Tensor


class StepNoise(NamedTuple):
    """All random draws of one step (None where the config needs none).

    refresh: [G^3/K, 3] U[0,1) occupancy-refresh jitter (occ sampler).
    bg: [R, 3] U[0,1) background colour.
    march: [R, S] U[0,1) dense-sampler jitter.
    rank, within: [R, keep], [R, keep, sps] U[0,1) occ-sampler jitter.
    explore: [R, 1] bool exploration rays (occ_explore_eps > 0).
    gs_points: [n, 3] uniform points of the contracted domain for the
      global-sparsity loss (global_sparsity_weight > 0).
    """
    refresh: torch.Tensor | None
    bg: torch.Tensor
    march: torch.Tensor | None
    rank: torch.Tensor | None
    within: torch.Tensor | None
    explore: torch.Tensor | None
    gs_points: torch.Tensor | None


def var_loss_weight(step: int, cfg: Config) -> float:
    """Ramp 0 -> var_loss_weight over [var_loss_start, var_loss_end]
    (reference train_manager.cpp:85-93, strict > comparisons)."""
    t = cfg.train
    if step > t.var_loss_end:
        return t.var_loss_weight
    if step > t.var_loss_start:
        return ((step - t.var_loss_start)
                / max(t.var_loss_end - t.var_loss_start, 1)
                * t.var_loss_weight)
    return 0.0


def refresh_phase(cfg: Config, step: int) -> int | None:
    """The occupancy refresh phase of ``step``, or None when the step
    does not refresh: a 1/K partial refresh every ``occ_update_every``
    steps, K times as often before ``occ_refresh_warmup``, phase =
    (step // cadence) % K."""
    m = cfg.model
    if m.sampler_mode != "occ":
        return None
    k_ph = m.occ_refresh_phases
    cadence = (max(m.occ_update_every // k_ph, 1)
               if step < m.occ_refresh_warmup else m.occ_update_every)
    if step % cadence:
        return None
    return (step // cadence) % k_ph


def draw_noise(cfg: Config, step: int, n_rays: int,
               device: torch.device) -> StepNoise:
    """The draws of ``step`` for a batch of ``n_rays`` rays, from a
    generator seeded from (train seed, step) only."""
    seed = np.random.SeedSequence([cfg.train.seed, step]).generate_state(
        1, np.uint64)[0]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    m = cfg.model

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)

    refresh = (rand(occupancy.refresh_points(m), 3)
               if refresh_phase(cfg, step) is not None else None)
    bg = rand(n_rays, 3)
    march = rank = within = explore = gs_points = None
    if m.sampler_mode == "occ":
        if m.occ_explore_eps > 0.0:
            explore = rand(n_rays, 1) < m.occ_explore_eps
        rank = rand(n_rays, m.occ_keep)
        within = rand(n_rays, m.occ_keep, m.occ_samples_per_segment)
    else:
        march = rand(n_rays, m.n_samples)
    if cfg.train.global_sparsity_weight > 0.0:
        dom_r = 1.0 + m.contraction_radius
        gs_points = (rand(cfg.train.global_sparsity_points, 3)
                     * (2.0 * dom_r) - dom_r)
    return StepNoise(refresh=refresh, bg=bg, march=march, rank=rank,
                     within=within, explore=explore, gs_points=gs_points)


def _level_weights(cfg: Config, step: int,
                   device: torch.device) -> torch.Tensor | None:
    """Coarse-to-fine anneal: level l ramps over steps
    [la*(l-1)/L, la*l/L]; computed in f32 on the host as JAX does."""
    la = cfg.train.level_anneal_end
    if la <= 0:
        return None
    nl = cfg.model.n_levels
    prog = np.clip(np.float32(step) / np.float32(la), 0.0, 1.0)
    lw = np.clip(prog * np.float32(nl) - np.arange(nl, dtype=np.float32)
                 + np.float32(1.0), 0.0, 1.0).astype(np.float32)
    return torch.as_tensor(lw, device=device)


def make_loss_fn(cfg: Config):
    """Loss over a ray batch given (cam_idx, ij, gt)."""

    def loss_fn(params: dict[str, Any], poses: torch.Tensor,
                intrinsics: torch.Tensor, cam_idx: torch.Tensor,
                ij: torch.Tensor, gt: torch.Tensor, noise: StepNoise,
                step: int, occ_vals: torch.Tensor | None,
                consts: dict[str, Any] | None = None
                ) -> tuple[torch.Tensor, StepMetrics]:
        cam = cam_idx.long()
        rays_o, rays_d = rays_from_pose(poses[cam], intrinsics[cam],
                                        ij.float())
        emb_idx = cam if cfg.train.train_app_emb else None
        res = renderer.render(params, rays_o, rays_d, cfg.model,
                              occ_vals=occ_vals,
                              level_weights=_level_weights(cfg, step,
                                                           rays_o.device),
                              emb_idx=emb_idx, noise=noise, consts=consts)
        # Charbonnier color loss (train_manager.cpp:78)
        color_loss = torch.mean(torch.sqrt((res.colors - gt) ** 2 + 1e-4))
        if cfg.train.var_loss_mode == "distortion":
            march = cfg.model.n_samples * cfg.model.sample_l
            var_loss = torch.mean(distortion_loss(
                res.weights, res.t, res.dt, res.mask, march))
        else:
            # weight variance at spatial positions t / (sample_l * 16)
            var = weight_variance(res.weights, res.mask,
                                  pos=res.t / (cfg.model.sample_l * 16.0))
            var_loss = torch.mean(torch.sqrt(var + 1e-2))
        loss = color_loss + var_loss * var_loss_weight(step, cfg)
        if (cfg.train.explore_sparsity_weight > 0.0
                and res.explore is not None):
            # optical depth of samples in occupied-but-ineligible segments
            m = res.explore.float()
            fog = torch.log1p(torch.clamp(res.sec_density, 0.0, 1e4)) * m
            exp_loss = torch.sum(fog) / torch.clamp_min(torch.sum(m), 1.0)
            loss = loss + cfg.train.explore_sparsity_weight * exp_loss
        if cfg.train.occ_reg_weight > 0.0 and cfg.train.occ_reg_t > 0.0:
            # mean clipped optical depth of near-march survivor samples
            near_m = ((res.t < cfg.train.occ_reg_t) & (res.dt > 0.0)
                      & res.mask).float()
            occ_reg = (torch.sum(torch.clamp(res.sec_density, 0.0, 1e4)
                                 * near_m)
                       / torch.clamp_min(torch.sum(near_m), 1.0))
            loss = loss + cfg.train.occ_reg_weight * occ_reg
        if cfg.train.global_sparsity_weight > 0.0:
            # density prior at random points of the contracted domain
            gpts = noise.gs_points
            dom_r = 1.0 + cfg.model.contraction_radius
            in_dom = (torch.linalg.vector_norm(gpts, dim=-1)
                      < dom_r * 0.999).float()
            sig = renderer.density_at(params, gpts, cfg.model,
                                      contracted=True, consts=consts)
            gs = torch.log1p(torch.clamp(sig, 0.0, 1e4)) * in_dom
            gs_loss = torch.sum(gs) / torch.clamp_min(torch.sum(in_dom), 1.0)
            loss = loss + cfg.train.global_sparsity_weight * gs_loss
        mse = torch.mean((res.colors - gt) ** 2)
        psnr = 20.0 * torch.log10(1.0 / torch.sqrt(mse))
        return loss, StepMetrics(loss=loss, color_loss=color_loss,
                                 var_loss=var_loss, mse=mse, psnr=psnr)

    return loss_fn


def make_train_step(cfg: Config, optimizer: Optimizer):
    """Build the step

        train_step(params, occ_grid, poses, intrinsics, step, cam_idx, ij,
                   gt, noise=None, consts=None) -> (occ_grid, metrics)

    which refreshes the occupancy grid on its cadence (with the params
    before the update, under ``torch.no_grad()``), renders and scores the
    batch, and updates ``params`` in place through ``optimizer`` (made
    for the same params dict). The grads stay in the leaves' ``.grad``
    until the next step. ``noise`` defaults to :func:`draw_noise`;
    ``consts`` are the renderer's non-trained constants (the warp tables
    in perspective mode).
    """
    if cfg.train.grad_blocks > 0:
        raise NotImplementedError(
            "grad_blocks > 0 (shard-count-invariant gradients) belongs to "
            "the multi-GPU item of the roadmap (ROADMAP A11)")
    loss_fn = make_loss_fn(cfg)
    use_occ = cfg.model.sampler_mode == "occ"
    scale = float(cfg.train.loss_scale)

    def train_step(params: dict[str, Any], occ_grid: torch.Tensor | None,
                   poses: torch.Tensor, intrinsics: torch.Tensor, step: int,
                   cam_idx: torch.Tensor, ij: torch.Tensor, gt: torch.Tensor,
                   noise: StepNoise | None = None,
                   consts: dict[str, Any] | None = None
                   ) -> tuple[torch.Tensor | None, StepMetrics]:
        if noise is None:
            noise = draw_noise(cfg, step, cam_idx.shape[0], poses.device)
        occ_vals = None
        if use_occ:
            phase = refresh_phase(cfg, step)
            if phase is not None:
                with torch.no_grad():
                    occ_grid = occupancy.update_grid(
                        occ_grid,
                        lambda pts: renderer.density_at(
                            params, pts, cfg.model, contracted=True,
                            consts=consts),
                        cfg.model, phase=phase, u=noise.refresh)
            # sigma-valued occupancy; warmup forces everything occupied
            occ_vals = occupancy.occ_values(
                occ_grid, cfg.model,
                warmup=step < cfg.model.occ_warmup_steps)
        optimizer.zero_grad()
        loss, metrics = loss_fn(params, poses, intrinsics, cam_idx, ij, gt,
                                noise, step, occ_vals, consts)
        # static loss scaling (reference fp16 kernels' x128); metrics
        # stay unscaled
        (loss * scale).backward()
        if scale != 1.0:
            for p in optimizer.named.values():
                if p.grad is not None:
                    p.grad.div_(scale)
        optimizer.step()
        return occ_grid, StepMetrics(*(t.detach() for t in metrics))

    return train_step
