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

Across devices (``mesh``, a ``parallel.mesh.DataMesh`` of k ranks, one
process each; JAX ``make_train_step(mesh=)`` and ``_block_grads``):

* **default**: rank r renders rows ``[r*B/k, (r+1)*B/k)`` of the global
  batch B and builds a local loss whose gradients sum, over the ranks,
  to the global-batch gradient: a mean term is its local mean over k,
  a ratio term (explore sparsity, ``occ_reg``) divides its local sum by
  the global denominator (all-reduced, no gradient), and the
  batch-free global-sparsity term is counted on rank 0 only. The
  gradients and the metrics are then summed over the ranks in one
  all-reduce; the metrics are the global ones, PSNR from the global MSE.
* **``grad_blocks = V > 0``**: the batch is cut into V blocks of B/V
  rays, rank r computes blocks ``[r*V/k, (r+1)*V/k)`` with one backward
  each (each block its own loss, as JAX's ``vmap`` instance), the
  [V, ...] stack of block gradients is gathered to every rank and
  reduced as ``sum(dim=0) / V``: the same tensor and the same reduction
  at every k dividing V, so the update is bitwise the same at every k.
  Block b draws from a generator seeded from (seed, step, b), JAX's
  ``fold_in(key, b)``; metrics are the means over the blocks.

Every rank draws the global batch's ``StepNoise`` and takes its rows, so
k ranks use the draws of one; the occupancy refresh is replicated (each
rank computes the same grid from the same params and draws).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from f2nerf_tpu_torch.core.cameras import rays_from_pose
from f2nerf_tpu_torch.core.config import Config
from f2nerf_tpu_torch.models import occupancy, renderer
from f2nerf_tpu_torch.ops.composite import distortion_loss, weight_variance
from f2nerf_tpu_torch.parallel.mesh import (DataMesh, all_reduce_sum,
                                            shard_batch)
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


def _generator(device: torch.device, *key: int) -> torch.Generator:
    seed = np.random.SeedSequence(list(key)).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(seed))


def _ray_draws(gen: torch.Generator, cfg: Config, n_rays: int,
               device: torch.device) -> dict:
    """The per-ray draws of ``n_rays`` rays and the global-sparsity
    points, in this order from ``gen``."""
    m = cfg.model

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)

    out = dict(bg=rand(n_rays, 3), march=None, rank=None, within=None,
               explore=None, gs_points=None)
    if m.sampler_mode == "occ":
        if m.occ_explore_eps > 0.0:
            out["explore"] = rand(n_rays, 1) < m.occ_explore_eps
        out["rank"] = rand(n_rays, m.occ_keep)
        out["within"] = rand(n_rays, m.occ_keep, m.occ_samples_per_segment)
    else:
        out["march"] = rand(n_rays, m.n_samples)
    if cfg.train.global_sparsity_weight > 0.0:
        dom_r = 1.0 + m.contraction_radius
        out["gs_points"] = (rand(cfg.train.global_sparsity_points, 3)
                            * (2.0 * dom_r) - dom_r)
    return out


def draw_noise(cfg: Config, step: int, n_rays: int,
               device: torch.device) -> StepNoise:
    """The draws of ``step`` for a global batch of ``n_rays`` rays, from a
    generator seeded from (train seed, step) only.

    With ``grad_blocks = V > 0`` the per-ray draws of block b (rows
    ``[b*n/V, (b+1)*n/V)``) come from a generator seeded from (train
    seed, step, b), and ``gs_points`` is [V, n, 3], one set a block (JAX
    draws each block from ``fold_in(key, b)``); the refresh jitter stays
    the step's."""
    gen = _generator(device, cfg.train.seed, step)
    refresh = (torch.rand((occupancy.refresh_points(cfg.model), 3),
                          generator=gen, device=device)
               if refresh_phase(cfg, step) is not None else None)
    n_blocks = cfg.train.grad_blocks
    if n_blocks <= 0:
        return StepNoise(refresh=refresh,
                         **_ray_draws(gen, cfg, n_rays, device))
    if n_rays % n_blocks:
        raise ValueError(f"grad_blocks={n_blocks} must divide rays/step="
                         f"{n_rays}")
    blocks = [_ray_draws(_generator(device, cfg.train.seed, step, b), cfg,
                         n_rays // n_blocks, device)
              for b in range(n_blocks)]
    merged = {}
    for name, first in blocks[0].items():
        join = torch.stack if name == "gs_points" else torch.cat
        merged[name] = (None if first is None
                        else join([b[name] for b in blocks]))
    return StepNoise(refresh=refresh, **merged)


def _per_ray(noise: StepNoise):
    """(name, tensor) of the draws with one row a ray."""
    for name in ("bg", "march", "rank", "within", "explore"):
        x = getattr(noise, name)
        if x is not None:
            yield name, x


def shard_noise(mesh: DataMesh | None, noise: StepNoise) -> StepNoise:
    """This rank's rows of a global batch's draws (``shard_batch``); the
    refresh jitter is the whole step's. ``gs_points`` is sharded only in
    ``grad_blocks`` mode, where it holds one set a block ([V, n, 3])."""
    gs = noise.gs_points
    if gs is not None and gs.dim() == 3:
        gs, = shard_batch(mesh, gs)
    return noise._replace(gs_points=gs, **{
        name: shard_batch(mesh, x)[0] for name, x in _per_ray(noise)})


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


def make_loss_fn(cfg: Config, mesh: DataMesh | None = None):
    """Loss over a ray batch given (cam_idx, ij, gt). With a ``mesh``,
    the batch is this rank's shard and the loss its share of the global
    one (module docstring); ``metrics`` are then this rank's shares too,
    summed over the ranks by the step."""
    shards = mesh.size if mesh is not None else 1
    counts_global_terms = mesh is None or mesh.rank == 0

    def mean(x: torch.Tensor) -> torch.Tensor:
        return torch.mean(x) if shards == 1 else torch.mean(x) / shards

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
        color_loss = mean(torch.sqrt((res.colors - gt) ** 2 + 1e-4))
        if cfg.train.var_loss_mode == "distortion":
            march = cfg.model.n_samples * cfg.model.sample_l
            var_loss = mean(distortion_loss(
                res.weights, res.t, res.dt, res.mask, march))
        else:
            # weight variance at spatial positions t / (sample_l * 16)
            var = weight_variance(res.weights, res.mask,
                                  pos=res.t / (cfg.model.sample_l * 16.0))
            var_loss = mean(torch.sqrt(var + 1e-2))
        loss = color_loss + var_loss * var_loss_weight(step, cfg)
        # samples in occupied-but-ineligible segments; near-march survivor
        # samples: the ratio terms' masks, whose sums over the global
        # batch are their denominators
        explore_m = near_m = None
        if (cfg.train.explore_sparsity_weight > 0.0
                and res.explore is not None):
            explore_m = res.explore.float()
        if cfg.train.occ_reg_weight > 0.0 and cfg.train.occ_reg_t > 0.0:
            near_m = ((res.t < cfg.train.occ_reg_t) & (res.dt > 0.0)
                      & res.mask).float()
        dens = [torch.sum(m) for m in (explore_m, near_m) if m is not None]
        if dens and mesh is not None:
            dens = all_reduce_sum(mesh, torch.stack(dens)).unbind()
        dens = iter(dens)
        if explore_m is not None:
            # optical depth of samples in occupied-but-ineligible segments
            fog = (torch.log1p(torch.clamp(res.sec_density, 0.0, 1e4))
                   * explore_m)
            exp_loss = torch.sum(fog) / torch.clamp_min(next(dens), 1.0)
            loss = loss + cfg.train.explore_sparsity_weight * exp_loss
        if near_m is not None:
            # mean clipped optical depth of near-march survivor samples
            occ_reg = (torch.sum(torch.clamp(res.sec_density, 0.0, 1e4)
                                 * near_m)
                       / torch.clamp_min(next(dens), 1.0))
            loss = loss + cfg.train.occ_reg_weight * occ_reg
        if cfg.train.global_sparsity_weight > 0.0 and counts_global_terms:
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
        mse = mean((res.colors - gt) ** 2)
        return loss, _metrics(loss, color_loss, var_loss, mse)

    return loss_fn


def _metrics(loss, color_loss, var_loss, mse) -> StepMetrics:
    """The step's metrics, PSNR from ``mse`` (the log of the mean, not a
    mean of logs)."""
    return StepMetrics(loss=loss, color_loss=color_loss, var_loss=var_loss,
                       mse=mse, psnr=20.0 * torch.log10(1.0 / torch.sqrt(mse)))


def _flat_grads(optimizer: Optimizer) -> list[torch.Tensor]:
    """Every leaf's grad flattened, zeros for a leaf without one."""
    return [(p.grad if p.grad is not None else torch.zeros_like(p)
             ).reshape(-1) for p in optimizer.named.values()]


def _set_grads(optimizer: Optimizer, flat: torch.Tensor) -> None:
    """Point every leaf's ``.grad`` at its slice of ``flat``."""
    sizes = [p.numel() for p in optimizer.named.values()]
    for p, g in zip(optimizer.named.values(), flat.split(sizes)):
        p.grad = g.view_as(p)


def make_train_step(cfg: Config, optimizer: Optimizer,
                    mesh: DataMesh | None = None):
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

    With a ``mesh`` of k ranks, (cam_idx, ij, gt) are this rank's rows of
    the global batch (``parallel.mesh.shard_batch``), ``noise`` is the
    global batch's (this rank takes its rows), and the metrics and the
    update are the global ones on every rank (module docstring). Raises
    ``ValueError`` unless ``grad_blocks`` V divides the global batch and
    k divides V.
    """
    n_blocks = cfg.train.grad_blocks
    shards = mesh.size if mesh is not None else 1
    if n_blocks > 0 and n_blocks % shards:
        raise ValueError(f"the mesh size {shards} must divide "
                         f"grad_blocks={n_blocks}")
    loss_fn = make_loss_fn(cfg, None if n_blocks > 0 else mesh)
    use_occ = cfg.model.sampler_mode == "occ"
    scale = float(cfg.train.loss_scale)

    def block_grads(params, poses, intrinsics, step, cam_idx, ij, gt,
                    noise, occ_vals, consts) -> StepMetrics:
        """JAX ``_block_grads``: this rank's blocks, one backward each,
        into a zero-filled [V, n_params + 4] stack (grads, then loss,
        color, var, mse), summed over the ranks (an exact gather), then
        reduced in one fixed order; the grads are left in the leaves."""
        mine = n_blocks // shards
        rows = cam_idx.shape[0] // mine
        first = (mesh.rank if mesh is not None else 0) * mine
        n_params = sum(p.numel() for p in optimizer.named.values())
        stack = torch.zeros((n_blocks, n_params + 4), device=poses.device)
        for j in range(mine):
            sl = slice(j * rows, (j + 1) * rows)
            bnoise = noise._replace(
                gs_points=(None if noise.gs_points is None
                           else noise.gs_points[j]),
                **{name: x[sl] for name, x in _per_ray(noise)})
            optimizer.zero_grad()
            loss, m = loss_fn(params, poses, intrinsics, cam_idx[sl], ij[sl],
                              gt[sl], bnoise, step, occ_vals, consts)
            (loss * scale).backward()
            stack[first + j] = torch.cat(_flat_grads(optimizer)
                                         + [torch.stack(m[:4]).detach()])
        all_reduce_sum(mesh, stack)
        _set_grads(optimizer, torch.sum(stack[:, :n_params], dim=0)
                   / n_blocks)
        return _metrics(*torch.mean(stack[:, n_params:], dim=0))

    def train_step(params: dict[str, Any], occ_grid: torch.Tensor | None,
                   poses: torch.Tensor, intrinsics: torch.Tensor, step: int,
                   cam_idx: torch.Tensor, ij: torch.Tensor, gt: torch.Tensor,
                   noise: StepNoise | None = None,
                   consts: dict[str, Any] | None = None
                   ) -> tuple[torch.Tensor | None, StepMetrics]:
        n_rays = cam_idx.shape[0] * shards
        if n_blocks > 0 and n_rays % n_blocks:
            raise ValueError(f"grad_blocks={n_blocks} must divide "
                             f"rays/step={n_rays}")
        if noise is None:
            noise = draw_noise(cfg, step, n_rays, poses.device)
        noise = shard_noise(mesh, noise)
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
        if n_blocks > 0:
            metrics = block_grads(params, poses, intrinsics, step, cam_idx,
                                  ij, gt, noise, occ_vals, consts)
        else:
            optimizer.zero_grad()
            loss, metrics = loss_fn(params, poses, intrinsics, cam_idx, ij,
                                    gt, noise, step, occ_vals, consts)
            # static loss scaling (reference fp16 kernels' x128); metrics
            # stay unscaled
            (loss * scale).backward()
            if mesh is not None:
                # the grads and the metrics' shares summed in one call
                flat = all_reduce_sum(mesh, torch.cat(
                    _flat_grads(optimizer)
                    + [torch.stack(metrics[:4]).detach()]))
                _set_grads(optimizer, flat[:-4])
                metrics = _metrics(*flat[-4:])
        if scale != 1.0:
            for p in optimizer.named.values():
                if p.grad is not None:
                    p.grad.div_(scale)
        optimizer.step()
        return occ_grid, StepMetrics(*(t.detach() for t in metrics))

    return train_step
