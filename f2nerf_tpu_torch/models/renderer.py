"""Volume renderer: sampler -> hash field -> SH shader -> compositing
(port of ``f2nerf_tpu/models/renderer.py``, TRAIN and VALIDATE modes).

Reference ``src/renderer.{hpp,cpp}``. A single dense masked pass replaces
the reference's two-pass early-stop compaction; it is exact because the
keep mask is a prefix of each ray (ops/composite.py).

Params are a plain dict with the JAX package's layout:
``{"field": {...}, "shader": {...}, "app_emb": [n_images, 16]}``. The
non-trained constants are a second dict shaped like the JAX package's
``consts``: ``{"field": {"warp_anchors", "warp_rows"}}`` in perspective
mode, ``{}`` or None otherwise.
The dense sampler's two-pass TRAIN path (``dense_two_pass``, off by
default) is not ported.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from f2nerf_tpu_torch.core.config import ModelConfig
from f2nerf_tpu_torch.models import hash_field, occupancy, sampler, sh_shader
from f2nerf_tpu_torch.ops.composite import composite, density_activation

Params = dict[str, Any]


class RenderResult(NamedTuple):
    colors: torch.Tensor   # [R, 3]
    depths: torch.Tensor   # [R]
    weights: torch.Tensor  # [R, S] (zero outside the keep mask)
    mask: torch.Tensor     # [R, S] bool keep mask
    t: torch.Tensor        # [R, S] sample distances
    dt: torch.Tensor       # [R, S] sample interval widths (0 = invalid)
    sec_density: torch.Tensor | None = None  # [R, S] sigma*dt
    explore: torch.Tensor | None = None      # [R, S] bool (occ sampler)


def init(generator: torch.Generator, cfg: ModelConfig, n_images: int,
         device: torch.device) -> Params:
    """Trainable params with the JAX package's distributions; the
    appearance embedding is 0.1 * N(0, 1). ``generator`` lives on
    ``device``."""
    return {
        "field": hash_field.init(generator, cfg, device),
        "shader": sh_shader.init(generator, cfg, device),
        "app_emb": torch.randn((n_images, cfg.app_emb_dim),
                               generator=generator, device=device) * 0.1,
    }


def _field_consts(consts: Params | None) -> Params | None:
    return None if consts is None else consts.get("field")


def density_at(params: Params, points: torch.Tensor, cfg: ModelConfig,
               contracted: bool = False,
               consts: Params | None = None) -> torch.Tensor:
    """[N, 3] points -> [N] sigma (the occupancy refresh runs it under
    ``torch.no_grad()``; the global-sparsity loss differentiates it).
    ``contracted=True`` for points already in contracted space."""
    feat = hash_field.query(params["field"], points, cfg,
                            pre_contracted=contracted,
                            consts=_field_consts(consts))
    return density_activation(feat[..., 0], cfg.density_shift)


def render(params: Params, rays_o: torch.Tensor, rays_d: torch.Tensor,
           cfg: ModelConfig, occ_vals: torch.Tensor | None = None,
           level_weights: torch.Tensor | None = None,
           eval_emb: torch.Tensor | None = None,
           emb_idx: torch.Tensor | None = None,
           noise=None, consts: Params | None = None) -> RenderResult:
    """Render a batch of rays.

    VALIDATE (``noise`` None): no jitter, grey (0.5) background, and the
    optional ``eval_emb`` [app_emb_dim] added to the shading features.
    TRAIN (``noise`` given, e.g. a ``train.step.StepNoise``): the random
    background ``noise.bg`` [R, 3], the samplers jittered by
    ``noise.march`` (dense) or ``noise.rank`` / ``noise.within`` /
    ``noise.explore`` (occ), and the per-image embedding
    ``app_emb[emb_idx]`` when ``emb_idx`` [R] is given (JAX ``render``,
    ``renderer.py:110-175``).

    Args:
      rays_o, rays_d: [R, 3] ray origins/directions (dirs need not be unit).
      occ_vals: [2, G^3] from ``occupancy.occ_values``; required when
        cfg.sampler_mode == 'occ'.
    """
    r = rays_o.shape[0]
    train = noise is not None
    if train:
        if cfg.sampler_mode == "dense" and cfg.dense_two_pass:
            raise NotImplementedError(
                "the dense two-pass TRAIN renderer (dense_two_pass) is "
                "not ported")
        bg_color = noise.bg
    else:
        bg_color = torch.full((r, 3), 0.5, device=rays_o.device)
    if cfg.sampler_mode == "occ":
        if occ_vals is None:
            raise ValueError("sampler_mode='occ' requires occ_vals")
        smp = occupancy.sample_rays_occ(
            rays_o, rays_d, occ_vals, cfg,
            rank_u=noise.rank if train else None,
            within_u=noise.within if train else None,
            explore=noise.explore if train else None)
        explore = smp.explore
    else:
        smp = sampler.sample_rays(rays_o, rays_d, cfg,
                                  u=noise.march if train else None)
        explore = None
    if train:
        emb = (None if emb_idx is None
               else params["app_emb"][emb_idx][:, None, :])
    else:
        emb = None if eval_emb is None else eval_emb[None, None, :]
    return _render_samples(params, smp.pts, smp.dirs, smp.t, smp.dt,
                           explore, bg_color, cfg, level_weights, emb,
                           consts)


def _render_samples(params, pts, ray_dirs, t, dt, explore, bg_color, cfg,
                    level_weights, emb=None, consts=None) -> RenderResult:
    """Field query + shading + masked compositing over [R, S] samples."""
    r, s = pts.shape[0], pts.shape[1]
    feat = hash_field.query_rays(params["field"], pts, cfg,
                                 level_weights=level_weights,
                                 consts=_field_consts(consts))  # [R, S, F]
    sigma = density_activation(feat[..., 0], cfg.density_shift)
    # shading feature: [1, feat_1..F-1] (renderer.cpp:95-99)
    shading_feat = torch.cat([torch.ones_like(feat[..., :1]),
                              feat[..., 1:]], dim=-1)
    if emb is not None:
        shading_feat = shading_feat + emb
    dirs = ray_dirs[:, None, :].expand(r, s, 3)
    colors = sh_shader.query(params["shader"], shading_feat, dirs, cfg)
    # where(dt > 0) rather than a product: sigma is unbounded and
    # inf * 0 would put NaN into the compositing cumsum
    sec_density = torch.where(dt > 0.0, sigma * dt,
                              torch.zeros((), device=dt.device))
    rgb, depth, weights, mask = composite(sec_density, colors, t, bg_color,
                                          cfg.trans_eps)
    return RenderResult(colors=rgb, depths=depth, weights=weights,
                        mask=mask, t=t, dt=dt, sec_density=sec_density,
                        explore=explore)


@torch.no_grad()
def render_rays_chunked(params: Params, rays_o: torch.Tensor,
                        rays_d: torch.Tensor, cfg: ModelConfig,
                        chunk: int = 8192,
                        occ_vals: torch.Tensor | None = None,
                        eval_emb: torch.Tensor | None = None,
                        consts: Params | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """VALIDATE-mode render of many rays in chunks of ``chunk`` rays
    (reference Renderer::render_all_rays, src/renderer.cpp:125-151)."""
    outs_c, outs_d = [], []
    for i in range(0, rays_o.shape[0], chunk):
        res = render(params, rays_o[i:i + chunk], rays_d[i:i + chunk], cfg,
                     occ_vals=occ_vals, eval_emb=eval_emb, consts=consts)
        outs_c.append(res.colors)
        outs_d.append(res.depths)
    return torch.cat(outs_c, 0), torch.cat(outs_d, 0)


def render_image(params: Params, pose: torch.Tensor, intrinsic: torch.Tensor,
                 h: int, w: int, cfg: ModelConfig, chunk: int = 8192,
                 occ_vals: torch.Tensor | None = None,
                 eval_emb: torch.Tensor | None = None,
                 supersample: int = 1, consts: Params | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Render a full image; returns (rgb [H, W, 3] clipped, depth [H, W]).

    ``supersample=k`` renders k*h x k*w through scaled intrinsics and
    box-averages k x k blocks (exact area supersampling of the camera).
    """
    from f2nerf_tpu_torch.core.cameras import pixel_grid, rays_from_pose

    dev = pose.device
    k = max(int(supersample), 1)
    if k > 1:
        intrinsic = intrinsic * k
        intrinsic[2, 2] = 1.0
    hh, ww = h * k, w * k
    ij = torch.as_tensor(pixel_grid(hh, ww), device=dev)
    rays_o, rays_d = rays_from_pose(pose[None], intrinsic[None], ij)
    colors, depths = render_rays_chunked(params, rays_o, rays_d, cfg,
                                         chunk=chunk, occ_vals=occ_vals,
                                         eval_emb=eval_emb, consts=consts)
    rgb = torch.clamp(colors.reshape(hh, ww, 3), 0.0, 1.0)
    depth = depths.reshape(hh, ww)
    if k > 1:
        rgb = rgb.reshape(h, k, w, k, 3).mean(dim=(1, 3))
        depth = depth.reshape(h, k, w, k).mean(dim=(1, 3))
    return rgb, depth
