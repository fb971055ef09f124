"""Volume renderer: sampler -> hash field -> SH shader -> compositing
(port of ``f2nerf_tpu/models/renderer.py``, TRAIN and VALIDATE modes).

Reference ``src/renderer.{hpp,cpp}``. A single dense masked pass
replaces the reference's two-pass early-stop compaction by default; it
is exact because the keep mask is a prefix of each ray
(ops/composite.py). The dense sampler's TRAIN mode can take the
two-pass instead (``dense_two_pass``, :func:`_render_two_pass`), where
JAX takes it.

Params are a plain dict with the JAX package's layout:
``{"field": {...}, "shader": {...}, "app_emb": [n_images, 16]}``. The
non-trained constants are a second dict shaped like the JAX package's
``consts``: ``{"field": {...}}`` holding the warp tables in perspective
mode and the hash constants in xor mode (``models/hash_field.py``), ``{}``
or None otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from f2nerf_tpu_torch.core.config import ModelConfig
from f2nerf_tpu_torch.models import hash_field, occupancy, sampler, sh_shader
from f2nerf_tpu_torch.ops.composite import (composite, composite_weights,
                                            density_activation,
                                            exclusive_cumsum)
from f2nerf_tpu_torch.parallel.mesh import DataMesh, all_gather_rows
from f2nerf_tpu_torch.utils import trace

Params = dict[str, Any]


class RenderResult(NamedTuple):
    colors: torch.Tensor   # [R, 3]
    depths: torch.Tensor   # [R]
    weights: torch.Tensor  # [R, S] (zero outside the keep mask)
    mask: torch.Tensor     # [R, S] bool keep mask
    t: torch.Tensor        # [R, S] sample distances
    dt: torch.Tensor       # [R, S] sample interval widths (0 = invalid)
    # [R, S] sigma*dt; the dense two-pass returns it zeroed outside the
    # survivor prefix ``mask`` (pass 2 never queries the tail), the single
    # pass for every dt > 0 sample (JAX renderer.py:39-47)
    sec_density: torch.Tensor | None = None
    explore: torch.Tensor | None = None      # [R, S] bool (occ sampler)


def init(generator: torch.Generator, cfg: ModelConfig, n_images: int,
         device: torch.device) -> Params:
    """Trainable params with the JAX package's distributions; the
    appearance embedding is 0.1 * N(0, 1). ``generator`` lives on
    ``device``. The non-trained constants come from
    ``hash_field.init_consts`` and ``warp.warp_consts``."""
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
    ``renderer.py:110-175``). The dense sampler with ``dense_two_pass``
    and a sample count divisible by 8 renders TRAIN in two passes
    (:func:`_render_two_pass`).

    Args:
      rays_o, rays_d: [R, 3] ray origins/directions (dirs need not be unit).
      occ_vals: [2, G^3] from ``occupancy.occ_values``; required when
        cfg.sampler_mode == 'occ'.
    """
    r = rays_o.shape[0]
    train = noise is not None
    if train:
        bg_color = noise.bg
    else:
        bg_color = torch.full((r, 3), 0.5, device=rays_o.device)
    if cfg.sampler_mode == "occ" and occ_vals is None:
        raise ValueError("sampler_mode='occ' requires occ_vals")
    with trace.span("render.sample"):
        if cfg.sampler_mode == "occ":
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
    if train and uses_two_pass(cfg):
        ray_emb = None if emb_idx is None else params["app_emb"][emb_idx]
        return _render_two_pass(params, smp, bg_color, cfg, level_weights,
                                ray_emb, consts)
    if train:
        emb = (None if emb_idx is None
               else params["app_emb"][emb_idx][:, None, :])
    else:
        emb = None if eval_emb is None else eval_emb[None, None, :]
    return _render_samples(params, smp.pts, smp.dirs, smp.t, smp.dt,
                           explore, bg_color, cfg, level_weights, emb,
                           consts)


def uses_two_pass(cfg: ModelConfig) -> bool:
    """Whether TRAIN renders take the dense two-pass
    (:func:`_render_two_pass`)."""
    return (cfg.sampler_mode == "dense" and cfg.dense_two_pass
            and cfg.n_samples % 8 == 0)


def _render_samples(params, pts, ray_dirs, t, dt, explore, bg_color, cfg,
                    level_weights, emb=None, consts=None) -> RenderResult:
    """Field query + shading + masked compositing over [R, S] samples."""
    r, s = pts.shape[0], pts.shape[1]
    with trace.span("render.field"):
        feat = hash_field.query_rays(params["field"], pts, cfg,
                                     level_weights=level_weights,
                                     consts=_field_consts(consts))
        sigma = density_activation(feat[..., 0], cfg.density_shift)
    with trace.span("render.shade"):
        # shading feature: [1, feat_1..F-1] (renderer.cpp:95-99)
        shading_feat = torch.cat([torch.ones_like(feat[..., :1]),
                                  feat[..., 1:]], dim=-1)
        if emb is not None:
            shading_feat = shading_feat + emb
        dirs = ray_dirs[:, None, :].expand(r, s, 3)
        colors = sh_shader.query(params["shader"], shading_feat, dirs, cfg)
    with trace.span("render.composite"):
        # where(dt > 0) rather than a product: sigma is unbounded and
        # inf * 0 would put NaN into the compositing cumsum
        sec_density = torch.where(dt > 0.0, sigma * dt,
                                  torch.zeros((), device=dt.device))
        rgb, depth, weights, mask = composite(sec_density, colors, t,
                                              bg_color, cfg.trans_eps)
        if trace.enabled():
            trace.count("render.live", ((dt > 0.0) & mask).sum())
            trace.count("render.slots", dt.numel())
    return RenderResult(colors=rgb, depths=depth, weights=weights,
                        mask=mask, t=t, dt=dt, sec_density=sec_density,
                        explore=explore)


def two_pass_bucket(n: int, n_surv: int) -> int:
    """The dense two-pass's pass-2 size for ``n_surv`` survivors of
    ``n`` samples: the smallest of n/8, n/4, n/2 that holds them, else
    ``n`` (the single pass)."""
    return next((b for b in (n // 8, n // 4, n // 2) if n_surv <= b), n)


def _render_two_pass(params, smp, bg_color, cfg, level_weights, ray_emb,
                     consts) -> RenderResult:
    """Dense TRAIN two-pass: the reference's early-stop compaction
    (renderer.cpp:58-88) with static buckets (JAX ``_render_two_pass``,
    ``renderer.py:178-312``).

    Pass 1 queries the density of every sample without gradients and
    gives the survivor prefix ``mask`` (transmittance > trans_eps). A
    stable partition puts the survivors first, in ray-major order (two
    cumsums and one scatter to unique indices, as JAX builds it). Pass 2
    runs the field, the shader and the compositing, differentiably, on
    the first NB entries of that order, NB the smallest of {RS/8, RS/4,
    RS/2} that holds the survivors; the entries past the survivors are
    the first non-survivors, given dt = 0. When none holds them, the
    single pass runs (:func:`_render_samples`), having paid for pass 1.

    The bucket is chosen on the host, so the survivor count is read once
    per call: the one device sync of a two-pass training step.

    Compositing: each ray's survivors are contiguous and in order, so
    pass 2's ``sigma * dt`` and colors are scattered back to [R, S]
    (unique indices) and composited per ray as the single pass does,
    with the pass-1 mask. JAX sums per ray with ``segment_sum``; the port
    keeps the scatter and the per-row sums, which are deterministic on
    the card (no float atomics), so two steps give bitwise-equal grads.
    """
    r, s = smp.pts.shape[0], smp.pts.shape[1]
    n = r * s
    fconsts = _field_consts(consts)
    with trace.span("render.field"), torch.no_grad():
        # run dedup off in pass 1, as in JAX: no backward to compress
        feat1 = hash_field.query_rays(
            params["field"], smp.pts,
            dataclasses.replace(cfg, encode_dedup=False),
            level_weights=level_weights, consts=fconsts)
        sigma1 = density_activation(feat1[..., 0], cfg.density_shift)
        sec1 = torch.where(smp.dt > 0.0, sigma1 * smp.dt,
                           torch.zeros((), device=smp.dt.device))
        mask1 = torch.exp(-exclusive_cumsum(sec1)) > cfg.trans_eps
        # pass 1's slots are encoded, never composited
        trace.count("render.slots", n)
        flat_mask = mask1.reshape(n)
        n_surv = int(flat_mask.sum())                  # the host sync
    nb = two_pass_bucket(n, n_surv)
    if nb == n:
        emb = None if ray_emb is None else ray_emb[:, None, :]
        return _render_samples(params, smp.pts, smp.dirs, smp.t, smp.dt,
                               None, bg_color, cfg, level_weights, emb,
                               consts)

    with trace.span("render.field"):
        # survivors first, ray-major order kept: a stable partition of
        # the flat mask
        cum_in = torch.cumsum(flat_mask, 0)
        cum_out = torch.cumsum(~flat_mask, 0)
        pos = torch.where(flat_mask, cum_in - 1, n_surv + cum_out - 1)
        order = torch.empty(n, dtype=torch.int64, device=pos.device)
        order[pos] = torch.arange(n, device=pos.device)
        idx = order[:nb]                                       # [NB]
        ray_id = idx // s
        valid = torch.arange(nb, device=idx.device) < n_surv
        pts = smp.pts.reshape(n, 3)[idx]
        dt = torch.where(valid, smp.dt.reshape(n)[idx],
                         torch.zeros((), device=idx.device))
        feat = hash_field.query_compacted(params["field"], pts, cfg,
                                          level_weights=level_weights,
                                          consts=fconsts)      # [NB, F]
        sigma = density_activation(feat[:, 0], cfg.density_shift)
    with trace.span("render.shade"):
        shading_feat = torch.cat([torch.ones_like(feat[:, :1]),
                                  feat[:, 1:]], dim=-1)
        if ray_emb is not None:
            shading_feat = shading_feat + ray_emb[ray_id]
        colors = sh_shader.query(params["shader"], shading_feat[:, None, :],
                                 smp.dirs[ray_id][:, None, :], cfg)[:, 0]
    with trace.span("render.composite"):
        sec = torch.where(dt > 0.0, sigma * dt,
                          torch.zeros((), device=dt.device))
        # back to [R, S]: zero outside the survivors, exactly
        sec_full = sec.new_zeros(n).index_put((idx,), sec).reshape(r, s)
        colors_full = colors.new_zeros((n, 3)).index_put(
            (idx,), colors).reshape(r, s, 3)
        rgb, depth, weights = composite_weights(sec_full, colors_full,
                                                smp.t, bg_color)
        if trace.enabled():
            # pass 2's live slots are its survivors (dt > 0 there)
            trace.count("render.live", (dt > 0.0).sum())
            trace.count("render.slots", nb)
    return RenderResult(colors=rgb, depths=depth, weights=weights,
                        mask=mask1, t=smp.t, dt=smp.dt, sec_density=sec_full,
                        explore=None)


@torch.no_grad()
def render_rays_chunked(params: Params, rays_o: torch.Tensor,
                        rays_d: torch.Tensor, cfg: ModelConfig,
                        chunk: int = 8192,
                        occ_vals: torch.Tensor | None = None,
                        eval_emb: torch.Tensor | None = None,
                        consts: Params | None = None,
                        mesh: DataMesh | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """VALIDATE-mode render of many rays in chunks of ``chunk`` rays
    (reference Renderer::render_all_rays, src/renderer.cpp:125-151).

    With ``mesh`` (a ``parallel.mesh.DataMesh`` of k ranks; every rank
    calls with the same rays), the chunk is rounded up to a multiple of
    k, the last chunk is padded with rays of 1.0 to a multiple of k (JAX
    pads it to a whole chunk, for one compiled shape; eager PyTorch needs
    no fixed shape), each rank renders its contiguous slice of every
    chunk, and the rows are gathered, so every rank returns every ray.
    """
    k = mesh.size if mesh is not None else 1
    chunk = -(-chunk // k) * k
    outs = []
    for i in range(0, rays_o.shape[0], chunk):
        o, d = rays_o[i:i + chunk], rays_d[i:i + chunk]
        n = o.shape[0]
        pad = -n % k
        if pad:
            o = torch.cat([o, o.new_ones((pad, 3))])
            d = torch.cat([d, d.new_ones((pad, 3))])
        part = (n + pad) // k
        r = mesh.rank if mesh is not None else 0
        sl = slice(r * part, (r + 1) * part)
        res = render(params, o[sl], d[sl], cfg, occ_vals=occ_vals,
                     eval_emb=eval_emb, consts=consts)
        if mesh is None:
            outs.append((res.colors, res.depths))
            continue
        rows = all_gather_rows(mesh, torch.cat([res.colors,
                                                res.depths[:, None]], 1))
        outs.append((rows[:n, :3], rows[:n, 3]))
    return (torch.cat([c for c, _ in outs], 0),
            torch.cat([d for _, d in outs], 0))


def render_image(params: Params, pose: torch.Tensor, intrinsic: torch.Tensor,
                 h: int, w: int, cfg: ModelConfig, chunk: int = 8192,
                 occ_vals: torch.Tensor | None = None,
                 eval_emb: torch.Tensor | None = None,
                 supersample: int = 1, consts: Params | None = None,
                 mesh: DataMesh | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Render a full image; returns (rgb [H, W, 3] clipped, depth [H, W]).
    With ``mesh``, the rays are sharded over its ranks and every rank
    returns the whole image (:func:`render_rays_chunked`).

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
                                         eval_emb=eval_emb, consts=consts,
                                         mesh=mesh)
    rgb = torch.clamp(colors.reshape(hh, ww, 3), 0.0, 1.0)
    depth = depths.reshape(hh, ww)
    if k > 1:
        rgb = rgb.reshape(h, k, w, k, 3).mean(dim=(1, 3))
        depth = depth.reshape(h, k, w, k).mean(dim=(1, 3))
    return rgb, depth
