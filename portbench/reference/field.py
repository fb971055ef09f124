"""Plain PyTorch reference of the F2-NeRF field and renderer.

Float32 throughout, with TF32 off (:func:`strict_fp32`), no CUDA kernel,
no cache and no dedup. The feature table is read in the precision that
the configuration states: ``bf16_features`` rounds it to bfloat16 before
the trilinear interpolation, as the configuration's haloed table is
stored. The control of the benchmark's comparison reads it one step
lower (``table_dtype=torch.float8_e4m3fn``).

Sources: the reference fork (github.com/SakodaShintaro/f2-nerf):
``src/hash_3d_anchored.{cpp,cu}`` (the multi-level hash encode and the
radial contraction), ``src/sh_shader.cpp`` (the shader),
``src/renderer.cpp`` (density activation, compositing) and
``src/points_sampler.cpp`` (the dense march). The paged table layout,
the occupancy sampler and the loss terms follow the JAX package's
design, whose semantics the port keeps: pages of 4x4x4 cells with an
additive page hash, where a corner past a page's last cell reads the
next page of that axis (page + A, + B or + 1 modulo the level's pages).
The encode here gathers the 8 corners of each (point, level) directly
from the pages; it builds no haloed table.

The sampler, compositing and loss helpers are frozen copies of the
port's plain PyTorch code (each names its origin); a configuration is a
plain dict read from ``portbench/configs/<name>.json``.

The renders take the configuration's field as a function (its field
file's ``features``): ``field(params, pts, dtype, contracted=False)``
maps [N, 3] world points, or with ``contracted`` points of the
occupancy grid's domain [-2, 2)^3, to [N, hash_feat_dim] float32
features (channel 0 raw density), the table read in ``dtype``.
:func:`field` is the paged field's.
"""

from __future__ import annotations

import math
import types
from typing import NamedTuple

import numpy as np
import torch

from portbench.reference.sh import sh_encode

BLOCK = 4
_U32 = 0xFFFFFFFF
DOMAIN = 2.0            # contracted coordinates live in [-2, 2)
SIGMA_EMA_MAX = 1.0e4   # the occupancy EMA's ceiling
SHADER_EPS = 1e-3       # the widened sigmoid's eps (src/sh_shader.cpp:22-29)
ENCODE_CHUNK = 1 << 18  # points per chunk of the encode


def strict_fp32() -> None:
    """Float32 matrix products in float32: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def model_ns(model: dict) -> types.SimpleNamespace:
    """The configuration's ``model`` dict as attributes."""
    return types.SimpleNamespace(**model)


def table_dtype(model) -> torch.dtype:
    """The precision the configuration states for the feature table."""
    return torch.bfloat16 if model.bf16_features else torch.float32


# -- paged layout ------------------------------------------------------------

class Layout(NamedTuple):
    n_levels: int
    n_channels: int
    n_pages: tuple
    page_offset: tuple
    a: np.ndarray          # [L] uint32 x constant of the page hash
    b: np.ndarray          # [L] uint32 y constant
    scales: np.ndarray     # [L] float32
    biases: np.ndarray     # [L, 3] float32

    @property
    def total_pages(self) -> int:
        return self.page_offset[-1] + self.n_pages[-1]


def level_scales(n_levels: int, base: float, fine: float) -> np.ndarray:
    """exp2(base + (fine - base) * l / (L - 1)) in float32 (frozen copy
    of ``f2nerf_tpu_torch/ops/hash_encode.py:level_scales``)."""
    lvl = np.arange(n_levels, dtype=np.float32)
    return np.exp2(base + (fine - base) * lvl / max(n_levels - 1, 1))


def layout(model) -> Layout:
    """Pages per level and hash constants from the configuration alone
    (frozen copy of ``f2nerf_tpu_torch/ops/hash_paged.py:make_paged_meta``:
    the same ``default_rng(init_seed + 7)`` draws)."""
    scales = level_scales(model.n_levels, model.res_base_pow2,
                          model.res_fine_pow2)
    rng = np.random.default_rng(model.init_seed + 7)
    max_pages = max((1 << model.log2_table_size) // BLOCK ** 3, 1)
    n_pages, offsets, a_c, b_c, biases = [], [], [], [], []
    off = 0
    for lvl in range(model.n_levels):
        res_blocks = int(np.ceil(4.0 * float(scales[lvl]) / BLOCK)) + 1
        if res_blocks ** 3 <= max_pages:
            n_p = res_blocks ** 3
            a_c.append(res_blocks * res_blocks)
            b_c.append(res_blocks)
            biases.append(np.full(3, 2.0 * float(scales[lvl]),
                                  dtype=np.float32))
        else:
            n_p = max_pages
            a_c.append(int(rng.integers(1 << 20, 1 << 31)) | 1)
            b_c.append(int(rng.integers(1 << 20, 1 << 31)) | 1)
            biases.append(rng.uniform(100.0, 1100.0, 3).astype(np.float32))
        n_pages.append(n_p)
        offsets.append(off)
        off += n_p
    return Layout(model.n_levels, model.n_channels, tuple(n_pages),
                  tuple(offsets), np.array(a_c, dtype=np.uint32),
                  np.array(b_c, dtype=np.uint32),
                  np.asarray(scales, dtype=np.float32),
                  np.stack(biases).astype(np.float32))


# -- encode ------------------------------------------------------------------

def rounded(pool: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``pool`` as read in ``dtype``, in float32; the gradient passes
    straight through the rounding."""
    if dtype == torch.float32:
        return pool
    return pool + (pool.detach().to(dtype).float() - pool.detach())


def _encode_chunk(table: torch.Tensor, x: torch.Tensor, lay: Layout
                  ) -> torch.Tensor:
    """[n, 3] contracted points -> [n, L*C] features, 8 corners a
    (point, level) gathered from ``table`` [P, C, 4, 4, 4]."""
    dev = x.device
    scales = torch.as_tensor(lay.scales, device=dev)
    biases = torch.as_tensor(lay.biases, device=dev)
    pt = x[None, :, :] * scales[:, None, None] + biases[:, None, :]
    f = torch.floor(pt.detach())
    frac = pt - f                                        # [L, n, 3]
    cell = f.to(torch.int32)
    blk = (cell >> 2).to(torch.int64) & _U32
    local = (cell & (BLOCK - 1)).long()
    n_p = torch.as_tensor(np.array(lay.n_pages, dtype=np.int64),
                          device=dev)[:, None]
    a = torch.as_tensor(lay.a.astype(np.int64), device=dev)[:, None]
    b = torch.as_tensor(lay.b.astype(np.int64), device=dev)[:, None]
    page = ((((blk[..., 0] * a) & _U32) + ((blk[..., 1] * b) & _U32)
             + blk[..., 2]) & _U32) % n_p                # [L, n]
    # a corner past the page's last cell on an axis reads the next page
    # of that axis: + A (x), + B (y), + 1 (z), modulo the level's pages
    step = torch.stack([a % n_p, b % n_p, torch.ones_like(n_p)], -1)
    offs = torch.as_tensor(np.array(lay.page_offset, dtype=np.int64),
                           device=dev)[:, None]
    out = 0.0
    for corner in range(8):
        d = torch.tensor([(corner >> 2) & 1, (corner >> 1) & 1, corner & 1],
                         device=dev)
        c = local + d                                    # [L, n, 3]
        over = (c >= BLOCK).long()
        pg = (page + (over * step).sum(-1)) % n_p + offs
        c = c - BLOCK * over
        vals = table[pg, :, c[..., 0], c[..., 1], c[..., 2]]   # [L, n, C]
        w = torch.prod(torch.where(d.bool(), frac, 1.0 - frac), dim=-1)
        out = out + w[..., None] * vals
    return out.permute(1, 0, 2).reshape(x.shape[0], -1)


def encode(pool: torch.Tensor, x: torch.Tensor, lay: Layout,
           dtype: torch.dtype) -> torch.Tensor:
    """[N, 3] contracted points -> [N, L*C] float32 features, the table
    read in ``dtype``; differentiable in ``pool`` and ``x``."""
    table = rounded(pool, dtype)
    parts = [_encode_chunk(table, x[i:i + ENCODE_CHUNK], lay)
             for i in range(0, x.shape[0], ENCODE_CHUNK)]
    return torch.cat(parts, 0)


def contract(points: torch.Tensor, radius: float = 1.0) -> torch.Tensor:
    """Radial contraction onto the ball of radius 2r (frozen copy of
    ``f2nerf_tpu_torch/ops/contraction.py``;
    ``src/hash_3d_anchored.cpp:79-82``)."""
    norm = torch.linalg.vector_norm(points, dim=-1, keepdim=True)
    safe_norm = torch.clamp_min(norm, 1e-12)
    inside = norm <= radius
    outside_pts = (1.0 + radius - radius / safe_norm) * points / safe_norm
    return torch.where(inside, points, outside_pts)


class _TruncExp(torch.autograd.Function):
    """exp(x), gradient g * exp(clamp(x, -100, 5))
    (``src/CustomOps/CustomOps.cpp:10-20``)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -100.0, 5.0))


def density(raw: torch.Tensor, shift: float) -> torch.Tensor:
    return _TruncExp.apply(raw - shift)


def field(params: dict, pts: torch.Tensor, model, lay: Layout,
          dtype: torch.dtype, contracted: bool = False) -> torch.Tensor:
    """[N, 3] points -> [N, 16] features (channel 0 raw density)."""
    x = pts if contracted else contract(pts, model.contraction_radius)
    feat = encode(params["field"]["feat_pool"], x, lay, dtype)
    return feat @ params["field"]["mlp"]["w"] + params["field"]["mlp"]["b"]


def shade(params: dict, feats: torch.Tensor, dirs: torch.Tensor,
          model) -> torch.Tensor:
    """Features ++ SH(dirs) -> 64 -> ReLU -> 3 -> widened sigmoid."""
    sh = params["shader"]
    x = torch.cat([feats, sh_encode(dirs, model.sh_degree)], dim=-1)
    h = torch.relu(x @ sh["w0"] + sh["b0"])
    return ((1.0 + 2.0 * SHADER_EPS) * torch.sigmoid(h @ sh["w1"] + sh["b1"])
            - SHADER_EPS)


# -- samplers (frozen copies of models/sampler.py and models/occupancy.py) --

def sample_dense(rays_o, rays_d, model, u=None):
    """Stratified march, ``u`` [R, S] the TRAIN jitter or None
    (``f2nerf_tpu_torch/models/sampler.py:sample_rays``)."""
    r, s = rays_o.shape[0], model.n_samples
    dirs = rays_d / torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True)
    noise = (torch.ones((r, s), device=rays_o.device) if u is None
             else u - 0.5 + 1.0)
    t = model.sample_near + torch.cumsum(noise, dim=-1) * model.sample_l
    pts = rays_o[:, None, :] + dirs[:, None, :] * t[..., None]
    dt = torch.diff(t, dim=-1, prepend=t[:, :1])
    return pts, dirs, dt, t, None


def sigma_threshold(model) -> float:
    seg_len = model.n_samples * model.sample_l / model.occ_segments
    return -math.log(max(1.0 - model.occ_thresh, 1e-9)) / seg_len


def occ_values(grid: torch.Tensor, model, warmup: bool = False
               ) -> torch.Tensor:
    """[2, G^3] sampler values of a [2, G, G, G] grid
    (``f2nerf_tpu_torch/models/occupancy.py:occ_values``)."""
    gmax, gmean = grid[0], grid[1]
    thresh = torch.clamp_max(torch.mean(gmax), sigma_threshold(model))
    occ = gmax >= thresh * 0.999
    vals = torch.where(occ, torch.clamp_min(gmax, 1e-12),
                       torch.zeros((), device=gmax.device))
    if warmup:
        vals = torch.clamp_min(vals, sigma_threshold(model))
    return torch.stack([vals.reshape(-1),
                        torch.clamp_max(gmean, SIGMA_EMA_MAX).reshape(-1)])


def _cell_index(pts: torch.Tensor, g: int) -> torch.Tensor:
    ijk = torch.clamp(((pts + DOMAIN) * (g / (2.0 * DOMAIN))).to(
        torch.int32), 0, g - 1).long()
    return (ijk[..., 0] * g + ijk[..., 1]) * g + ijk[..., 2]


def sample_occ(rays_o, rays_d, vals, model, rank_u=None, within_u=None,
               explore=None):
    """Occupancy-guided sampling (``f2nerf_tpu_torch/models/occupancy.py:
    sample_rays_occ``): ``occ_keep`` segments chosen evenly among the
    occupied, transmittance-eligible ones, ``occ_samples_per_segment``
    samples each; TRAIN jitters the ranks and the samples and fills the
    explore slots. Returns (pts, dirs, dt, t, explore)."""
    train = rank_u is not None
    r, dev = rays_o.shape[0], rays_o.device
    n_seg, keep = model.occ_segments, model.occ_keep
    sps = model.occ_samples_per_segment
    seg_len = model.n_samples * model.sample_l / n_seg
    dirs = rays_d / torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True)
    t_mid = (model.sample_near
             + (torch.arange(n_seg, dtype=torch.float32, device=dev) + 0.5)
             * seg_len)
    mid = rays_o[:, None, :] + dirs[:, None, :] * t_mid[None, :, None]
    cell = _cell_index(contract(mid), model.occ_grid_res)
    both = vals.float()[:, cell]
    occ_seg, elig_seg = both[0], both[1]
    occ = occ_seg > 0.0
    occ_all = occ_all_orig = occ
    if model.occ_trans_eps > 0.0:
        sig = torch.clamp_max(elig_seg, SIGMA_EMA_MAX)
        tau = torch.clamp_max(sig * seg_len, model.occ_elig_tau_cap)
        cum_tau = torch.cumsum(tau, dim=-1) - tau
        occ = occ & (torch.exp(-cum_tau) > model.occ_trans_eps)
    if train and model.occ_explore_eps > 0.0:
        occ = torch.where(explore, occ_all, occ)
    n_exp = min(model.occ_explore_slots, keep - 1) if train else 0
    k_base = keep - n_exp
    cum = torch.cumsum(occ.to(torch.int32), dim=-1)
    m = cum[:, -1:]
    j = torch.arange(keep, dtype=torch.float32, device=dev)[None, :]
    u = rank_u if train else 0.5
    ranks = torch.where(m > k_base, torch.floor((j + u) * m.float() / k_base),
                        j.expand(r, keep)).to(torch.int32)
    if n_exp:
        if model.occ_explore_targeted:
            occ_tgt = occ_all & ~occ
            has_tgt = torch.any(occ_tgt, dim=-1, keepdim=True)
            occ_all = torch.where(has_tgt, occ_tgt, occ_all)
        cum_all = torch.cumsum(occ_all.to(torch.int32), dim=-1)
        m_all = cum_all[:, -1:]
        ranks_exp = torch.floor(
            (j - k_base + u) * m_all.float() / n_exp).to(torch.int32)
        is_exp = (torch.arange(keep, device=dev) >= k_base)[None, :]
        ranks = torch.where(is_exp, ranks_exp, ranks)
        m_sel = torch.where(is_exp, m_all, m)
        cum_sel = torch.where(is_exp[:, :, None], cum_all[:, None, :],
                              cum[:, None, :])
        occ_sel = torch.where(is_exp[:, :, None], occ_all[:, None, :],
                              occ[:, None, :])
    else:
        m_sel, cum_sel, occ_sel = m, cum[:, None, :], occ[:, None, :]
    valid_seg = ranks < m_sel
    hit = (cum_sel == (ranks + 1)[:, :, None]) & occ_sel
    seg_idx = torch.sum(
        hit * torch.arange(n_seg, dtype=torch.int32, device=dev), dim=-1)
    u = within_u if train else 0.5
    base = model.sample_near + seg_idx.float()[..., None] * seg_len
    within = (torch.arange(sps, dtype=torch.float32, device=dev)
              + u) * (seg_len / sps)
    t = (base + within).reshape(r, keep * sps)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    dt_local = torch.where(valid_seg[..., None],
                           torch.full((), seg_len / sps, device=dev), zero)
    dt = dt_local.expand(r, keep, sps).reshape(r, keep * sps)
    pts = rays_o[:, None, :] + dirs[:, None, :] * t[..., None]
    ineg = occ_all_orig & ~occ
    slot_ineg = torch.gather(ineg, 1, seg_idx.long()) & valid_seg
    explore_out = slot_ineg[..., None].expand(r, keep, sps).reshape(
        r, keep * sps)
    return pts, dirs, dt, t, explore_out


# -- compositing (frozen copy of ops/composite.py) --------------------------

def exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, dim=-1) - x


def composite(sd, colors, t, bg, trans_eps):
    """(rgb, depth, weights, mask) of [R, S] optical depths: samples kept
    while the transmittance exceeds ``trans_eps`` (src/renderer.cpp:58-122)."""
    mask = torch.exp(-exclusive_cumsum(sd)) > trans_eps
    sd = sd * mask
    trans = torch.exp(-exclusive_cumsum(sd))
    weights = trans * (1.0 - torch.exp(-sd))
    last = torch.exp(-torch.sum(sd, dim=-1))
    rgb = torch.sum(weights[..., None] * colors, dim=-2) + last[..., None] * bg
    depth = torch.sum(weights * (t + 1e-2), dim=-1) / (1.0 - last + 1e-4)
    return rgb, depth, weights, mask


def distortion_loss(weights, t, dt, mask, march_len):
    w = weights * mask
    s_mid = (t - 0.5 * dt) / march_len
    d = dt / march_len
    loss_bi = 2.0 * torch.sum(
        w * (s_mid * exclusive_cumsum(w) - exclusive_cumsum(w * s_mid)),
        dim=-1)
    return loss_bi + torch.sum(w * w * d, dim=-1) / 3.0


def weight_variance(weights, mask, pos):
    w = weights * mask
    mean = torch.sum(w * pos, dim=-1) / (torch.sum(w, dim=-1) + 1e-6)
    bias = pos - mean[..., None]
    return torch.sum(w * bias * bias, dim=-1)


# -- rays and render ---------------------------------------------------------

def rays_from_pose(pose, intrinsic, ij):
    """Pinhole rays with the half-pixel shift, camera looking down -z
    (``src/rays.cpp:7-29``)."""
    i = ij[..., 0].float() + 0.5
    j = ij[..., 1].float() + 0.5
    u = (j - intrinsic[..., 0, 2]) / intrinsic[..., 0, 0]
    v = -((i - intrinsic[..., 1, 2]) / intrinsic[..., 1, 1])
    dir_cam = torch.stack([u, v, -torch.ones_like(u)], dim=-1)
    rays_d = (pose[..., :3, :3] @ dir_cam[..., None])[..., 0]
    return torch.broadcast_to(pose[..., :3, 3], rays_d.shape), rays_d


class Render(NamedTuple):
    colors: torch.Tensor
    weights: torch.Tensor
    mask: torch.Tensor
    t: torch.Tensor
    dt: torch.Tensor
    sec_density: torch.Tensor
    explore: torch.Tensor | None


def render(params, rays_o, rays_d, model, field, dtype, occ_vals=None,
           noise=None, emb_idx=None) -> Render:
    """Render rays; ``noise`` (``reference.train.Noise``) makes it TRAIN:
    jittered samples, the random background and the per-image
    appearance embedding ``app_emb[emb_idx]``; None is VALIDATE (grey
    background, no embedding)."""
    r = rays_o.shape[0]
    train = noise is not None
    bg = noise.bg if train else torch.full((r, 3), 0.5, device=rays_o.device)
    if model.sampler_mode == "occ":
        pts, dirs, dt, t, explore = sample_occ(
            rays_o, rays_d, occ_vals, model,
            rank_u=noise.rank if train else None,
            within_u=noise.within if train else None,
            explore=noise.explore if train else None)
    else:
        pts, dirs, dt, t, explore = sample_dense(
            rays_o, rays_d, model, u=noise.march if train else None)
    s = pts.shape[1]
    feat = field(params, pts.reshape(r * s, 3), dtype).reshape(r, s, -1)
    sigma = density(feat[..., 0], model.density_shift)
    shading = torch.cat([torch.ones_like(feat[..., :1]), feat[..., 1:]], -1)
    if train and emb_idx is not None:
        shading = shading + params["app_emb"][emb_idx][:, None, :]
    colors = shade(params, shading, dirs[:, None, :].expand(r, s, 3), model)
    sd = torch.where(dt > 0.0, sigma * dt, torch.zeros((), device=dt.device))
    rgb, _, weights, mask = composite(sd, colors, t, bg, model.trans_eps)
    return Render(rgb, weights, mask, t, dt, sd, explore)


def render_rays(params, rays_o, rays_d, model, field, dtype, occ_vals,
                chunk: int = 1 << 15) -> torch.Tensor:
    """VALIDATE colors [R, 3] of many rays, in chunks, without a graph."""
    with torch.no_grad():
        return torch.cat([
            render(params, rays_o[i:i + chunk], rays_d[i:i + chunk], model,
                   field, dtype, occ_vals).colors
            for i in range(0, rays_o.shape[0], chunk)], 0)


def pixel_grid(h: int, w: int, device) -> torch.Tensor:
    ii, jj = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32),
                            indexing="ij")
    return torch.stack([ii.reshape(-1), jj.reshape(-1)], -1).to(device)


def render_image(params, pose, intrinsic, h, w, model, field, dtype,
                 occ_vals) -> torch.Tensor:
    """[h, w, 3] VALIDATE render clipped to [0, 1]."""
    rays_o, rays_d = rays_from_pose(pose[None], intrinsic[None],
                                    pixel_grid(h, w, pose.device))
    colors = render_rays(params, rays_o, rays_d, model, field, dtype,
                         occ_vals)
    return torch.clamp(colors.reshape(h, w, 3), 0.0, 1.0)
