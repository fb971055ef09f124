"""Anchored hash-grid scene field (port of
``f2nerf_tpu/models/hash_field.py``). Differentiable in ``feat_pool`` and
the head (training) and in the query points (the localizer's pose
gradient).

Input map (radial contraction, or the perspective warp of
``models/warp.py``) -> hash encode -> Linear(L*C -> 16) head. Two encode
backends (``cfg.hash_mode``), as in the JAX package:

* ``"paged"`` (default): ``ops/hash_paged.py``, the CUDA kernels'
  encode; ``feat_pool`` [P_total, C, 4, 4, 4];
* ``"xor"``: ``ops/hash_encode.py``, the reference's per-corner
  XOR-prime hash (``src/hash_3d_anchored.cu:27-58``) in plain PyTorch,
  the semantic oracle; ``feat_pool`` [L, T, C]. It launches no kernel.

The field's non-trained constants are its ``consts`` dict (the JAX
package's ``consts["field"]``), never part of ``params``: the warp tables
``{"warp_anchors": [M, 3], "warp_rows": [M, 128]}`` in perspective mode,
and the xor hash's ``{"primes": [L, 3] int64, "biases": [L, 3],
"scales": [L]}`` in xor mode; both when a config asks for both.
Parameters are a plain dict with the JAX package's layout
(``{"feat_pool": ..., "mlp": {"w": [L*C, 16], "b"}}``, ``w`` applied as
``x @ w``, so converted weights are not transposed).

In paged mode a params dict may also carry ``"haloed"``, the haloed
table already in its compute dtype: callers whose params never change
(the localizer) build it once instead of on every query. A query that
would differentiate ``feat_pool`` refuses the cached table, whose
gradient would never reach the pool.
"""

from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch

from f2nerf_tpu_torch.core.config import ModelConfig
from f2nerf_tpu_torch.models.warp import WarpTables, warp_points
from f2nerf_tpu_torch.ops import hash_paged
from f2nerf_tpu_torch.ops.contraction import contract, uncontract
from f2nerf_tpu_torch.ops.hash_encode import (hash_encode, init_primes,
                                              level_scales)

Params = dict[str, Any]
WARP_KEYS = ("warp_anchors", "warp_rows")
XOR_KEYS = ("primes", "biases", "scales")


@functools.lru_cache(maxsize=16)
def paged_meta(cfg: ModelConfig) -> hash_paged.PagedMeta:
    """Static paged-table layout, derived deterministically from config."""
    scales = level_scales(cfg.n_levels, cfg.res_base_pow2,
                          cfg.res_fine_pow2)
    return hash_paged.make_paged_meta(
        cfg.n_levels, cfg.table_size, cfg.n_channels, scales,
        np_seed=cfg.init_seed)


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.bf16_features else torch.float32


def init(generator: torch.Generator, cfg: ModelConfig,
         device: torch.device) -> Params:
    """Field parameters with the JAX package's distributions (not its
    bits): feat_pool ~ (U*0.2-1)*1e-4 (pages in paged mode, [L, T, C] in
    xor mode), mlp ~ U(-1/sqrt(in), 1/sqrt(in)). ``generator`` lives on
    ``device``."""
    if cfg.hash_mode == "paged":
        feat = hash_paged.init_pages(generator, paged_meta(cfg), device)
    elif cfg.hash_mode == "xor":
        u = torch.rand((cfg.n_levels, cfg.table_size, cfg.n_channels),
                       generator=generator, device=device)
        feat = (u * 0.2 - 1.0) * 1e-4
    else:
        raise ValueError(f"unknown hash_mode {cfg.hash_mode!r}")
    in_dim = cfg.n_levels * cfg.n_channels
    bound = 1.0 / np.sqrt(in_dim)

    def uniform(*shape):
        u = torch.rand(shape, generator=generator, device=device)
        return u * (2.0 * bound) - bound

    return {"feat_pool": feat,
            "mlp": {"w": uniform(in_dim, cfg.hash_feat_dim),
                    "b": uniform(cfg.hash_feat_dim)}}


def init_consts(generator: torch.Generator, cfg: ModelConfig,
                device: torch.device, np_seed: int = 2022) -> Params:
    """The field's hash constants: ``{}`` in paged mode (its constants
    follow from the config); in xor mode ``primes`` [L, 3] int64, drawn
    by ``init_primes`` from ``np.random.default_rng(np_seed)`` as the JAX
    package draws them (bitwise; ``renderer.init``'s ``np_seed``, 2022 by
    default, which the JAX ``Trainer`` sets to ``cfg.train.seed``),
    ``biases`` [L, 3] ~ U[100, 1100) from ``generator`` (the JAX
    package's distribution, not its bits) and ``scales`` [L] f32."""
    if cfg.hash_mode == "paged":
        return {}
    if cfg.hash_mode != "xor":
        raise ValueError(f"unknown hash_mode {cfg.hash_mode!r}")
    primes = init_primes(np.random.default_rng(np_seed), cfg.n_levels)
    u = torch.rand((cfg.n_levels, 3), generator=generator, device=device)
    scales = level_scales(cfg.n_levels, cfg.res_base_pow2, cfg.res_fine_pow2)
    return {"primes": torch.tensor(primes.astype(np.int64), device=device),
            "biases": u * 1000.0 + 100.0,
            "scales": torch.tensor(scales, device=device)}


def haloed_table(params: Params, cfg: ModelConfig) -> torch.Tensor:
    """The haloed table in the compute dtype (see the module docstring)."""
    return hash_paged.halo_pages(params["feat_pool"], paged_meta(cfg)).to(
        compute_dtype(cfg))


def _apply_level_weights(feat: torch.Tensor, level_weights,
                         cfg: ModelConfig) -> torch.Tensor:
    """Scale each hash level's channel block ([..., L*C] level-major)
    by level_weights [L]."""
    if level_weights is None:
        return feat
    shape = feat.shape
    f = feat.reshape(*shape[:-1], cfg.n_levels, cfg.n_channels)
    f = f * level_weights.to(feat.dtype)[..., :, None]
    return f.reshape(shape)


def check_consts(cfg: ModelConfig, consts: Params | None) -> None:
    """Raise unless ``consts`` (the field's constants) hold what the
    config needs: the warp tables for ``warp_mode='perspective'``, the
    hash constants for ``hash_mode='xor'``, nothing otherwise."""
    if cfg.hash_mode not in ("paged", "xor"):
        raise ValueError(f"unknown hash_mode {cfg.hash_mode!r}")
    if cfg.warp_mode not in ("contract", "perspective"):
        raise ValueError(f"unknown warp_mode {cfg.warp_mode!r}")
    have = consts or {}
    if cfg.warp_mode == "perspective":
        missing = [k for k in WARP_KEYS if k not in have]
        if missing:
            raise ValueError(
                f"warp_mode='perspective' needs the warp tables in the "
                f"field's consts, missing {missing} (built by "
                f"models.warp.warp_consts from the training poses)")
    if cfg.hash_mode == "xor":
        missing = [k for k in XOR_KEYS if k not in have]
        if missing:
            raise ValueError(
                f"hash_mode='xor' needs the hash constants in the field's "
                f"consts, missing {missing} (made by hash_field.init_consts)")


def encode_coords(points: torch.Tensor, cfg: ModelConfig,
                  consts: Params | None = None,
                  pre_contracted: bool = False) -> torch.Tensor:
    """[N, 3] points -> the encode's [N, 3] coordinates in [-2, 2]^3:
    the radial contraction, or the perspective warp of the world points
    (``pre_contracted`` points are uncontracted first, JAX
    ``hash_field.py:283-293``)."""
    check_consts(cfg, consts)
    if cfg.warp_mode == "contract":
        return points if pre_contracted else contract(
            points, cfg.contraction_radius)
    world = (uncontract(points, cfg.contraction_radius) if pre_contracted
             else points)
    # n_cams from the config, as the JAX package unpacks the rows
    return warp_points(world, WarpTables(
        anchors=consts["warp_anchors"], rows=consts["warp_rows"],
        n_cams=cfg.warp_n_cams), blend_k=cfg.warp_blend_k)


def _cached_haloed(params: Params) -> torch.Tensor | None:
    """``params["haloed"]``, refused when ``feat_pool`` would need a
    gradient (see the module docstring)."""
    haloed = params.get("haloed")
    if (haloed is not None and params["feat_pool"].requires_grad
            and torch.is_grad_enabled()):
        raise ValueError(
            "params carry a cached 'haloed' table while feat_pool requires "
            "grad: the gradient would never reach feat_pool; drop "
            "'haloed' from params to train")
    return haloed


def _head(params: Params, feat: torch.Tensor, level_weights,
          cfg: ModelConfig) -> torch.Tensor:
    feat = _apply_level_weights(feat, level_weights, cfg)
    return feat @ params["mlp"]["w"] + params["mlp"]["b"]


def query(params: Params, points: torch.Tensor, cfg: ModelConfig,
          pre_contracted: bool = False,
          level_weights=None, consts: Params | None = None) -> torch.Tensor:
    """[N, 3] world-space points -> [N, hash_feat_dim] f32 features
    (channel 0 is raw density). Reference src/hash_3d_anchored.cpp:70-88.
    ``consts``: the field's constants (see the module docstring)."""
    x = encode_coords(points, cfg, consts, pre_contracted)
    if cfg.hash_mode == "xor":
        pool = params["feat_pool"]
        if cfg.bf16_features:
            pool = pool.to(torch.bfloat16)
        feat = hash_encode(x, pool, consts["primes"], consts["biases"],
                           consts["scales"])
        return _head(params, feat, level_weights, cfg)
    feat = hash_paged.paged_encode(
        x, params["feat_pool"], paged_meta(cfg),
        compute_dtype=compute_dtype(cfg), chunk=cfg.encode_chunk,
        haloed=_cached_haloed(params))
    return _head(params, feat, level_weights, cfg)


@functools.lru_cache(maxsize=32)
def ray_budgets(cfg: ModelConfig) -> tuple[int, ...] | None:
    """Per-level run budgets of the ray-coherent encode dedup, or None
    where it does not apply (``encode_dedup`` off, xor mode, the
    perspective warp, whose Lipschitz bound certifies no budget): JAX
    ``hash_field.ray_budgets``. The march a ray spans: the occupancy
    sampler's is ``n_samples * sample_l`` exactly, the dense sampler's
    TRAIN jitter keeps it under 1.5 times that."""
    if (not cfg.encode_dedup or cfg.hash_mode != "paged"
            or cfg.warp_mode == "perspective"):
        return None
    if cfg.sampler_mode == "occ":
        s = cfg.occ_keep * cfg.occ_samples_per_segment
        march = cfg.n_samples * cfg.sample_l
        occ = (cfg.occ_keep, cfg.occ_samples_per_segment,
               cfg.occ_segments)
    else:
        s = cfg.n_samples
        march = 1.5 * s * cfg.sample_l
        occ = None
    budgets = hash_paged.dedup_budgets(paged_meta(cfg), s, march,
                                       cfg.dedup_max_frac, occ=occ)
    return budgets if any(budgets) else None


@functools.lru_cache(maxsize=32)
def compacted_budgets(cfg: ModelConfig, s2: int) -> tuple[int, ...] | None:
    """Heuristic run budgets for pseudo-rows of ``s2`` consecutive
    samples of the dense two-pass's compacted survivor stream (JAX
    ``hash_field.compacted_budgets``): twice the certified per-ray budget
    plus 16, rounded up to 8, kept while at most ``dedup_max_frac * s2``.
    Not certified: a pseudo-row spans several rays' prefixes, so JAX's
    ``query_compacted`` checks the run counts at run time."""
    base = ray_budgets(cfg)
    if base is None or cfg.sampler_mode != "dense":
        return None
    out = []
    for b in base:
        if not b:
            out.append(0)
            continue
        b2 = ((2 * b + 16 + 7) // 8) * 8
        out.append(b2 if b2 <= cfg.dedup_max_frac * s2 else 0)
    return tuple(out) if any(out) else None


def query_rays(params: Params, points: torch.Tensor, cfg: ModelConfig,
               level_weights=None, consts: Params | None = None
               ) -> torch.Tensor:
    """Ray-structured query: [R, S, 3] -> [R, S, hash_feat_dim].

    Where :func:`ray_budgets` gives budgets (``encode_dedup``, paged,
    contraction) the encode is ``hash_paged.paged_encode_rays``, as in
    the JAX package: each deduped level reads its run's page, which is
    the sample's own wherever no run id clamps (the budgets are certified
    bounds), so the features and both gradients are the flat encode's
    bitwise. Otherwise the flat :func:`query`.
    """
    r, s = points.shape[0], points.shape[1]
    budgets = ray_budgets(cfg)
    if budgets is None:
        return query(params, points.reshape(r * s, 3), cfg,
                     level_weights=level_weights,
                     consts=consts).reshape(r, s, -1)
    check_consts(cfg, consts)
    x = contract(points.reshape(r * s, 3),
                 cfg.contraction_radius).reshape(r, s, 3)
    feat = hash_paged.paged_encode_rays(
        x, params["feat_pool"], paged_meta(cfg), budgets,
        compute_dtype=compute_dtype(cfg), chunk=cfg.encode_chunk,
        haloed=_cached_haloed(params))
    return _head(params, feat, level_weights, cfg)


def query_compacted(params: Params, points: torch.Tensor, cfg: ModelConfig,
                    level_weights=None, consts: Params | None = None
                    ) -> torch.Tensor:
    """Flat [N, 3] query of the dense two-pass's compacted survivor
    stream (``models/renderer.py``, pass 2): the flat :func:`query`.

    With ``dense_two_pass_dedup`` JAX checks at run time whether each
    deduped level's run counts over pseudo-rows of ``n_samples`` fit
    :func:`compacted_budgets`, and takes the run-dedup encode if they do,
    else the flat one; without it, the flat one. Where the counts fit, no
    run id clamps, so the dedup's page indices are the flat ones; where
    they do not, JAX encodes flat. Every branch gives the flat encode's
    inputs, so the port encodes flat.
    """
    return query(params, points, cfg, level_weights=level_weights,
                 consts=consts)
