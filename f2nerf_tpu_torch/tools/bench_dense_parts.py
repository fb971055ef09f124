"""Decompose the dense train step (port of ``scripts/bench_dense_parts.py``)
at the JAX script's point: ``Config()`` with the dense sampler, 512 rays x
1024 samples (the reference operating point). Parts: the dense sampler,
the encode forward with and without run dedup, forward + backward with
and without it, the render forward (TRAIN, masked compositing), forward
+ backward, and the full train step (losses + Adam).

    python -m f2nerf_tpu_torch.tools.bench_dense_parts [--device cpu]

Each part prints the JAX script's label with its wall ms (host clock up
to a synchronize), device ms (the card's busy time in a profile of
the same calls) and busy share, per call (``common.time_part``).
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from f2nerf_tpu_torch.convert import flatten
from f2nerf_tpu_torch.core.config import Config
from f2nerf_tpu_torch.core.device import resolve_device
from f2nerf_tpu_torch.models import hash_field, occupancy, renderer
from f2nerf_tpu_torch.models import sampler as sampler_mod
from f2nerf_tpu_torch.tools.bench_step_parts import seeded_rays
from f2nerf_tpu_torch.tools.common import add_device_flag, part_line, time_part
from f2nerf_tpu_torch.train.optim import make_optimizer
from f2nerf_tpu_torch.train.step import draw_noise, make_train_step

WIDTH = 21          # the JAX script pads its labels to 22 columns


def dense_config(cfg: Config, rays: int) -> Config:
    """``cfg`` with the dense sampler and a point budget of ``rays``."""
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, sampler_mode="dense"),
        train=dataclasses.replace(cfg.train, pts_batch_size=rays * 512))


def measure(cfg: Config, rays: int = 512, device=None, iters: int = 10
            ) -> dict:
    """{"samples", "budgets", label: {"wall_ms", "device_ms", "busy_share"}} of each
    part, at ``cfg`` made dense and ``rays`` (``main``: ``Config()`` and
    512, the JAX script's)."""
    dev = resolve_device(device)
    cfg_full = dense_config(cfg, rays)
    mcfg = cfg_full.model
    out = {"samples": mcfg.n_samples,
           "budgets": hash_field.ray_budgets(mcfg)}
    gen = torch.Generator(device=dev).manual_seed(0)
    n_images = 8
    params = renderer.init(gen, mcfg, n_images, dev)
    consts = {"field": hash_field.init_consts(gen, mcfg, dev)}
    rng = np.random.default_rng(0)
    o, d = seeded_rays(rng, rays, dev)
    march = draw_noise(cfg_full, 1, rays, dev).march
    cfg_nd = dataclasses.replace(mcfg, encode_dedup=False)

    def query(pts, m):
        return hash_field.query_rays(params["field"], pts, m,
                                     consts=consts["field"])

    with torch.no_grad():
        out["dense sampler:"] = time_part(
            lambda: sampler_mod.sample_rays(o, d, mcfg, u=march), dev, iters)
        pts = sampler_mod.sample_rays(o, d, mcfg, u=march).pts
        out["encode fwd (dedup):"] = time_part(lambda: query(pts, mcfg), dev,
                                               iters)
        out["encode fwd (nodedup):"] = time_part(lambda: query(pts, cfg_nd),
                                                 dev, iters)

    field = list(flatten(params["field"]).values())
    leaves = list(flatten(params).values())
    for p in leaves:
        p.requires_grad_(True)

    def enc_grad(m):
        loss = torch.sum(query(pts, m).float())
        return torch.autograd.grad(loss, field, allow_unused=True)

    out["encode fwd+bwd:"] = time_part(lambda: enc_grad(mcfg), dev, iters)
    out["encode f+b (nodedup):"] = time_part(lambda: enc_grad(cfg_nd), dev,
                                             iters)

    noise = draw_noise(cfg_full, 2, rays, dev)
    emb_idx = torch.zeros((rays,), dtype=torch.long, device=dev)

    def render_loss():
        res = renderer.render(params, o, d, mcfg, emb_idx=emb_idx,
                              noise=noise, consts=consts)
        return torch.mean(res.colors.float())

    with torch.no_grad():
        out["render fwd:"] = time_part(render_loss, dev, iters)
    out["render fwd+bwd:"] = time_part(
        lambda: torch.autograd.grad(render_loss(), leaves, allow_unused=True),
        dev, iters)

    # full train step (losses + adam)
    optimizer = make_optimizer(params, cfg_full.train)
    occ_grid = occupancy.init_grid(mcfg, dev)
    poses = torch.eye(3, 4, device=dev).repeat(n_images, 1, 1)
    intr = torch.tensor([[200.0, 0, 128.0], [0, 200.0, 128.0],
                         [0, 0, 1.0]], device=dev).repeat(n_images, 1, 1)
    step_fn = make_train_step(cfg_full, optimizer)
    cam = rng.integers(0, n_images, rays).astype(np.int32)
    ij = np.stack([rng.integers(0, 256, rays),
                   rng.integers(0, 256, rays)], -1).astype(np.int32)
    gt = rng.random((rays, 3)).astype(np.float32)
    batch = [torch.as_tensor(x, device=dev) for x in (cam, ij, gt)]
    out["full train step:"] = time_part(
        lambda: step_fn(params, occ_grid, poses, intr, 3000, *batch,
                        consts=consts), dev, iters)
    return out


def report(out: dict, rays: int = 512) -> list[str]:
    """The lines the JAX script prints, the device ms beside each."""
    lines = [f"dense point: {rays} rays x {out['samples']} samples, "
             f"budgets={out['budgets']}"]
    return lines + [part_line(label, t, width=WIDTH)
                    for label, t in out.items()
                    if label not in ("samples", "budgets")]


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    add_device_flag(ap)
    args = ap.parse_args(argv)
    out = measure(Config(), device=args.device)
    for line in report(out):
        print(line)
    return out


if __name__ == "__main__":
    main()
