"""Time the flagship train step and its encode pieces in isolation (port
of ``scripts/bench_encode_parts.py``): the full step, the encode forward,
forward + backward for the pages, and for the pages and the points, at
the JAX script's point: 8192 rays x 64 samples (ray-structured, monotone
t per ray like the occupancy sampler), ``Config()``'s L8/C4 2^19 table,
run dedup at its budgets.

    python -m f2nerf_tpu_torch.tools.bench_encode_parts [--device cpu]

The forward launches ``trilinear_fwd``, the backward for the pages
``trilinear_bwd`` and the one for the points ``trilinear_bwd_frac`` too.
Each part prints the JAX script's label with its wall ms (host clock up
to a synchronize), device ms (the card's busy time in a profile of
the same calls) and busy share, per call (``common.time_part``).
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from f2nerf_tpu_torch.core.config import Config
from f2nerf_tpu_torch.core.device import resolve_device
from f2nerf_tpu_torch.models import hash_field, occupancy, renderer
from f2nerf_tpu_torch.ops import hash_paged
from f2nerf_tpu_torch.tools.common import add_device_flag, part_line, time_part
from f2nerf_tpu_torch.train.optim import make_optimizer
from f2nerf_tpu_torch.train.step import make_train_step


def measure(cfg: Config, rays: int = 8192, device=None, iters: int = 10
            ) -> dict:
    """{"budgets": the dedup budgets, label: {"wall_ms", "device_ms", "busy_share"}}
    of each part, at ``cfg`` and ``rays`` (``main``: ``Config()`` and
    8192, the JAX script's)."""
    dev = resolve_device(device)
    mcfg = cfg.model
    s = mcfg.occ_keep * mcfg.occ_samples_per_segment
    gen = torch.Generator(device=dev).manual_seed(0)
    fparams = hash_field.init(gen, mcfg, dev)
    rng = np.random.default_rng(0)
    o = rng.standard_normal((rays, 1, 3)) * 0.3
    d = rng.standard_normal((rays, 1, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = np.sort(rng.uniform(0, 4.0, (rays, s, 1)), axis=1)
    pts = torch.as_tensor((o + t * d).clip(-1.9, 1.9), dtype=torch.float32,
                          device=dev)
    meta = hash_field.paged_meta(mcfg)
    pages = fparams["feat_pool"]
    budgets = hash_field.ray_budgets(mcfg)
    out = {"budgets": budgets}

    def enc(pg, p):
        return hash_paged.paged_encode_rays(p, pg, meta, budgets,
                                            chunk=mcfg.encode_chunk)

    with torch.no_grad():
        out["encode fwd:"] = time_part(lambda: enc(pages, pts), dev, iters)
    pages_g = pages.detach().clone().requires_grad_(True)
    pts_g = pts.detach().clone().requires_grad_(True)
    out["encode fwd+bwd(params):"] = time_part(
        lambda: torch.autograd.grad(torch.sum(enc(pages_g, pts)), pages_g),
        dev, iters)
    out["encode fwd+bwd(params+pts):"] = time_part(
        lambda: torch.autograd.grad(torch.sum(enc(pages_g, pts_g)),
                                    (pages_g, pts_g)), dev, iters)

    # full train step for context
    fcfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, pts_batch_size=rays * 512))
    n_images = 8
    rparams = renderer.init(gen, fcfg.model, n_images, dev)
    optimizer = make_optimizer(rparams, fcfg.train)
    occ_grid = occupancy.init_grid(fcfg.model, dev)
    poses = torch.eye(3, 4, device=dev).repeat(n_images, 1, 1)
    intr = torch.tensor([[200.0, 0, 128.0], [0, 200.0, 128.0],
                         [0, 0, 1.0]], device=dev).repeat(n_images, 1, 1)
    step_fn = make_train_step(fcfg, optimizer)
    cam = torch.as_tensor(rng.integers(0, n_images, rays), dtype=torch.int32,
                          device=dev)
    ij = torch.as_tensor(rng.integers(0, 256, (rays, 2)), dtype=torch.int32,
                         device=dev)
    gt = torch.as_tensor(rng.random((rays, 3)), dtype=torch.float32,
                         device=dev)
    out["full train step:"] = time_part(
        lambda: step_fn(rparams, occ_grid, poses, intr, 1, cam, ij, gt),
        dev, iters)
    return out


def report(out: dict) -> list[str]:
    """The lines the JAX script prints, the device ms beside each."""
    return [f"budgets: {out['budgets']}"] + [
        part_line(label, t) for label, t in out.items() if label != "budgets"]


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
