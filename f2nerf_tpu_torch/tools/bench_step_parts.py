"""Decompose the flagship train step's render (port of
``scripts/bench_step_parts.py``): the occupancy sampler, the field query,
shading + compositing, the whole render forward, forward + backward, and
the occupancy refresh amortized over its cadence, at the JAX script's
point: ``Config()``, 8192 rays, seeded params and rays.

    python -m f2nerf_tpu_torch.tools.bench_step_parts [--device cpu]

Each part prints the JAX script's label with its wall ms (host clock up
to a synchronize), device ms (the card's busy time in a profile of
the same calls) and busy share, per call (``common.time_part``).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from f2nerf_tpu_torch.convert import flatten
from f2nerf_tpu_torch.core.config import Config
from f2nerf_tpu_torch.core.device import resolve_device
from f2nerf_tpu_torch.models import hash_field, occupancy, renderer, sh_shader
from f2nerf_tpu_torch.ops.composite import composite, density_activation
from f2nerf_tpu_torch.tools.common import add_device_flag, part_line, time_part
from f2nerf_tpu_torch.train.step import draw_noise


def seeded_rays(rng: np.random.Generator, rays: int, dev: torch.device):
    """The JAX scripts' rays: origins N(0, 0.3^2), unit directions, drawn
    from ``rng`` in that order."""
    o = rng.standard_normal((rays, 3)) * 0.3
    d = rng.standard_normal((rays, 3))
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return (torch.as_tensor(o, dtype=torch.float32, device=dev),
            torch.as_tensor(d, dtype=torch.float32, device=dev))


def measure(cfg: Config, rays: int = 8192, device=None, iters: int = 10
            ) -> dict:
    """{label: {"wall_ms", "device_ms", "busy_share"}} of each part, at ``cfg`` and
    ``rays`` (``main``: the JAX script's ``Config()`` and 8192)."""
    dev = resolve_device(device)
    mcfg = cfg.model
    gen = torch.Generator(device=dev).manual_seed(0)
    params = renderer.init(gen, mcfg, 8, dev)
    consts = {"field": hash_field.init_consts(gen, mcfg, dev)}
    o, d = seeded_rays(np.random.default_rng(0), rays, dev)
    occ_grid = occupancy.init_grid(mcfg, dev)
    occ_bits = occupancy.occ_values(occ_grid, mcfg, warmup=True)
    noise = draw_noise(cfg, 1, rays, dev)
    out = {}

    def sample():
        return occupancy.sample_rays_occ(
            o, d, occ_bits, mcfg, rank_u=noise.rank, within_u=noise.within,
            explore=noise.explore)

    def query(pts):
        return hash_field.query_rays(params["field"], pts, mcfg,
                                     consts=consts["field"])

    def shade_comp(feat, smp):
        sigma = density_activation(feat[..., 0], mcfg.density_shift)
        sf = torch.cat([torch.ones_like(feat[..., :1]), feat[..., 1:]],
                       dim=-1)
        r, s = feat.shape[0], feat.shape[1]
        dirs = smp.dirs[:, None, :].expand(r, s, 3)
        colors = sh_shader.query(params["shader"], sf, dirs, mcfg)
        sec = torch.where(smp.dt > 0.0, sigma * smp.dt,
                          torch.zeros((), device=dev))
        bg = torch.full((r, 3), 0.5, device=dev)
        return composite(sec, colors, smp.t, bg, mcfg.trans_eps)[0]

    def render():
        return renderer.render(params, o, d, mcfg, occ_vals=occ_bits,
                               consts=consts).colors

    with torch.no_grad():
        out["occ sampler:"] = time_part(sample, dev, iters)
        smp = sample()
        out["field query fwd:"] = time_part(lambda: query(smp.pts), dev,
                                            iters)
        feat = query(smp.pts)
        out["shade+composite fwd:"] = time_part(
            lambda: shade_comp(feat, smp), dev, iters)
        out["render fwd total:"] = time_part(render, dev, iters)

    leaves = list(flatten(params).values())
    for p in leaves:
        p.requires_grad_(True)

    def render_grad():
        colors = render()
        loss = torch.mean(torch.sqrt((colors - 0.5) ** 2 + 1e-4))
        return torch.autograd.grad(loss, leaves, allow_unused=True)

    out["render fwd+bwd:"] = time_part(render_grad, dev, iters)
    for p in leaves:
        p.requires_grad_(False)

    u = torch.rand((occupancy.refresh_points(mcfg), 3),
                   generator=torch.Generator(device=dev).manual_seed(1),
                   device=dev)
    with torch.no_grad():
        out["occ grid refresh:"] = time_part(
            lambda: occupancy.update_grid(
                occ_grid, lambda pts: renderer.density_at(
                    params, pts, mcfg, contracted=True, consts=consts),
                mcfg, u=u), dev, iters=5)
    return out


def report(out: dict, cfg: Config) -> list[str]:
    """The lines the JAX script prints, the device ms beside each."""
    lines = []
    for label, t in out.items():
        if label == "occ grid refresh:":
            every = cfg.model.occ_update_every
            lines.append(part_line(label, t, f" (/{every} = "
                                   f"{t['wall_ms'] / every:.2f} ms/step "
                                   f"amortized)"))
        else:
            lines.append(part_line(label, t))
    return lines


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    add_device_flag(ap)
    args = ap.parse_args(argv)
    cfg = Config()
    out = measure(cfg, device=args.device)
    for line in report(out, cfg):
        print(line)
    return out


if __name__ == "__main__":
    main()
