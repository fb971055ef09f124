"""Tell a held-out failure of geometry from one of shading (port of
``scripts/diag_holdout.py``).

    python -m f2nerf_tpu_torch.tools.diag_holdout RESULT_DIR \\
        [--scene checker] [--n_images 32] [--hw 128] [--holdout_every 8] \\
        [--holdout_view 8] [--train_view 7] [--device cpu]

Restores the newest checkpoint of a ``quality_run --holdout`` run and
renders, with the run's own VALIDATE render:
  (a) a training view and a held-out view as they are;
  (b) both with every ray's direction in the SH shader frozen to the
      training view's axis (``-pose[:3, 2]``; geometry unchanged): if (b)
      scores far above (a) on the held-out view, the failure is
      view-dependent shading, not geometry;
  (c) their depth maps: geometry made of sheets shows as noisy depth at
      the held-out pose.
Prints each render's PSNR and depth percentiles and writes
``diag_{tag}_{view}.png`` and ``diag_{tag}_{view}_depth.png`` (depth
scaled to [0, 1]) into RESULT_DIR.
"""

from __future__ import annotations

import argparse
import pathlib

import numpy as np
import torch

from f2nerf_tpu_torch.core.cameras import pixel_grid, rays_from_pose
from f2nerf_tpu_torch.models import hash_field, occupancy, sampler, sh_shader
from f2nerf_tpu_torch.ops.composite import composite, density_activation
from f2nerf_tpu_torch.tools.common import (add_device_flag, holdout_split,
                                           make_scene, restore_run, subset)
from f2nerf_tpu_torch.utils.image_io import write_image
from f2nerf_tpu_torch.utils.metrics import psnr

CHUNK = 16384          # rays a render call, as in the JAX script


@torch.no_grad()
def render_rays(run, rays_o: torch.Tensor, rays_d: torch.Tensor,
                fixed_dir: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The VALIDATE render of [R, 3] rays, step by step: the sampler
    with no jitter, the field, the density, the shading features
    ``[1, feat[1:]]``, the SH shader on the rays' directions (or on
    ``fixed_dir`` [3] for every ray), a 0.5 background and the
    ``trans_eps`` cut. Returns (rgb [R, 3], depth [R])."""
    cfgm = run.cfg.model
    if cfgm.sampler_mode == "occ":
        smp = occupancy.sample_rays_occ(rays_o, rays_d, run.occ_vals, cfgm)
    else:
        smp = sampler.sample_rays(rays_o, rays_d, cfgm)
    feat = hash_field.query_rays(run.params["field"], smp.pts, cfgm,
                                 consts=run.consts.get("field"))
    sigma = density_activation(feat[..., 0], cfgm.density_shift)
    shading = torch.cat([torch.ones_like(feat[..., :1]), feat[..., 1:]],
                        dim=-1)
    r, s = smp.pts.shape[0], smp.pts.shape[1]
    d = smp.dirs if fixed_dir is None else fixed_dir.expand(r, 3)
    colors = sh_shader.query(run.params["shader"], shading,
                             d[:, None, :].expand(r, s, 3), cfgm)
    sec = torch.where(smp.dt > 0.0, sigma * smp.dt,
                      torch.zeros((), device=smp.dt.device))
    bg = torch.full((r, 3), 0.5, device=rays_o.device)
    rgb, depth, _, _ = composite(sec, colors, smp.t, bg, cfgm.trans_eps)
    return rgb, depth


def render_view(run, ds, i: int, out: pathlib.Path, fixed_dir=None,
                tag: str = "") -> float:
    """Render view ``i`` of ``ds`` in chunks of ``CHUNK`` rays, print its
    PSNR and depth percentiles, write its two PNGs; returns the PSNR."""
    dev = run.device
    ij = torch.as_tensor(pixel_grid(ds.height, ds.width), device=dev)
    rays_o, rays_d = rays_from_pose(
        torch.as_tensor(ds.poses[i], device=dev)[None],
        torch.as_tensor(ds.intrinsics[i], device=dev)[None], ij)
    fixed = (None if fixed_dir is None
             else torch.as_tensor(fixed_dir, dtype=torch.float32,
                                  device=dev))
    rgbs, deps = [], []
    for c0 in range(0, rays_o.shape[0], CHUNK):
        rgb, dep = render_rays(run, rays_o[c0:c0 + CHUNK],
                               rays_d[c0:c0 + CHUNK], fixed)
        rgbs.append(rgb.cpu().numpy())
        deps.append(dep.cpu().numpy())
    rgb = np.clip(np.concatenate(rgbs).reshape(ds.height, ds.width, 3), 0, 1)
    dep = np.concatenate(deps).reshape(ds.height, ds.width)
    p = psnr(rgb, ds.images[i])
    print(f"view {i} {tag}: psnr {p:.2f} depth[p10,p50,p90]="
          f"{np.percentile(dep, [10, 50, 90]).round(3).tolist()}")
    write_image(out / f"diag_{tag}_{i}.png", rgb)
    dn = (dep - dep.min()) / max(dep.max() - dep.min(), 1e-6)
    write_image(out / f"diag_{tag}_{i}_depth.png",
                np.repeat(dn[..., None], 3, -1))
    return p


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("result_dir", type=pathlib.Path)
    ap.add_argument("--scene", default="checker")
    ap.add_argument("--n_images", type=int, default=32)
    ap.add_argument("--hw", type=int, default=128)
    ap.add_argument("--holdout_every", type=int, default=8)
    ap.add_argument("--holdout_view", type=int, default=8)
    ap.add_argument("--train_view", type=int, default=7)
    add_device_flag(ap)
    args = ap.parse_args(argv)

    ds = make_scene(args.scene, args.n_images, args.hw)
    # the split the run trained with (app_emb is sized to the train views)
    _, keep = holdout_split(ds.n_images, args.holdout_every)
    run = restore_run(args.result_dir, subset(ds, keep), args.device)
    print("restored step", run.step)

    hv, tv = args.holdout_view, args.train_view
    # the frozen direction: the train view's central axis (-z of its pose)
    fdir = -np.asarray(ds.poses[tv][:3, 2])
    out = args.result_dir
    render_view(run, ds, tv, out, tag="train")
    render_view(run, ds, hv, out, tag="holdout")
    render_view(run, ds, hv, out, fixed_dir=fdir, tag="holdout_fixdir")
    render_view(run, ds, tv, out, fixed_dir=fdir, tag="train_fixdir")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
