"""Dense-point step time on a TRAINED field (port of
``scripts/bench_dense_trained.py``): the regime where the early stop pays
off, once rays terminate. Restores a dense run's newest checkpoint
(``checkpoints/step_*/state.pt``; the geometry from
``inference_params.yaml``, read with ``core/yaml_io.py``), measures the
survivor prefix of real rays on the trained field and the survivor
stream's pseudo-row run counts against their budgets, and times the train
step with ``dense_two_pass`` (and its survivor dedup) on and off.

    python -m f2nerf_tpu_torch.tools.bench_dense_trained [run_dir] [arm] [rays] [trans_eps] [--device cpu]

``arm``: ``all`` (the three step variants and the statistics), ``stats``
(the statistics only), ``surv``, ``tp`` or ``off`` (one variant). As in
the JAX script, the rays come from ``make_checker_dataset`` with two
views more than the run's (a ring of the same radius; only the cameras
are used) and ``trans_eps`` overrides the config's to probe a later
survivor regime. Each variant prints the JAX script's line with its wall
ms (host clock up to a synchronize), device ms (the card's busy time
in a profile of the same calls) and busy share (``common.time_part``).
"""

from __future__ import annotations

import argparse
import itertools
import dataclasses
import pathlib

import numpy as np
import torch

from f2nerf_tpu_torch.convert import unflatten
from f2nerf_tpu_torch.core import yaml_io
from f2nerf_tpu_torch.core.cameras import rays_from_pose
from f2nerf_tpu_torch.core.config import Config
from f2nerf_tpu_torch.core.device import resolve_device
from f2nerf_tpu_torch.data.synthetic import make_checker_dataset
from f2nerf_tpu_torch.models import hash_field
from f2nerf_tpu_torch.models import sampler as sampler_mod
from f2nerf_tpu_torch.ops import hash_paged
from f2nerf_tpu_torch.ops.composite import density_activation, exclusive_cumsum
from f2nerf_tpu_torch.ops.contraction import contract
from f2nerf_tpu_torch.tools.common import (add_device_flag, device_text,
                                           time_part)
from f2nerf_tpu_torch.train import checkpoint as ckpt_lib
from f2nerf_tpu_torch.train.optim import make_optimizer
from f2nerf_tpu_torch.train.step import make_train_step

ARMS = {"surv": ((True, True),), "tp": ((True, False),),
        "off": ((False, False),), "stats": (),
        "all": ((True, True), (True, False), (False, False))}


def march_draws(rays: int, samples: int, dev: torch.device) -> torch.Tensor:
    """The dense sampler's TRAIN jitter U[0, 1) [rays, samples] for the
    statistics (JAX draws it from ``key(1)``)."""
    gen = torch.Generator(device=dev).manual_seed(1)
    return torch.rand((rays, samples), generator=gen, device=dev)


def _restore(state: dict, cfg: Config, dev: torch.device):
    """Fresh params, optimizer and constants holding the checkpoint."""
    params = unflatten({k: v.to(dev).clone()
                        for k, v in state["params"].items()})
    optimizer = make_optimizer(params, cfg.train)
    optimizer.load_state_dict(state["adam"])
    optimizer.set_count(int(state["count"]))
    consts = unflatten({k: v.to(dev) for k, v in state["consts"].items()})
    return params, optimizer, consts or None


def measure(run_dir, arm: str = "all", rays: int = 512,
            trans_eps: float | None = None, device=None, iters: int = 20
            ) -> dict:
    """The statistics and the timed variants; the printed lines under
    ``"lines"``."""
    dev = resolve_device(device)
    run_dir = pathlib.Path(run_dir)
    lines = []
    cfg = Config.load(run_dir / "train_config.yaml")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, pts_batch_size=rays * 512))
    if cfg.model.sampler_mode != "dense":
        raise ValueError(f"{run_dir} is not a dense run (sampler_mode "
                         f"{cfg.model.sampler_mode!r})")
    if trans_eps is not None:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, trans_eps=trans_eps))
        lines.append(f"trans_eps override: {trans_eps}")
    ip = yaml_io.load(run_dir / "inference_params.yaml")
    n_images, h, w = ip["n_images"], ip["height"], ip["width"]
    state = ckpt_lib.restore(run_dir / "checkpoints")
    params, _, consts = _restore(state, cfg, dev)
    lines.append(f"restored step {state['step']} from {run_dir}")
    out = {"restored_step": int(state["step"]), "arms": {}}

    ds = make_checker_dataset(n_images=n_images + 2, h=h, w=w)
    all_poses = torch.as_tensor(ds.poses, device=dev)
    all_intr = torch.as_tensor(ds.intrinsics, device=dev)
    rng = np.random.default_rng(0)

    def real_rays(cam, ij):
        cam = torch.as_tensor(cam, device=dev).long()
        return rays_from_pose(all_poses[cam], all_intr[cam],
                              torch.as_tensor(ij, device=dev).float())

    # survivor-prefix distribution on the trained field, real rays
    cam0 = rng.integers(0, n_images, rays).astype(np.int32)
    ij0 = np.stack([rng.integers(0, h, rays),
                    rng.integers(0, w, rays)], -1).astype(np.int32)
    o, d = real_rays(cam0, ij0)
    mcfg = cfg.model
    s2 = mcfg.n_samples
    with torch.no_grad():
        smp = sampler_mod.sample_rays(o, d, mcfg,
                                      u=march_draws(rays, s2, dev))
        feat = hash_field.query_rays(params["field"], smp.pts, mcfg,
                                     consts=(consts or {}).get("field"))
        sigma = density_activation(feat[..., 0], mcfg.density_shift)
        sec = torch.where(smp.dt > 0, sigma * smp.dt,
                          torch.zeros((), device=dev))
        trans = torch.exp(-exclusive_cumsum(sec, dim=-1))
        mask = trans > mcfg.trans_eps
    k = mask.sum(dim=-1).cpu().numpy()
    out["prefix"] = {"mean": float(k.mean()), "p50": float(np.percentile(
        k, 50)), "p90": float(np.percentile(k, 90)), "max": int(k.max()),
        "samples": s2}
    lines.append(f"survivor prefix k: mean {k.mean():.0f} p50 "
                 f"{np.percentile(k, 50):.0f} p90 {np.percentile(k, 90):.0f} "
                 f"max {k.max()} of S={s2}")

    # pseudo-row run statistics for the survivor-stream dedup: do the
    # measured max run counts on this trained field fit the budgets?
    flat_mask = mask.cpu().numpy().ravel()
    n_surv = int(flat_mask.sum())
    out["survivors"] = n_surv
    out["share"] = n_surv / flat_mask.size
    b2 = hash_field.compacted_budgets(mcfg, s2)
    if b2 is not None and arm in ("all", "stats", "surv"):
        order = np.concatenate([np.nonzero(flat_mask)[0],
                                np.nonzero(~flat_mask)[0]])
        # quarter bucket: the bucket the ~25% survivor regime selects
        nb = smp.pts.shape[0] * s2 // 4
        idx = order[:nb - nb % s2]
        pts_c = smp.pts.reshape(-1, 3)[torch.as_tensor(idx, device=dev)]
        xc = contract(pts_c, mcfg.contraction_radius)
        page_idx = hash_paged.page_indices(
            xc, hash_field.paged_meta(mcfg))[0].cpu().numpy()
        r2 = idx.size // s2
        lines.append(f"survivors {n_surv}/{flat_mask.size} "
                     f"({100 * n_surv / flat_mask.size:.0f}%); pseudo-row "
                     f"(s2={s2}) max runs vs budget per level:")
        out["runs"] = {}
        for lvl, b in enumerate(b2):
            pl = page_idx[lvl].reshape(r2, s2)
            runs = 1 + (pl[:, 1:] != pl[:, :-1]).sum(1)
            out["runs"][lvl] = (int(runs.max()), int(np.percentile(runs, 90)),
                                b)
            lines.append(f"  L{lvl}: max {runs.max()} p90 "
                         f"{int(np.percentile(runs, 90))} budget {b}"
                         f"{' FAIL' if b and runs.max() > b else ''}")

    poses, intr = all_poses[:n_images], all_intr[:n_images]
    for tp, dd in ARMS[arm]:
        cfg_v = dataclasses.replace(cfg, model=dataclasses.replace(
            mcfg, dense_two_pass=tp, dense_two_pass_dedup=dd))
        params, optimizer, consts = _restore(state, cfg_v, dev)
        step_fn = make_train_step(cfg_v, optimizer)
        cam = rng.integers(0, n_images, rays).astype(np.int32)
        ij = np.stack([rng.integers(0, h, rays),
                       rng.integers(0, w, rays)], -1).astype(np.int32)
        gt = rng.random((rays, 3)).astype(np.float32)
        batch = [torch.as_tensor(x, device=dev) for x in (cam, ij, gt)]
        # the warm-up call at step 19000, then 19000, 19001, ...
        steps = itertools.chain([19000], itertools.count(19000))
        t = time_part(lambda: step_fn(params, None, poses, intr, next(steps),
                                      *batch, consts=consts), dev, iters)
        t["rays_per_s"] = rays / t["wall_ms"] * 1e3
        out["arms"][f"two_pass={tp} surv_dedup={dd}"] = t
        lines.append(f"two_pass={tp} surv_dedup={dd}: {t['wall_ms']:7.2f} "
                     f"ms/step ({t['rays_per_s']:7.0f} rays/s) "
                     f"({device_text(t, '7.2f')})")
    out["lines"] = lines
    return out


def main(argv: list[str] | None = None) -> dict:
    # one arm per invocation keeps each run to one step variant, as the
    # JAX script's positional arguments do
    ap = argparse.ArgumentParser()
    ap.add_argument("run_dir", nargs="?", default="_runs/r2_dense20k")
    ap.add_argument("arm", nargs="?", default="all", choices=sorted(ARMS))
    ap.add_argument("rays", nargs="?", type=int, default=512)
    ap.add_argument("trans_eps", nargs="?", type=float, default=None)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    out = measure(args.run_dir, args.arm, args.rays, args.trans_eps,
                  device=args.device)
    for line in out["lines"]:
        print(line)
    return out


if __name__ == "__main__":
    main()
