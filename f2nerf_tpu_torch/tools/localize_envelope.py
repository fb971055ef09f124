"""Localization robustness envelope: initial position error x the
differential learning rate, on a trained quality run's held-out views
(port of ``scripts/localize_envelope.py``).

    python -m f2nerf_tpu_torch.tools.localize_envelope RESULT_DIR \\
        [--scene textured] [--n_images 48] [--hw 128] [--holdout_every 8] \\
        [--pos_noises 0.02,0.05,0.1,0.2] [--lrs 2e-4,3e-3,3e-2] \\
        [--views 3] [--device cpu] ...

For each cell, ``--views`` held-out views are perturbed (each cell's
generator seeded from ``default_rng(7)``, as in the JAX script) and
recovered by ``Localizer.localize``; one row per cell: the mean position
error before, after the search and after the refinement, and the mean
number of backtracks. Exits 1 when ``--budget_s`` ran out first.
"""

from __future__ import annotations

import argparse
import pathlib
import time

import numpy as np

from f2nerf_tpu_torch.tools.common import (add_device_flag,
                                           checkpoint_localizer,
                                           holdout_split, make_scene,
                                           perturb_pose, subset)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("result_dir", type=pathlib.Path)
    ap.add_argument("--scene", default="textured")
    ap.add_argument("--n_images", type=int, default=48)
    ap.add_argument("--hw", type=int, default=128)
    ap.add_argument("--holdout_every", type=int, default=8)
    ap.add_argument("--pos_noises", default="0.02,0.05,0.1,0.2")
    ap.add_argument("--lrs", default="2e-4,3e-3,3e-2")
    ap.add_argument("--views", type=int, default=3,
                    help="holdout views per cell (envelope cost control)")
    ap.add_argument("--particles", type=int, default=128)
    ap.add_argument("--search_rounds", type=int, default=3)
    ap.add_argument("--diff_iters", type=int, default=30)
    ap.add_argument("--budget_s", type=float, default=520.0)
    add_device_flag(ap)
    args = ap.parse_args(argv)

    ds = make_scene(args.scene, args.n_images, args.hw)
    held, keep = holdout_split(ds.n_images, args.holdout_every)
    loc, step = checkpoint_localizer(args.result_dir, subset(ds, keep),
                                     ds.intrinsics[0], args.hw, args.device)
    print(f"restored step {step}")

    pos_noises = [float(x) for x in args.pos_noises.split(",")]
    lrs = [float(x) for x in args.lrs.split(",")]
    views = held[:args.views]
    rng_master = np.random.default_rng(7)
    t0 = time.monotonic()
    print(f"{'pos_noise':>9} {'lr':>8} {'err0':>7} {'search':>7} "
          f"{'final':>7} {'bt':>3}")
    for pn in pos_noises:
        for lr in lrs:
            if time.monotonic() - t0 > args.budget_s:
                print("budget reached; re-run for remaining cells")
                return 1
            e0s, e1s, e2s, bts = [], [], [], []
            rng = np.random.default_rng(rng_master.integers(1 << 31))
            for i in views:
                gt_pose = np.asarray(ds.poses[i], dtype=np.float32)
                noisy = perturb_pose(rng, gt_pose, pn, 2.0)
                res = loc.localize(
                    noisy, ds.images[i], particle_num=args.particles,
                    search_rounds=args.search_rounds,
                    noise_coeff=max(2.0, pn * 40.0),
                    diff_iters=args.diff_iters, diff_lr=lr)
                e0s.append(np.linalg.norm(noisy[:3, 3] - gt_pose[:3, 3]))
                e1s.append(np.linalg.norm(
                    res["search_pose"][:3, 3] - gt_pose[:3, 3]))
                e2s.append(np.linalg.norm(
                    res["pose"][:3, 3] - gt_pose[:3, 3]))
                bts.append(res["backtracks"])
            print(f"{pn:>9.3f} {lr:>8.0e} {np.mean(e0s):>7.4f} "
                  f"{np.mean(e1s):>7.4f} {np.mean(e2s):>7.4f} "
                  f"{np.mean(bts):>3.1f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
