"""Pose recovery on held-out views against a trained quality run (port
of ``scripts/localize_validation.py``).

    python -m f2nerf_tpu_torch.tools.localize_validation RESULT_DIR \\
        [--scene textured] [--n_images 32] [--hw 128] [--holdout_every 8] \\
        [--device cpu] ...

The run must have been trained on the same scene with every
``holdout_every``-th view held out (``quality_run --holdout``). Each
held-out view's true pose is perturbed (position N(0, ``pos_noise``) per
axis, rotation N(0, ``rot_noise_deg``) degrees per axis, from
``default_rng(7)``, as the JAX script draws them) and recovered by the
staged pipeline (``Localizer.localize``: particle search rounds, then
the differential refinement). Prints the position error before, after
the search and after the refinement, in scene units, and PASS (exit 0)
when the mean error fell.
"""

from __future__ import annotations

import argparse
import pathlib

import numpy as np

from f2nerf_tpu_torch.tools.common import (add_device_flag,
                                           checkpoint_localizer,
                                           holdout_split, make_scene,
                                           perturb_pose, subset)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("result_dir", type=pathlib.Path)
    ap.add_argument("--scene", default="textured")
    ap.add_argument("--n_images", type=int, default=32)
    ap.add_argument("--hw", type=int, default=128)
    ap.add_argument("--holdout_every", type=int, default=8)
    ap.add_argument("--pos_noise", type=float, default=0.03,
                    help="initial position offset (normalized units; "
                         "scene radius is 1)")
    ap.add_argument("--rot_noise_deg", type=float, default=2.0)
    ap.add_argument("--particles", type=int, default=128)
    ap.add_argument("--search_rounds", type=int, default=3)
    ap.add_argument("--diff_iters", type=int, default=30)
    ap.add_argument("--diff_lr", type=float, default=3e-3)
    add_device_flag(ap)
    args = ap.parse_args(argv)

    ds = make_scene(args.scene, args.n_images, args.hw)
    held, keep = holdout_split(ds.n_images, args.holdout_every)
    loc, step = checkpoint_localizer(args.result_dir, subset(ds, keep),
                                     ds.intrinsics[0], args.hw, args.device)
    print(f"restored step {step}")

    rng = np.random.default_rng(7)
    errs_before, errs_search, errs_final = [], [], []
    for i in held:
        gt_pose = np.asarray(ds.poses[i], dtype=np.float32)
        noisy = perturb_pose(rng, gt_pose, args.pos_noise,
                             args.rot_noise_deg)
        res = loc.localize(noisy, ds.images[i], particle_num=args.particles,
                           search_rounds=args.search_rounds,
                           noise_coeff=2.0, diff_iters=args.diff_iters,
                           diff_lr=args.diff_lr)
        if res["backtracks"]:
            print(f"  auto-lr: {res['backtracks']} backtracks, "
                  f"final lr {res['lr_final']:.2e}")
        e0 = float(np.linalg.norm(noisy[:3, 3] - gt_pose[:3, 3]))
        e1 = float(np.linalg.norm(res["search_pose"][:3, 3]
                                  - gt_pose[:3, 3]))
        e2 = float(np.linalg.norm(res["pose"][:3, 3] - gt_pose[:3, 3]))
        errs_before.append(e0)
        errs_search.append(e1)
        errs_final.append(e2)
        print(f"holdout view {i:02d}: pos err {e0:.4f} -> search "
              f"{e1:.4f} -> diff {e2:.4f} (scene units)", flush=True)

    print(f"mean position error: before {np.mean(errs_before):.4f}, "
          f"after search {np.mean(errs_search):.4f}, "
          f"after differential {np.mean(errs_final):.4f} "
          f"({100 * np.mean(errs_final):.2f}% of scene radius)")
    ok = np.mean(errs_final) < np.mean(errs_before)
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
