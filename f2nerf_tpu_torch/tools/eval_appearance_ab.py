"""Eval-time appearance and supersampling A/B on a trained checkpoint
(port of ``scripts/eval_appearance_ab.py``).

    python -m f2nerf_tpu_torch.tools.eval_appearance_ab RESULT_DIR \\
        [--scene textured] [--n_images 48] [--hw 128] [--holdout_every 8] \\
        [--supersamples 1,2] [--embs none,mean] [--budget_s 520] \\
        [--device cpu]

The appearance embedding ``app_emb`` is trained per training view and
only added in TRAIN renders (reference ``src/renderer.cpp:100-104``), so
every VALIDATE render evaluates the shader off the inputs it trained on.
This tool renders every view of a ``quality_run --holdout`` checkpoint
under each (``eval_emb``, supersample) arm and prints the mean train and
held-out PSNR / SSIM of each: no training, only measurement. The
embedding modes: ``none``; ``mean``, the mean trained row; ``own``, each
training view with its own row and each held-out view with the mean (an
upper bound on how much per-view appearance the model memorized). Arms
not reached within ``--budget_s`` are left out, and the exit code is 1.
"""

from __future__ import annotations

import argparse
import pathlib
import time

import numpy as np
import torch

from f2nerf_tpu_torch.models import renderer
from f2nerf_tpu_torch.tools.common import (add_device_flag, holdout_split,
                                           make_scene, restore_run, subset)
from f2nerf_tpu_torch.utils.metrics import psnr, ssim


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("result_dir", type=pathlib.Path)
    ap.add_argument("--scene", default="textured")
    ap.add_argument("--n_images", type=int, default=48)
    ap.add_argument("--hw", type=int, default=128)
    ap.add_argument("--holdout_every", type=int, default=8)
    ap.add_argument("--supersamples", default="1,2")
    ap.add_argument("--embs", default="none,mean",
                    help="comma list from {none, mean, own}: 'own' "
                         "renders each TRAIN view with its own trained "
                         "embedding (holdouts get the mean) — an upper "
                         "bound quantifying how much per-image "
                         "appearance the model memorized")
    ap.add_argument("--budget_s", type=float, default=520.0)
    add_device_flag(ap)
    args = ap.parse_args(argv)

    ds = make_scene(args.scene, args.n_images, args.hw)
    held, keep = holdout_split(ds.n_images, args.holdout_every)
    run = restore_run(args.result_dir, subset(ds, keep), args.device)
    print(f"restored step {run.step}")
    app_emb = run.params["app_emb"]
    mean_emb = torch.mean(app_emb, dim=0)
    emb_norm = float(torch.linalg.vector_norm(mean_emb))
    per_norm = float(torch.mean(torch.linalg.vector_norm(app_emb, dim=1)))
    print(f"app_emb: mean-vector norm {emb_norm:.3f}, "
          f"mean per-image norm {per_norm:.3f}")

    sss = [int(s) for s in args.supersamples.split(",")]
    emb_modes = args.embs.split(",")
    arms = [(e, s) for s in sss for e in emb_modes]
    # dataset view -> its training embedding row (training views only)
    train_row = {v: r for r, v in enumerate(keep)}
    t0 = time.monotonic()
    print(f"{'arm':<16} {'train PSNR':>10} {'hold PSNR':>10} "
          f"{'train SSIM':>10} {'hold SSIM':>10} {'gap':>6}")
    for emb_mode, ss in arms:
        if time.monotonic() - t0 > args.budget_s:
            print("budget reached; re-run for remaining arms")
            return 1
        accum = {"train": ([], []), "holdout": ([], [])}
        for i in range(ds.n_images):
            if emb_mode == "none":
                emb = None
            elif emb_mode == "mean":
                emb = mean_emb
            else:  # own: the train view's row, the mean for held-out views
                emb = (app_emb[train_row[i]] if i in train_row
                       else mean_emb)
            rgb, _ = renderer.render_image(
                run.params, torch.as_tensor(ds.poses[i], device=run.device),
                torch.as_tensor(ds.intrinsics[i], device=run.device),
                ds.height, ds.width, run.cfg.model, chunk=16384,
                occ_vals=run.occ_vals, eval_emb=emb, supersample=ss,
                consts=run.consts)
            rgb = rgb.cpu().numpy()
            tag = "holdout" if i in held else "train"
            accum[tag][0].append(psnr(rgb, ds.images[i]))
            accum[tag][1].append(ssim(rgb, ds.images[i]))
        tp, hp = np.mean(accum["train"][0]), np.mean(accum["holdout"][0])
        tss, hss = np.mean(accum["train"][1]), np.mean(accum["holdout"][1])
        print(f"emb={emb_mode:<5} ss={ss} {tp:>10.2f} {hp:>10.2f} "
              f"{tss:>10.3f} {hss:>10.3f} {tp - hp:>6.2f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
