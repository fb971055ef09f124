"""Render held-out views from a trained run and score PSNR / SSIM (port
of ``scripts/eval_holdout.py``).

    python -m f2nerf_tpu_torch.tools.eval_holdout TRAIN_RESULT_DIR \\
        HOLDOUT_DIR [--chunk 16384] [--out tsv] [--save_images] [--device cpu]

The holdout directory (``make_synthetic_dataset --holdout``, or any
cams_meta dataset) carries world-frame poses; they are mapped into the
run's normalized frame through the run's ``inference_params.yaml``
(normalizing center and radius), not the holdout directory's own
normalization. Writes ``holdout_summary.tsv`` (``image_idx psnr ssim
time_s``) into the run directory unless ``--out`` says otherwise.
"""

from __future__ import annotations

import argparse
import pathlib
import time

import numpy as np
import torch

from f2nerf_tpu_torch.data.dataset import load_dataset
from f2nerf_tpu_torch.localize.localizer import Localizer
from f2nerf_tpu_torch.models import renderer
from f2nerf_tpu_torch.tools.common import add_device_flag
from f2nerf_tpu_torch.utils.image_io import write_image
from f2nerf_tpu_torch.utils.metrics import psnr, ssim


def run_frame_poses(ds, loc: Localizer) -> np.ndarray:
    """The dataset's poses in the run's normalized frame."""
    world_t = ds.poses[:, :3, 3] * ds.radius + ds.center
    poses = ds.poses.copy()
    poses[:, :3, 3] = (world_t - loc.center.numpy()) / loc.radius
    return poses


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("train_result_dir", type=pathlib.Path)
    ap.add_argument("holdout_dir", type=pathlib.Path)
    ap.add_argument("--chunk", type=int, default=16384)
    ap.add_argument("--out", default=None,
                    help="summary tsv path (default "
                         "<result>/holdout_summary.tsv)")
    ap.add_argument("--save_images", action="store_true",
                    help="write [gt | pred] strips next to the summary")
    add_device_flag(ap)
    args = ap.parse_args(argv)

    ds = load_dataset(args.holdout_dir)
    loc = Localizer.from_checkpoint(args.train_result_dir,
                                    device=args.device)
    poses = run_frame_poses(ds, loc)

    rows = []
    out_dir = pathlib.Path(args.out).parent if args.out \
        else args.train_result_dir
    for i in range(ds.n_images):
        t0 = time.monotonic()
        rgb, _ = renderer.render_image(
            loc.params, torch.as_tensor(poses[i], device=loc.device),
            torch.as_tensor(ds.intrinsics[i], device=loc.device),
            ds.height, ds.width, loc.cfg.model, chunk=args.chunk,
            occ_vals=loc.occ_vals, consts=loc.consts)
        rgb = rgb.cpu().numpy()
        dt = time.monotonic() - t0
        p = psnr(rgb, ds.images[i])
        s = ssim(rgb, ds.images[i])
        rows.append((i, p, s, dt))
        print(f"holdout {i:02d} psnr={p:.2f} ssim={s:.4f} "
              f"{dt * 1e3:.0f} ms", flush=True)
        if args.save_images:
            write_image(out_dir / f"holdout_{i:02d}.png",
                        np.concatenate([ds.images[i], rgb], axis=1))

    out = pathlib.Path(args.out) if args.out \
        else args.train_result_dir / "holdout_summary.tsv"
    with open(out, "w") as f:
        f.write("image_idx\tpsnr\tssim\ttime_s\n")
        for r in rows:
            f.write(f"{r[0]}\t{r[1]:.4f}\t{r[2]:.4f}\t{r[3]:.4f}\n")
    ps, ss = [r[1] for r in rows], [r[2] for r in rows]
    print(f"holdout mean PSNR {np.mean(ps):.2f} dB "
          f"(min {np.min(ps):.2f}) SSIM {np.mean(ss):.4f} -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
