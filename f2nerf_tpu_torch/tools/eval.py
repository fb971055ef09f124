"""Offline eval: PSNR / SSIM (/ LPIPS when weights are available) over
paired gt/pred image directories -> info.json (port of
``scripts/eval.py``; reference ``scripts/eval.py:78-117``).

    python -m f2nerf_tpu_torch.tools.eval --gt_dir GT --pred_dir PRED \\
        [--out info.json] [--lpips_weights lpips_vgg.pt] [--device cpu]

LPIPS(vgg) runs through ``utils/lpips.py`` on a local weight file
(``--lpips_weights``, ``LPIPS_WEIGHTS`` or ``weights/lpips_vgg.pt``);
without one its column is null, as in the JAX script. The JAX script's
fallback to the ``lpips`` pip package is not kept: the port needs no
package beyond torch and numpy.
"""

from __future__ import annotations

import argparse
import glob
import json
import pathlib

import numpy as np
import torch

from f2nerf_tpu_torch.tools.common import add_device_flag
from f2nerf_tpu_torch.utils.image_io import read_image
from f2nerf_tpu_torch.utils.metrics import psnr, ssim


def try_lpips(weights: str | None = None, device=None):
    """The LPIPS(vgg) network of the local weight file on ``device``, or
    None when there is none (or it does not load)."""
    from f2nerf_tpu_torch.utils import lpips

    try:
        return lpips.load(weights, device=device)
    except Exception as e:  # noqa: BLE001 — the column is optional
        print(f"lpips: local loader failed ({e})")
        return None


def to_lpips_input(x: np.ndarray) -> torch.Tensor:
    """[H, W, 3] in [0, 1] -> [1, 3, H, W] in [-1, 1]."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    return torch.from_numpy(x).permute(2, 0, 1)[None] * 2.0 - 1.0


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--gt_dir", required=True)
    ap.add_argument("--pred_dir", required=True)
    ap.add_argument("--out", default=None,
                    help="output json (default <pred_dir>/info.json)")
    ap.add_argument("--lpips_weights", default=None,
                    help="local LPIPS(vgg) weight file "
                         "(see f2nerf_tpu_torch/utils/lpips.py; also read "
                         "from the LPIPS_WEIGHTS env var)")
    add_device_flag(ap)
    args = ap.parse_args(argv)

    gt_paths = sorted(glob.glob(str(pathlib.Path(args.gt_dir) / "*.png")))
    pred_paths = sorted(
        glob.glob(str(pathlib.Path(args.pred_dir) / "*.png")))
    if len(gt_paths) != len(pred_paths):
        raise SystemExit(f"count mismatch: {len(gt_paths)} gt vs "
                         f"{len(pred_paths)} pred")

    lpips_model = try_lpips(args.lpips_weights, args.device)
    psnrs, ssims, lpipss = [], [], []
    for g, p in zip(gt_paths, pred_paths):
        gt = read_image(g)
        pred = read_image(p)
        psnrs.append(psnr(pred, gt))
        ssims.append(ssim(pred, gt))
        if lpips_model is not None:
            lpipss.append(float(lpips_model(to_lpips_input(pred),
                                            to_lpips_input(gt))))
        print(f"{pathlib.Path(p).name}: psnr={psnrs[-1]:.3f} "
              f"ssim={ssims[-1]:.4f}")

    info = {
        "psnr": float(np.mean(psnrs)),
        "ssim": float(np.mean(ssims)),
        "n_images": len(gt_paths),
    }
    if lpipss:
        info["lpips_vgg"] = float(np.mean(lpipss))
    else:
        info["lpips_vgg"] = None
        print("lpips: weights absent (supply real VGG weights via "
              "--lpips_weights / LPIPS_WEIGHTS)")

    out = args.out or str(pathlib.Path(args.pred_dir) / "info.json")
    with open(out, "w") as f:
        json.dump(info, f, indent=2)
    print(json.dumps(info))


if __name__ == "__main__":
    main()
