"""Concatenate paired image sequences of two directories side by side,
heights padded to match, e.g. localization plots next to camera frames
(port of ``scripts/concat_inference_images.py``).

    python -m f2nerf_tpu_torch.tools.concat_inference_images DIR1 DIR2 \\
        OUT_DIR [--glob1 '*/plot_result_last.png'] [--scale1 2.0]

The left panels are the ``--glob1`` matches under DIR1 (upscaled by
``--scale1``), the right ones ``DIR2/*.png``; each output is named after
its right panel.
"""

from __future__ import annotations

import argparse
import glob as globmod
import pathlib

import numpy as np

from f2nerf_tpu_torch.utils.image_io import (read_image, resize_image,
                                             write_image)


def pad_to_height(img: np.ndarray, h: int) -> np.ndarray:
    if img.shape[0] >= h:
        return img
    pad = np.zeros((h - img.shape[0],) + img.shape[1:], img.dtype)
    return np.concatenate([img, pad], axis=0)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("dir1", help="left-panel directory")
    ap.add_argument("dir2", help="right-panel directory (*.png)")
    ap.add_argument("out_dir")
    ap.add_argument("--glob1", default="*/plot_result_last.png",
                    help="glob under dir1 for left panels")
    ap.add_argument("--scale1", type=float, default=2.0,
                    help="upscale factor for left panels")
    args = ap.parse_args(argv)

    lefts = sorted(globmod.glob(str(pathlib.Path(args.dir1) / args.glob1)))
    rights = sorted(pathlib.Path(args.dir2).glob("*.png"))
    if not lefts or not rights:
        raise SystemExit("no input images found")
    out_dir = pathlib.Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for i in range(min(len(lefts), len(rights))):
        left = read_image(lefts[i])
        if args.scale1 != 1.0:
            left = resize_image(left, int(left.shape[0] * args.scale1),
                                int(left.shape[1] * args.scale1))
        right = read_image(rights[i])
        h = max(left.shape[0], right.shape[0])
        merged = np.concatenate(
            [pad_to_height(left, h), pad_to_height(right, h)], axis=1)
        out_path = out_dir / rights[i].name
        write_image(out_path, merged)
        print(f"saved {out_path}")


if __name__ == "__main__":
    main()
