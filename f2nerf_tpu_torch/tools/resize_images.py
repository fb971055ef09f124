"""Downscale a directory of PNG images by an integer factor (port of
``scripts/resize_images.py``).

    python -m f2nerf_tpu_torch.tools.resize_images IN_DIR OUT_DIR \\
        [--resize_factor 2]
"""

from __future__ import annotations

import argparse
import pathlib

from f2nerf_tpu_torch.utils.image_io import (read_image, resize_image,
                                             write_image)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("input_dir")
    ap.add_argument("output_dir")
    ap.add_argument("--resize_factor", type=int, default=2)
    args = ap.parse_args(argv)

    out_dir = pathlib.Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = sorted(pathlib.Path(args.input_dir).glob("*.png"))
    if not paths:
        raise SystemExit(f"no .png images in {args.input_dir}")
    for k, p in enumerate(paths):
        img = read_image(p)
        h = img.shape[0] // args.resize_factor
        w = img.shape[1] // args.resize_factor
        write_image(out_dir / p.name, resize_image(img, h, w))
        print(f"\r{k + 1}/{len(paths)}", end="", flush=True)
    print(f"\nwrote {len(paths)} images to {out_dir}")


if __name__ == "__main__":
    main()
