"""Crop a directory of PNG images to a row range, e.g. to remove a
vehicle's hood from dashcam frames (port of ``scripts/crop_images.py``):
reads ``<dir>/images_original``, keeps rows [top, bottom), writes
``<dir>/images``.

    python -m f2nerf_tpu_torch.tools.crop_images TARGET_DIR \\
        [--top 0] [--bottom 850]
"""

from __future__ import annotations

import argparse
import pathlib

from f2nerf_tpu_torch.utils.image_io import read_image, write_image


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("target_dir",
                    help="directory containing images_original/")
    ap.add_argument("--top", type=int, default=0)
    ap.add_argument("--bottom", type=int, default=850,
                    help="first excluded row (reference crops to 850)")
    args = ap.parse_args(argv)

    target = pathlib.Path(args.target_dir)
    in_dir = target / "images_original"
    out_dir = target / "images"
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = sorted(in_dir.glob("*.png"))
    if not paths:
        raise SystemExit(f"no .png images in {in_dir}")
    for k, p in enumerate(paths):
        write_image(out_dir / p.name, read_image(p)[args.top:args.bottom])
        print(f"\r{k + 1}/{len(paths)}", end="", flush=True)
    print(f"\nwrote {len(paths)} images to {out_dir}")


if __name__ == "__main__":
    main()
