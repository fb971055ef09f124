"""Render a procedural scene to an on-disk cams_meta dataset directory
(cams_meta.tsv + images/*.png), optionally splitting held-out views into
a sibling directory (port of ``scripts/make_synthetic_dataset.py``; the
same files, bitwise).

    python -m f2nerf_tpu_torch.tools.make_synthetic_dataset OUT_DIR \\
        [--scene checker] [--n_images 18] [--hw 400] [--holdout 8]

With ``--holdout k`` every k-th view goes to ``<OUT_DIR>_holdout``.
"""

from __future__ import annotations

import argparse
import pathlib

from f2nerf_tpu_torch.data.dataset import save_dataset
from f2nerf_tpu_torch.tools.common import (SCENES, holdout_split,
                                           make_scene, subset)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir", type=pathlib.Path)
    ap.add_argument("--scene", choices=SCENES, default="checker")
    ap.add_argument("--n_images", type=int, default=18)
    ap.add_argument("--hw", type=int, default=400)
    ap.add_argument("--holdout", type=int, default=0,
                    help="withhold every k-th view into <out_dir>_holdout")
    args = ap.parse_args(argv)

    ds = make_scene(args.scene, args.n_images, args.hw)
    if args.holdout > 0:
        held, keep = holdout_split(ds.n_images, args.holdout)
        save_dataset(subset(ds, keep), args.out_dir)
        hold_dir = args.out_dir.parent / (args.out_dir.name + "_holdout")
        save_dataset(subset(ds, held), hold_dir)
        print(f"{len(keep)} train views -> {args.out_dir}; "
              f"{len(held)} held-out -> {hold_dir}")
    else:
        save_dataset(ds, args.out_dir)
        print(f"{ds.n_images} views -> {args.out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
