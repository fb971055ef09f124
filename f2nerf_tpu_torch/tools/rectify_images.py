"""Undistort (rectify) a directory of PNG images with its
``camera_info.yaml`` (port of ``scripts/rectify_images.py``): the remap
table is built once with ``utils/undistort.py`` and reused for every
frame.

    python -m f2nerf_tpu_torch.tools.rectify_images TARGET_DIR

Layout: ``<dir>/images_original`` + ``<dir>/camera_info.yaml`` ->
``<dir>/images``. The YAML is read by ``core/yaml_io.py`` (no ``yaml``
package needed), in either convention: the sensor_msgs dump (``K`` /
``D`` lists) or the ROS calibration file (``camera_matrix`` /
``distortion_coefficients`` with ``data``).
"""

from __future__ import annotations

import argparse
import pathlib

import numpy as np

from f2nerf_tpu_torch.core import yaml_io
from f2nerf_tpu_torch.utils.image_io import read_image, write_image
from f2nerf_tpu_torch.utils.undistort import (build_undistort_map,
                                              remap_bilinear)


def load_camera_info(path: pathlib.Path) -> tuple[np.ndarray, np.ndarray]:
    """(intrinsic [3, 3], distortion [k]) float64 from either convention."""
    info = yaml_io.load(path, block_sequences=True)
    if "K" in info:
        k, d = info["K"], info["D"]
    else:
        k = info["camera_matrix"]["data"]
        d = info["distortion_coefficients"]["data"]
    return (np.asarray(k, dtype=np.float64).reshape(3, 3),
            np.asarray(d, dtype=np.float64))


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("target_dir",
                    help="dir with images_original/ and camera_info.yaml")
    args = ap.parse_args(argv)

    target = pathlib.Path(args.target_dir)
    intrinsic, dist = load_camera_info(target / "camera_info.yaml")
    if dist.size < 4:
        dist = np.pad(dist, (0, 4 - dist.size))

    out_dir = target / "images"
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = sorted((target / "images_original").glob("*.png"))
    if not paths:
        raise SystemExit(f"no .png images in {target / 'images_original'}")
    maps = None
    for k, p in enumerate(paths):
        img = read_image(p)
        if maps is None:
            maps = build_undistort_map(intrinsic, dist,
                                       img.shape[0], img.shape[1])
        write_image(out_dir / p.name, remap_bilinear(img, *maps))
        print(f"\r{k + 1}/{len(paths)}", end="", flush=True)
    print(f"\nwrote {len(paths)} images to {out_dir}")


if __name__ == "__main__":
    main()
