"""Localizer latency bench (port of ``scripts/bench_localize.py``;
reference metric: the localize callback's ms,
ros2/src/ros2-f2-nerf/src/nerf_based_localizer.cpp:401).

    python -m f2nerf_tpu_torch.tools.bench_localize [--resize 8] \\
        [--particles 100] [--device cpu]

Times the three localize primitives at the ``Config()`` model with seeded
random weights (latency is shape-bound) on an 850x1920 frame, the ROS
node's: the particle search (one batched render of ``--particles`` x
``render_pixel_num`` pixels), one differential step (through the whole
frame at the localize resolution) and a full-frame render. Each is run
once to warm up, then 5 times; the host clock around calls that end in
``torch.cuda.synchronize()`` on the card.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from f2nerf_tpu_torch.core.config import Config
from f2nerf_tpu_torch.core.device import resolve_device
from f2nerf_tpu_torch.localize.localizer import Localizer, LocalizerParam
from f2nerf_tpu_torch.models import occupancy, renderer
from f2nerf_tpu_torch.tools.common import add_device_flag

FRAME_H, FRAME_W = 850, 1920      # the ROS node's cropped camera frame


def make_localizer(resize: int, device) -> Localizer:
    """The bench's localizer: ``Config()``, params from seed 0, an
    empty-grid occupancy, an f = 1000 camera at the centre."""
    cfg = Config()
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = renderer.init(gen, cfg.model, 4, dev)
    occ_vals = occupancy.occ_values(occupancy.init_grid(cfg.model, dev),
                                    cfg.model)
    h, w = FRAME_H, FRAME_W
    intr = np.array([[1000.0, 0, w / 2], [0, 1000.0, h / 2],
                     [0, 0, 1.0]], np.float32)
    return Localizer(params, cfg, intr, np.zeros(3), 1.0, h, w,
                     param=LocalizerParam(resize_factor=resize),
                     occ_vals=occ_vals, seed=0, device=dev)


def timeit(fn, device: torch.device, n: int = 5) -> float:
    """Mean ms of ``n`` calls after one warm-up call."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    sync()
    return (time.perf_counter() - t0) / n * 1000


def bench(loc: Localizer, particles: int) -> dict:
    """{"search", "diff", "render"} ms."""
    pose = np.eye(3, 4, dtype=np.float32)
    img = loc.render_image(pose).cpu().numpy()
    return {
        "search": timeit(lambda: loc.optimize_pose_by_random_search(
            pose, img, particle_num=particles, noise_coeff=1.0),
            loc.device),
        "diff": timeit(lambda: loc.optimize_pose_by_differential(
            pose, img, iteration_num=1), loc.device),
        "render": timeit(lambda: loc.render_image(pose).cpu(), loc.device)}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--resize", type=int, default=8,
                    help="resize_factor (reference infer uses 32; the "
                         "ROS node 1)")
    ap.add_argument("--particles", type=int, default=100)
    add_device_flag(ap)
    args = ap.parse_args(argv)

    loc = make_localizer(args.resize, args.device)
    ms = bench(loc, args.particles)
    print(f"particle search ({args.particles} particles x "
          f"{loc.param.render_pixel_num} px): {ms['search']:.1f} ms")
    print(f"differential opt (1 iter, {loc.infer_height}x"
          f"{loc.infer_width}): {ms['diff']:.1f} ms")
    print(f"full render {loc.infer_height}x{loc.infer_width}: "
          f"{ms['render']:.1f} ms")
    return ms


if __name__ == "__main__":
    main()
