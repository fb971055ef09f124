#!/usr/bin/env python3
"""Faults planted under the timed path, each of which has to bring
``correct`` out false: a step that returns its state unchanged, half of
the batch left out, an answer altered where it is produced. No cell
exchanges anything between chips.

    python3 portbench/faults.py --workload <cell> --seeds 11,12,13 \\
        [--seconds 2] [--check-rate 0.2] [--faults half_batch]

For each fault of the cell's kind and each seed it runs the cell as a
benchmark run does (set-up, a short window, the check) with the program
patched, and prints one JSON line: the numbers compared, all of them,
and whether the committed limits call the run correct. The benchmark's
own runs never plant a fault; ``tests/test_portbench_faults.py`` plants
them at a tiny size on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys

sys.path[0] = str(pathlib.Path(__file__).resolve().parents[1])

from portbench import checks, control, harness  # noqa: E402


class FrameFault:
    """A fault of a frame cell, planted in ``LocalizerService`` and its
    localizer."""

    KINDS = ("state_unchanged", "half_batch", "pose_altered",
             "image_altered")

    def __init__(self, how: str):
        if how not in self.KINDS:
            raise ValueError(f"unknown frame fault {how!r}")
        self.how = how

    def program(self, svc):
        import numpy as np
        from f2nerf_tpu_torch.localize.localizer import Particle

        loc = svc.localizer
        if self.how == "state_unchanged":
            loc.optimize_pose_by_differential = (
                lambda pose, image, iteration_num, lr=1e-4: [pose.copy()])
            loc.optimize_pose_by_random_search = (
                lambda pose, image, n, coeff: [Particle(pose, 1.0)])
        elif self.how == "half_batch":
            loc.param.render_pixel_num = max(1, min(
                loc.param.render_pixel_num,
                loc.infer_height * loc.infer_width) // 2)
            inner_frame = loc._frame

            def half_frame(image):
                ij, gt, valid, n = inner_frame(image)
                return ij[:n // 2], gt[:n // 2], None, n // 2

            loc._frame = half_frame
        elif self.how == "pose_altered":
            inner = svc.handle

            def handle(req):
                out = inner(req)
                if "pose" in out and req.get("cmd") == "localize":
                    out["pose"] = (np.asarray(out["pose"]) + 1e-3).tolist()
                return out

            svc.handle = handle
        elif self.how == "image_altered":
            inner = svc.handle

            def handle(req):
                out = inner(req)
                if "rendered" in out:
                    img = np.asarray(out["rendered"])
                    img[0, 0] += 0.05
                    out["rendered"] = img.tolist()
                return out

            svc.handle = handle


class TrainFault:
    """A fault of a train cell, planted in the step function and its
    optimizer."""

    KINDS = ("state_unchanged", "half_batch", "loss_altered")

    def __init__(self, how: str):
        if how not in self.KINDS:
            raise ValueError(f"unknown train fault {how!r}")
        self.how = how

    def program(self, step_fn, optimizer):
        if self.how == "state_unchanged":
            optimizer.step = lambda: None
            return step_fn
        if self.how == "half_batch":
            def half(params, grid, poses, intr, step, cam, ij, gt, **kw):
                n = cam.shape[0] // 2
                return step_fn(params, grid, poses, intr, step, cam[:n],
                               ij[:n], gt[:n], **kw)
            return half

        def altered(*args, **kw):
            grid, m = step_fn(*args, **kw)
            return grid, m._replace(loss=m.loss * 1.01)
        return altered


FAULTS = {"frames": FrameFault, "train": TrainFault}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated whole numbers")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--check-rate", type=float, default=None,
                    help="share of a frame cell's window frames compared")
    ap.add_argument("--faults", default="",
                    help="comma-separated; all of the cell's kind if empty")
    args = ap.parse_args(argv)
    root = pathlib.Path(os.getcwd())
    cell = harness.load_cell(root, args.workload)
    fault = FAULTS[cell.mix["kind"]]
    kinds = [k for k in args.faults.split(",") if k] or fault.KINDS
    seeds = [int(s) for s in args.seeds.split(",")]
    for how in kinds:
        for line in control.readings(root, args.workload, seeds,
                                     args.seconds, (), hooks=fault(how),
                                     check_rate=args.check_rate):
            nums = line["program"]
            print(json.dumps({
                "fault": how, "seed": line["seed"], "failed": line["failed"],
                "correct": line["failed"] == 0
                and checks.within(nums, cell.limits),
                "numbers": nums}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
