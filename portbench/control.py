#!/usr/bin/env python3
"""The controls of the comparison that decides ``correct``, and the
program's own readings beside them, over many seeds in one process.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 \\
        [--seconds 2] [--check-rate 0.2] [--controls fp8_table,tf32]

For each seed it runs the cell as a benchmark run does (set-up, a short
window, the check) and prints one JSON line: the program's numbers (the
lower readings of each limit) and, for each control, the numbers of the
plain reference put in the program's place one precision step below
what the configuration states (``common.CONTROLS``), judged against the
reference by the same functions. A limit sits above every program
reading and below the control's. The benchmark's own runs never run a
control.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import pathlib
import sys
import time

sys.path[0] = str(pathlib.Path(__file__).resolve().parents[1])

from portbench import common, harness  # noqa: E402


def readings(root: pathlib.Path, workload: str, seeds: list[int],
             seconds: float, controls: tuple, device: str = "cuda",
             hooks=None, check_rate: float | None = None):
    """Yields {"seed", "failed", "program", <control>: numbers} per seed;
    ``hooks`` may break the program (``portbench/faults.py``), and
    ``check_rate`` replaces the frame mix's share of frames compared, so
    that a short window compares as many frames as a full run does."""
    import torch

    cell = harness.load_cell(root, workload)
    refused = harness.refusal(cell)
    if refused:
        print(f"portbench: {refused}", file=sys.stderr)
        raise SystemExit(2)
    if check_rate is not None and "check_rate" in cell.mix:
        cell.mix["check_rate"] = check_rate
    dev = torch.device(device)
    driver = importlib.import_module(f"portbench.drive_{cell.mix['kind']}")
    for seed in seeds:
        with contextlib.redirect_stdout(common.NullWriter()):
            out = driver.run(cell, seed, seconds, False, dev, hooks=hooks,
                             t_start=time.time(), controls=controls)
        yield {"seed": seed, "failed": out.failed, "program": out.numbers,
               **out.controls}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated whole numbers")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--check-rate", type=float, default=None,
                    help="share of a frame cell's window frames compared")
    ap.add_argument("--controls", default=",".join(common.CONTROLS))
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    controls = tuple(c for c in args.controls.split(",") if c)
    for line in readings(pathlib.Path(os.getcwd()), args.workload, seeds,
                         args.seconds, controls,
                         check_rate=args.check_rate):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
