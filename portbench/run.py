#!/usr/bin/env python3
"""One run of one cell of the benchmark of ``f2nerf_tpu_torch``.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of the repository (or of a checkout of it). See
``portbench/harness.py``.
"""

import pathlib
import sys

# the repository's root, not this folder, heads the import path
sys.path[0] = str(pathlib.Path(__file__).resolve().parents[1])

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main())
