"""Shared by the benchmark's tests: a tiny copy of the benchmark (the
same cells and the shelved one, configurations cut to a few hundred
pages, mixes cut to a few rays, then as each configuration's field file
asks: its optional ``TINY_MODEL`` and ``TINY_MIX``) in a scratch
checkout that links the program beside it, and one run of a cell in it
on the CPU."""

from __future__ import annotations

import contextlib
import io
import json
import os
import pathlib
import shutil

from portbench import harness

PB = pathlib.Path(__file__).resolve().parents[1]
REPO = PB.parent
PROGRAM = "f2nerf_tpu_torch"

TINY_MODEL = {"n_levels": 2, "log2_table_size": 10, "occ_grid_res": 16,
              "occ_segments": 16, "n_samples": 64, "sample_l": 1.0 / 16.0,
              "occ_warmup_steps": 4, "occ_refresh_warmup": 8,
              "occ_update_every": 4, "occ_refresh_phases": 2}
TINY_TRAIN = {"pts_batch_size": 16 * 512}
TINY_MIX = {"frames": {"frame_hw": [40, 96], "particle_num": 6,
                       "targets": 2, "warmup_frames": 1, "check_rate": 0.5,
                       "trace_frames": 2},
            "train": {"images": 2, "image_hw": 16, "focal": 12.0,
                      "trace_steps": 4}}


def tiny_tree(dst: pathlib.Path) -> pathlib.Path:
    """A checkout at ``dst``: the benchmark's folder with its
    configurations and mixes cut to the tiny sizes, BENCHMARK.json, and
    the program linked in. Returns ``dst``."""
    pb = dst / PB.name
    shutil.copytree(PB, pb, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["workloads"].append(SHELVED)
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "occ-localize" in m.get("workloads", ()):
            m["workloads"].append(SHELVED["name"])
    (dst / "BENCHMARK.json").write_text(json.dumps(spec))
    os.symlink(REPO / PROGRAM, dst / PROGRAM)
    fields = {}     # configuration name -> its field file
    for path in (pb / "configs").glob("*.json"):
        conf = json.loads(path.read_text())
        file = pb / "fields" / f"{harness.field_name(conf)}.py"
        field = harness.load_module(file) if file.is_file() else None
        conf["config"]["model"].update(TINY_MODEL)
        conf["config"]["model"].update(getattr(field, "TINY_MODEL", {}))
        conf["config"]["train"].update(TINY_TRAIN)
        path.write_text(json.dumps(conf))
        fields[conf["name"]] = field
    mix_fields = {}  # mix name -> the field files of the cells that run it
    for w in spec["workloads"]:
        mix_fields.setdefault(w["traffic"], []).append(fields[w["config"]])
    for path in (pb / "mixes").glob("*.json"):
        mix = json.loads(path.read_text())
        mix.update(TINY_MIX[mix["kind"]])
        for field in mix_fields.get(path.stem, ()):
            mix.update(getattr(field, "TINY_MIX", {}).get(mix["kind"], {}))
        path.write_text(json.dumps(mix))
    return dst


CELLS = tuple(w["name"] for w in json.loads(
    (REPO / "BENCHMARK.json").read_text())["workloads"])
# a cell whose files the benchmark keeps (its mix and limits) while its
# entry waits for chip time to prove it (PERF.md, Open questions); the
# tiny copy lists it beside the frame cell, so that its path stays tested
SHELVED = {"name": "occ-track", "config": "f2nerf-occ",
           "traffic": "node-mode1", "chips": 1,
           "why": "node frames in mode 1: one Adam step on the pose"}
TINY_CELLS = CELLS + (SHELVED["name"],)


def tiny_checkout(tmp: pathlib.Path) -> pathlib.Path:
    return tiny_tree(tmp / "checkout")


def run_cpu(root: pathlib.Path, workload: str, seed: int = 7,
            seconds: float = 0.3, trace: int = 0, hooks=None
            ) -> tuple[int, dict | None, str]:
    """(exit code, the result line, standard error) of one CPU run."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = harness.main(["--workload", workload, "--seed", str(seed),
                           "--seconds", str(seconds), "--trace", str(trace)],
                          device="cpu", hooks=hooks, root=root)
    lines = [ln for ln in out.getvalue().splitlines() if ln.strip()]
    result = json.loads(lines[-1]) if rc == 0 and lines else None
    return rc, result, err.getvalue()
