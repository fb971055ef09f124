"""The benchmark of ``f2nerf_tpu_torch``: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Everything that belongs to one configuration, traffic mix, per-layer
metric, kernel count or cell is found by its name in ``BENCHMARK.json``:

* the configuration: the ``file`` of its ``configs`` entry
  (``portbench/configs/<name>.json``), the port's ``Config`` as run;
* the configuration's field: ``portbench/fields/<field>.py``, where
  ``<field>`` is the file's top-level ``"field"`` key, ``paged`` without
  it. A field file gives ``RUNS``, {model key: the values it runs}, and
  three functions of (model, mix, seed, device) or (model, scene):
  ``train_scene`` and ``frame_scene``, the weights, the program's
  ``consts["field"]`` and, for training, the cameras, drawn on the device
  from the seed and the mix (``inputs.Scene``); ``features``, the plain
  reference's field function (``reference/field.py``), which keeps
  nothing the program is handed;
* the traffic mix: ``portbench/mixes/<traffic>.json``, parameters that
  the driver of its ``kind`` reads (``drive_<kind>.py``);
* a per-layer metric: ``portbench/metrics/<name>.py``, whose
  ``read(ctx)`` returns the number or None;
* a kernel's work: ``portbench/counts/<kernel>.py``;
* a cell's limits for the comparison that decides ``correct``:
  ``portbench/limits/<workload>.json``.

A run is one fresh process. It refuses to run (exit 2, no result), before
anything is drawn, where the configuration asks for what its field does
not run, and without the card or with fewer cards than the cell asks
for. It fails (exit 3, no result) if JAX or the JAX package is loaded
once the window has closed. Its last line of standard output is the
result, a JSON object with ``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each compared number beside its limit, also printed as the
last lines of standard error.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import pathlib
import sys
import time
import types
from dataclasses import dataclass

BENCH_DIR = pathlib.Path(__file__).resolve().parent.name
FORBIDDEN = ("jax", "jaxlib", "flax", "f2nerf_tpu")
DEFAULT_FIELD = "paged"


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict       # the configuration's file
    mix: dict
    limits: dict
    spec: dict         # BENCHMARK.json
    pb: pathlib.Path   # the benchmark's folder in the checkout
    field: types.ModuleType | None   # its field file; None if missing


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root: pathlib.Path, name: str) -> Cell:
    spec = load_json(root / "BENCHMARK.json")
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise SystemExit(f"unknown workload {name!r}; the cells are "
                         f"{sorted(work)}")
    wl = work[name]
    conf = {c["name"]: c for c in spec["configs"]}[wl["config"]]
    pb = root / BENCH_DIR
    config = load_json(root / conf["file"])
    field = pb / "fields" / f"{field_name(config)}.py"
    return Cell(name=name, workload=wl, config=config,
                mix=load_json(pb / "mixes" / f"{wl['traffic']}.json"),
                limits=load_json(pb / "limits" / f"{name}.json"), spec=spec,
                pb=pb, field=load_module(field) if field.is_file() else None)


def field_name(config: dict) -> str:
    return config.get("field", DEFAULT_FIELD)


def refusal(cell: Cell) -> str | None:
    """Why the cell's field cannot run its configuration's model, in one
    line; None when it can."""
    name = field_name(cell.config)
    if cell.field is None:
        return (f"configuration {cell.workload['config']!r} names field "
                f"{name!r}; add {BENCH_DIR}/fields/{name}.py")
    model = cell.config["config"]["model"]
    for key, runs in cell.field.RUNS.items():
        if model.get(key) not in runs:
            return (f"field {name!r} does not run {key} {model.get(key)!r}; "
                    f"add {BENCH_DIR}/fields/<name>.py and name it in the "
                    f"configuration")
    return None


def _for_cell(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def end_to_end_for(spec: dict, cell: str) -> list[dict]:
    return [m for m in spec["end_to_end"] if _for_cell(m, cell)]


def per_layer_for(spec: dict, cell: str) -> list[dict]:
    """A metric with ``workloads`` is this cell's if it lists the cell;
    one without, if the cell reports the end-to-end metric it moves."""
    e2e = {m["name"] for m in end_to_end_for(spec, cell)}
    return [m for m in spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


def load_module(path: pathlib.Path):
    """A file found by name (names may hold dots) as a module."""
    mod_name = "portbench_" + path.parent.name + "_" + \
        path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Ctx:
    """What a per-layer reader reads: the reduced trace, what the traced
    units did, and the card's peaks."""

    def __init__(self, pb: pathlib.Path, trace, work: dict,
                 peak: dict | None):
        self.pb, self.trace, self.work, self.peak = pb, trace, work, peak
        self.units = int(work.get("units", 0))

    def count(self, name: str) -> dict:
        """``portbench/counts/<name>.py``'s count of the traced units:
        {"flops", "bytes", ...}."""
        return load_module(self.pb / "counts" / f"{name}.py").count(
            self.work)

    def least_s(self, count: dict) -> float:
        """The least time of ``count`` on the card: the larger of its
        operations over the peak rate and its bytes over the bandwidth."""
        return max(count["flops"] / self.peak["flops_per_s"],
                   count["bytes"] / self.peak["bytes_per_s"])


def card_peak(pb: pathlib.Path, kind: str) -> dict | None:
    for entry in load_json(pb / "peaks.json")["cards"]:
        if entry["match"] in kind:
            return entry
    return None


def read_per_layer(spec: dict, cell: str, ctx: Ctx) -> dict:
    out = {}
    for m in per_layer_for(spec, cell):
        value = load_module(ctx.pb / "metrics" / f"{m['name']}.py").read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_loaded() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is
    JAX's or the JAX package's, compared whole."""
    return sorted({n.split(".", 1)[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="One run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, device=None, hooks=None, root=None,
         t_start: float | None = None) -> int:
    """One run; returns the exit code. ``device``, ``hooks`` and ``root``
    are for the tests: a CPU device skips the look for a card, and
    ``hooks.program`` may break the program under test."""
    from portbench import common

    if t_start is None:
        t_start = time.time() - common.process_age_s()
    args = parse_args(argv)
    root = pathlib.Path(root or os.getcwd())
    cell = load_cell(root, args.workload)
    refused = refusal(cell)
    if refused:
        print(f"portbench: {refused}", file=sys.stderr)
        return 2
    import torch

    if device is None:
        chips = int(cell.workload["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"portbench: {cell.name} needs {chips} CUDA device(s); "
                  f"found {torch.cuda.device_count()}", file=sys.stderr)
            return 2
        device = "cuda"
    dev = torch.device(device)
    driver = importlib.import_module(f"portbench.drive_{cell.mix['kind']}")
    with contextlib.redirect_stdout(common.NullWriter()):
        out = driver.run(cell, args.seed, args.seconds, bool(args.trace), dev,
                         hooks=hooks, t_start=t_start)
    bad = forbidden_loaded()
    if bad:
        print(f"portbench: loaded once the window had closed: {bad}",
              file=sys.stderr)
        return 3
    from portbench import checks

    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    device_rec = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                  "kind": kind, "count": int(cell.workload["chips"]),
                  "memory_peak_bytes": out.memory_peak_bytes}
    result = {"correct": False, "attempted": out.attempted,
              "failed": out.failed}
    if args.trace:
        ctx = Ctx(cell.pb, out.trace, out.work, card_peak(cell.pb, kind))
        result["metrics"] = read_per_layer(cell.spec, cell.name, ctx)
        device_rec["busy_s"] = out.trace.busy_s
        device_rec["window_s"] = out.trace.window_s
    else:
        units = {m["name"]: m["unit"]
                 for m in end_to_end_for(cell.spec, cell.name)}
        result["metrics"] = {k: {"value": float(out.end_to_end[k]),
                                 "unit": units[k]} for k in units}
    result["device"] = device_rec
    if args.trace:
        result["breakdown"] = {"device_ops": out.trace.device_ops,
                               "idle_gaps": out.trace.idle_gaps}
    result["correct"] = bool(out.failed == 0
                             and checks.within(out.numbers, cell.limits))
    result["checks"] = checks.report(out.numbers, cell.limits)
    for name in sorted(set(out.numbers) - set(cell.limits)):
        print(f"reading {name}: {out.numbers[name]!r} (not compared)",
              file=sys.stderr)
    for name in sorted(set(cell.limits) - set(out.numbers)):
        print(f"check {name}: no reading, limit {cell.limits[name]}",
              file=sys.stderr)
    for name, rec in result["checks"].items():
        print(f"check {name}: {rec['value']!r} limit {rec['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
