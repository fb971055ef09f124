"""The program's own spans and counters (``f2nerf_tpu_torch/utils/
trace.py``): what the ``program_span`` and ``program_counter`` readers
read, and a traced run that charges device time and idle time to them.

Readers. While the harness's profiler records, each span of the program
keeps its host duration and each counter its total, per process;
:func:`host_ms` and :func:`live_share` read them after the window. A
program without that module (an older checkout) gives nothing to read:
the readers return None.

A traced run with the attribution::

    python3 portbench/spans.py --workload <cell> --seed <n> \\
        --seconds <s> [--out <file.json>]

runs the cell as ``run.py --trace 1`` does and prints its result line,
then one JSON line (also written to ``--out``): per span name, its calls,
host ms a unit and the device ms a unit of the kernels launched while
it was open on the host, from any thread (:func:`device_by_span`), with
its largest kernels by name, and
the window's idle time by the innermost host operation at each gap,
summed over every gap and split by whether the gap lies inside the
unit's root span (:func:`idle_by_label`).
"""

from __future__ import annotations

import argparse
import bisect
import json
import pathlib
import statistics
import sys

if __name__ == "__main__":
    # the repository's root, not this folder, heads the import path
    sys.path[0] = str(pathlib.Path(__file__).resolve().parents[1])

from portbench.readers import _units  # noqa: E402

# the program's root spans, then the harness's, which stand in for them
# where the program has none
ROOTS = ("serve.localize", "step", "portbench.frame", "portbench.step")
# the renderer's counters: sample slots compositing can weight, and all
LIVE, SLOTS = "render.live", "render.slots"


def _program_trace():
    try:
        from f2nerf_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace


def host_ms(ctx, unit: str, span: str):
    """Host ms a unit in the program's span ``span``: the median of its
    calls' host durations times its calls a unit (a median, so that one
    full collection inside a call does not set it)."""
    n, trace = _units(ctx, unit), _program_trace()
    if not n or trace is None:
        return None
    seconds = trace.host_durations().get(span)
    if not seconds:
        return None
    return statistics.median(seconds) * 1e3 * len(seconds) / n


def live_share(ctx, unit: str):
    """Per cent of the sample slots the field encoded that compositing
    can weight (the program's ``render.live`` over ``render.slots``)."""
    trace = _program_trace()
    if not _units(ctx, unit) or trace is None:
        return None
    totals = trace.counts()
    if not totals.get(SLOTS):
        return None
    return 100.0 * totals.get(LIVE, 0.0) / totals[SLOTS]


def _union(intervals):
    """Sorted, disjoint [start, end) intervals covering ``intervals``."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _inside(union, starts, t: float) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t < union[i][1]


def device_by_span(spans, kernels) -> dict[str, float]:
    """Device seconds by span name: each kernel counts toward every name
    one of whose spans was open on the host, on any thread, when the
    kernel's launch call was made.

    spans: (start_us, end_us, name) host intervals; kernels:
    (launch_us, device_us) pairs, the launch call's host time and the
    kernel's device duration."""
    by_name: dict[str, list] = {}
    for s, e, name in spans:
        by_name.setdefault(name, []).append((s, e))
    out = {}
    for name, intervals in by_name.items():
        union = _union(intervals)
        starts = [s for s, _ in union]
        out[name] = sum(d for t, d in kernels
                        if _inside(union, starts, t)) / 1e6
    return out


def gap_labels(gap_list, cpu):
    """(label, start_us, end_us) of each idle gap: the innermost host
    operation running at its middle, as ``tracing.label_gaps`` names it,
    for every gap."""
    cpu = sorted(cpu)
    stack, k = [], 0
    for s, e in sorted(gap_list):
        mid = 0.5 * (s + e)
        while k < len(cpu) and cpu[k][0] <= mid:
            stack.append(cpu[k])
            k += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        yield (stack[-1][2] if stack else "host outside any operation",
               s, e)


def idle_by_label(gap_list, cpu, roots) -> dict:
    """The idle seconds of ``gap_list`` by label (every gap), and split
    by whether each gap's middle lies inside a ``roots`` interval
    (start_us, end_us): ``inside_s``, of it ``inside_root_self_s`` (the
    gaps labelled by the root span itself), and ``outside_s``."""
    union = _union(roots)
    starts = [s for s, _ in union]
    root_names = {f"{r} (between operations)" for r in ROOTS}
    by, inside, own, outside = {}, 0.0, 0.0, 0.0
    for label, s, e in gap_labels(gap_list, cpu):
        sec = (e - s) / 1e6
        by[label] = by.get(label, 0.0) + sec
        if _inside(union, starts, 0.5 * (s + e)):
            inside += sec
            own += sec if label in root_names else 0.0
        else:
            outside += sec
    return {"by_label": dict(sorted(by.items(), key=lambda kv: -kv[1])),
            "inside_s": inside, "inside_root_self_s": own,
            "outside_s": outside}


def attribute(prof, units: int, kernels: tuple[str, ...] = ()) -> dict:
    """The attribution of a finished harness profile (its window the
    ``tracing.WINDOW_SPAN`` range) over ``units`` units; ``kernels``
    names kernels whose device seconds are reported beside."""
    import re

    import torch

    from portbench import tracing

    cpu_t, cuda_t = (torch.autograd.DeviceType.CPU,
                     torch.autograd.DeviceType.CUDA)
    events = prof.events()
    window = next(e for e in events if e.name == tracing.WINDOW_SPAN
                  and e.device_type == cpu_t)
    w0, w1 = window.time_range.start, window.time_range.end
    launch_at, spans, cpu, device = {}, [], [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == cpu_t:
            if t < w0 or s > w1 or e is window:
                continue
            if e.name in tracing.LAUNCH_CALLS:
                launch_at[e.id] = s
            span = bool(getattr(e, "is_user_annotation", False))
            if span:
                spans.append((s, t, e.name))
            cpu.append((s, t, f"{e.name} (between operations)" if span
                        else e.name))
        elif (e.device_type == cuda_t
              and not getattr(e, "is_user_annotation", False)):
            device.append((e.id, s, t, e.name))
    names = {n for _, _, n in spans}
    device = [d for d in device if d[3] not in names]
    launched = [(launch_at[i], t - s) for i, s, t, _ in device
                if i in launch_at]
    dev_s = device_by_span(spans, launched)
    # each span's kernels by name, the TOP largest
    by_kernel: dict[str, list] = {}
    for i, s, t, n in device:
        if i in launch_at:
            by_kernel.setdefault(n[:96], []).append((launch_at[i], t - s))
    top: dict[str, dict] = {}
    for kernel, group in by_kernel.items():
        for span, sec in device_by_span(spans, group).items():
            if sec > 0.0:
                top.setdefault(span, {})[kernel] = sec * 1e3 / units
    host: dict[str, list] = {}
    for s, t, n in spans:
        host.setdefault(n, []).append((t - s) / 1e3)
    table = {n: {"calls": len(v), "host_ms_median": statistics.median(v),
                 "host_ms": statistics.median(v) * len(v) / units,
                 "device_ms": dev_s.get(n, 0.0) * 1e3 / units,
                 "top_kernels_ms": dict(sorted(
                     top.get(n, {}).items(), key=lambda kv: -kv[1])[
                         :tracing.TOP])}
             for n, v in sorted(host.items())}
    clipped = [(max(s, w0), min(t, w1)) for _, s, t, _ in device]
    clipped = [(s, t) for s, t in clipped if t > s]
    root = next((r for r in ROOTS if r in names), None)
    idle = idle_by_label(tracing.gaps(clipped, w0, w1), cpu,
                         [(s, t) for s, t, n in spans if n == root])
    pat = re.compile(r"\b(" + "|".join(map(re.escape, kernels)) + r")\b") \
        if kernels else None
    return {"units": units, "window_s": (w1 - w0) / 1e6,
            "busy_s": tracing.union_s(clipped), "root": root,
            "device_launches_matched": len(launched),
            "device_ops": len(device), "spans": table, "idle": idle,
            "kernels_ms": (sum(t - s for _, s, t, n in device
                               if pat.search(n)) / 1e3 / units
                           if pat else None)}


def main(argv=None, device=None, root=None) -> int:
    """One traced run and its attribution; returns the exit code.
    ``device`` and ``root`` as for ``harness.main`` (the tests')."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from portbench import harness, tracing

    kept = {}
    reduce, read = tracing.reduce, harness.read_per_layer

    def keep_profile(prof, *a, **k):
        kept["prof"] = prof
        return reduce(prof, *a, **k)

    def keep_ctx(spec, cell, ctx):
        kept["ctx"] = ctx
        return read(spec, cell, ctx)

    tracing.reduce, harness.read_per_layer = keep_profile, keep_ctx
    try:
        rc = harness.main(["--workload", args.workload, "--seed",
                           str(args.seed), "--seconds", str(args.seconds),
                           "--trace", "1"], device=device, root=root)
    finally:
        tracing.reduce, harness.read_per_layer = reduce, read
    if rc != 0:
        return rc
    ctx = kept["ctx"]
    bwd = harness.load_module(ctx.pb / "counts" / "trilinear_bwd.py")
    out = attribute(kept["prof"], ctx.units, bwd.KERNELS)
    out["workload"], out["seed"] = args.workload, args.seed
    out["unit_wall_ms_untraced"] = ctx.work["unit_wall_s"] * 1e3
    trace = _program_trace()
    if trace is not None:
        out["counts"] = trace.counts()
        out["program_host_ms"] = {
            n: statistics.median(v) * 1e3 * len(v) / ctx.units
            for n, v in sorted(trace.host_durations().items())}
    line = json.dumps(out)
    if args.out:
        path = pathlib.Path(args.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
