"""Reduction of a ``torch.profiler`` trace of the measured window to what
the per-layer readers and the result line need: the device's busy
intervals, the CUDA runtime's launch calls, device time by kernel name
and inside the program's ``record_function`` spans, and the breakdown
(device operations by time, idle gaps by what the host was doing).

The window is the CPU range of the harness's own span
:data:`WINDOW_SPAN`; device intervals are clipped to it.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import torch

WINDOW_SPAN = "portbench.window"
# CUDA runtime / driver calls that put work on the device
LAUNCH_CALLS = frozenset({
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
    "cuLaunchKernelEx", "cudaLaunchCooperativeKernel", "cudaGraphLaunch",
    "cudaMemcpy", "cudaMemcpyAsync", "cudaMemcpy2DAsync",
    "cudaMemcpyPeerAsync", "cudaMemset", "cudaMemsetAsync",
    "cudaMemset2DAsync"})
TOP = 10


@dataclass
class Trace:
    """One traced window: ``units`` steps or frames over ``window_s``."""
    window_s: float
    busy_s: float
    launches: int
    device: list = field(default_factory=list)    # (start_us, end_us, name)
    spans: dict = field(default_factory=dict)     # span -> (calls, device_s)
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)

    def kernel_s(self, names: tuple[str, ...]) -> float:
        """Device seconds of the kernels whose function name is one of
        ``names`` (a whole identifier inside the demangled name)."""
        pat = re.compile(r"\b(" + "|".join(map(re.escape, names)) + r")\b")
        return sum(e - s for s, e, n in self.device if pat.search(n)) / 1e6


def union_s(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals (microseconds in,
    seconds out)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e6


def gaps(intervals: list[tuple[float, float]], w0: float, w1: float
         ) -> list[tuple[float, float]]:
    """The idle stretches of [w0, w1] between the intervals."""
    out, t = [], w0
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, w1)))
        t = max(t, e)
        if t >= w1:
            break
    if t < w1:
        out.append((t, w1))
    return [(s, e) for s, e in out if e > s]


def label_gaps(gap_list, cpu: list[tuple[float, float, str]]) -> list:
    """Idle seconds by the innermost host operation running at each gap's
    middle (the latest-started one not yet ended), largest first, at most
    :data:`TOP`. One sweep over the operations in order of start."""
    cpu = sorted(cpu)
    by, stack, k = {}, [], 0
    for s, e in sorted(gap_list):
        mid = 0.5 * (s + e)
        while k < len(cpu) and cpu[k][0] <= mid:
            stack.append(cpu[k])
            k += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        name = stack[-1][2] if stack else "host outside any operation"
        by[name] = by.get(name, 0.0) + (e - s) / 1e6
    return sorted(([n[:96], v] for n, v in by.items()),
                  key=lambda kv: -kv[1])[:TOP]


def _is_device(evt) -> bool:
    return evt.device_type == torch.autograd.DeviceType.CUDA


def _is_span(evt) -> bool:
    """A ``record_function`` range (the profiler shows it on the host
    and again over the device's kernels), not an operation."""
    return bool(getattr(evt, "is_user_annotation", False))


def _device_us(evt) -> float:
    us = getattr(evt, "device_time_total", None)
    return evt.cuda_time_total if us is None else us


def reduce(prof, spans: tuple[str, ...] = ("compute_runs",)) -> Trace:
    """The :class:`Trace` of a finished profiler whose window was
    recorded under :data:`WINDOW_SPAN`."""
    events = prof.events()
    cpu_type = torch.autograd.DeviceType.CPU
    windows = [e for e in events
               if e.name == WINDOW_SPAN and e.device_type == cpu_type]
    if len(windows) != 1:
        raise RuntimeError(f"the trace holds {len(windows)} "
                           f"'{WINDOW_SPAN}' spans, not 1")
    w0, w1 = windows[0].time_range.start, windows[0].time_range.end
    host_spans = {e.name for e in events
                  if e.device_type == cpu_type and _is_span(e)}
    device, cpu, launches = [], [], 0
    span_acc = {name: [0, 0.0] for name in spans}
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if _is_device(e):
            if _is_span(e) or e.name in host_spans:
                continue
            s, t = max(s, w0), min(t, w1)
            if t > s:
                device.append((s, t, e.name))
            continue
        if e.device_type != cpu_type or t < w0 or s > w1 or e is windows[0]:
            continue
        if e.name in LAUNCH_CALLS:
            launches += 1
        if e.name in span_acc:
            acc = span_acc[e.name]
            acc[0] += 1
            acc[1] += sum(_device_us(c) for c in e.cpu_children) / 1e6
        cpu.append((s, t, f"{e.name} (between operations)" if _is_span(e)
                    else e.name))
    intervals = [(s, t) for s, t, _ in device]
    by_name = {}
    for s, t, n in device:
        by_name[n] = by_name.get(n, 0.0) + (t - s) / 1e6
    return Trace(
        window_s=(w1 - w0) / 1e6, busy_s=union_s(intervals),
        launches=launches, device=device,
        spans={k: tuple(v) for k, v in span_acc.items() if v[0]},
        device_ops=sorted(([k[:96], v] for k, v in by_name.items()),
                          key=lambda kv: -kv[1])[:TOP],
        idle_gaps=label_gaps(gaps(intervals, w0, w1), cpu))
