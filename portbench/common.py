"""Pieces shared by the harness and the traffic drivers."""

from __future__ import annotations

import contextlib
import gc
import os
from dataclasses import dataclass, field

import torch

from portbench import tracing


class NullWriter:
    """A text sink: the program's per-frame log lines go here, so that
    the run's standard output ends in its result line alone."""

    def write(self, text: str) -> int:
        return len(text)

    def flush(self) -> None:
        pass


def process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``), 0.0 where
    that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


class SetupClock:
    """Seconds from the process's start to each named point of set-up,
    printed to standard error."""

    def __init__(self, t_start: float):
        self.t_start = t_start

    def mark(self, name: str) -> float:
        import sys
        import time

        at = time.time() - self.t_start
        print(f"setup {name}: {at:.3f} s", file=sys.stderr, flush=True)
        return at


class CollectorClock:
    """Times the interpreter's full garbage collections while open, for
    the window's report on standard error."""

    def __enter__(self):
        import gc
        import time

        self.pauses, self._t0 = [], None

        def callback(phase, info):
            if info.get("generation") != 2:
                return
            if phase == "start":
                self._t0 = time.perf_counter()
            elif self._t0 is not None:
                self.pauses.append((time.perf_counter() - self._t0) * 1e3)

        self._cb = callback
        gc.callbacks.append(callback)
        return self

    def __exit__(self, *exc):
        import gc
        import sys

        gc.callbacks.remove(self._cb)
        print(f"window: {len(self.pauses)} full collections, "
              f"{sum(self.pauses):.1f} ms in all, longest "
              f"{max(self.pauses, default=0.0):.1f} ms", file=sys.stderr)


def window_profile(lat_ms: list) -> None:
    """The window's frame latencies, to standard error: the median of
    each fifth of the window, and the five longest with their places."""
    import sys

    import numpy as np

    lat = np.asarray(lat_ms)
    fifths = [float(np.median(p)) for p in np.array_split(lat, 5) if len(p)]
    worst = np.argsort(lat)[::-1][:5]
    print(f"window: {len(lat)} frames; median ms by fifth "
          f"{[round(f, 2) for f in fifths]}; longest "
          f"{[(int(i), round(float(lat[i]), 2)) for i in worst]}",
          file=sys.stderr)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def free(dev: torch.device) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def memory_peak(dev: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" \
        else 0


@contextlib.contextmanager
def profiled(enabled: bool, dev: torch.device):
    """``torch.profiler`` over the block when ``enabled`` (CPU, and CUDA
    on a card), the block recorded as :data:`tracing.WINDOW_SPAN`;
    yields a holder whose ``trace`` is the reduced :class:`tracing.Trace`
    once the block has ended, None when not enabled."""
    holder = type("Traced", (), {"trace": None})()
    if not enabled:
        yield holder
        return
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync(dev)
    try:
        prof = profile(activities=acts, acc_events=True)
    except TypeError:           # a torch without acc_events
        prof = profile(activities=acts)
    with prof:
        with record_function(tracing.WINDOW_SPAN):
            yield holder
            sync(dev)
    holder.trace = tracing.reduce(prof)


def span(name: str, enabled: bool):
    """A ``record_function`` span of the harness's own, when tracing."""
    if not enabled:
        return contextlib.nullcontext()
    from torch.profiler import record_function
    return record_function(name)


@dataclass
class Outcome:
    """What a driver hands back to the harness."""
    end_to_end: dict                 # metric name -> value
    attempted: int
    failed: int
    setup_s: float
    memory_peak_bytes: int
    numbers: dict                    # compared number -> value
    trace: tracing.Trace | None = None
    work: dict = field(default_factory=dict)   # what the traced units did
    controls: dict = field(default_factory=dict)   # control -> numbers


# the controls of ``portbench/control.py``: the reference put in the
# program's place one precision step below what the configuration states
CONTROLS = ("fp8_table", "tf32")


@contextlib.contextmanager
def control_precision(name: str, stated: torch.dtype):
    """Yields the table dtype of control ``name``, with the matmul
    precision it asks for set while it runs: ``fp8_table`` reads the
    bfloat16 feature table in float8 (e4m3); ``tf32`` lets the float32
    matrix products run in TF32."""
    if name not in CONTROLS:
        raise ValueError(f"unknown control {name!r}; one of {CONTROLS}")
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = name == "tf32"
    try:
        yield torch.float8_e4m3fn if name == "fp8_table" else stated
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
