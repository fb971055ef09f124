"""The program's spans and counters, and the profiler window that
exports them.

Spans and counters follow ``torch.profiler``: while a profiler records
on the calling thread (``torch.autograd._profiler_enabled()``, which the
autograd engine's threads inherit), :func:`span` is a
``torch.profiler.record_function`` range, so it shares the profiler's
clock with the device's kernels, and :func:`count` adds to a total.
Otherwise each is one check of that flag and nothing more: no setting
or environment variable switches them.

While a CUDA graph is captured (:func:`capturing`) they follow the
capture instead, profiler or not. A capture that records the counters
has :func:`enabled` true, and :func:`count` records its ``(name,
value)`` pairs: the values the graph's replays recompute, which
:func:`add` adds to the totals after each replay while a profiler
records. A capture that does not has :func:`enabled` false, so the
counters' device work stays out of that graph. Spans are off in either:
a graph's replay runs no host code.

While it records, a span also keeps its host duration, and a counter
its total, per process: :func:`host_durations` and :func:`counts` read
them, :func:`reset` clears them. A total stays on the device until
:func:`counts` reads it, with one synchronize.

Names are the profile's labels and what readers of a profile look up:
``compute_runs`` (the encode's run dedup), ``warp_points`` with the
counters ``warp.points`` and ``warp.clamped`` (the points the
perspective warp mapped, and those with a coordinate at its clamp),
``mesh/broadcast`` and ``mesh/all_reduce``, and the layer boundaries:

* ``serve.localize`` (a frame's root) holding ``serve.resize``,
  ``serve.render_reply``, ``serve.score``, ``serve.reply``; the counter
  ``serve.resize_card`` (frames resized on the card); ``localize.draw``, ``localize.weigh``, ``localize.fuse``,
  ``localize.pose_grad``;
* ``step`` (a training step's root) holding ``step.noise``,
  ``step.refresh``, ``step.forward``, ``step.backward``,
  ``step.optimizer`` in an eager step, ``step.noise`` and
  ``step.replay`` in a step that replays a CUDA graph; the counter
  ``step.graphed`` (steps served by a replay);
* ``render.sample``, ``render.field``, ``render.shade``,
  ``render.composite``; the counters ``render.live`` and
  ``render.slots`` (sample slots that compositing can weight, and every
  slot the field encoded).
"""

from __future__ import annotations

import contextlib
import pathlib
import threading
import time

import torch

_OFF = contextlib.nullcontext()
_durations: dict[str, list[float]] = {}
_totals: dict[str, torch.Tensor | int] = {}
_lock = threading.Lock()
# inside :func:`capturing`: the capture's recorded pairs, or None
_capturing = False
_pairs: list | None = None


def enabled() -> bool:
    """True while a profiler records on this thread; inside
    :func:`capturing`, while the capture records the counters."""
    if _capturing:
        return _pairs is not None
    return torch.autograd._profiler_enabled()


class _Span:
    __slots__ = ("name", "_range", "_t0")

    def __init__(self, name: str):
        self.name = name
        self._range = torch.profiler.record_function(name)

    def __enter__(self):
        self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self._t0
        self._range.__exit__(*exc)
        _durations.setdefault(self.name, []).append(seconds)
        return False


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler
    records; a shared no-op context otherwise. The spans of one unit are
    those inside its root span's range. Off inside :func:`capturing`."""
    if _capturing or not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name)


def count(name: str, value: torch.Tensor | int) -> None:
    """Add ``value`` (a tensor, left on its device, or an int) to the
    total ``name`` while a profiler records; during a capture, record
    the pair instead, if it records the counters; nothing otherwise. A
    call site whose value costs device work checks :func:`enabled`
    first."""
    if _capturing:
        if _pairs is not None:
            _pairs.append((name, value))
        return
    if not torch.autograd._profiler_enabled():
        return
    with _lock:
        _totals[name] = _totals[name] + value if name in _totals else value


@contextlib.contextmanager
def capturing(record: bool):
    """Around a CUDA graph's capture. With ``record``, :func:`enabled`
    is true and :func:`count` appends its pairs to the yielded list;
    without, :func:`enabled` is false and the block yields None."""
    global _capturing, _pairs
    _capturing, _pairs = True, [] if record else None
    try:
        yield _pairs
    finally:
        _capturing, _pairs = False, None


def add(pairs) -> None:
    """:func:`count` each recorded ``(name, value)`` pair after a
    graph's replay: a copy of each tensor value, since the value is the
    graph's output, which the next replay overwrites."""
    for name, value in pairs:
        count(name, value.clone() if torch.is_tensor(value) else value)


def counts() -> dict[str, float]:
    """Every counter's total, as floats (one synchronize)."""
    with _lock:
        items = list(_totals.items())
    return {k: float(v) for k, v in items}


def host_durations() -> dict[str, list[float]]:
    """Host seconds of each recorded span, per name, in order of exit."""
    return {k: list(v) for k, v in _durations.items()}


def reset() -> None:
    """Clear the spans' durations and the counters' totals."""
    with _lock:
        _durations.clear()
        _totals.clear()


class Window:
    """``torch.profiler`` over units ``[first, last)`` of a loop, written
    as one Chrome trace ``<out_dir>/<name>_<first>_<last><suffix>.json``.

    Call :meth:`tick` with each unit's number before the unit runs: it
    opens the profiler at ``first`` and, at ``last``, waits for the
    device, closes it and writes the trace. The profiler records the
    thread that opened it (and the autograd engine's threads); a tick
    from another thread does nothing. ``out_dir`` None: no window."""

    def __init__(self, out_dir: str | pathlib.Path | None,
                 units: tuple[int, int], name: str, suffix: str = ""):
        self.out_dir = pathlib.Path(out_dir) if out_dir else None
        self.first, self.last = units
        self.path = (None if self.out_dir is None else self.out_dir
                     / f"{name}_{self.first}_{self.last}{suffix}.json")
        self._prof = None
        self._thread = None

    def tick(self, unit: int, device: torch.device) -> None:
        if self.out_dir is None:
            return
        if unit == self.first and self._prof is None:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
            self._thread = threading.get_ident()
        elif (unit == self.last and self._prof is not None
              and self._thread == threading.get_ident()):
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            self._prof.__exit__(None, None, None)
            self.out_dir.mkdir(parents=True, exist_ok=True)
            self._prof.export_chrome_trace(str(self.path))
            self._prof = None
