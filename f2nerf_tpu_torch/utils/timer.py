"""Timing utilities (port of ``f2nerf_tpu/utils/timer.py``).

Reference ``src/stop_watch.{hpp,cpp}``: ``ScopeWatch`` (a wall-clock
scope with a CUDA sync) and ``Timer``. PyTorch returns before the card
finishes, so a scope that should include device work synchronizes the
device of the tensors it is given (``torch.cuda.synchronize``).
"""

from __future__ import annotations

import contextlib
import time

import torch


class Timer:
    """Reference Timer (stop_watch.hpp:22-35)."""

    def __init__(self):
        self._t0 = time.monotonic()

    def start(self) -> None:
        self._t0 = time.monotonic()

    def elapsed_seconds(self) -> float:
        return time.monotonic() - self._t0


@contextlib.contextmanager
def scope_watch(name: str, sync_on=None, printer=print):
    """Timing scope (reference ScopeWatch, stop_watch.cpp:11-25).

    Args:
      name: scope label.
      sync_on: optional tensor or (nested) dict / list of tensors; the
        devices they live on are synchronized before the stop, so device
        work inside the scope is included.
    """
    t0 = time.monotonic()
    try:
        yield
    finally:
        if sync_on is not None:
            device_sync(sync_on)
        printer(f"[{name}] {time.monotonic() - t0:.4f} s")


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def device_sync(x) -> None:
    """Wait for the device work queued on the CUDA devices that hold the
    tensors in ``x``; CPU tensors need no wait."""
    for dev in {t.device for t in _tensors(x) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


class StepTimer:
    """Per-step EMA timer for training loops; negligible overhead, syncs
    only when asked."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.ema: float | None = None
        self._t0: float | None = None

    def tic(self) -> None:
        self._t0 = time.monotonic()

    def toc(self) -> float:
        dt = time.monotonic() - (self._t0 or time.monotonic())
        self.ema = dt if self.ema is None else (
            self.alpha * dt + (1 - self.alpha) * self.ema)
        return dt
