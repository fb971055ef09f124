"""What the per-layer readers in ``portbench/metrics/`` share. Each
returns None where the run gives it nothing to read: another kind of
unit, no traced units, no such span or kernel in the trace, or no known
peak for the card."""

from __future__ import annotations


def _units(ctx, unit: str) -> int:
    if ctx.trace is None or ctx.work.get("unit") != unit:
        return 0
    return ctx.units


def launch_calls(ctx, unit: str):
    """CUDA runtime calls that put work on the device, per unit."""
    n = _units(ctx, unit)
    return ctx.trace.launches / n if n else None


def span_device_ms(ctx, unit: str, span: str):
    """Device ms per unit of the kernels launched in a program span."""
    n = _units(ctx, unit)
    if not n or span not in ctx.trace.spans:
        return None
    return ctx.trace.spans[span][1] * 1e3 / n


def idle_share(ctx, unit: str):
    """Per cent of the traced window in which the device ran nothing."""
    n = _units(ctx, unit)
    if not n:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def roofline(ctx, unit: str, kernel: str):
    """Per cent: the kernel's least time over its device time in the
    trace (by kernel name, over its launches)."""
    n = _units(ctx, unit)
    if not n or ctx.peak is None:
        return None
    count = ctx.count(kernel)
    seconds = ctx.trace.kernel_s(count["kernels"])
    if seconds <= 0.0 or count["flops"] <= 0:
        return None
    return 100.0 * ctx.least_s(count) / seconds


def mfu(ctx, unit: str, count_name: str):
    """Per cent: a unit's least time on the card over its wall time in
    the untraced rest of the window (the profiler slows the host)."""
    n = _units(ctx, unit)
    if not n or ctx.peak is None:
        return None
    least = ctx.least_s(ctx.count(count_name)) / n
    return 100.0 * least / ctx.work["unit_wall_s"]
