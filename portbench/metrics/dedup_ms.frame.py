"""Device ms per frame in the program's compute_runs span (the encode's run
dedup); moves frame_ms_p50."""

from portbench import readers


def read(ctx):
    return readers.span_device_ms(ctx, "frame", "compute_runs")
