"""Device ms per training step in the program's compute_runs span (the
encode's run dedup); moves train_rays_per_s."""

from portbench import readers


def read(ctx):
    return readers.span_device_ms(ctx, "step", "compute_runs")
