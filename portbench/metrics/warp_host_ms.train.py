"""Host ms a training step in the program's warp_points span (the
perspective warp of the step's samples and of the refresh's grid
points); moves train_rays_per_s."""

from portbench import spans


def read(ctx):
    return spans.host_ms(ctx, "step", "warp_points")
