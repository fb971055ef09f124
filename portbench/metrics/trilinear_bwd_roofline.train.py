"""Share of trilinear_bwd's roofline in training steps
(counts/trilinear_bwd.py); moves train_rays_per_s."""

from portbench import readers


def read(ctx):
    return readers.roofline(ctx, "step", "trilinear_bwd")
