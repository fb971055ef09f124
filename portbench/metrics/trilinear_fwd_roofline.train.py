"""Share of trilinear_fwd's roofline in training steps
(counts/trilinear_fwd.py); moves train_rays_per_s."""

from portbench import readers


def read(ctx):
    return readers.roofline(ctx, "step", "trilinear_fwd")
