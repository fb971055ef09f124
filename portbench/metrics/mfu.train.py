"""The training steps' least time on the card (counts/train_step.py) over
their wall time, per cent; moves train_rays_per_s."""

from portbench import readers


def read(ctx):
    return readers.mfu(ctx, "step", "train_step")
