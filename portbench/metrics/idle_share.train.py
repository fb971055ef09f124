"""Per cent of the traced training window with nothing on the device; moves
train_rays_per_s."""

from portbench import readers


def read(ctx):
    return readers.idle_share(ctx, "step")
