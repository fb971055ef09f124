"""Per cent of the sample slots the field encoded in training steps that
compositing can weight (the program's render.live over render.slots);
moves train_rays_per_s."""

from portbench import spans


def read(ctx):
    return spans.live_share(ctx, "step")
