"""Host ms a training step in the program's step.backward span (the
backward call, with the all-reduce where there is a mesh); moves
train_rays_per_s."""

from portbench import spans


def read(ctx):
    return spans.host_ms(ctx, "step", "step.backward")
