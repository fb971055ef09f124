"""Host ms a training step in the program's step.forward span (the loss
function: rays, render, losses); moves train_rays_per_s."""

from portbench import spans


def read(ctx):
    return spans.host_ms(ctx, "step", "step.forward")
