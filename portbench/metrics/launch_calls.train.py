"""CUDA runtime launch, copy and set calls per training step (what a CUDA
graph of the step would collapse); moves train_rays_per_s."""

from portbench import readers


def read(ctx):
    return readers.launch_calls(ctx, "step")
