"""CUDA runtime launch, copy and set calls per frame; moves frame_ms_p50."""

from portbench import readers


def read(ctx):
    return readers.launch_calls(ctx, "frame")
