"""Per cent of the sample slots the field encoded in frames that compositing
can weight (the program's render.live over render.slots); moves
frame_ms_p50."""

from portbench import spans


def read(ctx):
    return spans.live_share(ctx, "frame")
