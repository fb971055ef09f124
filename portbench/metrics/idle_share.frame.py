"""Per cent of the traced frame window with nothing on the device; moves
frame_ms_p50."""

from portbench import readers


def read(ctx):
    return readers.idle_share(ctx, "frame")
