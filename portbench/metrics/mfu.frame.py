"""The frames' least time on the card (counts/localize_frame.py) over their
wall time, per cent; moves frame_ms_p50."""

from portbench import readers


def read(ctx):
    return readers.mfu(ctx, "frame", "localize_frame")
