"""Share of trilinear_fwd's roofline in frames (counts/trilinear_fwd.py);
moves frame_ms_p50."""

from portbench import readers


def read(ctx):
    return readers.roofline(ctx, "frame", "trilinear_fwd")
