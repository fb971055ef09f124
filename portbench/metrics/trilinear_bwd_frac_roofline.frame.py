"""Share of trilinear_bwd_frac's roofline in mode-1 frames
(counts/trilinear_bwd_frac.py); moves frame_ms_p50."""

from portbench import readers


def read(ctx):
    return readers.roofline(ctx, "frame", "trilinear_bwd_frac")
