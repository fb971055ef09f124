"""Host ms a frame in the program's localize.draw span (the particles' poses
drawn on the host); moves frame_ms_p50."""

from portbench import spans


def read(ctx):
    return spans.host_ms(ctx, "frame", "localize.draw")
