"""Host ms a frame in the program's serve.resize span (the service's resize
of the node's frame to the render size); moves frame_ms_p50."""

from portbench import spans


def read(ctx):
    return spans.host_ms(ctx, "frame", "serve.resize")
