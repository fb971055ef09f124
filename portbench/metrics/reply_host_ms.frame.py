"""Host ms a frame in the program's serve.reply span (the reply's pose, dict
and the rendered image's tolist); moves frame_ms_p50."""

from portbench import spans


def read(ctx):
    return spans.host_ms(ctx, "frame", "serve.reply")
