"""Share of page_index's roofline in frames (counts/page_index.py);
moves frame_ms_p50. Reads nothing where the program has no such kernel."""

from portbench import readers


def read(ctx):
    return readers.roofline(ctx, "frame", "page_index")
