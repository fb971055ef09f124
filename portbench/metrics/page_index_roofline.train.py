"""Share of page_index's roofline in training steps
(counts/page_index.py); moves train_rays_per_s. Reads nothing where the
program has no such kernel."""

from portbench import readers


def read(ctx):
    return readers.roofline(ctx, "step", "page_index")
