"""Per cent of the points the program's perspective warp mapped in
training steps that reached its clamp at 1.999 on some axis (the
program's warp.clamped over warp.points): the share of the samples and
grid points that no chart of the trajectory holds inside the hash
domain; moves train_rays_per_s."""

from portbench import spans
from portbench.readers import _units

POINTS, CLAMPED = "warp.points", "warp.clamped"


def read(ctx):
    trace = spans._program_trace()
    if not _units(ctx, "step") or trace is None:
        return None
    totals = trace.counts()
    if not totals.get(POINTS):
        return None
    return 100.0 * totals.get(CLAMPED, 0.0) / totals[POINTS]
