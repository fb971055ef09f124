"""Per cent of the traced training steps that the program served by
replaying a CUDA graph (its step.graphed counter over the traced steps);
moves train_rays_per_s."""

from portbench import spans
from portbench.readers import _units

GRAPHED = "step.graphed"


def read(ctx):
    n, trace = _units(ctx, "step"), spans._program_trace()
    if not n or trace is None:
        return None
    graphed = trace.counts().get(GRAPHED)
    if graphed is None:
        return None
    return 100.0 * graphed / n
