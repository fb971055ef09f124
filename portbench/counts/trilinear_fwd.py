"""Work of ``trilinear_fwd`` (the encode's forward, ``kernels/csrc/
trilinear_fwd.cu``): every (sample, level) pair the traced units encode.

Operations: the trilinear weights and the 8-corner interpolation of C
channels per pair. Bytes, each read or written once: the sample's 3
float32 coordinates in, its L*C float32 features out. The feature table
is counted at its lower bound that shapes alone give: nothing, since
which rows a sample set touches, and how often the cache serves them, is
data. So the least time is a floor that no implementation can pass.
"""

from portbench import work as W

KERNELS = ("trilinear_fwd_kernel",)


def count(work: dict) -> dict:
    n = W.forward_samples(work)
    lv, c = work["levels"], work["channels"]
    return {"flops": n * lv * W.interp_flops(c),
            "bytes": n * (3 * 4 + lv * c * 4), "kernels": KERNELS}
