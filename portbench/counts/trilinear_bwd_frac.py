"""Work of ``trilinear_bwd_frac`` (the point gradient of the localizer's
differential step, ``kernels/csrc/trilinear_bwd_frac.cu``).

Operations: per (sample, level) pair the weights and their derivatives
(6), and per corner a C-channel dot product with the cotangent (2C) and
the three partial products of the weights (9). Bytes, each read or
written once: the sample's 3 float32 coordinates in and its 3 float32
coordinate gradients out, the pair's C float32 cotangents in; the table
at the lower bound that shapes alone give, nothing.
"""

from portbench import work as W

KERNELS = ("trilinear_bwd_frac_kernel",)


def count(work: dict) -> dict:
    n = W.point_grad_samples(work)
    lv, c = work["levels"], work["channels"]
    return {"flops": n * lv * (6 + 8 * (2 * c + 9)),
            "bytes": n * (3 * 4 + 3 * 4 + lv * c * 4), "kernels": KERNELS}
