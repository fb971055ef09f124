"""Work of ``page_index`` (the encode's index, ``kernels/csrc/
page_index.cu``): every (sample, level) pair the traced units encode,
the same pairs as ``trilinear_fwd``'s, the refresh's included.

Operations per pair: on each of the 3 axes the scale's product and the
bias's sum, the floor, the fraction's difference, the conversion to an
integer, the mask of the local cell, its conversion to a float and the
block's shift (8); then the hash's two products, two sums, remainder
and page offset (6): 30. Bytes, each read or written once: the sample's
3 float32 coordinates in; per level the int32 page index and the 6
float32 of local cell and fractions out.
"""

from portbench import work as W

KERNELS = ("page_index_kernel",)
PAIR_OPS = 3 * 8 + 6


def count(work: dict) -> dict:
    n = W.forward_samples(work)
    lv = work["levels"]
    return {"flops": n * lv * PAIR_OPS,
            "bytes": n * (3 * 4 + lv * (4 + 6 * 4)), "kernels": KERNELS}
