"""Work of ``trilinear_bwd`` (the page gradient of training, ``kernels/
csrc/trilinear_bwd.cu``: the ``trilinear_bwd_tiles`` and
``trilinear_bwd_merge`` kernels; the wrapper's zero-fill and stable sort
are glue outside this count and outside its time).

Operations: per (sample, level) pair the trilinear weights and the 8
corners' C products and sums into the gradient. Bytes, each read or
written once: the sample's 3 float32 coordinates and the pair's C
float32 cotangents in. The gradient table is counted at the lower bound
that shapes alone give, nothing: which pages a batch touches is data.
"""

from portbench import work as W

KERNELS = ("trilinear_bwd_tiles", "trilinear_bwd_merge")


def count(work: dict) -> dict:
    n = W.table_grad_samples(work)
    lv, c = work["levels"], work["channels"]
    return {"flops": n * lv * W.interp_flops(c),
            "bytes": n * (3 * 4 + lv * c * 4), "kernels": KERNELS}
