"""Work of the traced training steps as a whole, for ``mfu.train``.

Operations: every sample's forward (encode, head, shader, compositing),
its backward (the page gradient's interpolation, and the head's and the
shader's products for the gradients of their inputs and of their
weights), the refresh's density queries (encode and head), and Adam's
update (12 operations a parameter). Bytes, each read or written once:
each sample's encode inputs and outputs forward and backward (see
``trilinear_fwd.py``; the table at its lower bound, nothing), and Adam's
reads of the parameters, gradients and both moments and writes of the
parameters and both moments (7 float32 values a parameter).
"""

from portbench import work as W

ADAM_FLOPS, ADAM_BYTES = 12, 7 * 4


def count(work: dict) -> dict:
    n = work["units"] * W.samples(work["rays"], work)
    lv, c = work["levels"], work["channels"]
    refresh = work["refresh_steps"] * work["refresh_points"]
    head = 2 * lv * c * work["feat_dim"]
    flops = (n * (W.forward_flops(work) + lv * W.interp_flops(c)
                  + 2 * W.matmul_flops(work) + W.POINTWISE_FLOPS)
             + refresh * (lv * W.interp_flops(c) + head)
             + work["units"] * work["param_count"] * ADAM_FLOPS)
    nbytes = ((2 * n + refresh) * W.encode_bytes(work)
              + work["units"] * work["param_count"] * ADAM_BYTES)
    return {"flops": flops, "bytes": nbytes}
