"""Work of the traced frames as a whole, for ``mfu.frame``.

Operations: every sample's forward (encode, head, shader, compositing)
of the particles' pixels (mode 0) or of the differential render (mode
1), and of the reply's full-frame render; in mode 1 the backward to the
points (the point gradient's interpolation and the head's and shader's
products for their inputs' gradients). Bytes, each read or written once:
each sample's encode inputs and outputs, and in mode 1 the points'
gradients (the table at its lower bound, nothing).
"""

from portbench import work as W


def count(work: dict) -> dict:
    fwd = W.forward_samples(work)
    back = W.point_grad_samples(work)
    lv, c = work["levels"], work["channels"]
    flops = (fwd * W.forward_flops(work)
             + back * (lv * (6 + 8 * (2 * c + 9)) + W.matmul_flops(work)
                       + W.POINTWISE_FLOPS))
    nbytes = (fwd + back) * W.encode_bytes(work) + back * 3 * 4
    return {"flops": flops, "bytes": nbytes}
