"""Counts of the encode's work from what the traced units did (the
``work`` dict of a driver), shared by ``portbench/counts/*.py``.

A (sample, level) pair is one point of one hash level. Every sample slot
the sampler gives a ray is encoded (the occupancy sampler's slots past a
ray's occupied segments included), so the counts are the same whatever
dedup, compaction or kernel does the work.
"""

from __future__ import annotations


def shapes(model) -> dict:
    """The configuration's shapes that the counts read: the sample slots
    a ray gets and the field's widths."""
    spr = (model.occ_keep * model.occ_samples_per_segment
           if model.sampler_mode == "occ" else model.n_samples)
    return {"samples_per_ray": spr, "levels": model.n_levels,
            "channels": model.n_channels, "feat_dim": model.hash_feat_dim,
            "sh_dim": model.sh_degree ** 2,
            "shader_hidden": model.shader_hidden_dim}


def samples(rays: int, work: dict) -> int:
    return rays * work["samples_per_ray"]


def forward_samples(work: dict) -> int:
    """Samples whose features the traced units encode (forward)."""
    if work["unit"] == "step":
        return (work["units"] * samples(work["rays"], work)
                + work["refresh_steps"] * work["refresh_points"])
    frame = samples(work["frame_rays"], work)
    if work["mode"] == 0:   # the particles' pixels, the reply's render
        per = samples(work["particle_rays"], work) + frame
    else:                   # the differential render, the reply's render
        per = 2 * frame
    return work["units"] * per


def table_grad_samples(work: dict) -> int:
    """Samples whose page gradient the traced units take (training)."""
    if work["unit"] != "step":
        return 0
    return work["units"] * samples(work["rays"], work)


def point_grad_samples(work: dict) -> int:
    """Samples whose point gradient the traced units take (mode 1)."""
    if work["unit"] != "frame" or work["mode"] != 1:
        return 0
    return work["units"] * samples(work["frame_rays"], work)


# operations of one (sample, level) pair: the 8 trilinear weights from
# the 3 fractions (3 subtractions, 16 products), then C products and C
# sums per corner
def weights_flops() -> int:
    return 19


def interp_flops(c: int) -> int:
    return weights_flops() + 8 * 2 * c


def matmul_flops(work: dict) -> int:
    """One sample's head (L*C -> F) and shader (F + SH -> hidden -> 3)
    multiply-adds, as operations."""
    d_in = work["feat_dim"] + work["sh_dim"]
    return 2 * (work["levels"] * work["channels"] * work["feat_dim"]
                + d_in * work["shader_hidden"] + work["shader_hidden"] * 3)


# per sample, besides the encode and the matrix products: contraction,
# density activation, SH basis, activations and compositing
POINTWISE_FLOPS = 60


def forward_flops(work: dict) -> int:
    """One sample's forward: encode, head, shader, compositing."""
    return (work["levels"] * interp_flops(work["channels"])
            + matmul_flops(work) + 3 * work["sh_dim"] + POINTWISE_FLOPS)


def encode_bytes(work: dict) -> int:
    """One sample's encode: 3 float32 coordinates in, L*C float32
    features (or their cotangents) out."""
    return 3 * 4 + work["levels"] * work["channels"] * 4
