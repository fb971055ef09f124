"""The field every configuration runs unless its file names another: the
fork's multi-level hash on the paged table behind the radial contraction
(``warp_mode`` "contract", ``hash_mode`` "paged"), with no constants.

A field file gives the drivers what belongs to the field: ``RUNS``,
``train_scene``, ``frame_scene`` and ``features`` (``portbench/harness.py``
says what each must give). This one draws the weights and cameras of
``portbench/inputs.py`` and reads ``portbench/reference/field.py``.
"""

from __future__ import annotations

from portbench import inputs
from portbench.reference import field as F

RUNS = {"warp_mode": ("contract",), "hash_mode": ("paged",)}


def train_scene(model, mix: dict, seed: int, device) -> inputs.Scene:
    """The trainer's map and cameras: O(1) weights from ``seed`` for the
    mix's images, and the mix's cameras at the identity pose."""
    n_img = int(mix["images"])
    params = inputs.map_weights(model, n_img, seed, device)
    poses, intr = inputs.cameras(n_img, int(mix["image_hw"]),
                                 float(mix["focal"]), device)
    return inputs.Scene(params, {}, poses, intr)


def frame_scene(model, mix: dict, seed: int, device) -> inputs.Scene:
    """The localizer's map: O(1) weights from ``seed`` with four
    appearance rows, no cameras."""
    return inputs.Scene(inputs.map_weights(model, 4, seed, device), {},
                        None, None)


def features(model, scene: inputs.Scene):
    """The plain reference's field: contraction, then the paged encode
    and the head."""
    lay = F.layout(model)

    def field(params, pts, dtype, contracted=False):
        return F.field(params, pts, model, lay, dtype, contracted=contracted)

    return field
