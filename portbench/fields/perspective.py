"""F2-NeRF's perspective warp in front of the fork's paged hash
(``warp_mode`` "perspective", ``hash_mode`` "paged"): the field maps a
world point through the charts of its nearest camera regions
(``f2nerf_tpu_torch/models/warp.py``), so its constants are the warp
tables of the training cameras, and its cameras are a free forward
trajectory rather than a ring.

The trajectory follows ``make_corridor_dataset``'s path
(``f2nerf_tpu_torch/data/synthetic.py``), written here in NumPy: views
evenly spaced along a 16-unit path from z = 0.5 to 14.5, swaying
x = 0.6 sin(2.4 pi z / 16) at height 0.25 + 0.1 sin(1.3 z), each
position moved by N(0, 0.02^2) per axis, each view looking 2.5 units
ahead; then centred on the cameras' mean and scaled so that the farthest
camera lies at 1, as ``core/cameras.normalize_poses`` does. It is drawn
from a stream of its own, derived from the seed the field is given. No
image is rendered: the colours of a batch stay the seed's.

The program's tables come from the trainer's own call,
``models.warp.warp_consts``; the plain reference (:func:`features`)
builds its charts again from the cameras (``reference/warp.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import inputs
from portbench.reference import field as F
from portbench.reference import warp as W

RUNS = {"warp_mode": ("perspective",), "hash_mode": ("paged",)}
# the tiny copy of the tests: 8 views of 8 regions, 2 cameras a region
TINY_MODEL = {"warp_n_regions": 8, "warp_n_cams": 2}
TINY_MIX = {"train": {"images": 8}}

LENGTH = 16.0       # the path's length
AHEAD = 2.5         # how far ahead a view looks
JITTER = 0.02       # the position noise
VIEWS = 128         # the trajectory's views where the mix names none


def _path(z: float) -> np.ndarray:
    return np.array([0.6 * np.sin(2.4 * np.pi * z / LENGTH),
                     0.25 + 0.1 * np.sin(1.3 * z), z])


def _look_at(position: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Camera-to-world [3, 4], the camera looking down -z, y up."""
    back = position - target
    back = back / np.linalg.norm(back)
    right = np.cross(np.array([0.0, 1.0, 0.0]), back)
    right = right / np.linalg.norm(right)
    up = np.cross(back, right)
    return np.stack([right, up, back, position], axis=1)


def trajectory(n_views: int, seed: int) -> np.ndarray:
    """[n, 3, 4] float32 camera-to-world poses of the free forward
    trajectory, centred and scaled."""
    rng = np.random.default_rng(seed)
    poses = []
    for k in range(n_views):
        z = 0.5 + (LENGTH - 2.0) * k / max(n_views - 1, 1)
        poses.append(_look_at(_path(z) + rng.normal(0.0, JITTER, 3),
                              _path(z + AHEAD)))
    poses = np.stack(poses).astype(np.float32)
    bias = poses[:, :, 3] - poses[:, :, 3].mean(axis=0)
    poses[:, :, 3] = bias / float(np.linalg.norm(bias, axis=-1).max())
    return poses


def _cameras(model, n_views: int, seed: int, device) -> tuple:
    """The trajectory's poses on ``device`` and the program's warp
    tables for them."""
    from f2nerf_tpu_torch.models.warp import warp_consts

    poses = trajectory(n_views, inputs.sub_seeds(seed, ("trajectory",))[
        "trajectory"])
    return (torch.as_tensor(poses, device=device),
            warp_consts(poses, model, device)["field"])


def train_scene(model, mix: dict, seed: int, device) -> inputs.Scene:
    """O(1) weights from ``seed`` for the mix's images, the trajectory's
    cameras at the mix's size and focal length, and their tables."""
    n_img = int(mix["images"])
    params = inputs.map_weights(model, n_img, seed, device)
    poses, consts = _cameras(model, n_img, seed, device)
    _, intr = inputs.cameras(n_img, int(mix["image_hw"]), float(mix["focal"]),
                             device)
    return inputs.Scene(params, consts, poses, intr)


def frame_scene(model, mix: dict, seed: int, device) -> inputs.Scene:
    """The localizer's map: O(1) weights with four appearance rows, and
    the tables of the same trajectory (its poses kept for the
    reference)."""
    poses, consts = _cameras(model, int(mix.get("images", VIEWS)), seed,
                             device)
    return inputs.Scene(inputs.map_weights(model, 4, seed, device), consts,
                        poses, None)


def features(model, scene: inputs.Scene):
    """The plain reference's field: the warp of charts built again from
    the scene's cameras (grid-domain points uncontracted first), then
    the paged encode and the head."""
    lay = F.layout(model)
    charts = W.charts(scene.poses.cpu().numpy(), model)

    def field(params, pts, dtype, contracted=False):
        world = (W.uncontract(pts, model.contraction_radius) if contracted
                 else pts)
        x = W.warp(world, charts, model.warp_blend_k)
        feat = F.encode(params["field"]["feat_pool"], x, lay, dtype)
        return feat @ params["field"]["mlp"]["w"] + params["field"]["mlp"]["b"]

    return field
