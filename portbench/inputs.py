"""The benchmark's inputs, made from ``--seed``: weights, the occupancy
grid, cameras, ray batches and target frames. A configuration's field
(``portbench/fields/<name>.py``) chooses which weights, constants and
cameras it draws, and hands them over as a :class:`Scene`.

Frozen copies, each naming its origin, so that a later change to the
program does not change what the benchmark feeds it:

* :func:`seeded_grid`, :func:`cameras`, :func:`batch_data` and
  :func:`first_step` from ``f2nerf_tpu_torch/bench.py`` (the grid's
  ``default_rng(1)`` becomes a generator seeded from ``--seed``);
* :func:`map_weights` from ``chip_smoke.py:o1_params`` (O(1) features
  and a density bias of 4, so renders show structure and gradients are
  O(1)); the leaves are drawn here with ``renderer.init``'s shapes and
  distributions instead of by calling it;
* :func:`target_frames` from ``chip_smoke.py:target_frame`` (a frame
  rendered from a pose a few centimetres off the prior), rendered by the
  plain reference and enlarged to the node's full frame.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from portbench.reference import field as F
from portbench.reference import localize as RL

_MASK64 = (1 << 64) - 1


class Scene(NamedTuple):
    """What a field draws for a run, on the device, before the program
    sees any of it."""
    params: dict                 # the map's weights
    consts: dict                 # the program's consts["field"]
    poses: torch.Tensor | None   # [n, 3, 4] training cameras
    intr: torch.Tensor | None    # [n, 3, 3] their intrinsics


def sub_seeds(seed: int, names: tuple[str, ...]) -> dict[str, int]:
    """One 63-bit seed per name, all from ``seed`` (any whole number)."""
    states = np.random.SeedSequence(int(seed) & _MASK64).spawn(len(names))
    return {n: int(s.generate_state(1, np.uint64)[0] >> np.uint64(1))
            for n, s in zip(names, states)}


def seeded_grid(model, seed: int, device) -> torch.Tensor:
    """bench.py:seeded_grid: the [2, G, G, G] grid with ~25% of its cells
    at twice the density threshold in both channels."""
    res = model.occ_grid_res
    occ_rng = np.random.default_rng(seed)
    seeded = ((occ_rng.random((res, res, res)) < 0.25).astype(np.float32)
              * np.float32(2.0 * F.sigma_threshold(model)))
    return torch.as_tensor(np.stack([seeded, seeded]), device=device)


def cameras(n_images: int, hw: int, focal: float, device
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """bench.py:cameras: identity poses [n, 3, 4] and intrinsics [n, 3, 3]
    of hw x hw at ``focal``."""
    poses = torch.eye(3, 4, device=device).repeat(n_images, 1, 1)
    intr = torch.tensor([[focal, 0, hw / 2], [0, focal, hw / 2],
                         [0, 0, 1.0]], device=device).repeat(n_images, 1, 1)
    return poses, intr


def batch_data(rng: np.random.Generator, rays: int, n_images: int, hw: int
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """bench.py:batch_data: one batch on the host, drawn in the order
    cam, i, j, gt."""
    cam = rng.integers(0, n_images, rays).astype(np.int32)
    ij = np.stack([rng.integers(0, hw, rays),
                   rng.integers(0, hw, rays)], -1).astype(np.int32)
    gt = rng.random((rays, 3)).astype(np.float32)
    return cam, ij, gt


def first_step(model) -> int:
    """bench.py:first_step: past the occupancy warm-up and the slow
    refresh cadence."""
    return max(model.occ_warmup_steps, model.occ_refresh_warmup) + 1024


def map_weights(model, n_images: int, seed: int, device) -> dict:
    """chip_smoke.py:o1_params on the device from ``seed``: pages
    U[-1, 1], the head and shader U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
    the head's density bias 4, the appearance embedding 0.1 * N(0, 1)."""
    g = torch.Generator(device=device).manual_seed(seed)
    lay = F.layout(model)

    def uniform(bound, *shape):
        return torch.rand(shape, generator=g, device=device) * (2 * bound) \
            - bound

    pool = uniform(1.0, lay.total_pages, model.n_channels, F.BLOCK, F.BLOCK,
                   F.BLOCK)
    in_dim = model.n_levels * model.n_channels
    mlp = {"w": uniform(in_dim ** -0.5, in_dim, model.hash_feat_dim),
           "b": uniform(in_dim ** -0.5, model.hash_feat_dim)}
    mlp["b"][0] = 4.0
    d_in = model.hash_feat_dim + model.sh_degree ** 2
    d_h = model.shader_hidden_dim
    shader = {"w0": uniform(d_in ** -0.5, d_in, d_h),
              "b0": uniform(d_in ** -0.5, d_h),
              "w1": uniform(d_h ** -0.5, d_h, 3),
              "b1": uniform(d_h ** -0.5, 3)}
    emb = torch.randn((n_images, model.app_emb_dim), generator=g,
                      device=device) * 0.1
    return {"field": {"feat_pool": pool, "mlp": mlp}, "shader": shader,
            "app_emb": emb}


def frame_intrinsic(frame_hw, focal: float, factor: int) -> np.ndarray:
    """chip_smoke.py:make_localizer's camera of the full frame, and the
    localizer's at 1/``factor`` (the [2, 2] entry kept at 1)."""
    h, w = frame_hw
    full = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1.0]],
                    np.float32)
    small = full / factor
    small[2, 2] = 1.0
    return full, small


def target_frames(mp: RL.Map, rng: np.random.Generator, n: int,
                  shift: float, frame_hw, factor: int) -> list[np.ndarray]:
    """``n`` float32 frames of the node's full size: each rendered at the
    localizer's size from the identity pose moved by up to ``shift`` on
    every axis, then enlarged ``factor`` times (edge rows repeated)."""
    h, w = frame_hw
    out = []
    for _ in range(n):
        pose = np.eye(3, 4, dtype=np.float32)
        pose[:, 3] += rng.uniform(-shift, shift, 3).astype(np.float32)
        small = mp.image(pose)
        big = np.repeat(np.repeat(small, factor, 0), factor, 1)
        big = np.pad(big, ((0, max(h - big.shape[0], 0)),
                           (0, max(w - big.shape[1], 0)), (0, 0)),
                     mode="edge")[:h, :w]
        out.append(np.ascontiguousarray(big, dtype=np.float32))
    return out
