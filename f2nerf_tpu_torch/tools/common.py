"""Pieces the tools share: the synthetic scenes by name, the holdout
split, the ``--device`` flag and the localizer over a quality run's
checkpoint."""

from __future__ import annotations

import argparse
import dataclasses
import pathlib

import numpy as np

from f2nerf_tpu_torch.data import synthetic
from f2nerf_tpu_torch.data.dataset import Dataset

SCENES = ("checker", "sphere", "corridor", "textured", "longtraj", "objcap")


def make_scene(name: str, n_images: int, hw: int) -> Dataset:
    """``make_<name>_dataset`` of ``data/synthetic.py`` at hw x hw."""
    if name not in SCENES:
        raise ValueError(f"unknown scene {name!r}; one of {SCENES}")
    make = getattr(synthetic, f"make_{name}_dataset")
    return make(n_images=n_images, h=hw, w=hw)


def holdout_split(n_images: int, every: int) -> tuple[list[int], list[int]]:
    """(held, keep): every ``every``-th view from view 0 held out, the
    rest kept for training; nothing held out when ``every`` <= 0."""
    held = list(range(0, n_images, every)) if every > 0 else []
    return held, [i for i in range(n_images) if i not in held]


def subset(ds: Dataset, idx: list[int]) -> Dataset:
    """The views ``idx`` of ``ds``, in that order (same normalization)."""
    return dataclasses.replace(
        ds, poses=ds.poses[idx], intrinsics=ds.intrinsics[idx],
        dist_params=ds.dist_params[idx], bounds=ds.bounds[idx],
        images=ds.images[idx])


def add_device_flag(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain PyTorch path)")


def checkpoint_localizer(result_dir: pathlib.Path, train_ds: Dataset,
                         intrinsic: np.ndarray, hw: int, device,
                         render_pixel_num: int = 512):
    """A ``Localizer`` over the newest checkpoint of a quality run, in
    the training views' frame (the JAX scripts' set-up): a ``Trainer`` on
    ``train_ds`` resolves the config (auto ``sample_near``) and writes its
    run files into ``<result_dir>/diag_tmp``; the params, constants and
    grid come from ``<result_dir>/checkpoints``. Returns (localizer,
    checkpoint step)."""
    from f2nerf_tpu_torch.convert import unflatten
    from f2nerf_tpu_torch.core.config import Config
    from f2nerf_tpu_torch.localize.localizer import Localizer, LocalizerParam
    from f2nerf_tpu_torch.models import occupancy
    from f2nerf_tpu_torch.train import checkpoint as ckpt_lib
    from f2nerf_tpu_torch.train.loop import Trainer

    cfg = Config.load(result_dir / "train_config.yaml")
    tr = Trainer(cfg, train_ds, result_dir=result_dir / "diag_tmp",
                 device=device)
    tr.close()
    state = ckpt_lib.restore(result_dir / "checkpoints")
    params = unflatten({k: v.to(tr.device)
                        for k, v in state["params"].items()})
    consts = (unflatten({k: v.to(tr.device)
                         for k, v in state["consts"].items()})
              if state["consts"] else tr.consts)
    occ_vals = None
    if tr.cfg.model.sampler_mode == "occ":
        occ_vals = occupancy.occ_values(state["occ_grid"].to(tr.device),
                                        tr.cfg.model)
    loc = Localizer(params, tr.cfg, np.asarray(intrinsic),
                    np.zeros(3), 1.0, hw, hw,
                    param=LocalizerParam(render_pixel_num=render_pixel_num),
                    occ_vals=occ_vals, seed=0, device=tr.device,
                    consts=consts)
    return loc, int(state["step"])


def perturb_pose(rng: np.random.Generator, pose: np.ndarray, pos_noise: float,
                 rot_noise_deg: float) -> np.ndarray:
    """``pose`` moved by N(0, pos_noise) per axis and turned by
    N(0, rot_noise_deg) degrees about each axis, drawn in that order
    (the JAX scripts' draws)."""
    from f2nerf_tpu_torch.localize.localizer import _euler_rotations

    noisy = np.asarray(pose, dtype=np.float32).copy()
    off = rng.normal(0.0, pos_noise, 3).astype(np.float32)
    noisy[:3, 3] += off
    theta = np.deg2rad(rng.normal(0.0, rot_noise_deg, 3))
    noisy[:3, :3] = (_euler_rotations(theta) @ noisy[:3, :3]).astype(
        np.float32)
    return noisy
