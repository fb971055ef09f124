"""Checkpoints with true resume (port of ``f2nerf_tpu/train/checkpoint.py``).

The JAX package saves with Orbax; the port saves one ``torch.save`` file,
``checkpoints/step_%08d/state.pt``, holding

* ``params``: the flattened params (``convert.flatten`` names);
* ``adam``: the ``Optimizer``'s torch Adam ``state_dict`` (moments and
  per-param step) and ``count``, its schedule's update count;
* ``step``: the training step;
* ``occ_grid``: the occupancy grid (or None).

It is read back onto the CPU with ``torch.load(weights_only=True)``,
which unpickles only tensors and plain containers. The file is written
under a temporary name and renamed, so a step directory holds a whole
checkpoint or none; as in the JAX package the newest ``keep_last`` are
kept (two guard against a crash mid-save).
"""

from __future__ import annotations

import os
import pathlib
import shutil
from typing import Any

import torch

from f2nerf_tpu_torch.convert import flatten

STATE_FILE = "state.pt"


def all_steps(ckpt_dir: str | pathlib.Path) -> list[int]:
    """Steps of the complete checkpoints in ``ckpt_dir``, ascending."""
    d = pathlib.Path(ckpt_dir)
    if not d.exists():
        return []
    return sorted(int(p.name.split("_")[1]) for p in d.glob("step_*")
                  if (p / STATE_FILE).is_file())


def save(ckpt_dir: str | pathlib.Path, step: int, params: dict[str, Any],
         optimizer, occ_grid: torch.Tensor | None = None,
         keep_last: int = 2) -> None:
    """Save ``params`` (nested or flat dict of tensors), ``optimizer``
    (a ``train.optim.Optimizer``) and ``occ_grid`` as step ``step``;
    keep the newest ``keep_last`` checkpoints (0 keeps all)."""
    path = pathlib.Path(ckpt_dir).resolve() / f"step_{step:08d}"
    path.mkdir(parents=True, exist_ok=True)
    state = {"step": int(step),
             "params": {k: v.detach() for k, v in flatten(params).items()},
             "adam": optimizer.adam.state_dict(),
             "count": int(optimizer.count), "occ_grid": occ_grid}
    tmp = path / (STATE_FILE + ".tmp")
    torch.save(state, tmp)
    os.replace(tmp, path / STATE_FILE)
    if keep_last > 0:
        for old in all_steps(path.parent)[:-keep_last]:
            shutil.rmtree(path.parent / f"step_{old:08d}", ignore_errors=True)


def latest_step(ckpt_dir: str | pathlib.Path) -> int | None:
    """The newest complete checkpoint's step, or None."""
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str | pathlib.Path, step: int | None = None
            ) -> dict[str, Any]:
    """The checkpoint of ``step`` (default: the newest) as saved, on the
    CPU: {"step", "params" (flat), "adam", "count", "occ_grid"}."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = (pathlib.Path(ckpt_dir).resolve() / f"step_{step:08d}"
            / STATE_FILE)
    return torch.load(path, map_location="cpu", weights_only=True)
