"""Training loop: the driver around the train step (port of
``f2nerf_tpu/train/loop.py``).

Mirrors the reference TrainManager (src/main_functions/train_manager.cpp)
as the JAX loop does:

* ``train_log.txt`` lines ``Time / Iter / PSNR (EMA 0.9) / LOSS / LR``
  (plus ``OCC``, the occupied share of the grid, in occupancy mode) every
  ``report_freq`` steps (:138-153);
* vis PNGs ``[gt | pred | depth]`` every ``vis_freq`` steps (:111-130);
* checkpoints every ``save_freq`` steps, with the optimizer state, the
  step and the occupancy grid, so training truly resumes
  (``train/checkpoint.py``);
* ``train_config.yaml`` and ``inference_params.yaml`` written into the
  run directory at start.

The step's metrics stay on the device until a report: then the queued
metrics are stacked and copied to the host once, so the host never waits
on the card per step. A NaN loss raises ``FloatingPointError``, or, with
``nan_recovery > 0``, rolls back to the newest checkpoint whose every
float tensor is finite.

Batches come from the native loader (``data/native_loader.py``) when its
library loads, else from ``Dataset.sample_batch`` on a numpy Generator
seeded with ``cfg.train.seed``, exactly as the JAX trainer takes them, so
one seed gives one batch stream in both packages.
"""

from __future__ import annotations

import dataclasses
import math
import pathlib
import pickle
import time
from collections.abc import Callable, Mapping
from typing import Any

import numpy as np
import torch

from f2nerf_tpu_torch.convert import params_from_numpy
from f2nerf_tpu_torch.core.config import Config
from f2nerf_tpu_torch.core.device import resolve_device
from f2nerf_tpu_torch.data.dataset import Dataset
from f2nerf_tpu_torch.models import occupancy, renderer
from f2nerf_tpu_torch.train import checkpoint as ckpt_lib
from f2nerf_tpu_torch.train.optim import lr_schedule, make_optimizer
from f2nerf_tpu_torch.train.step import StepNoise, draw_noise, make_train_step
from f2nerf_tpu_torch.utils.image_io import write_image


def resolve_sample_near(cfg: Config, dataset: Dataset) -> Config:
    """AUTO near bound (``sample_near < 0``): the dataset's smallest
    per-camera near bound in normalized units, clamped to 1.5 (cameras
    lie on the unit ball after normalization, so more means the bounds
    disagree with the poses and the march would skip the scene)."""
    if cfg.model.sample_near >= 0.0:
        return cfg
    near = float(np.min(dataset.bounds[:, 0]) / max(dataset.radius, 1e-9))
    if near > 1.5:
        print(f"WARNING: auto sample_near resolved to {near:.3f}"
              " (> 1.5 x scene radius — dataset bounds look"
              " inconsistent with the normalized poses);"
              " clamping to 1.5")
        near = 1.5
    print(f"auto sample_near resolved to {near:.4f} (normalized units)")
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, sample_near=near))


class Trainer:
    """Trains the field on ``dataset``; runs on ``cuda`` unless ``device``
    says otherwise.

    ``params``: start from these (a nested dict of numpy arrays, e.g. a
    JAX run's params) instead of a seeded init. ``noise_fn(step, n_rays)
    -> StepNoise`` gives each step's draws (default:
    ``train.step.draw_noise``). ``profile_dir``: trace steps
    ``profile_steps[0]`` to ``profile_steps[1]`` with ``torch.profiler``
    into a Chrome trace there.
    """

    def __init__(self, cfg: Config, dataset: Dataset,
                 result_dir: str | pathlib.Path | None = None,
                 device: str | torch.device | None = None,
                 params: Mapping[str, Any] | None = None,
                 noise_fn: Callable[[int, int], StepNoise] | None = None,
                 profile_dir: str | pathlib.Path | None = None,
                 profile_steps: tuple[int, int] = (10, 15)):
        cfg = resolve_sample_near(cfg, dataset)
        self.cfg = cfg
        self.dataset = dataset
        self.device = resolve_device(device)
        self.result_dir = (pathlib.Path(result_dir)
                           if result_dir is not None else None)
        self.profile_dir = (pathlib.Path(profile_dir) if profile_dir
                            else None)
        self.profile_steps = profile_steps
        self._profiler = None
        # training seconds across run() calls in this process: the Time
        # column stays monotonic when a driver trains in chunks
        self._elapsed_s = 0.0

        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(
                cfg.train.seed)
            self.params = renderer.init(gen, cfg.model, dataset.n_images,
                                        self.device)
        else:
            self.params = params_from_numpy(params, self.device)
        self.optimizer = make_optimizer(self.params, cfg.train)
        self.occ_grid = occupancy.init_grid(cfg.model, self.device)
        self.step = 0
        self.poses = torch.as_tensor(dataset.poses, device=self.device)
        self.intrinsics = torch.as_tensor(dataset.intrinsics,
                                          device=self.device)
        self._step_fn = make_train_step(cfg, self.optimizer)
        self._noise_fn = noise_fn or (lambda step, n: draw_noise(
            cfg, step, n, self.device))
        self._rng = np.random.default_rng(cfg.train.seed)
        # the native prefetching loader when its library loads
        self._native = None
        try:
            from f2nerf_tpu_torch.data.native_loader import (
                NativeBatchLoader, available)
            if available():
                self._native = NativeBatchLoader(
                    dataset.images, cfg.train.rays_per_step,
                    seed=cfg.train.seed)
        except (OSError, RuntimeError):
            self._native = None
        self._lr = lr_schedule(cfg.train)
        self.psnr_smooth = -1.0
        self._nan_budget = cfg.train.nan_recovery

        if self.result_dir is not None:
            self.result_dir.mkdir(parents=True, exist_ok=True)
            cfg.save(self.result_dir / "train_config.yaml")
            dataset.save_inference_params(self.result_dir)
            self._log_file = open(self.result_dir / "train_log.txt", "a")
        else:
            self._log_file = None

    @property
    def batch_source(self) -> str:
        """Where the batches come from: "native" or "numpy"."""
        return "native" if self._native is not None else "numpy"

    def close(self) -> None:
        """Close the log file and stop the native loader's threads."""
        if self._log_file is not None:
            self._log_file.close()
            self._log_file = None
        if self._native is not None:
            self._native.close()
            self._native = None

    # -- checkpoint / resume ------------------------------------------------
    def save_checkpoint(self) -> None:
        if self.result_dir is None:
            return
        ckpt_lib.save(self.result_dir / "checkpoints", self.step,
                      self.params, self.optimizer, self.occ_grid)

    def try_resume(self) -> bool:
        """Adopt the newest checkpoint of the run directory, if any."""
        if self.result_dir is None:
            return False
        d = self.result_dir / "checkpoints"
        if ckpt_lib.latest_step(d) is None:
            return False
        self._adopt(ckpt_lib.restore(d))
        return True

    def _adopt(self, state: dict) -> None:
        with torch.no_grad():
            for name, p in self.optimizer.named.items():
                p.copy_(state["params"][name])
        self.optimizer.adam.load_state_dict(state["adam"])
        self.optimizer.set_count(int(state["count"]))
        occ_grid = state["occ_grid"]
        if occ_grid is not None and occ_grid.dim() == 3:
            # a legacy single-channel (max-EMA) grid: add an empty
            # mean-sigma eligibility channel (it re-learns within a few
            # refreshes; 0 = no eligibility cuts meanwhile)
            occ_grid = torch.stack([occ_grid, torch.zeros_like(occ_grid)])
        self.occ_grid = (None if occ_grid is None
                         else occ_grid.to(self.device))
        self.step = int(state["step"])

    def _recover(self) -> bool:
        """After a NaN loss: restore the newest checkpoint whose params,
        Adam state and grid are all finite, and continue on a fresh host
        batch stream (the failing ray sequence is not replayed).

        A checkpoint saved inside the NaN-detection lag window can hold
        finite params but poisoned Adam moments or grid, so every float
        tensor of a candidate is checked before it is adopted.
        """
        if self.result_dir is None:
            return False
        d = self.result_dir / "checkpoints"
        for s in reversed(ckpt_lib.all_steps(d)):
            try:
                state = ckpt_lib.restore(d, step=s)
            except (OSError, RuntimeError, ValueError, EOFError,
                    pickle.UnpicklingError):
                continue
            if not all(bool(torch.isfinite(t).all())
                       for t in _float_tensors(state)):
                continue
            self._adopt(state)
            self._rng = np.random.default_rng(
                int(self._rng.integers(1 << 63)))
            self.psnr_smooth = -1.0
            self._log(f"NAN-RECOVER: restored finite checkpoint step {s}")
            return True
        return False

    # -- the loop -----------------------------------------------------------
    def run(self, n_steps: int | None = None) -> dict:
        """Train to ``end_iter`` (or ``n_steps`` more); on NaN, recover up
        to ``cfg.train.nan_recovery`` times (0 = raise, the reference's
        behaviour)."""
        end = (self.step + n_steps if n_steps is not None
               else self.cfg.train.end_iter)
        while True:
            try:
                return self._run_inner(end)
            except FloatingPointError:
                if self._nan_budget <= 0 or not self._recover():
                    raise
                self._nan_budget -= 1

    def next_batch(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The next (cam_idx, ij, gt) batch, on the device."""
        if self._native is not None:
            cam_idx, ij, gt = self._native.next()
        else:
            cam_idx, ij, gt = self.dataset.sample_batch(
                self._rng, self.cfg.train.rays_per_step)
        return tuple(torch.as_tensor(x, device=self.device)
                     for x in (cam_idx, ij, gt))

    def _run_inner(self, end: int) -> dict:
        cfg = self.cfg
        t0 = time.monotonic()
        pending: list = []
        last_metrics = None

        while self.step < end:
            self._profile_window()
            cam_idx, ij, gt = self.next_batch()
            self.occ_grid, metrics = self._step_fn(
                self.params, self.occ_grid, self.poses, self.intrinsics,
                self.step, cam_idx, ij, gt,
                noise=self._noise_fn(self.step, cam_idx.shape[0]))
            self.step += 1
            pending.append(metrics)

            if self.step % cfg.train.report_freq == 0:
                last_metrics = self._report(pending, t0)
                pending.clear()
            if self.step % cfg.train.vis_freq == 0:
                self._vis()
            if self.step % cfg.train.save_freq == 0:
                self.save_checkpoint()

        if pending:
            last_metrics = self._report(pending, t0)
        self._elapsed_s += time.monotonic() - t0
        return last_metrics or {}

    def _profile_window(self) -> None:
        if self.profile_dir is None:
            return
        from torch.profiler import ProfilerActivity, profile

        from f2nerf_tpu_torch.utils.timer import device_sync

        if self.step == self.profile_steps[0] and self._profiler is None:
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._profiler = profile(activities=acts)
            self._profiler.__enter__()
        elif self.step == self.profile_steps[1] and self._profiler is not None:
            device_sync(self.params)
            self._profiler.__exit__(None, None, None)
            self.profile_dir.mkdir(parents=True, exist_ok=True)
            self._profiler.export_chrome_trace(
                str(self.profile_dir / f"train_steps_{self.profile_steps[0]}"
                    f"_{self.profile_steps[1]}.json"))
            self._profiler = None

    def _report(self, pending: list, t0: float) -> dict:
        # every queued step's metrics in one device -> host copy
        fetched = torch.stack([torch.stack(tuple(m)) for m in pending]
                              ).cpu().numpy().astype(np.float64)
        fields = pending[0]._fields
        i_psnr, i_mse = fields.index("psnr"), fields.index("mse")
        for row in fetched:
            if math.isnan(row[i_mse]):
                raise FloatingPointError(f"NaN loss at step {self.step}")
            psnr = float(row[i_psnr])
            self.psnr_smooth = (psnr if self.psnr_smooth < 0
                                else psnr * 0.1 + self.psnr_smooth * 0.9)
        last = dict(zip(fields, (float(v) for v in fetched[-1])))
        lr = float(self._lr(self.step))
        total = int(self._elapsed_s + time.monotonic() - t0)
        occ_part = ""
        if self.cfg.model.sampler_mode == "occ":
            # occupied share per report: the pruning-health curve
            frac = float(occupancy.occupancy_bits(
                self.occ_grid, self.cfg.model).float().mean())
            occ_part = f" OCC: {frac:.3f}"
        self._log(f"Time: {total // 60:02d}:{total % 60:02d} "
                  f"Iter: {self.step:6d} PSNR: {self.psnr_smooth:.6f} "
                  f"LOSS: {last['color_loss']:.6f} LR: {lr:.6f}" + occ_part)
        return {"step": self.step, "psnr": self.psnr_smooth,
                "color_loss": last["color_loss"], "lr": lr,
                "loss": last["loss"]}

    def _log(self, line: str) -> None:
        print(line, flush=True)
        if self._log_file is not None:
            self._log_file.write(line + "\n")
            self._log_file.flush()

    def occ_bits(self) -> torch.Tensor | None:
        """The sampler's occupancy values of the current grid (None in
        dense mode)."""
        if self.cfg.model.sampler_mode != "occ":
            return None
        return occupancy.occ_values(
            self.occ_grid, self.cfg.model,
            warmup=self.step < self.cfg.model.occ_warmup_steps)

    def _vis(self) -> None:
        if self.result_dir is None:
            return
        ds = self.dataset
        rgb, depth = renderer.render_image(
            self.params, self.poses[0], self.intrinsics[0], ds.height,
            ds.width, self.cfg.model, chunk=self.cfg.train.ray_batch_size,
            occ_vals=self.occ_bits())
        depth3 = np.repeat(depth.cpu().numpy()[..., None], 3, axis=-1)
        concat = np.concatenate([ds.images[0], rgb.cpu().numpy(), depth3],
                                axis=1)
        out = self.result_dir / "images"
        out.mkdir(exist_ok=True)
        write_image(out / f"{self.step:08d}_0.png", concat)


def _float_tensors(x: Any):
    """Every floating-point tensor inside ``x`` (dicts, lists, tuples)."""
    if isinstance(x, torch.Tensor):
        if x.is_floating_point():
            yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _float_tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _float_tensors(v)
