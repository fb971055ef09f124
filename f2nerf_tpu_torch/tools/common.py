"""Pieces the tools share: the synthetic scenes by name, the holdout
split, the ``--device`` flag, a quality run's checkpoint restored (and a
localizer over it), the parts benches' timer, and the launcher of local
ranks."""

from __future__ import annotations

import argparse
import dataclasses
import os
import pathlib
import socket
import subprocess
import sys
import tempfile
from typing import Any, NamedTuple

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


class RestoredRun(NamedTuple):
    """A quality run's newest checkpoint, on its device."""
    cfg: Any               # the Trainer's config (auto ``sample_near`` resolved)
    params: dict
    consts: dict
    occ_vals: Any          # ``occupancy.occ_values`` of the grid, or None
    step: int
    device: Any


def restore_run(result_dir: pathlib.Path, train_ds: Dataset, device
                ) -> RestoredRun:
    """The newest checkpoint of a quality run, in the training views'
    frame (the JAX scripts' set-up): a ``Trainer`` on ``train_ds``
    resolves the config (auto ``sample_near``) and writes its run files
    into ``<result_dir>/diag_tmp``; the params, constants and grid come
    from ``<result_dir>/checkpoints``."""
    from f2nerf_tpu_torch.convert import unflatten
    from f2nerf_tpu_torch.core.config import Config
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
    return RestoredRun(tr.cfg, params, consts, occ_vals, int(state["step"]),
                       tr.device)


def checkpoint_localizer(result_dir: pathlib.Path, train_ds: Dataset,
                         intrinsic: np.ndarray, hw: int, device,
                         render_pixel_num: int = 512):
    """A ``Localizer`` over the newest checkpoint of a quality run
    (:func:`restore_run`). Returns (localizer, checkpoint step)."""
    from f2nerf_tpu_torch.localize.localizer import Localizer, LocalizerParam

    run = restore_run(result_dir, train_ds, device)
    loc = Localizer(run.params, run.cfg, np.asarray(intrinsic),
                    np.zeros(3), 1.0, hw, hw,
                    param=LocalizerParam(render_pixel_num=render_pixel_num),
                    occ_vals=run.occ_vals, seed=0, device=run.device,
                    consts=run.consts)
    return loc, run.step


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


def kernel_ms(events) -> float:
    """The card's busy time in ms among a profile's raw events
    (``prof.profiler.kineto_results.events()``; building ``prof.events()``
    from them takes seconds a window): the summed durations of the events
    that ran on the card (kernels, copies, fills), a kernel's duration
    being its self device time. User annotations (``record_function``
    ranges, e.g. ``Optimizer.step#Adam.step``) are left out, as they span
    kernels counted on their own; host events are left out."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    return sum(e.duration_ns() for e in events
               if e.device_type() == cuda and not e.is_user_annotation()
               ) / 1e6


def time_part(fn, device, iters: int = 10) -> dict:
    """One warm-up call of ``fn``, then ``iters`` calls timed, per call:
    ``wall_ms``, the host clock around the calls up to a synchronize;
    ``device_ms``, the card's busy time in ``iters`` more calls
    (:func:`kernel_ms` of a ``torch.profiler`` window over them: the
    profiler's callbacks slow the host, so the wall is taken without
    it); ``busy_share``, ``device_ms / wall_ms``. Off the card both stay
    None: a CPU run measures no device."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"

    def timed() -> float:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        if cuda:
            torch.cuda.synchronize(device)
        return (time.perf_counter() - t0) / iters * 1e3

    fn()
    if not cuda:
        return {"wall_ms": timed(), "device_ms": None, "busy_share": None}
    torch.cuda.synchronize(device)
    wall = timed()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        timed()
    dev_ms = kernel_ms(prof.profiler.kineto_results.events()) / iters
    return {"wall_ms": wall, "device_ms": dev_ms,
            "busy_share": dev_ms / wall}


def device_text(t: dict, fmt: str = "8.2f") -> str:
    """``device <ms> ms, busy <share>``, or ``device not measured``."""
    if t["device_ms"] is None:
        return "device not measured"
    return (f"device {t['device_ms']:{fmt}} ms, busy "
            f"{t['busy_share']:.1%}")


def part_line(label: str, t: dict, suffix: str = "", width: int = 0) -> str:
    """``label wall ms (device ms, busy share)``: the JAX script's label,
    padded to ``width`` as it pads it, and its number's format, the
    card's busy time beside it."""
    return (f"{label.ljust(width)} {t['wall_ms']:8.2f} ms{suffix} "
            f"({device_text(t)})")


def launch_ranks(module: str, n: int, rank_argv) -> None:
    """Start ``n`` ranks of ``python -m module`` on this host in
    torchrun's environment (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, a
    free port on localhost; the repo on ``PYTHONPATH``), rank r with the
    arguments ``rank_argv(r, port)``; relay rank 0's output as it comes.
    Raises ``SystemExit`` with the failing ranks' error output."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (repo, env.get("PYTHONPATH")) if p)
    env.setdefault("OMP_NUM_THREADS", "1")
    env.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
               WORLD_SIZE=str(n))
    with tempfile.TemporaryDirectory() as tmp:
        errs = [open(os.path.join(tmp, f"rank{i}.err"), "w+")
                for i in range(n)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", module, *rank_argv(i, port)],
            env={**env, "RANK": str(i), "LOCAL_RANK": str(i)},
            stdout=subprocess.PIPE if i == 0 else subprocess.DEVNULL,
            stderr=errs[i], text=True) for i in range(n)]
        for line in procs[0].stdout:
            print(line, end="", flush=True)
        rc = [p.wait() for p in procs]
        tails = []
        for i, f in enumerate(errs):
            f.seek(0)
            if rc[i]:
                tails.append(f"rank {i}:\n{f.read()[-2000:]}")
            f.close()
    if any(rc):
        raise SystemExit(f"worker exit codes {rc}\n" + "\n".join(tails))
