"""Training-step throughput (rays/s per card, forward + backward + Adam)
at the flagship F2-NeRF operating point (port of ``bench.py``).

    python -m f2nerf_tpu_torch.bench [--quick] [--iters 50] [--rays R] \\
        [--dense] [--warp {contract,perspective}] [--no-quality-machinery] \\
        [--encode_chunk N] [--budget_s S] [--no-cache-write] [--device cpu]

Prints the device on one line (``torch.cuda.get_device_name(0)`` and
``nvidia-smi --query-gpu=name,power.limit``, or ``cpu``), then as its
last line ONE JSON object ``{"metric", "value", "unit", "vs_baseline"}``.

The arms are the script's:

* default: ``Config()`` (occupancy sampler) at 8192 rays a step;
* ``--dense``: the dense sampler, 512 rays x 1024 samples (the
  reference's operating point, ``train_manager.cpp:69-70``);
* ``--warp perspective``: the perspective warp, whose tables come from
  the ring of ``make_sphere_dataset(n_images=8, h=8, w=8)``; it
  disqualifies run dedup, so its rate is a headline of its own;
* ``--no-quality-machinery``: no explore slots and no explore-sparsity
  term (the pure-throughput point, the quality / speed knob);
* ``--quick``: ``Config.tiny()`` for 10 steps (a smoke run).

``pts_batch_size`` is ``rays * 512``. The occupancy arms start from a
seeded ~25%-occupied grid (:func:`seeded_grid`): an empty grid past the
warm-up would make every slot a degenerate re-walk and overstate the
rate. Eight identity cameras of 256 x 256 at f = 200 (:func:`cameras`);
the batches come from ``default_rng(0)`` (:func:`batch_data`). The first
step is past the occupancy warm-up and the slow partial-refresh cadence
(:func:`first_step`), the regime most of a 20,000-step run spends its
time in. One warm-up step, then ``iters`` steps in chunks of 10: each
chunk's batches are drawn before its clock starts and handed to the
step inside it (the host-to-device copies are timed), and the chunk
ends in ``loss.item()``, which waits for the card.

``vs_baseline``: the reference repo publishes no numbers; the anchor is
the F2-NeRF paper's implied training throughput on an RTX 2080Ti (~20k
steps x 512 rays in ~12 min, about 14.2k rays/s).

Watchdog (``main`` only): a daemon thread armed before the first step
prints a line if the run exceeds ``--budget_s`` (env ``BENCH_BUDGET_S``,
default 480 s): the best chunk so far, labelled "watchdog emit after N
iters"; else the cached result of the same source state (git sha plus a
hash of the working tree's diff) and the same arm, labelled CACHED;
else 0.0. Then it exits 0 with ``os._exit(0)``. It acts on the clock
only: a build or launch failure raises out of ``main`` with a non-zero
exit code. Every completed run other than ``--quick`` writes its result
to ``f2nerf_tpu_torch/BENCH_SELF.json`` (git-ignored) unless
``--no-cache-write``. Run :func:`measure` inside another process, never
``main``: the watchdog would end that process.

Where the port differs from the script:

* the params come from the port's ``renderer.init`` with a seeded
  ``torch.Generator``: the port cannot draw ``jax.random.key(0)``'s bits.
  The rate does not depend on the weights' values;
* the rate is divided by the cards the step runs on, one for this
  process (the script divides by every device of the host);
* there is no compilation cache: the CUDA kernels are built at first use
  by ``kernels/build.py`` into its git-ignored build directory, which the
  warm-up step takes, outside every timed chunk;
* the arm key of the cache also names the device.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import pathlib
import subprocess
import threading
import time

import numpy as np
import torch

from f2nerf_tpu_torch.core.config import Config
from f2nerf_tpu_torch.core.device import resolve_device
from f2nerf_tpu_torch.models import hash_field, occupancy, renderer
from f2nerf_tpu_torch.tools.common import add_device_flag
from f2nerf_tpu_torch.train.optim import make_optimizer
from f2nerf_tpu_torch.train.step import make_train_step

REFERENCE_RAYS_PER_S = 14200.0  # F2-NeRF paper, RTX 2080Ti (see docstring)
SELF_CACHE = pathlib.Path(__file__).resolve().parent / "BENCH_SELF.json"
N_IMAGES = 8
CAM_HW, CAM_F = 256, 200.0
THROUGHPUT_RAYS = 8192     # every arm but --dense and --quick
DENSE_RAYS = 512           # --dense: the reference's 512 x 1024
CHUNK = 10                 # steps between the watchdog's updates


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="tiny config, few iters (CI smoke)")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--rays", type=int, default=None,
                    help="override rays/step")
    ap.add_argument("--dense", action="store_true",
                    help="reference-parity operating point: dense "
                         "sampler, 512 rays x 1024 samples "
                         "(train_manager.cpp:69-70, points_sampler.hpp)")
    ap.add_argument("--warp", choices=("contract", "perspective"),
                    default=None,
                    help="override ModelConfig.warp_mode — perspective "
                         "certifiably disqualifies run dedup "
                         "(models/hash_field.py), so its flagship rate "
                         "is a separate headline")
    ap.add_argument("--no-quality-machinery", action="store_true",
                    help="disable the quality additions (explore slots + "
                         "explore-sparsity term) to measure the "
                         "pure-throughput operating point — the "
                         "documented quality/perf knob")
    ap.add_argument("--encode_chunk", type=int, default=None,
                    help="override ModelConfig.encode_chunk (points per "
                         "chunk of the plain encode)")
    ap.add_argument("--budget_s", type=float,
                    default=float(os.environ.get("BENCH_BUDGET_S", 480)))
    ap.add_argument("--no-cache-write", action="store_true")
    add_device_flag(ap)
    return ap.parse_args(argv)


def arm_key(args: argparse.Namespace, device_name: str) -> str:
    """The cache's arm: the script's flags, then the device."""
    return (f"quick={args.quick},dense={args.dense},warp={args.warp},"
            f"noqm={args.no_quality_machinery},rays={args.rays},"
            f"chunk={args.encode_chunk},device={device_name}")


def arm_config(args: argparse.Namespace) -> Config:
    """The arm's config, overrides in the script's order."""
    cfg = Config.tiny() if args.quick else Config()
    model, train = cfg.model, cfg.train
    if args.warp is not None:
        model = dataclasses.replace(model, warp_mode=args.warp)
    if args.encode_chunk is not None:
        model = dataclasses.replace(model, encode_chunk=args.encode_chunk)
    if args.no_quality_machinery:
        model = dataclasses.replace(model, occ_explore_slots=0)
        train = dataclasses.replace(train, explore_sparsity_weight=0.0)
    rays = args.rays
    if args.dense:
        model = dataclasses.replace(model, sampler_mode="dense")
        if rays is None:
            rays = DENSE_RAYS
    if rays is None and not args.quick:
        rays = THROUGHPUT_RAYS
    if rays:
        train = dataclasses.replace(train, pts_batch_size=rays * 512)
    return dataclasses.replace(cfg, model=model, train=train)


def arm_unit(args: argparse.Namespace, cfg: Config) -> str:
    """The script's unit string, character for character."""
    if args.quick:
        return "rays/s/chip (tiny cfg)"
    if cfg.model.sampler_mode == "occ":
        spr = cfg.model.occ_keep * cfg.model.occ_samples_per_segment
        mode = f"occ sampler, {spr} samples/ray"
        if args.warp == "perspective":
            mode += ", perspective warp (no run dedup)"
        if args.no_quality_machinery:
            mode += ", quality machinery off (r1 parity point)"
    else:
        mode = (f"dense, {cfg.model.n_samples} samples/ray"
                + (", reference-parity point 512x1024"
                   if args.dense else ""))
    return f"rays/s/chip (fwd+bwd+adam, {mode})"


def seeded_grid(cfg: Config, dev: torch.device) -> torch.Tensor:
    """The seeded ~25%-occupied [2, G, G, G] grid: cells drawn from
    ``default_rng(1)`` below 0.25 set to twice the density threshold in
    both channels."""
    res = cfg.model.occ_grid_res
    occ_rng = np.random.default_rng(1)
    seeded = ((occ_rng.random((res, res, res)) < 0.25).astype(np.float32)
              * np.float32(2.0 * occupancy.sigma_threshold(cfg.model)))
    return torch.as_tensor(np.stack([seeded, seeded]), device=dev)


def cameras(dev: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(poses [8, 3, 4], intrinsics [8, 3, 3]): identity poses, 256 x 256
    at f = 200."""
    poses = torch.eye(3, 4, device=dev).repeat(N_IMAGES, 1, 1)
    intr = torch.tensor([[CAM_F, 0, CAM_HW / 2], [0, CAM_F, CAM_HW / 2],
                         [0, 0, 1.0]], device=dev).repeat(N_IMAGES, 1, 1)
    return poses, intr


def batch_data(rng: np.random.Generator, rays: int
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One batch on the host, drawn in the order cam, i, j, gt."""
    cam = rng.integers(0, N_IMAGES, rays).astype(np.int32)
    ij = np.stack([rng.integers(0, CAM_HW, rays),
                   rng.integers(0, CAM_HW, rays)], -1).astype(np.int32)
    gt = rng.random((rays, 3)).astype(np.float32)
    return cam, ij, gt


def to_device(arrays, dev: torch.device) -> tuple[torch.Tensor, ...]:
    return tuple(torch.as_tensor(x, device=dev) for x in arrays)


def first_step(cfg: Config) -> int:
    """Past the occupancy warm-up and the slow refresh cadence."""
    return max(cfg.model.occ_warmup_steps,
               cfg.model.occ_refresh_warmup) + 1024


def ring_warp_consts(cfg: Config, dev: torch.device) -> dict:
    """The warp tables of ``--warp perspective`` (``{"field": {...}}``):
    built from the ring of ``make_sphere_dataset(n_images=8, h=8, w=8)``'s
    poses, where a run builds them from its training cameras."""
    from f2nerf_tpu_torch.data.synthetic import make_sphere_dataset
    from f2nerf_tpu_torch.models.warp import warp_consts
    ring = make_sphere_dataset(n_images=N_IMAGES, h=8, w=8)
    return warp_consts(ring.poses, cfg.model, dev)


def measure(args: argparse.Namespace, device: str | torch.device | None,
            progress=None) -> tuple[float, str, int]:
    """The arm's rays/s on ``device`` (default: the card). Returns
    (value, unit, iters done). ``progress(value, unit, iters_done)`` is
    called with the unit alone (value None) before the first step and
    after every chunk. Arms no watchdog."""
    dev = resolve_device(device)
    cfg = arm_config(args)
    rays = cfg.train.rays_per_step
    gen = torch.Generator(device=dev).manual_seed(0)
    params = renderer.init(gen, cfg.model, N_IMAGES, dev)
    consts = {"field": hash_field.init_consts(gen, cfg.model, dev)}
    if cfg.model.warp_mode == "perspective":
        consts["field"].update(ring_warp_consts(cfg, dev)["field"])
    optimizer = make_optimizer(params, cfg.train)
    grid = (seeded_grid(cfg, dev) if cfg.model.sampler_mode == "occ"
            else occupancy.init_grid(cfg.model, dev))
    poses, intr = cameras(dev)
    rng = np.random.default_rng(0)
    step_fn = make_train_step(cfg, optimizer)
    step0 = first_step(cfg)
    unit = arm_unit(args, cfg)
    if progress is not None:
        progress(None, unit, 0)

    # warm-up: builds the kernels on first use
    grid, m = step_fn(params, grid, poses, intr, step0,
                      *to_device(batch_data(rng, rays), dev), consts=consts)
    m.loss.item()

    iters = 10 if args.quick else args.iters
    chunk = max(1, min(CHUNK, iters))
    n_cards = 1
    done, t_total, k, value = 0, 0.0, 0, 0.0
    while done < iters:
        this = min(chunk, iters - done)
        batches = [batch_data(rng, rays) for _ in range(this)]
        t0 = time.perf_counter()
        for b in batches:
            grid, m = step_fn(params, grid, poses, intr, step0 + k + 1,
                              *to_device(b, dev), consts=consts)
            k += 1
        m.loss.item()
        t_total += time.perf_counter() - t0
        done += this
        value = done * rays / t_total / n_cards
        if progress is not None:
            progress(value, unit, done)
    return value, unit, iters


def _git_sha() -> str | None:
    """HEAD's sha, suffixed with a hash of the working tree's diff when
    the tree is dirty: the cached fallback is valid only for the exact
    source state it was measured at."""
    where = str(SELF_CACHE.parent)
    try:
        sha = subprocess.run(["git", "-C", where, "rev-parse", "HEAD"],
                             capture_output=True, text=True,
                             timeout=10).stdout.strip() or None
        if sha is None:
            return None
        diff = subprocess.run(["git", "-C", where, "diff", "HEAD"],
                              capture_output=True, text=True,
                              timeout=10).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    if diff:
        sha += "+dirty:" + hashlib.sha256(diff.encode()).hexdigest()[:12]
    return sha


def result_line(value: float, unit: str) -> str:
    return json.dumps({
        "metric": "train_rays_per_s_per_chip",
        "value": round(float(value), 1),
        "unit": unit,
        "vs_baseline": round(float(value) / REFERENCE_RAYS_PER_S, 3),
    })


class BenchRun:
    """One invocation's result: the best chunk so far, which the watchdog
    reads, and the result line, printed once."""

    def __init__(self, arm: str):
        self.arm = arm
        self.value: float | None = None
        self.unit: str | None = None
        self.iters_done = 0
        self._lock = threading.Lock()
        self._emitted = False

    def progress(self, value: float | None, unit: str, iters_done: int
                 ) -> None:
        # the unit first: the watchdog never sees a value without it
        self.unit = unit
        if value is not None:
            self.iters_done = iters_done
            self.value = value

    def emit(self, value: float, unit: str) -> None:
        """Print the result line, once per run."""
        with self._lock:
            if self._emitted:
                return
            self._emitted = True
            print(result_line(value, unit), flush=True)

    def watchdog(self, budget_s: float) -> None:
        """After ``budget_s``: emit what there is, then exit 0 at once
        (a call blocked in native code would hold up a normal exit)."""
        time.sleep(budget_s)
        if self.value is not None:
            self.emit(self.value,
                      self.unit + f", watchdog emit after {self.iters_done}"
                      f" iters at {budget_s:.0f}s budget")
        else:
            cached = None
            try:
                cached = json.loads(SELF_CACHE.read_text())
                # a cache of another source state or another arm (or no
                # sha on either side) is refused
                sha = _git_sha()
                if (sha is None or cached.get("git_sha") != sha
                        or cached.get("arm") != self.arm):
                    cached = None
            except (OSError, ValueError, AttributeError):
                cached = None
            if cached:
                self.emit(cached["value"],
                          cached["unit"] + " [CACHED in-round result: this "
                          "driver-run invocation hit the time budget before "
                          "measuring; see BENCH_NOTES.md]")
            else:
                self.emit(0.0, "rays/s/chip [bench run exceeded budget "
                               "before any measurement completed]")
        os._exit(0)


def device_line(dev: torch.device) -> tuple[str, str]:
    """(device name, the line that names it and its power limit)."""
    if dev.type != "cuda":
        return "cpu", "device: cpu"
    name = torch.cuda.get_device_name(dev)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        smi = "unavailable"
    return name, f"device: {name}; nvidia-smi: {smi}"


def main(argv: list[str] | None = None) -> None:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    name, line = device_line(dev)
    print(line, flush=True)
    run = BenchRun(arm_key(args, name))
    threading.Thread(target=run.watchdog, args=(args.budget_s,),
                     daemon=True).start()
    value, unit, iters = measure(args, dev, progress=run.progress)
    if not args.no_cache_write and not args.quick:
        try:
            SELF_CACHE.write_text(json.dumps(
                {"value": round(value, 1), "unit": unit, "iters": iters,
                 "wall_date": time.strftime("%Y-%m-%d"),
                 "git_sha": _git_sha(), "arm": run.arm}))
        except OSError:
            pass
    run.emit(value, unit)


if __name__ == "__main__":
    main()
