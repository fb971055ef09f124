#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases (each passes or raises; the script exits 0 only if all pass):

1. Device and build: print the card, its power limit, and build every
   CUDA kernel under f2nerf_tpu_torch/kernels/csrc (one nvcc per
   source, all started together).
2. Kernels at full width, each held against its plain PyTorch version
   and timed with CUDA events (and each once at C = 3, which the wrappers
   run zero-padded to C = 4, at a small width): ``trilinear_fwd`` on the inputs of one
   mode-0 localize request, ``trilinear_bwd`` on the 4.19 M (point,
   level) pairs of one training step at ``bench.py``'s operating point
   and on as many uniform random pairs (each with a seeded O(1)
   cotangent; the zero-fill, the stable sort and the two passes also
   timed alone, and an atomic ``index_add_`` scatter of the corner
   values beside them), ``trilinear_bwd_frac`` on the 13.0 M
   pairs of one mode-1 step (106x240 rays x 64 samples x 8 levels, a
   seeded O(1) cotangent); the two backward kernels also for two
   launches that must be bitwise equal. ``trilinear_fwd`` and
   ``trilinear_bwd_frac`` run on uniform random points and again on the
   paths' own inputs (``in_situ_inputs``: the page indices and fractions
   of one full-frame render at the serve pose and, for
   ``trilinear_fwd``, of one mode-0 particle render), each set checked
   and timed alike.
3. Serving: a ``Localizer`` at the full-width ``Config()`` model (seeded
   random weights, the seeded 25%-occupied grid of ``bench.py``) behind
   a ``LocalizerService``: ``init_pose``, three mode-0 ``localize``
   requests of 64 particles, ``status``.
4. Training: ``make_optimizer`` + ``make_train_step`` at ``bench.py``'s
   operating point (``Config()``, 8192 rays/step, 8 cameras of 256x256
   at f = 200, the seeded grid), 24 steps from step 3072 (two occupancy
   refreshes among them); step times, rays/s, peak memory and one
   profiled step.
5. Differential serving: the same model with O(1) features behind a
   ``LocalizerService``: ``init_pose``, three mode-1 requests (one Adam
   step on the pose through the whole 106x240 frame) and one mode-2
   request at its defaults (3 search rounds of 128 particles, up to 30
   refinement steps with backtracking); request times, peak memory and
   one profiled mode-1 request.
6. Run directory, with ``yaml`` and ``PIL`` unimportable throughout
   (the card's machine has neither): the port's ``make_textured_dataset``
   at its defaults (32 views of 128x128, seed ``--seed``) written with
   ``save_dataset``; ``python -m f2nerf_tpu_torch.apps.main train`` in
   process on ``Config.quality(end_iter=600)`` (the full-width model
   ``scripts/quality_run.py`` trains: 4,096 rays per step, auto
   ``sample_near``; a report every 50 steps, checkpoints at 300 and 600,
   a vis PNG at 600); a fresh ``Trainer`` resumed from the run directory
   equal to the last checkpoint bitwise; a second ``train`` call that
   trains nothing; ``test`` (``summary.tsv``, PSNR / SSIM of its renders);
   ``Localizer.from_checkpoint`` on the run directory (every training
   view rendered at full resolution for PSNR / SSIM) behind a
   ``LocalizerService``: one mode-0 and one mode-1 request on a training
   view whose pose is moved 2 cm; then the loop's steady step against the
   bare train step at the same 4,096 rays, in turns.
   In phases 3-6 the kernels' launch counts are set to 0 just before and
   read just after each path (in phase 6: train, test, mode 0, mode 1);
   every kernel of the path must have launched, and the kernels of the
   other paths must not (a frozen field pays for no page gradient, a
   training step for no point gradient).
7. End-to-end checks: the VALIDATE renderer on 512 rays, two train
   steps on 512 rays at full width, and the pose loss and gradient on a
   17x40 frame at full width, each on the card and on the CPU (plain
   versions); two runs of a step on the card give bitwise-equal
   ``feat_pool`` grads; whether two runs give bitwise-equal pose
   gradients is reported.

Then one JSON line per the kernels, the ``nvidia-smi`` name and power
limit, and as the last line ``{"ok": true, "device": {...}}``. Without a
CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib.abc
import json
import pathlib
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

from f2nerf_tpu_torch.apps import main as cli
from f2nerf_tpu_torch.apps.serve import LocalizerService
from f2nerf_tpu_torch.core.cameras import rays_from_pose
from f2nerf_tpu_torch.core.config import Config, ModelConfig
from f2nerf_tpu_torch.data.dataset import load_dataset, save_dataset
from f2nerf_tpu_torch.data.synthetic import make_textured_dataset
from f2nerf_tpu_torch.kernels import build, trilinear
from f2nerf_tpu_torch.localize.localizer import Localizer, LocalizerParam
from f2nerf_tpu_torch.models import hash_field, occupancy, renderer
from f2nerf_tpu_torch.ops import hash_paged
from f2nerf_tpu_torch.ops.contraction import contract
from f2nerf_tpu_torch.train import checkpoint as ckpt_lib
from f2nerf_tpu_torch.train.loop import Trainer
from f2nerf_tpu_torch.train.optim import make_optimizer
from f2nerf_tpu_torch.train.step import (StepNoise, draw_noise,
                                         make_train_step)
from f2nerf_tpu_torch.utils.image_io import read_image
from f2nerf_tpu_torch.utils.metrics import psnr, ssim

# H100 SXM peaks (NVIDIA data sheet) for the bound: HBM3 bytes/s and
# f32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
KERNEL_TOL = 1e-5          # kernel vs plain version, same inputs
FRAME_H, FRAME_W, RESIZE = 850, 1920, 8   # scripts/bench_localize.py
N_REQUESTS, PARTICLES = 3, 64
N_DIFF_REQUESTS = 3                      # mode-1 requests
CHECK_RESIZE = 48                        # 17x40 frame for the pose check
# bench.py's training operating point (bench.py:203-265)
TRAIN_RAYS, N_IMAGES, CAM_HW, CAM_F = 8192, 8, 256, 200.0
STEP0, TRAIN_STEPS, STEADY_FROM = 3072, 24, 2
CHECK_RAYS = 512
ALL_KERNELS = ("trilinear_fwd", "trilinear_bwd", "trilinear_bwd_frac")
# the run-directory phase: Config.quality trained for RUN_STEPS steps
RUN_STEPS, RUN_REPORT = 600, 50
LOOP_STEPS = 40              # steps per timing window, loop vs bare step
SERVE_VIEW = 5               # the training view the requests localize
POSE_SHIFT = (0.012, -0.008, 0.014)   # world units (2.0 cm)


def zero_launches() -> None:
    for name in ALL_KERNELS:
        getattr(trilinear, name).launches = 0


def read_launches() -> dict:
    return {name: getattr(trilinear, name).launches for name in ALL_KERNELS}


def check_launches(path: str, launches: dict, used: tuple) -> None:
    """Every kernel in ``used`` launched on the path, no other did."""
    log(f"launches on the {path} path: {launches}")
    for name, count in launches.items():
        if (count > 0) != (name in used):
            raise RuntimeError(f"{name} launched {count} times on the {path} "
                               f"path (expected {'> 0' if name in used else 0})")


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, flush: torch.Tensor | None = None) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()``; ``flush`` (a
    buffer larger than the L2) is rewritten before each timed call so
    the call finds the cache cold, as a render does."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def samples_per_ray(cfg: Config) -> int:
    return cfg.model.occ_keep * cfg.model.occ_samples_per_segment


def request_inputs(cfg: Config, seed: int, dev: torch.device,
                   n: int | None = None):
    """Encode inputs of ``n`` points, by default one mode-0 request's
    64 particles x 256 pixels x 64 samples = 1,048,576, uniform in
    [-2, 2)^3, over the full table with pages drawn U[-1, 1] (O(1)
    features), bf16."""
    meta = hash_field.paged_meta(cfg.model)
    g = torch.Generator(device=dev).manual_seed(seed)
    pages = torch.rand((meta.total_pages, meta.n_channels, 4, 4, 4),
                       generator=g, device=dev) * 2 - 1
    haloed = hash_paged.halo_pages(pages, meta).to(torch.bfloat16)
    if n is None:
        n = PARTICLES * 256 * samples_per_ray(cfg)
    pts = torch.rand((n, 3), generator=g, device=dev) * 4 - 2
    page_idx, local, frac = hash_paged.page_indices(pts, meta)
    return haloed, page_idx, torch.cat([local.float(), frac], dim=-1)


def touched_table_bytes(haloed, page_idx, local_frac) -> int:
    """Bytes of the table cells the 8 corners of these (point, level)
    pairs touch, each counted once. It counts (page, slot) cells of C
    channels, so the row layout does not change it."""
    n_pages, width = haloed.shape
    c = width // hash_paged.ROW_PAD
    touched = torch.zeros(n_pages * hash_paged.ROW_PAD, dtype=torch.bool,
                          device=haloed.device)
    lx, ly, lz = (local_frac[..., k].long() for k in range(3))
    base = page_idx.long() * hash_paged.ROW_PAD
    for k in range(8):
        dx, dy, dz = k >> 2, (k >> 1) & 1, k & 1
        touched[base + 25 * (lx + dx) + 5 * (ly + dy) + (lz + dz)] = True
    return int(touched.sum()) * c * haloed.element_size()


def trilinear_bound_ms(haloed, page_idx, local_frac) -> float:
    """Least time for this call's work on an H100 SXM: each input byte
    read once (the table cells the corners touch, counted once), the
    output written once; ~80 f32 flops per (point, level) is far below
    the compute bound."""
    c = haloed.shape[1] // hash_paged.ROW_PAD
    pairs = page_idx.numel()
    io_bytes = (page_idx.numel() * 4 + local_frac.numel() * 4
                + pairs * c * 4)
    flops = pairs * 8 * (2 + 2 * c)
    return max((touched_table_bytes(haloed, page_idx, local_frac)
                + io_bytes) / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3


def fwd_set(name: str, inputs: tuple, flush: torch.Tensor) -> dict:
    """trilinear_fwd on one input set (bf16 table, page_idx, local_frac):
    bf16 and f32 against the plain version, then timed L2 flushed and
    back to back beside its bound."""
    haloed, page_idx, lf = inputs
    errs = {}
    for table in (haloed.float(), haloed):
        out = trilinear.trilinear_fwd(table, page_idx, lf)
        torch.cuda.synchronize()
        err = float((out - trilinear.trilinear_fwd_ref(table, page_idx, lf)
                     ).abs().max())
        log(f"trilinear_fwd {name} {table.dtype} N={page_idx.shape[1]} "
            f"L={page_idx.shape[0]}: max |kernel - plain| = {err:.3e} "
            f"(tol {KERNEL_TOL})")
        if not (np.isfinite(err) and err <= KERNEL_TOL):
            raise RuntimeError(f"trilinear_fwd {name} {table.dtype} "
                               f"disagrees with its plain version: {err}")
        errs[str(table.dtype)] = err
    ms = cuda_ms(lambda: trilinear.trilinear_fwd(haloed, page_idx, lf),
                 flush=flush)
    warm_ms = cuda_ms(lambda: trilinear.trilinear_fwd(haloed, page_idx, lf))
    bound_ms = trilinear_bound_ms(haloed, page_idx, lf)
    log(f"trilinear_fwd {name} bf16: {ms:.4f} ms (L2 flushed), "
        f"{warm_ms:.4f} ms (back to back), bound {bound_ms:.4f} ms")
    res = {"pairs": page_idx.numel(),
           "max_abs_err": errs[str(torch.float32)],
           "max_abs_err_bf16": errs[str(torch.bfloat16)], "ms": ms,
           "warm_ms": warm_ms, "bound_ms": bound_ms}
    return res


def kernel_phase(cfg: Config, seed: int, dev: torch.device, situ: dict
                 ) -> dict:
    """trilinear_fwd on one mode-0 request's inputs (uniform random
    points), then on the paths' own (``situ``); the plain version is
    timed on the first."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    haloed, page_idx, lf = request_inputs(cfg, seed, dev)
    res = fwd_set("random", (haloed, page_idx, lf), flush)
    res["plain_ms"] = cuda_ms(lambda: trilinear.trilinear_fwd_ref(
        haloed, page_idx, lf, chunk=cfg.model.encode_chunk), flush=flush)
    log(f"trilinear_fwd plain (random): {res['plain_ms']:.3f} ms")
    del haloed, page_idx, lf
    in_situ = {name: fwd_set(name, situ[name], flush)
               for name in ("frame", "particles")}
    return {"name": "trilinear_fwd", "route": "cuda",
            "source": "f2nerf_tpu_torch/kernels/csrc/trilinear_fwd.cu",
            "replaces": "f2nerf_tpu/kernels/trilinear.py:146 (contract_fwd)",
            "launches": None, "bound_by": "bytes", "library_ms": None, **res,
            "in_situ": in_situ}


def in_situ_inputs(cfg: Config, seed: int, dev: torch.device) -> dict:
    """The encode inputs the paths give the kernels, captured by wrapping
    ``hash_paged.page_indices`` for one render each: "frame", one
    full-frame 106x240 render at the serve pose (25,440 rays x 64
    samples = 1,628,160 points, the render of a mode-1 step and of every
    reply), and "particles", one mode-0 request's particle render (64
    particles x 256 pixels x 64 samples = 1,048,576 points). Each is
    (haloed, page_idx, local_frac) over the localizer's bf16 table, with
    the differential phase's O(1) features."""
    loc = make_localizer(cfg, seed, dev, params=o1_params(cfg, seed + 6, dev))
    orig = hash_paged.page_indices
    captured = []

    def capture(points, meta):
        captured.append(orig(points, meta))
        return captured[-1]

    pose = np.eye(3, 4, dtype=np.float32)
    with mock.patch.object(hash_paged, "page_indices", capture):
        frame = loc.render_image(pose).cpu().numpy()
        loc.optimize_pose_by_random_search(pose, frame, PARTICLES, 1.0)
    haloed = loc.params["field"]["haloed"]
    return {name: (haloed, page_idx.clone(),
                   torch.cat([local.float(), frac], dim=-1))
            for name, (page_idx, local, frac)
            in zip(("frame", "particles"), captured, strict=True)}


def seeded_grid(cfg: Config, dev: torch.device) -> torch.Tensor:
    """bench.py's seeded ~25%-occupied [2, G, G, G] grid."""
    res = cfg.model.occ_grid_res
    occ_rng = np.random.default_rng(1)
    seeded = (occ_rng.random((res, res, res)) < 0.25).astype(np.float32) \
        * (2.0 * occupancy.sigma_threshold(cfg.model))
    return torch.as_tensor(np.stack([seeded, seeded]), device=dev)


def seeded_occ_vals(cfg: Config, dev: torch.device) -> torch.Tensor:
    """The seeded grid as sampler values."""
    return occupancy.occ_values(seeded_grid(cfg, dev), cfg.model)


def train_cfg(rays: int) -> Config:
    cfg = Config()
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, pts_batch_size=rays * 512))


def cameras(dev: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """bench.py's cameras: identity poses, 256x256 at f = 200."""
    poses = torch.eye(3, 4, device=dev).repeat(N_IMAGES, 1, 1)
    intr = torch.tensor([[CAM_F, 0, CAM_HW / 2], [0, CAM_F, CAM_HW / 2],
                         [0, 0, 1.0]], device=dev).repeat(N_IMAGES, 1, 1)
    return poses, intr


def batch(rng: np.random.Generator, rays: int, dev: torch.device):
    cam = rng.integers(0, N_IMAGES, rays).astype(np.int32)
    ij = np.stack([rng.integers(0, CAM_HW, rays),
                   rng.integers(0, CAM_HW, rays)], -1).astype(np.int32)
    gt = rng.random((rays, 3)).astype(np.float32)
    return tuple(torch.as_tensor(x, device=dev) for x in (cam, ij, gt))


def train_step_inputs(cfg: Config, seed: int, dev: torch.device):
    """page_idx / local_frac of one training step's samples at the bench
    point, and a seeded O(1) cotangent of the encode output."""
    poses, intr = cameras(dev)
    cam, ij, _ = batch(np.random.default_rng(seed), TRAIN_RAYS, dev)
    noise = draw_noise(cfg, STEP0, TRAIN_RAYS, dev)
    rays_o, rays_d = rays_from_pose(poses[cam.long()], intr[cam.long()],
                                    ij.float())
    smp = occupancy.sample_rays_occ(
        rays_o, rays_d, seeded_occ_vals(cfg, dev), cfg.model,
        rank_u=noise.rank, within_u=noise.within, explore=noise.explore)
    pts = contract(smp.pts.reshape(-1, 3), cfg.model.contraction_radius)
    meta = hash_field.paged_meta(cfg.model)
    page_idx, local, frac = hash_paged.page_indices(pts, meta)
    g = torch.Generator(device=dev).manual_seed(seed)
    cot = torch.randn((pts.shape[0], meta.n_levels * meta.n_channels),
                      generator=g, device=dev)
    return cot, page_idx, torch.cat([local.float(), frac], dim=-1), meta


def trilinear_bwd_bound_ms(g, page_idx, local_frac, n_pages: int,
                           out_bytes: int) -> float:
    """Least time on an H100 SXM: g, local_frac and page_idx read once,
    d_haloed written once (the sort permutation is this design's own
    intermediate, not the function's, so its bytes are left out);
    ~8*(2+2C) f32 flops per (point, level) is far below the compute
    bound."""
    m = page_idx.numel()
    c = g.shape[1] // page_idx.shape[0]
    io_bytes = (g.numel() * 4 + local_frac.numel() * 4 + m * 4
                + n_pages * c * hash_paged.ROW_PAD * out_bytes)
    flops = m * 8 * (2 + 2 * c)
    return max(io_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3


def corner_scatter_inputs(g, page_idx, local_frac):
    """The page gradient as a scatter: each (point, level) entry's 8
    corner contributions g * w [8M, C] f32 and their rows page*128 + slot
    of a [P*128, C] view of the table (the product form of the weights,
    an ulp from the kernel's hat form)."""
    n_levels, n = page_idx.shape
    c = g.shape[1] // n_levels
    gl = g.view(n, n_levels, c).permute(1, 0, 2)             # [L, N, C]
    local = local_frac[..., :3].long()
    frac = local_frac[..., 3:]
    vals, rows = [], []
    for k in range(8):
        d = (k >> 2, (k >> 1) & 1, k & 1)
        w = torch.ones_like(frac[..., 0])
        for a in range(3):
            w = w * (frac[..., a] if d[a] else 1.0 - frac[..., a])
        vals.append((gl * w[..., None]).reshape(-1, c))
        rows.append((page_idx.long() * hash_paged.ROW_PAD
                     + 25 * (local[..., 0] + d[0]) + 5 * (local[..., 1] + d[1])
                     + (local[..., 2] + d[2])).reshape(-1))
    return torch.cat(vals), torch.cat(rows)


def bwd_set(name: str, g, page_idx, lf, n_pages: int, flush: torch.Tensor
            ) -> dict:
    """trilinear_bwd on one input set: f32 and bf16 against the plain
    version, two launches bitwise equal; the sorted order's runs; then
    timed L2 flushed: the whole wrapper, its parts (zero-fill, stable
    sort, the two passes alone), back to back, and the atomic scatter
    ``index_add_`` of prebuilt corner values beside the bound.
    Tolerance 1e-5 x the sum of each cell's term magnitudes in f32 (the
    same f32 terms summed in another order; the kernel's hat-form weights
    differ from the plain one-hot form by an ulp), plus 2^-8 of the value
    in bf16 (one rounding of the sum)."""
    ref = trilinear.trilinear_bwd_ref(g, page_idx, lf, n_pages)
    mag = trilinear.trilinear_bwd_ref(g.abs(), page_idx, lf, n_pages)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        out = trilinear.trilinear_bwd(g, page_idx, lf, n_pages, dtype)
        again = trilinear.trilinear_bwd(g, page_idx, lf, n_pages, dtype)
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            raise RuntimeError(f"trilinear_bwd {name} {dtype}: two launches "
                               f"on the same inputs differ")
        err = (out.float() - ref).abs()
        tol = KERNEL_TOL * mag + (2.0 ** -8 * ref.abs()
                                  if dtype == torch.bfloat16 else 0.0)
        ratio = float((err / (tol + 1e-30)).max())
        errs[str(dtype)] = float(err.max())
        log(f"trilinear_bwd {name} {dtype} M={page_idx.numel()}: max "
            f"|kernel - plain| = {errs[str(dtype)]:.3e}, max err/tol = "
            f"{ratio:.3f}; two launches bitwise equal")
        if not (np.isfinite(ratio) and ratio <= 1.0):
            raise RuntimeError(f"trilinear_bwd {name} {dtype} disagrees with "
                               f"its plain version: err/tol {ratio}")
    del ref, mag, out, again, err, tol
    counts = torch.bincount(page_idx.reshape(-1).long(), minlength=n_pages)
    runs, max_run = int((counts > 0).sum()), int(counts.max())
    log(f"  {name}: {runs} runs (pages touched of {n_pages}), largest run "
        f"{max_run} pairs, mean {page_idx.numel() / runs:.1f} pairs")
    bf16 = torch.bfloat16
    width = g.shape[1] // page_idx.shape[0] * hash_paged.ROW_PAD
    ms = cuda_ms(lambda: trilinear.trilinear_bwd(g, page_idx, lf, n_pages,
                                                 bf16), flush=flush)
    warm_ms = cuda_ms(lambda: trilinear.trilinear_bwd(g, page_idx, lf,
                                                      n_pages, bf16))
    fill_ms = cuda_ms(lambda: torch.zeros((n_pages, width), dtype=bf16,
                                          device=g.device), flush=flush)
    sort_ms = cuda_ms(lambda: trilinear._bwd_sort(page_idx, n_pages),
                      flush=flush)
    skey, perm = trilinear._bwd_sort(page_idx, n_pages)
    out = trilinear.trilinear_bwd(g, page_idx, lf, n_pages, bf16)
    passes_ms = cuda_ms(lambda: trilinear._bwd_passes(g, lf, skey, perm, out),
                        flush=flush)
    del skey, perm, out
    vals, rows = corner_scatter_inputs(g, page_idx, lf)
    table = torch.zeros((n_pages * hash_paged.ROW_PAD, vals.shape[1]),
                        dtype=torch.float32, device=g.device)
    scatter_ms = cuda_ms(lambda: table.index_add_(0, rows, vals), flush=flush)
    del vals, rows, table
    bound_ms = trilinear_bwd_bound_ms(g, page_idx, lf, n_pages, 2)
    log(f"trilinear_bwd {name} bf16: whole wrapper {ms:.4f} ms (L2 "
        f"flushed), {warm_ms:.4f} ms (back to back); alone, L2 flushed: "
        f"zero-fill {fill_ms:.4f}, stable sort {sort_ms:.4f}, two passes "
        f"{passes_ms:.4f} ms; bound {bound_ms:.4f} ms; atomic scatter "
        f"(index_add_ of prebuilt corner values, non-deterministic) "
        f"{scatter_ms:.4f} ms")
    return {"pairs": page_idx.numel(), "max_abs_err": errs[str(torch.float32)],
            "max_abs_err_bf16": errs[str(bf16)], "ms": ms, "warm_ms": warm_ms,
            "fill_ms": fill_ms, "sort_ms": sort_ms, "passes_ms": passes_ms,
            "atomic_scatter_ms": scatter_ms, "bound_ms": bound_ms,
            "runs": runs, "max_run": max_run}


def bwd_kernel_phase(cfg: Config, seed: int, dev: torch.device) -> dict:
    """trilinear_bwd on one bench-point training step's 4.19 M pairs
    (the main numbers; the plain version is timed there), then on as many
    uniform random pairs (the worst case for the gathers), each with a
    seeded O(1) cotangent."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    g, page_idx, lf, meta = train_step_inputs(cfg, seed, dev)
    n_pages = meta.total_pages
    res = bwd_set("train step", g, page_idx, lf, n_pages, flush)
    res["plain_ms"] = cuda_ms(lambda: trilinear.trilinear_bwd_ref(
        g, page_idx, lf, n_pages, torch.bfloat16), reps=3, flush=flush)
    log(f"trilinear_bwd plain (train step): {res['plain_ms']:.3f} ms")
    n = page_idx.shape[1]
    del g, page_idx, lf
    gen = torch.Generator(device=dev).manual_seed(seed + 8)
    pts = torch.rand((n, 3), generator=gen, device=dev) * 4 - 2
    page_idx, local, frac = hash_paged.page_indices(pts, meta)
    g = torch.randn((n, meta.n_levels * meta.n_channels), generator=gen,
                    device=dev)
    random = bwd_set("random", g, page_idx,
                     torch.cat([local.float(), frac], dim=-1), n_pages, flush)
    return {"name": "trilinear_bwd", "route": "cuda",
            "source": "f2nerf_tpu_torch/kernels/csrc/trilinear_bwd.cu",
            "replaces": "f2nerf_tpu/kernels/trilinear.py:172 "
                        "(contract_bwd_rows)",
            "launches": None, "bound_by": "bytes", "library_ms": None, **res,
            "sets": {"random": random}}


def trilinear_bwd_frac_bound_ms(haloed, page_idx, local_frac) -> float:
    """Least time on an H100 SXM for the function's own bytes: the table
    cells the corners touch (each once), page_idx 4 B, local_frac 24 B,
    g 4C B and d_frac 12 B per (point, level); ~8*(2C+9) f32 flops per
    pair is far below the compute bound."""
    c = haloed.shape[1] // hash_paged.ROW_PAD
    pairs = page_idx.numel()
    io_bytes = pairs * (4 + 24 + 4 * c + 12)
    flops = pairs * 8 * (2 * c + 9)
    return max((touched_table_bytes(haloed, page_idx, local_frac)
                + io_bytes) / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3


def frac_set(name: str, inputs: tuple, g: torch.Tensor,
             flush: torch.Tensor) -> dict:
    """trilinear_bwd_frac on one input set (bf16 table, page_idx,
    local_frac) and the cotangent g: f32 and bf16 against the plain
    version and two launches bitwise equal, then timed L2 flushed and
    back to back beside its bound."""
    haloed, page_idx, lf = inputs
    errs = {}
    for table in (haloed.float(), haloed):
        out = trilinear.trilinear_bwd_frac(table, page_idx, lf, g)
        again = trilinear.trilinear_bwd_frac(table, page_idx, lf, g)
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            raise RuntimeError(f"trilinear_bwd_frac {name} {table.dtype}: "
                               f"two launches on the same inputs differ")
        ref = trilinear.trilinear_bwd_frac_ref(table, page_idx, lf, g)
        mag = trilinear.trilinear_bwd_frac_ref(table, page_idx, lf, g,
                                               magnitudes=True)
        err = (out - ref).abs()
        ratio = float((err / (KERNEL_TOL * mag + 1e-30)).max())
        errs[str(table.dtype)] = float(err.max())
        log(f"trilinear_bwd_frac {name} {table.dtype} N={page_idx.shape[1]} "
            f"L={page_idx.shape[0]}: max |kernel - plain| = "
            f"{errs[str(table.dtype)]:.3e}, max err/tol = {ratio:.3f}; two "
            f"launches bitwise equal")
        if not (np.isfinite(ratio) and ratio <= 1.0):
            raise RuntimeError(f"trilinear_bwd_frac {name} {table.dtype} "
                               f"disagrees with its plain version: err/tol "
                               f"{ratio}")
        del out, again, ref, mag, err
    args = (haloed, page_idx, lf, g)
    ms = cuda_ms(lambda: trilinear.trilinear_bwd_frac(*args), flush=flush)
    warm_ms = cuda_ms(lambda: trilinear.trilinear_bwd_frac(*args))
    bound_ms = trilinear_bwd_frac_bound_ms(haloed, page_idx, lf)
    log(f"trilinear_bwd_frac {name} bf16: {ms:.4f} ms (L2 flushed), "
        f"{warm_ms:.4f} ms (back to back), bound {bound_ms:.4f} ms")
    res = {"pairs": page_idx.numel(),
           "max_abs_err": errs[str(torch.float32)],
           "max_abs_err_bf16": errs[str(torch.bfloat16)], "ms": ms,
           "warm_ms": warm_ms, "bound_ms": bound_ms}
    return res


def frac_kernel_phase(cfg: Config, seed: int, dev: torch.device,
                      situ: dict) -> dict:
    """trilinear_bwd_frac at one mode-1 step's 106x240 rays x 64 samples
    x 8 levels: uniform random points, then the full-frame render's own
    (``situ``), each with a seeded O(1) cotangent; the plain version is
    timed on the first. Tolerance 1e-5 x the sum of each output's term
    magnitudes in f32 and in bf16 (rows widened to f32, g in f32 on both
    sides; only the order of the f32 sums differs)."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    n = (FRAME_H // RESIZE) * (FRAME_W // RESIZE) * samples_per_ray(cfg)
    inputs = request_inputs(cfg, seed + 5, dev, n)
    g = torch.randn((n, inputs[1].shape[0] * cfg.model.n_channels),
                    generator=torch.Generator(device=dev).manual_seed(seed),
                    device=dev)
    res = frac_set("random", inputs, g, flush)
    res["plain_ms"] = cuda_ms(lambda: trilinear.trilinear_bwd_frac_ref(
        *inputs, g), reps=3, flush=flush)
    log(f"trilinear_bwd_frac plain (random): {res['plain_ms']:.3f} ms")
    del inputs
    frame = situ["frame"]
    if frame[1].shape[1] != n:
        raise RuntimeError(f"the frame render has {frame[1].shape[1]} "
                           f"points, expected {n}")
    in_situ = {"frame": frac_set("frame", frame, g, flush)}
    return {"name": "trilinear_bwd_frac", "route": "cuda",
            "source": "f2nerf_tpu_torch/kernels/csrc/trilinear_bwd_frac.cu",
            "replaces": "f2nerf_tpu/kernels/trilinear.py:198 "
                        "(contract_bwd_frac)",
            "launches": None, "bound_by": "bytes", "library_ms": None, **res,
            "in_situ": in_situ}


def make_trainer(cfg: Config, seed: int, dev: torch.device,
                 o1_features: bool = False, where: torch.device | None = None):
    """Seeded params made on the card (so every copy has the same values),
    moved to ``where``, with their optimizer and train step."""
    g = torch.Generator(device=dev).manual_seed(seed)
    params = renderer.init(g, cfg.model, N_IMAGES, dev)
    if o1_features:
        pool = params["field"]["feat_pool"]
        params["field"]["feat_pool"] = torch.rand(
            pool.shape, generator=g, device=dev) * 2 - 1
    params = _to(params, where or dev)
    opt = make_optimizer(params, cfg.train)
    return params, opt, make_train_step(cfg, opt)


def training_phase(cfg: Config, seed: int, dev: torch.device) -> dict:
    """bench.py's operating point through the port's training entry
    points; step times on the host clock around synchronized steps."""
    params, opt, step_fn = make_trainer(cfg, seed, dev)
    poses, intr = cameras(dev)
    grid = seeded_grid(cfg, dev)
    rng = np.random.default_rng(seed)
    batches = [batch(rng, TRAIN_RAYS, dev) for _ in range(TRAIN_STEPS)]
    pool0 = params["field"]["feat_pool"].detach().clone()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_launches()
    torch.cuda.synchronize()
    times, losses = [], []
    for k in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        grid, m = step_fn(params, grid, poses, intr, STEP0 + k, *batches[k])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m.loss))
        if k == 1 and torch.equal(params["field"]["feat_pool"], pool0):
            raise RuntimeError("feat_pool did not change by step 2")
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
    check_launches("training", launches, ("trilinear_fwd", "trilinear_bwd"))
    finite = all(bool(torch.isfinite(p).all()) for p in opt.named.values())
    if not (finite and np.all(np.isfinite(losses))):
        raise RuntimeError(f"training diverged: losses {losses}")
    refresh = [k for k in range(TRAIN_STEPS)
               if (STEP0 + k) % cfg.model.occ_update_every == 0]
    steady = times[STEADY_FROM:]
    mean_ms = float(np.mean(steady))
    log(f"train steps (ms): {[round(t, 2) for t in times]}; refresh steps "
        f"{[STEP0 + k for k in refresh]}")
    log(f"train step at {TRAIN_RAYS} rays: mean {mean_ms:.2f} ms, median "
        f"{float(np.median(steady)):.2f} ms over steps {STEP0 + STEADY_FROM}"
        f"-{STEP0 + TRAIN_STEPS - 1} -> {TRAIN_RAYS / mean_ms * 1e3:.0f} "
        f"rays/s; peak memory {peak_gb:.2f} GiB; losses "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    prof = profile_call(lambda: step_fn(params, grid, poses, intr,
                                        STEP0 + TRAIN_STEPS, *batches[0]),
                        "train step")
    return {"step_ms": times, "mean_ms": mean_ms,
            "median_ms": float(np.median(steady)),
            "refresh_step_ms": [times[k] for k in refresh],
            "rays_per_s": TRAIN_RAYS / mean_ms * 1e3, "peak_mem_gb": peak_gb,
            "launches": launches, "losses": losses, "profile": prof,
            "halo": halo_times(params["field"]["feat_pool"], cfg)}


def halo_times(pool: torch.Tensor, cfg: Config) -> dict:
    """The training step's halo on its own: ``halo_pages`` and the cast
    to bf16, then their backward (autograd's transpose of both) for a
    seeded cotangent, on a copy of ``pool``: its device kernel time,
    profiled, and its time on the host clock around a synchronized call
    (median of 20), which the host's dispatch of its few dozen ops sets
    (CUDA events would time the host too)."""
    meta = hash_field.paged_meta(cfg.model)
    pages = pool.detach().clone().requires_grad_(True)
    cot = torch.randn((meta.total_pages, hash_paged.ROW_PAD * meta.n_channels),
                      generator=torch.Generator(pool.device).manual_seed(0),
                      device=pool.device).to(torch.bfloat16)

    def run():
        pages.grad = None
        hash_paged.halo_pages(pages, meta).to(torch.bfloat16).backward(cot)

    run()                                           # warm up
    res = {"profile": profile_call(run, "halo forward + backward")}
    times = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    res["host_ms"] = float(np.median(times))
    log(f"halo forward + backward: {res['host_ms']:.3f} ms on the host "
        f"clock (median of 20)")
    return res


def step_check_phase(seed: int, dev: torch.device) -> dict:
    """Two train steps at full width on 512 rays, on the card and on the
    CPU (plain versions), with O(1) features and the same draws; then the
    same two steps again on the card.

    Tolerances: loss rtol 1e-4 and grads atol 1e-2 x each leaf's largest
    |grad| (CUDA and the CPU round exp/log/sqrt differently, the sums
    cancel to ~1e-2 of their terms, and the bf16 page gradient can round
    a cell either way, 2^-8); params: every entry within 2.05 lr and at
    most 0.1% of them beyond 0.05 lr (an Adam step moves an entry by
    about lr whatever the size of its grad, so a near-zero grad whose
    sign differs moves it 2 lr apart).
    """
    cfg = train_cfg(CHECK_RAYS)
    rng = np.random.default_rng(seed + 3)
    poses, intr = cameras(dev)
    batches = [batch(rng, CHECK_RAYS, dev) for _ in range(2)]
    steps = (STEP0 + 1, STEP0 + 2)         # no refresh: CPU time
    noises = [draw_noise(cfg, s, CHECK_RAYS, dev) for s in steps]
    grid = seeded_grid(cfg, dev)
    runs = {}
    for name, where in (("cuda", dev), ("cuda again", dev),
                        ("cpu", torch.device("cpu"))):
        params, opt, step_fn = make_trainer(cfg, seed + 2, dev,
                                            o1_features=True, where=where)
        out = {"loss": [], "grads": [], "params": []}
        for s, b, nz in zip(steps, batches, noises):
            _, m = step_fn(params, grid.to(where), poses.to(where),
                           intr.to(where), s, *(x.to(where) for x in b),
                           noise=StepNoise(*(None if x is None
                                             else x.to(where) for x in nz)))
            out["loss"].append(float(m.loss))
            out["grads"].append({k: p.grad.detach().cpu().clone()
                                 for k, p in opt.named.items()})
            out["params"].append({k: p.detach().cpu().clone()
                                  for k, p in opt.named.items()})
        out["lr"] = max(g["lr"] for g in opt.adam.param_groups)
        runs[name] = out
    a, b, c = runs["cuda"], runs["cuda again"], runs["cpu"]
    report = {"loss_cuda": a["loss"], "loss_cpu": c["loss"]}
    if not np.allclose(a["loss"], c["loss"], rtol=1e-4, atol=0):
        raise RuntimeError(f"loss on the card {a['loss']} vs CPU "
                           f"{c['loss']}")
    worst = {}
    for k in range(2):
        for name, gc in c["grads"][k].items():
            scale = float(gc.abs().max())
            err = float((a["grads"][k][name] - gc).abs().max())
            worst[name] = max(worst.get(name, 0.0), err / max(scale, 1e-30))
            if err > 1e-2 * scale:
                raise RuntimeError(f"step {k} grad {name}: card vs CPU "
                                   f"{err:.3e} (scale {scale:.3e})")
    lr = c["lr"]
    for name, pc in c["params"][-1].items():
        d = (a["params"][-1][name] - pc).abs()
        far = float((d > 0.05 * lr).float().mean())
        if float(d.max()) > 2.05 * lr or far > 1e-3:
            raise RuntimeError(f"param {name}: card vs CPU max "
                               f"{float(d.max()):.3e}, share beyond 0.05 "
                               f"lr {far:.2e} (lr {lr:.3e})")
    unequal = sorted(name for name in a["grads"][0]
                     if not all(torch.equal(a["grads"][k][name],
                                            b["grads"][k][name])
                                for k in range(2)))
    log(f"train steps on card vs CPU, {CHECK_RAYS} rays: losses "
        f"{a['loss']} vs {c['loss']}; worst grad err / leaf max "
        f"{ {k: f'{v:.1e}' for k, v in worst.items()} }")
    log(f"two runs on the card: grads not bitwise equal for {unequal}")
    if "field/feat_pool" in unequal:
        raise RuntimeError("feat_pool grads differ between two runs on the "
                           "card")
    report.update(worst_grad_rel=worst, nondeterministic_leaves=unequal)
    return report


def o1_params(cfg: Config, seed: int, dev: torch.device) -> dict:
    """Seeded params with O(1) features (pages U[-1, 1]) and a density
    bias of 4, so renders show structure and pose gradients are O(1);
    the init's ~1e-4 features give near-zero ones."""
    g = torch.Generator(device=dev).manual_seed(seed)
    params = renderer.init(g, cfg.model, 4, dev)
    pool = params["field"]["feat_pool"]
    params["field"]["feat_pool"] = torch.rand(
        pool.shape, generator=g, device=dev) * 2 - 1
    params["field"]["mlp"]["b"][0] = 4.0
    return params


def make_localizer(cfg: Config, seed: int, dev: torch.device,
                   params: dict | None = None, resize: int = RESIZE,
                   where: torch.device | None = None) -> Localizer:
    """A localizer of the 850x1920 frame at ``resize`` on ``where``
    (default ``dev``), with ``params`` (default: the init's, seeded)."""
    if params is None:
        g = torch.Generator(device=dev).manual_seed(seed)
        params = renderer.init(g, cfg.model, 4, dev)
    intr = np.array([[1000.0, 0, FRAME_W / 2], [0, 1000.0, FRAME_H / 2],
                     [0, 0, 1.0]], np.float32)
    return Localizer(params, cfg, intr, np.zeros(3), 1.0, FRAME_H, FRAME_W,
                     param=LocalizerParam(resize_factor=resize),
                     occ_vals=seeded_occ_vals(cfg, dev), seed=seed,
                     device=where or dev)


def target_frame(loc: Localizer, shift=(0.01, -0.005, 0.02)
                 ) -> tuple[np.ndarray, np.ndarray]:
    """The identity pose and a frame rendered from a pose ``shift``
    away."""
    pose = np.eye(3, 4, dtype=np.float32)
    target_pose = pose.copy()
    target_pose[:, 3] += shift
    return pose, loc.render_image(target_pose).cpu().numpy()


def check_reply(r: dict, what: str) -> None:
    pose_w = np.asarray(r.get("pose", np.nan), dtype=np.float64)
    if not (r.get("ok") and pose_w.shape == (4, 4)
            and np.isfinite(pose_w).all()
            and np.isfinite(r.get("score", np.nan))
            and np.isfinite(r.get("diff_loss", 0.0))):
        raise RuntimeError(f"{what} failed: {r}")


def _to(tree, where):
    return {k: _to(v, where) if isinstance(v, dict) else v.to(where)
            for k, v in tree.items()}


def serving_phase(cfg: Config, seed: int, dev: torch.device) -> dict:
    loc = make_localizer(cfg, seed, dev)
    svc = LocalizerService(loc)
    pose, target = target_frame(loc)
    log(f"localizer {loc.infer_height}x{loc.infer_width}, "
        f"{hash_field.paged_meta(cfg.model).total_pages} pages")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_launches()
    if not svc.handle({"cmd": "init_pose",
                       "pose": loc.camera2world(pose).tolist()})["ok"]:
        raise RuntimeError("init_pose failed")
    req = {"cmd": "localize", "image": target.tolist(), "mode": 0,
           "particle_num": PARTICLES}
    times = []
    for k in range(N_REQUESTS):
        t0 = time.perf_counter()
        r = svc.handle(req)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        check_reply(r, f"mode-0 request {k}")
        log(f"mode-0 request {k}: {times[-1]:.1f} ms, score "
            f"{r['score']:.4g}")
    st = svc.handle({"cmd": "status"})
    if not (st["ok"] and st["frames"] == N_REQUESTS):
        raise RuntimeError(f"status: {st}")
    torch.cuda.synchronize()
    launches = read_launches()
    check_launches("serving", launches, ("trilinear_fwd",))
    return {"request_ms": times, "launches": launches,
            "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 2**30,
            "profile": profile_call(lambda: svc.handle(req),
                                    "mode-0 request")}


def differential_phase(cfg: Config, seed: int, dev: torch.device) -> dict:
    """Modes 1 and 2 through the service at the full-width model with
    O(1) features: three mode-1 requests (one Adam step on the pose
    through one render of the whole 106x240 frame and its backward) and
    one mode-2 request at its defaults."""
    loc = make_localizer(cfg, seed, dev, params=o1_params(cfg, seed + 6, dev))
    svc = LocalizerService(loc)
    pose, target = target_frame(loc)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_launches()
    if not svc.handle({"cmd": "init_pose",
                       "pose": loc.camera2world(pose).tolist()})["ok"]:
        raise RuntimeError("init_pose failed")
    req1 = {"cmd": "localize", "image": target.tolist(), "mode": 1}
    times = []
    for k in range(N_DIFF_REQUESTS):
        t0 = time.perf_counter()
        r = svc.handle(req1)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        check_reply(r, f"mode-1 request {k}")
        log(f"mode-1 request {k}: {times[-1]:.1f} ms, score "
            f"{r['score']:.4g}")
    t0 = time.perf_counter()
    r2 = svc.handle({"cmd": "localize", "image": target.tolist(),
                     "mode": 2})
    torch.cuda.synchronize()
    mode2_ms = (time.perf_counter() - t0) * 1e3
    check_reply(r2, "mode-2 request")
    if "diff_loss" not in r2:
        raise RuntimeError(f"mode-2 reply lacks diff_loss: {r2}")
    log(f"mode-2 request: {mode2_ms:.1f} ms, score {r2['score']:.4g}, "
        f"diff_loss {r2['diff_loss']:.4g}, lr_final {r2['lr_final']:.3g}, "
        f"backtracks {r2['backtracks']}")
    st = svc.handle({"cmd": "status"})
    if not (st["ok"] and st["frames"] == N_DIFF_REQUESTS + 1):
        raise RuntimeError(f"status: {st}")
    torch.cuda.synchronize()
    launches = read_launches()
    check_launches("differential", launches,
                   ("trilinear_fwd", "trilinear_bwd_frac"))
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"differential requests: peak memory {peak_gb:.2f} GiB")
    return {"mode1_request_ms": times, "mode2_request_ms": mode2_ms,
            "mode2_reply": {k: r2[k] for k in ("score", "diff_loss",
                                               "lr_final", "backtracks")},
            "launches": launches, "peak_mem_gb": peak_gb,
            "profile": profile_call(lambda: svc.handle(req1),
                                    "mode-1 request")}


def pose_check_phase(cfg: Config, seed: int, dev: torch.device) -> dict:
    """The differential loss and pose gradient at full width on a 17x40
    frame (680 rays), on the card and on the CPU (plain versions), from
    the same O(1) params. Tolerances: loss rtol 1e-5; gradient 1e-2 of
    its largest entry. The point gradient jumps where a sample crosses a
    cell edge, and the finest level (scale 1024) turns an ulp of sample
    position into ~1e-4 of a cell, so the pose gradient of a field with
    O(1) features is discontinuous at the ulp scale; the phase reports
    how far a 1e-7 shift of the translation moves the CPU gradient. CUDA
    and the CPU round the points' math differently (measured card vs
    CPU: 2.4e-3 on an NVIDIA H100 80GB HBM3). Whether two runs on the
    card give bitwise-equal gradients is reported, not required."""
    params = o1_params(cfg, seed + 7, dev)
    locs = {name: make_localizer(cfg, seed, dev, params=params,
                                 resize=CHECK_RESIZE, where=where)
            for name, where in (("cuda", dev), ("cpu", torch.device("cpu")))}
    pose, target = target_frame(locs["cuda"])
    shifted = pose.copy()
    shifted[:, 3] += 1e-7
    runs = {"cuda": locs["cuda"].pose_gradient(pose, target),
            "cuda again": locs["cuda"].pose_gradient(pose, target),
            "cpu": locs["cpu"].pose_gradient(pose, target),
            "cpu shifted": locs["cpu"].pose_gradient(shifted, target)}
    (loss_a, g_a), (_, g_b), (loss_c, g_c), (_, g_s) = runs.values()
    scale = float(np.abs(g_c).max())
    rel = float(np.abs(g_a - g_c).max()) / max(scale, 1e-30)
    shift_rel = float(np.abs(g_s - g_c).max()) / max(scale, 1e-30)
    loss_rel = abs(loss_a - loss_c) / abs(loss_c)
    bitwise = bool(np.array_equal(g_a, g_b))
    log(f"pose loss and gradient on card vs CPU, "
        f"{locs['cpu'].infer_height}x{locs['cpu'].infer_width} frame: loss "
        f"{loss_a:.6e} vs {loss_c:.6e} (rel {loss_rel:.1e}), max |d grad| / "
        f"max |grad| = {rel:.2e} (max |grad| {scale:.3e}; the CPU gradient "
        f"at the pose shifted by 1e-7: {shift_rel:.2e}); two runs on the "
        f"card bitwise equal: {bitwise}")
    if not (loss_rel <= 1e-5 and rel <= 1e-2):
        raise RuntimeError("the pose gradient on the card disagrees with "
                           "the CPU")
    return {"loss_cuda": loss_a, "loss_cpu": loss_c, "loss_rel": loss_rel,
            "grad_rel": rel, "grad_scale": scale,
            "cpu_shift_grad_rel": shift_rel, "bitwise_equal": bitwise}


def narrow_channels_check(seed: int, dev: torch.device) -> dict:
    """Each wrapper at C = 3 (the kernels are built for 1, 2, 4 and 8;
    the wrappers zero-pad to 4 and slice), 8 levels of a 2^14 table,
    65,536 uniform random points, f32 and bf16 tables, against its plain
    version with the tolerances of the full-width checks."""
    cfg = ModelConfig(n_levels=8, n_channels=3, log2_table_size=14)
    meta = hash_field.paged_meta(cfg)
    g = torch.Generator(device=dev).manual_seed(seed + 9)
    pages = torch.rand((meta.total_pages, 3, 4, 4, 4), generator=g,
                       device=dev) * 2 - 1
    pts = torch.rand((65536, 3), generator=g, device=dev) * 4 - 2
    page_idx, local, frac = hash_paged.page_indices(pts, meta)
    lf = torch.cat([local.float(), frac], dim=-1)
    cot = torch.randn((65536, 24), generator=g, device=dev)
    errs = {name: 0.0 for name in ALL_KERNELS}
    for dtype in (torch.float32, torch.bfloat16):
        haloed = hash_paged.halo_pages(pages, meta).to(dtype)
        out = trilinear.trilinear_fwd(haloed, page_idx, lf)
        ref = trilinear.trilinear_fwd_ref(haloed, page_idx, lf)
        err = float((out - ref).abs().max())
        if not err <= KERNEL_TOL:
            raise RuntimeError(f"trilinear_fwd at C = 3 {dtype}: {err}")
        errs["trilinear_fwd"] = max(errs["trilinear_fwd"], err)
        out = trilinear.trilinear_bwd_frac(haloed, page_idx, lf, cot)
        ref = trilinear.trilinear_bwd_frac_ref(haloed, page_idx, lf, cot)
        mag = trilinear.trilinear_bwd_frac_ref(haloed, page_idx, lf, cot,
                                               magnitudes=True)
        if not bool(((out - ref).abs() <= KERNEL_TOL * mag + 1e-30).all()):
            raise RuntimeError(f"trilinear_bwd_frac at C = 3 {dtype} "
                               f"disagrees with its plain version")
        errs["trilinear_bwd_frac"] = max(errs["trilinear_bwd_frac"],
                                         float((out - ref).abs().max()))
        out = trilinear.trilinear_bwd(cot, page_idx, lf, meta.total_pages,
                                      dtype)
        ref = trilinear.trilinear_bwd_ref(cot, page_idx, lf,
                                          meta.total_pages)
        mag = trilinear.trilinear_bwd_ref(cot.abs(), page_idx, lf,
                                          meta.total_pages)
        tol = KERNEL_TOL * mag + (2.0 ** -8 * ref.abs()
                                  if dtype == torch.bfloat16 else 0.0)
        if out.shape != ref.shape or not bool(
                ((out.float() - ref).abs() <= tol + 1e-30).all()):
            raise RuntimeError(f"trilinear_bwd at C = 3 {dtype} disagrees "
                               f"with its plain version")
        if dtype == torch.float32:
            errs["trilinear_bwd"] = float((out - ref).abs().max())
    torch.cuda.synchronize()
    log(f"C = 3 (padded to 4), 65,536 points x 8 levels: max |kernel - "
        f"plain| {json.dumps(errs)} (trilinear_bwd in f32)")
    return errs


class _Unimportable(importlib.abc.MetaPathFinder):
    def __init__(self, names: tuple):
        self.names = names

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in self.names:
            raise ImportError(f"{name} is made unimportable for this phase")
        return None


@contextlib.contextmanager
def unimportable(*names: str):
    """Inside, importing any of ``names`` raises ImportError, as on the
    machine with the card, which installs neither yaml nor PIL."""
    saved = {m: sys.modules.pop(m) for m in list(sys.modules)
             if m.split(".")[0] in names}
    finder = _Unimportable(names)
    sys.meta_path.insert(0, finder)
    try:
        yield
    finally:
        sys.meta_path.remove(finder)
        sys.modules.update(saved)


def _log_reports(path: pathlib.Path) -> list[dict]:
    rows = []
    for line in path.read_text().splitlines():
        if "Iter:" not in line:
            continue
        f = line.split()
        rows.append({"step": int(f[f.index("Iter:") + 1]),
                     "psnr": float(f[f.index("PSNR:") + 1]),
                     "loss": float(f[f.index("LOSS:") + 1])})
    return rows


def _subpath(name: str, used: tuple, fn) -> tuple[dict, object]:
    """``fn()`` between zeroed and read launch counts; the kernels in
    ``used`` must launch, the others not. Returns ({wall_s, launches},
    what ``fn`` returned)."""
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    res = {"wall_s": time.perf_counter() - t0, "launches": read_launches()}
    check_launches(f"run-directory {name}", res["launches"], used)
    return res, out


def _check_resumed(tr: Trainer, state: dict) -> None:
    """The resumed trainer holds the checkpoint's state bitwise."""
    if tr.step != state["step"] or tr.optimizer.count != state["count"]:
        raise RuntimeError(f"resumed step {tr.step} / count "
                           f"{tr.optimizer.count}, saved {state['step']} / "
                           f"{state['count']}")
    for name, p in tr.optimizer.named.items():
        if not torch.equal(p.detach().cpu(), state["params"][name]):
            raise RuntimeError(f"resumed {name} differs from the checkpoint")
    live = tr.optimizer.adam.state_dict()["state"]
    for k, saved in state["adam"]["state"].items():
        for key in ("step", "exp_avg", "exp_avg_sq"):
            if not torch.equal(live[k][key].cpu(), saved[key]):
                raise RuntimeError(f"resumed Adam {key} of param {k} "
                                   f"differs from the checkpoint")
    if not torch.equal(tr.occ_grid.cpu(), state["occ_grid"]):
        raise RuntimeError("resumed occupancy grid differs")


def _pose_error(reply_pose, true_world: np.ndarray) -> float:
    return float(np.linalg.norm(np.asarray(reply_pose)[:3, 3]
                                - true_world[:3, 3]))


def loop_vs_bare(tr: Trainer) -> dict:
    """The loop's steady step (``Trainer.run``: batches from its source,
    draws, the step, metrics fetched at each report) against the bare
    train step on batches already on the card, LOOP_STEPS steps a window,
    in turns loop, bare, bare, loop; ms per step on the host clock around
    synchronized windows; then 4 more loop steps profiled."""
    step_fn = make_train_step(tr.cfg, tr.optimizer)
    batches = [tr.next_batch() for _ in range(LOOP_STEPS)]
    rays = tr.cfg.train.rays_per_step
    times = {"loop": [], "bare": []}

    def bare():
        for k in range(LOOP_STEPS):
            tr.occ_grid, _ = step_fn(tr.params, tr.occ_grid, tr.poses,
                                     tr.intrinsics, tr.step + k, *batches[k])
        tr.step += LOOP_STEPS

    for which in ("loop", "bare", "bare", "loop"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if which == "loop":
            tr.run(LOOP_STEPS)
        else:
            bare()
        torch.cuda.synchronize()
        times[which].append((time.perf_counter() - t0) * 1e3 / LOOP_STEPS)
    prof = profile_call(lambda: tr.run(4), "4 loop steps (one refresh)")
    loop_ms, bare_ms = float(np.mean(times["loop"])), float(
        np.mean(times["bare"]))
    log(f"loop step {[round(t, 3) for t in times['loop']]} ms vs bare step "
        f"{[round(t, 3) for t in times['bare']]} ms at {rays} rays "
        f"({rays / loop_ms * 1e3:.0f} vs {rays / bare_ms * 1e3:.0f} rays/s; "
        f"the loop's own host time {loop_ms - bare_ms:+.3f} ms per step)")
    return {"loop_ms": times["loop"], "bare_ms": times["bare"],
            "loop_rays_per_s": rays / loop_ms * 1e3,
            "bare_rays_per_s": rays / bare_ms * 1e3,
            "loop_overhead_ms": loop_ms - bare_ms, "profile": prof}


def run_directory_phase(seed: int, dev: torch.device) -> dict:
    """Dataset directory -> train -> run directory -> resume, test, serve,
    through the CLI and the service, with yaml and PIL unimportable (see
    the module docstring, phase 6)."""
    t_phase = time.perf_counter()
    sub = {}
    with tempfile.TemporaryDirectory() as tmp, unimportable("yaml", "PIL"):
        data, run = pathlib.Path(tmp) / "data", pathlib.Path(tmp) / "run"
        save_dataset(make_textured_dataset(seed=seed), data)
        run.mkdir()
        cfg = Config.quality(end_iter=RUN_STEPS)
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, report_freq=RUN_REPORT, save_freq=RUN_STEPS // 2,
            vis_freq=RUN_STEPS))
        cfg.save(run / "train_config.yaml")
        t_setup = time.perf_counter() - t_phase

        sub["train"], _ = _subpath(
            "train", ("trilinear_fwd", "trilinear_bwd"),
            lambda: cli.main(["train", str(run), str(data)]))
        reports = _log_reports(run / "train_log.txt")
        log("train PSNR (smoothed) per report: " + ", ".join(
            f"{r['step']}: {r['psnr']:.3f}" for r in reports))
        if len(reports) != RUN_STEPS // RUN_REPORT:
            raise RuntimeError(f"{len(reports)} reports in train_log.txt")
        if not reports[-1]["loss"] < reports[0]["loss"]:
            raise RuntimeError(f"loss did not fall: {reports}")
        ckpts = sorted(p.name for p in (run / "checkpoints").glob("step_*"))
        if ckpts != [f"step_{RUN_STEPS // 2:08d}", f"step_{RUN_STEPS:08d}"]:
            raise RuntimeError(f"checkpoints {ckpts}")
        ds = load_dataset(data)
        vis = read_image(run / "images" / f"{RUN_STEPS:08d}_0.png")
        if vis.shape != (ds.height, 3 * ds.width, 3):
            raise RuntimeError(f"vis PNG {vis.shape}")

        # resume: a fresh trainer holds the last checkpoint bitwise; a
        # second train call trains nothing
        tr = Trainer(Config.load(run / "train_config.yaml"), ds,
                     result_dir=run)
        if not tr.try_resume():
            raise RuntimeError("try_resume found no checkpoint")
        _check_resumed(tr, ckpt_lib.restore(run / "checkpoints"))
        log(f"resumed at step {tr.step} bitwise equal to the checkpoint; "
            f"batch source: {tr.batch_source}")
        n_log = len((run / "train_log.txt").read_text().splitlines())
        cli.main(["train", str(run), str(data)])
        if (len((run / "train_log.txt").read_text().splitlines()) != n_log
                or ckpt_lib.latest_step(run / "checkpoints") != RUN_STEPS):
            raise RuntimeError("the second train call trained")

        sub["test"], _ = _subpath(
            "test", ("trilinear_fwd",),
            lambda: cli.main(["test", str(run), str(data)]))
        summary = (run / "test_result" / "summary.tsv").read_text()
        pairs = [read_image(run / "test_result" / f"{i:08d}.png")
                 for i in range(ds.n_images)]
        w = pairs[0].shape[1] // 2
        test_psnr = float(np.mean([psnr(x[:, w:], x[:, :w]) for x in pairs]))
        test_ssim = float(np.mean([ssim(x[:, w:], x[:, :w]) for x in pairs]))
        log(f"test summary.tsv: {summary.strip()!r}; renders "
            f"{pairs[0].shape[0]}x{w}: mean PSNR {test_psnr:.3f}, SSIM "
            f"{test_ssim:.4f}")

        loc = Localizer.from_checkpoint(run)
        full = [loc.render_image(ds.poses[i]).cpu().numpy()
                for i in range(ds.n_images)]
        view_psnr = float(np.mean([psnr(f, g) for f, g in
                                   zip(full, ds.images)]))
        view_ssim = float(np.mean([ssim(f, g) for f, g in
                                   zip(full, ds.images)]))
        log(f"training views at {ds.height}x{ds.width}: mean PSNR "
            f"{view_psnr:.3f}, SSIM {view_ssim:.4f}")

        svc = LocalizerService(loc)
        true_world = loc.camera2world(ds.poses[SERVE_VIEW])
        moved = true_world.copy()
        moved[:3, 3] += POSE_SHIFT
        image = ds.images[SERVE_VIEW].tolist()
        requests = {}
        for mode, used in ((0, ("trilinear_fwd",)),
                           (1, ("trilinear_fwd", "trilinear_bwd_frac"))):
            if not svc.handle({"cmd": "init_pose",
                               "pose": moved.tolist()})["ok"]:
                raise RuntimeError("init_pose failed")
            req = {"cmd": "localize", "image": image, "mode": mode,
                   "particle_num": PARTICLES}
            sub[f"mode{mode}"], r = _subpath(f"mode {mode}", used,
                                             lambda: svc.handle(req))
            check_reply(r, f"run-directory mode-{mode} request")
            requests[mode] = {
                "position_error_before": _pose_error(moved, true_world),
                "position_error_after": _pose_error(r["pose"], true_world),
                "score": r["score"],
                "ms": sub[f"mode{mode}"]["wall_s"] * 1e3}
            log(f"mode-{mode} request on view {SERVE_VIEW}: position error "
                f"{requests[mode]['position_error_before']:.4f} -> "
                f"{requests[mode]['position_error_after']:.4f} (world units), "
                f"score {r['score']:.4g}, {requests[mode]['ms']:.1f} ms")

        timing = loop_vs_bare(tr)
        batch_source = tr.batch_source
        tr.close()
    wall_s = time.perf_counter() - t_phase
    log(f"run-directory phase: {wall_s:.1f} s (set-up {t_setup:.1f} s, "
        f"train {sub['train']['wall_s']:.1f} s for {RUN_STEPS} steps)")
    return {"subpaths": sub, "reports": reports, "test_summary": summary,
            "test_psnr": test_psnr, "test_ssim": test_ssim,
            "view_psnr": view_psnr, "view_ssim": view_ssim,
            "requests": requests, "timing": timing,
            "batch_source": batch_source, "wall_s": wall_s}


def profile_call(fn, what: str) -> dict:
    """One more call under torch.profiler: wall time, device kernel time
    by name, and the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for evt in prof.key_averages():
        # user annotations (e.g. "Optimizer.step#Adam.step") span kernels
        # that are counted on their own
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False)):
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        kernels[evt.key] = kernels.get(evt.key, 0.0) + us / 1e3
    device_ms = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    log(f"profiled {what}: wall {wall_ms:.2f} ms, device kernels "
        f"{device_ms:.2f} ms (busy {device_ms / wall_ms:.1%})")
    for name, ms in top:
        log(f"  {ms:8.3f} ms  {name[:100]}")
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "top": [[name[:60], ms] for name, ms in top]}


def cross_check_phase(cfg: Config, seed: int, dev: torch.device) -> None:
    """512 rays through the renderer on the card and on the CPU, with
    O(1) features. Tolerance 1e-3: CUDA and CPU round transcendental
    functions differently, and the finest level (scale 1024) turns an
    ulp of sample position into ~1e-4 of cell fraction."""
    params = o1_params(cfg, seed + 1, dev)
    occ_vals = seeded_occ_vals(cfg, dev)
    rng = np.random.default_rng(seed)
    o = torch.as_tensor(rng.uniform(-0.3, 0.3, (512, 3)), dtype=torch.float32)
    d = torch.as_tensor(rng.normal(size=(512, 3)), dtype=torch.float32)
    outs = {}
    for name, where in (("cuda", dev), ("cpu", torch.device("cpu"))):
        with torch.no_grad():
            res = renderer.render(_to(params, where), o.to(where),
                                  d.to(where), cfg.model,
                                  occ_vals=occ_vals.to(where))
        outs[name] = (res.colors.cpu(), res.depths.cpu())
    dc = float((outs["cuda"][0] - outs["cpu"][0]).abs().max())
    dd = float(((outs["cuda"][1] - outs["cpu"][1]).abs()
                / (outs["cpu"][1].abs() + 1e-3)).max())
    log(f"render on card vs CPU, 512 rays: max |d color| = {dc:.3e}, "
        f"max rel d depth = {dd:.3e}; color std "
        f"{float(outs['cpu'][0].std()):.3f}")
    if not (dc <= 1e-3 and dd <= 1e-3):
        raise RuntimeError("render on the card disagrees with the CPU")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"device: {kind}; nvidia-smi: {smi}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    secs = build.build_all()
    log(f"built {sorted(secs)} in {time.perf_counter() - t0:.1f} s")
    for name in secs:
        # each kernel instance's mangled name, then its registers, spills
        # and shared memory
        for line in build.build_log(name).splitlines():
            if any(k in line for k in ("entry function", "registers",
                                       "spill")):
                log(f"  {name}: {line.split(':', 1)[-1].strip()}")

    cfg = Config()
    situ = in_situ_inputs(cfg, args.seed, dev)
    kernels = [kernel_phase(cfg, args.seed, dev, situ),
               bwd_kernel_phase(train_cfg(TRAIN_RAYS), args.seed, dev),
               frac_kernel_phase(cfg, args.seed, dev, situ)]
    del situ
    narrow = narrow_channels_check(args.seed, dev)
    for k in kernels:
        k["max_abs_err_c3"] = narrow[k["name"]]
    paths = {"serving": serving_phase(cfg, args.seed, dev),
             "training": training_phase(train_cfg(TRAIN_RAYS), args.seed,
                                        dev),
             "differential": differential_phase(cfg, args.seed, dev)}
    run_dir = run_directory_phase(args.seed, dev)
    for name, res in run_dir.pop("subpaths").items():
        paths[f"run_directory/{name}"] = res
    cross_check_phase(cfg, args.seed, dev)
    step_check = step_check_phase(args.seed, dev)
    pose_check = pose_check_phase(cfg, args.seed, dev)

    for k in kernels:
        by_path = {path: res["launches"][k["name"]]
                   for path, res in paths.items()}
        k["launches"] = sum(by_path.values())
        k["launches_by_path"] = by_path
    for path, res in paths.items():
        log(f"{path}: {json.dumps(res)}")
    log(f"run directory: {json.dumps(run_dir)}")
    log(f"step check: {json.dumps(step_check)}")
    log(f"pose check: {json.dumps(pose_check)}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
