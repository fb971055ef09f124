#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases (each passes or raises; the script exits 0 only if all pass):

1. Device and build: print the card, its power limit, and build every
   CUDA kernel under f2nerf_tpu_torch/kernels/csrc and the host image
   codec (f2nerf_tpu_torch/utils/csrc/image_codec.cpp; one compiler
   process per source, all started together).
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

8. The perspective warp (``warp_mode="perspective"`` at its defaults:
   64 regions, 4 cameras a region, a blend of the 3 nearest charts):
   (a) training at ``bench.py --warp perspective``'s point (phase 4's,
   with the warp tables of ``make_sphere_dataset(n_images=8, h=8,
   w=8)``'s ring, ``bench.py:216-225``), the profiled step naming the
   warp's ops (``record_function("warp_points")``) and their device ms;
   (b) the three kernels on the warp paths' own inputs, checked and
   timed as in phase 2: ``trilinear_fwd`` and ``trilinear_bwd_frac`` on
   one full-frame 106x240 render through the warp at a corridor view,
   ``trilinear_bwd`` on the warp training step's pairs; (c) phase 6 on
   ``make_corridor_dataset()`` (24 views of 128x128 on a 16-unit forward
   path) with the warp: the tables checked bitwise against
   ``build_warp(ds.poses, cfg.model)`` in the trainer, the resumed
   trainer and the localizer, and one mode-0, one mode-1 and one mode-2
   request (launch counts per sub-path, as in phase 6, with mode 2 as
   mode 1; peak memory per request); (d) phase 7's render and pose
   checks through the corridor's tables: the render at phase 7's
   tolerance, the pose gradient at ``WARP_POSE_TOL`` and the warp alone
   at tight tolerances (``pose_check_phase``).
9. The ROS2 node (``node_phase``): stub ``rclpy`` and message modules
   that record what is published, then ``apps.ros2_node.main`` on the
   card over phase 6's run directory in modes 0 and 1 (a frame before
   ``trigger_node_srv`` is refused; then activation, an initial pose 2 cm
   off view ``SERVE_VIEW`` and two bgr8 frames of that view). The
   published poses equal a ``LocalizerService`` of their own on the same
   run, seed and arrays to 1e-6, the images bitwise; per-frame ms of the
   node beside the service alone, the position error. Then one node over
   phase 3's localizer with two 850x1920 frames: the node's own host
   share, and the JAX node's nested-list hand-off timed alone.
10. The dense two-pass (``dense_phase``) at ``bench.py --dense``'s point
   (``Config()`` with the dense sampler, 512 rays x 1024 samples): fields
   for the full bucket (the seeded init) and each prefix bucket (O(1)
   features, a scanned density bias); the two-pass against the single
   pass on one batch, outputs and every param grad, in the full bucket
   and RS/8 with f32 tables at JAX's tolerances and with bf16 tables;
   two runs of a two-pass step giving bitwise-equal ``feat_pool`` grads;
   both modes timed in turns on each field (step ms, device ms, peak
   memory); each prefix bucket's compacted survivor stream as an input
   set of ``trilinear_fwd`` and ``trilinear_bwd``.
11. The xor hash (``xor_phase``): 4 training steps of ``Config()`` with
   ``hash_mode="xor"`` at phase 4's point, none of the three kernels
   launched; whether two runs give bitwise-equal grads (reported); the
   VALIDATE render on the card against the CPU as in phase 7.
12. LPIPS (``lpips_phase``): random weights, two renders of phase 6's
   map against their views, on the card and on the CPU (rel. 1e-4).

13. The multi-device path (``distributed_phase``; ``parallel/mesh.py``):
   the training phase's point (``Config()``, 8192 rays, steps 3072-3075
   with the refresh at 3072) in the default mode and with
   ``grad_blocks=4``, then 3 mode-0 requests and one mode-1 request of
   phases 3 and 5 through a ``LocalizerService``, each (a) in process
   with no process group, (b) as one NCCL rank and (c) as two gloo ranks
   sharing ``cuda:0`` (this script again, ``--dist-worker``, in
   torchrun's environment; every process given ``DIST_TIMEOUT_S``). (b)
   equals (a) bitwise in both modes, (c) in ``grad_blocks`` mode; (c)'s
   default mode is held to the CPU test's tolerances (``check_close``);
   renders, particle weights and reply poses agree to 1e-6; the ranks
   hold the same state bitwise. Step ms, device ms with the collective's
   share, peak memory per rank; (c)'s times are two processes
   time-slicing one card. Then ``torchrun --nproc_per_node=2 -m
   f2nerf_tpu_torch.apps.main train`` (gloo on ``cuda:0``, the textured
   dataset, ``Config.quality`` with ``grad_blocks=4``, 50 steps) against
   the same command in process: ``state.pt`` params and grid bitwise
   equal, the logs' losses equal; one mode-0 request served from the
   torchrun run. Launches per path ``distributed/{a,b,c}/{train,
   grad_blocks,mode0,mode1}`` (summed over the ranks) and
   ``distributed/run/{train_a,mode0}``.

14. The tools (``tools_phase``; ``f2nerf_tpu_torch/tools``), with jax,
   PIL and yaml unimportable: ``make_synthetic_dataset`` (the textured
   scene, 32 views of 128x128, every 8th held out), ``quality_run`` on
   the same split at ``Config.quality``'s width for ``TOOLS_STEPS`` steps
   (its 20,000 cut to fit the time limit), ``eval_holdout`` on the
   held-out directory, ``eval`` on its [gt | pred] strips (random LPIPS
   weights), ``localize_validation`` on the held-out views and
   ``bench_localize``: held-out PSNR / SSIM from both renderers (they must
   agree), LPIPS, the position error before and after recovery, the
   localizer's ms, launches per sub-path ``tools/<name>``.

15. Data prep (``dataprep_phase``), with jax, PIL and yaml (and in
   process zstandard and lz4) unimportable in process and, through a
   ``sitecustomize`` on ``PYTHONPATH``, in the drivers' child processes:
   (a) every fixture of
   ``tests/torch_fixtures/jpeg`` and ``tests/torch_fixtures/codec``
   (baseline and progressive JPEGs; 16-bit, sub-byte, palette and Adam7
   PNGs) decoded by the compiled codec behind ``read_image`` to its
   stored PIL decode exactly, and to the plain numpy decoders' pixels
   wherever they read the file; the host time of the codec and of the
   plain decoders, in ms and ms per megapixel, on three 1920x1080
   frames: a baseline JPEG and a progressive JPEG tiled from fixtures
   (``tile_jpeg``) and a PNG with Paeth- and Sub-filtered rows
   (``filtered_png``); (b) a ``.db3`` bag built with the port's
   ``rosbag_reader`` from ``make_textured_dataset()`` (PNG
   ``CompressedImage`` views on camera0, the world poses as pose messages
   at the views' stamps plus one before and one after, a zero
   calibration) and a second bag of the JPEG fixtures, bgr8 and mono8
   frames, then ``tools.extract_images_from_rosbag`` and
   ``tools.convert_pose_tsv_to_f2_format`` (a ``K`` / ``D``
   ``camera_info.yaml``, ROADMAP fact 8): the images bitwise, the
   ``cams_meta.tsv`` poses within 1e-6; (c) compressed mcap bags
   (``bag_codec_check``): every fixture of ``tests/torch_fixtures/bag``
   (zstd and LZ4 frames that together reach every mode of the compiled
   chunk codec, and the second bag's records plus a ``CameraInfo`` in a
   zstd- and an LZ4-chunked mcap file) decoded to its stored length and
   SHA-256; both mcap bags and a ``.db3`` bag of the same records through
   the extractor and the converter (``K`` written over three lines) to
   the same images, ``pose.tsv`` and ``cams_meta.tsv``, and to the JAX
   extractor's stored images and ``pose.tsv``; the codec's build seconds
   and its host decode rate on each frame fixture (at least
   ``CHUNK_RATE_S`` each); (d) ``tools/full_test.sh`` on that
   dataset with phase 6's ``Config.quality(end_iter=600)`` (the
   training-view PSNR beside phase 6's and an untrained map's); (e)
   ``tools/run_cli_until_done.sh`` training that map on to
   ``DATAPREP_STEPS`` with ``WINDOW_S`` set to cut the first window (a
   SIGTERM checkpoint, a second window, ``DONE``, the last checkpoint at
   ``DATAPREP_STEPS``), the map's training views then at least 5 dB above
   the untrained map's; (f) ``tools.modified_offset_by_particles_log``
   on a seeded particle log and a ``/**:`` parameter file. The child
   processes' launches per sub-path ``dataprep/{train,test,cli_windows}``.
16. The parts benches (``parts_phase``): ``tools.bench_step_parts``,
   ``bench_encode_parts`` and ``bench_dense_parts`` at their JAX scripts'
   points, and ``bench_dense_trained`` on a dense run that ``apps.main
   train`` trains here on the textured scene (``DENSE_RUN_STEPS``): wall
   and device ms of every part, the trained map's survivor share;
   launches per sub-path ``parts/{step,encode,dense,dense_trained}``.
   Each part's device ms is the card's busy time in a ``torch.profiler``
   window over its timed calls (``tools.common.time_part``), beside its
   wall ms and busy share.
17. The held-out diagnostics and ``bench_scaling`` (``diag_phase``),
   with jax, PIL and yaml unimportable: ``tools.diag_holdout`` on phase
   14's quality run (views 7 and 8: both as they are and with the
   directions frozen, their depth percentiles; view 8's normal render
   within ``DIAG_TOL_DB`` of its ``summary.tsv`` row),
   ``tools.eval_appearance_ab`` on it with ``--embs none,mean,own`` (the
   ``emb=none ss=1`` row equal to the summary's train and held-out means
   to ``AB_TOL_DB``), ``tools.bench_scaling`` in train and render mode
   at ``Config()``, 8192 rays, ``--counts 1`` in this process (rays/s
   beside phase 4's), then ``--multiprocess 2 --quick`` on two gloo CPU
   ranks (plumbing: its efficiency is a CPU figure); launches per
   sub-path ``diag/{diag_holdout,eval_appearance_ab,scaling_train,
   scaling_render}``.
18. The JAX system's entry points (``entry_phase``): (a)
   ``f2nerf_tpu_torch.bench.measure`` in each of ``bench.py``'s arms
   (the default, ``--no-quality-machinery``, ``--warp perspective``,
   ``--dense``, ``--quick``) at its default iterations: rays/s above 0
   with the script's unit string, beside phases 4, 8(a) and 10's rays/s
   of the same steps; then ``python -m f2nerf_tpu_torch.bench --iters 10
   --no-cache-write`` with jax, PIL and yaml unimportable: its last line
   the script's four keys, no watchdog or cached value. (b)
   ``graft_entry.entry()``: the flagship VALIDATE render's shapes, finite,
   its first ``ENTRY_CHECK_RAYS`` rays on the card against the CPU as in
   phase 7. (c) ``graft_entry.dryrun_multichip(1)`` in this process in a
   NCCL group of one rank, then ``python -m f2nerf_tpu_torch.graft_entry
   dryrun 2 --backend gloo`` (two gloo ranks on ``cuda:0``): the four
   arms' OK lines (dense, occ, flagship on its refresh step, localize),
   their losses and weights. Launches per sub-path ``entry/{default,
   noqm,warp,dense,quick,cli,render,dry_dense,dry_occ,dry_flagship,
   dry_localize,dry_gloo2}``.

Run dedup (``encode_dedup``, on by default) runs in phases 3-5 and 10;
after phases 3-5, and inside phase 10, it is also switched off and on in
turns (``steps_in_turns``, ``requests_dedup``, ``dense_dedup``): train
steps at phase 4's point, mode-0 and mode-1 requests, and dense two-pass
steps with ``dense_two_pass_dedup`` on the RS/8 and the full field, each
bitwise equal on and off (grads, params, metrics, replies, renders, the
pose gradient); step and request ms, device ms (the ``compute_runs``
scope), launches per sub-path ``dedup/{training,mode0,mode1}/{on,off}``
and ``dense/dedup/{RS/8,RS}/{on,off}``, and the largest run count of each
deduped level against its budget on a train step, a full frame, a
particle render (certified: must hold) and the compacted survivor
streams at RS/2, RS/4, RS/8 (JAX's run-time check: reported).

A phase that fails is reported and the others still run; the script
then exits non-zero. Otherwise one JSON line per the kernels (with the
launches by path: the warp paths under ``warp/``, the node's under
``node/``, the two-pass's under ``dense/``, xor's under ``xor/``, the
multi-device paths' under ``distributed/``, data prep's under
``dataprep/``, the parts benches' under ``parts/``, the diagnostics'
and ``bench_scaling``'s under ``diag/``, the entry points' under
``entry/``), the
``nvidia-smi`` name and power limit, and as the last line ``{"ok": true,
"device": {...}}``. Without a CUDA device it exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import importlib
import importlib.abc
import importlib.util
import io
import json
import os
import pathlib
import re
import signal
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import types
import zlib
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist

from f2nerf_tpu_torch import bench, graft_entry
from f2nerf_tpu_torch.apps import main as cli
from f2nerf_tpu_torch.apps.serve import LocalizerService
from f2nerf_tpu_torch.bench import (N_IMAGES, cameras, ring_warp_consts,
                                    seeded_grid)
from f2nerf_tpu_torch.convert import flatten
from f2nerf_tpu_torch.core.cameras import rays_from_pose
from f2nerf_tpu_torch.core.config import Config, ModelConfig
from f2nerf_tpu_torch.data.dataset import load_dataset, save_dataset
from f2nerf_tpu_torch.data.synthetic import (make_corridor_dataset,
                                             make_textured_dataset)
from f2nerf_tpu_torch.kernels import build, trilinear
from f2nerf_tpu_torch.localize.localizer import Localizer, LocalizerParam
from f2nerf_tpu_torch.models import hash_field, occupancy, renderer
from f2nerf_tpu_torch.models.warp import build_warp, warp_consts
from f2nerf_tpu_torch.ops import hash_paged
from f2nerf_tpu_torch.parallel import mesh as mesh_lib
from f2nerf_tpu_torch.train import checkpoint as ckpt_lib
from f2nerf_tpu_torch.train.loop import Trainer
from f2nerf_tpu_torch.train.optim import make_optimizer
from f2nerf_tpu_torch.train.step import (StepNoise, draw_noise,
                                         make_train_step)
from f2nerf_tpu_torch.utils.image_io import (read_image, resize_image,
                                             write_image)
from f2nerf_tpu_torch.utils.metrics import psnr, ssim


def _load_ros2_stubs() -> types.ModuleType:
    """``tests/_ros2_stubs.py``, the stub ROS modules the node phase runs
    behind (shared with the tests), loaded by its path: another ``tests``
    package on ``sys.path`` would shadow the repo's."""
    path = pathlib.Path(__file__).resolve().parent / "tests" / "_ros2_stubs.py"
    spec = importlib.util.spec_from_file_location("_ros2_stubs", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ros2_stubs = _load_ros2_stubs()

# H100 SXM peaks (NVIDIA data sheet) for the bound: HBM3 bytes/s and
# f32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
KERNEL_TOL = 1e-5          # kernel vs plain version, same inputs
FRAME_H, FRAME_W, RESIZE = 850, 1920, 8   # scripts/bench_localize.py
N_REQUESTS, PARTICLES = 3, 64
N_DIFF_REQUESTS = 3                      # mode-1 requests
CHECK_RESIZE = 48                        # 17x40 frame for the pose check
# bench.py's training operating point (f2nerf_tpu_torch/bench.py)
TRAIN_RAYS = bench.THROUGHPUT_RAYS
STEP0 = bench.first_step(Config())        # 3072
TRAIN_STEPS, STEADY_FROM = 24, 2
CHECK_RAYS = 512
ALL_KERNELS = ("trilinear_fwd", "trilinear_bwd", "trilinear_bwd_frac")
# the run-directory phase: Config.quality trained for RUN_STEPS steps
RUN_STEPS, RUN_REPORT = 600, 50
LOOP_STEPS = 40              # steps per timing window, loop vs bare step
SERVE_VIEW = 5               # the training view the requests localize
POSE_SHIFT = (0.012, -0.008, 0.014)   # world units (2.0 cm)
# the pose gradient through the warp, card vs CPU, of its largest entry
# (pose_check_phase: measured 8.6e-2; the contraction's is 1e-2)
WARP_POSE_TOL = 0.25


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


@contextlib.contextmanager
def captured_page_indices():
    """Inside, every ``hash_paged.page_indices`` call's (page_idx, local,
    frac) is appended to the list this yields."""
    orig = hash_paged.page_indices
    captured = []

    def capture(points, meta):
        captured.append(orig(points, meta))
        return captured[-1]

    with mock.patch.object(hash_paged, "page_indices", capture):
        yield captured


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
    pose = np.eye(3, 4, dtype=np.float32)
    with captured_page_indices() as captured:
        frame = loc.render_image(pose).cpu().numpy()
        loc.optimize_pose_by_random_search(pose, frame, PARTICLES, 1.0)
    haloed = loc.params["field"]["haloed"]
    return {name: (haloed, page_idx.clone(),
                   torch.cat([local.float(), frac], dim=-1))
            for name, (page_idx, local, frac)
            in zip(("frame", "particles"), captured, strict=True)}


def warp_cfg(cfg: Config) -> Config:
    """``cfg`` with the perspective warp at its defaults (64 regions, 4
    cameras a region, a blend of the 3 nearest charts)."""
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, warp_mode="perspective"))


def warp_frame_inputs(seed: int, dev: torch.device,
                      cfg: Config | None = None) -> tuple:
    """The encode inputs of one full-frame 106x240 render through the
    warp (``cfg``, default ``Config()``, with the warp; the tables of
    ``make_corridor_dataset(seed=seed)``; O(1) features) at the
    corridor's view ``SERVE_VIEW``: (bf16 haloed table, page_idx,
    local_frac), 25,440 rays x 64 samples."""
    cfg = warp_cfg(cfg or Config())
    corridor = make_corridor_dataset(seed=seed)
    loc = make_localizer(cfg, seed, dev, params=o1_params(cfg, seed + 6, dev),
                         consts=warp_consts(corridor.poses, cfg.model, dev))
    with captured_page_indices() as captured:
        loc.render_image(corridor.poses[SERVE_VIEW])
    (page_idx, local, frac), = captured
    return (loc.params["field"]["haloed"], page_idx,
            torch.cat([local.float(), frac], dim=-1))


def warp_train_inputs(seed: int, dev: torch.device):
    """``train_step_inputs`` of the warp training step
    (``bench.py --warp perspective``'s point)."""
    cfg = warp_cfg(train_cfg(TRAIN_RAYS))
    return train_step_inputs(cfg, seed, dev, ring_warp_consts(cfg, dev))


def warp_kernel_phase(seed: int, dev: torch.device, kernels: list) -> None:
    """The three kernels on the warp paths' own inputs: ``trilinear_fwd``
    and ``trilinear_bwd_frac`` on one full-frame render through the warp
    (``warp_frame_inputs``, with a seeded O(1) cotangent), and
    ``trilinear_bwd`` on the warp training step's pairs; checked and
    timed as the other input sets, added to ``kernels``' entries."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    by_name = {k["name"]: k for k in kernels}
    frame = warp_frame_inputs(seed, dev)
    by_name["trilinear_fwd"]["in_situ"]["warp_frame"] = fwd_set(
        "warp frame", frame, flush)
    levels, n = frame[1].shape
    channels = frame[0].shape[1] // hash_paged.ROW_PAD
    g = torch.randn((n, levels * channels),
                    generator=torch.Generator(device=dev).manual_seed(seed + 4),
                    device=dev)
    by_name["trilinear_bwd_frac"]["in_situ"]["warp_frame"] = frac_set(
        "warp frame", frame, g, flush)
    del frame, g
    g, page_idx, lf, meta = warp_train_inputs(seed, dev)
    by_name["trilinear_bwd"]["sets"]["warp_train_step"] = bwd_set(
        "warp train step", g, page_idx, lf, meta.total_pages, flush)


def seeded_occ_vals(cfg: Config, dev: torch.device) -> torch.Tensor:
    """The seeded grid as sampler values."""
    return occupancy.occ_values(seeded_grid(cfg, dev), cfg.model)


def train_cfg(rays: int) -> Config:
    cfg = Config()
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, pts_batch_size=rays * 512))


def batch(rng: np.random.Generator, rays: int, dev: torch.device):
    """One of bench.py's batches, on ``dev``."""
    return bench.to_device(bench.batch_data(rng, rays), dev)


def train_step_inputs(cfg: Config, seed: int, dev: torch.device,
                      consts: dict | None = None):
    """page_idx / local_frac of one training step's samples at the bench
    point, and a seeded O(1) cotangent of the encode output; ``consts``:
    the warp tables of a perspective ``cfg``."""
    poses, intr = cameras(dev)
    cam, ij, _ = batch(np.random.default_rng(seed), TRAIN_RAYS, dev)
    noise = draw_noise(cfg, STEP0, TRAIN_RAYS, dev)
    rays_o, rays_d = rays_from_pose(poses[cam.long()], intr[cam.long()],
                                    ij.float())
    smp = occupancy.sample_rays_occ(
        rays_o, rays_d, seeded_occ_vals(cfg, dev), cfg.model,
        rank_u=noise.rank, within_u=noise.within, explore=noise.explore)
    with torch.no_grad():
        pts = hash_field.encode_coords(smp.pts.reshape(-1, 3), cfg.model,
                                       (consts or {}).get("field"))
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


def training_phase(cfg: Config, seed: int, dev: torch.device,
                   consts: dict | None = None, path: str = "training"
                   ) -> dict:
    """bench.py's operating point through the port's training entry
    points; step times on the host clock around synchronized steps.
    ``consts``: the warp tables of a perspective ``cfg``."""
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
        grid, m = step_fn(params, grid, poses, intr, STEP0 + k, *batches[k],
                          consts=consts)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m.loss))
        if k == 1 and torch.equal(params["field"]["feat_pool"], pool0):
            raise RuntimeError("feat_pool did not change by step 2")
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
    check_launches(path, launches, ("trilinear_fwd", "trilinear_bwd"))
    finite = all(bool(torch.isfinite(p).all()) for p in opt.named.values())
    if not (finite and np.all(np.isfinite(losses))):
        raise RuntimeError(f"training diverged: losses {losses}")
    refresh = [k for k in range(TRAIN_STEPS)
               if (STEP0 + k) % cfg.model.occ_update_every == 0]
    steady = times[STEADY_FROM:]
    mean_ms = float(np.mean(steady))
    log(f"train steps (ms): {[round(t, 2) for t in times]}; refresh steps "
        f"{[STEP0 + k for k in refresh]}")
    log(f"{path}: train step at {TRAIN_RAYS} rays: mean {mean_ms:.2f} ms, "
        f"median "
        f"{float(np.median(steady)):.2f} ms over steps {STEP0 + STEADY_FROM}"
        f"-{STEP0 + TRAIN_STEPS - 1} -> {TRAIN_RAYS / mean_ms * 1e3:.0f} "
        f"rays/s; peak memory {peak_gb:.2f} GiB; losses "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    prof = profile_call(lambda: step_fn(params, grid, poses, intr,
                                        STEP0 + TRAIN_STEPS, *batches[0],
                                        consts=consts),
                        f"{path} train step")
    return {"step_ms": times, "mean_ms": mean_ms,
            "median_ms": float(np.median(steady)),
            "refresh_step_ms": [times[k] for k in refresh],
            "rays_per_s": TRAIN_RAYS / mean_ms * 1e3, "peak_mem_gb": peak_gb,
            "launches": launches, "losses": losses, "profile": prof,
            "halo": (halo_times(params["field"]["feat_pool"], cfg)
                     if consts is None else None)}


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
                   where: torch.device | None = None,
                   consts: dict | None = None, mesh=None) -> Localizer:
    """A localizer of the 850x1920 frame at ``resize`` on ``where``
    (default ``dev``), with ``params`` (default: the init's, seeded),
    ``consts`` (the warp tables of a perspective ``cfg``) and ``mesh``."""
    if params is None:
        g = torch.Generator(device=dev).manual_seed(seed)
        params = renderer.init(g, cfg.model, 4, dev)
    intr = np.array([[1000.0, 0, FRAME_W / 2], [0, 1000.0, FRAME_H / 2],
                     [0, 0, 1.0]], np.float32)
    return Localizer(params, cfg, intr, np.zeros(3), 1.0, FRAME_H, FRAME_W,
                     param=LocalizerParam(resize_factor=resize),
                     occ_vals=seeded_occ_vals(cfg, dev), seed=seed,
                     device=where or dev, consts=consts, mesh=mesh)


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


def pose_check_phase(cfg: Config, seed: int, dev: torch.device,
                     consts: dict | None = None,
                     grad_tol: float = 1e-2) -> dict:
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
    card give bitwise-equal gradients is reported, not required.

    ``consts``: the warp tables of a perspective ``cfg``; the gradient is
    then held to ``grad_tol`` (``WARP_POSE_TOL``), and the warp alone to
    tight tolerances (``warp_alone_check``). The warp amplifies an ulp of
    position near its cameras (its Lipschitz constant is O(100)), so
    more samples cross fine-level cell edges between the card and the
    CPU (measured on an NVIDIA H100 80GB HBM3, 700 W: card vs CPU 8.6e-2
    of the largest entry, the CPU's own move under a 1e-7 shift
    3.0e-2)."""
    params = o1_params(cfg, seed + 7, dev)
    locs = {name: make_localizer(cfg, seed, dev, params=params,
                                 resize=CHECK_RESIZE, where=where,
                                 consts=consts)
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
    log(f"{'warp ' if consts else ''}pose loss and gradient on card vs CPU, "
        f"{locs['cpu'].infer_height}x{locs['cpu'].infer_width} frame: loss "
        f"{loss_a:.6e} vs {loss_c:.6e} (rel {loss_rel:.1e}), max |d grad| / "
        f"max |grad| = {rel:.2e} (max |grad| {scale:.3e}; the CPU gradient "
        f"at the pose shifted by 1e-7: {shift_rel:.2e}); two runs on the "
        f"card bitwise equal: {bitwise}; gradient tolerance {grad_tol:g}")
    res = {"loss_cuda": loss_a, "loss_cpu": loss_c, "loss_rel": loss_rel,
           "grad_rel": rel, "grad_scale": scale, "grad_tol": grad_tol,
           "cpu_shift_grad_rel": shift_rel, "bitwise_equal": bitwise}
    if consts:
        res["warp_alone"] = warp_alone_check(consts, dev)
    if not (loss_rel <= 1e-5 and rel <= grad_tol):
        raise RuntimeError("the pose gradient on the card disagrees with "
                           "the CPU")
    return res


def warp_alone_check(consts: dict, dev: torch.device) -> dict:
    """``warp_points`` with the default blend on 65,536 seeded points
    around the anchors, on the card and on the CPU. Tolerances: values
    atol 1e-5 (coordinates up to 2; an ulp there is 2.4e-7), the
    gradient of sum(sin(3 y)) 1e-4 of its largest entry (the CPU against
    the JAX package: 1.3e-6 and 1.1e-6, ``tests/test_torch_warp.py``)."""
    anchors = consts["field"]["warp_anchors"].cpu()
    g = torch.Generator().manual_seed(11)
    pick = torch.randint(0, anchors.shape[0], (65536,), generator=g)
    pts = anchors[pick] + 0.3 * torch.randn((65536, 3), generator=g)
    cfg = warp_cfg(Config()).model
    outs = {}
    for name, where in (("cuda", dev), ("cpu", torch.device("cpu"))):
        x = pts.to(where).requires_grad_(True)
        y = hash_field.encode_coords(x, cfg, _to(consts, where)["field"])
        torch.sum(torch.sin(3.0 * y)).backward()
        outs[name] = (y.detach().cpu(), x.grad.cpu())
    val = float((outs["cuda"][0] - outs["cpu"][0]).abs().max())
    scale = float(outs["cpu"][1].abs().max())
    grad = float((outs["cuda"][1] - outs["cpu"][1]).abs().max()) / scale
    log(f"  the warp alone on card vs CPU, 65,536 points: max |d y| = "
        f"{val:.3e} (tol 1e-5), max |d grad| / max |grad| = {grad:.3e} "
        f"(tol 1e-4)")
    if not (val <= 1e-5 and grad <= 1e-4):
        raise RuntimeError("the warp on the card disagrees with the CPU")
    return {"max_value_err": val, "grad_rel": grad}


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
    check_launches(name, res["launches"], used)
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
    live = flatten(tr.consts)
    if set(live) != set(state["consts"]) or not all(
            torch.equal(live[k].cpu(), v) for k, v in state["consts"].items()):
        raise RuntimeError("resumed consts differ from the checkpoint")


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


def run_directory_phase(seed: int, dev: torch.device, root: pathlib.Path,
                        warp: bool = False) -> dict:
    """Dataset directory -> train -> run directory -> resume, test, serve,
    through the CLI and the service, with yaml and PIL unimportable (see
    the module docstring, phases 6 and 8c). The dataset goes to
    ``root/data``, the run to ``root/run`` (kept for phases 9 and 12).
    ``warp``: the corridor in ``warp_mode="perspective"``, with the
    tables checked and a mode-2 request, and no loop timing."""
    t_phase = time.perf_counter()
    name = "warp run-directory" if warp else "run-directory"
    sub = {}
    with unimportable("yaml", "PIL"):
        data, run = root / "data", root / "run"
        make = make_corridor_dataset if warp else make_textured_dataset
        save_dataset(make(seed=seed), data)
        run.mkdir(parents=True)
        cfg = Config.quality(end_iter=RUN_STEPS)
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, report_freq=RUN_REPORT, save_freq=RUN_STEPS // 2,
            vis_freq=RUN_STEPS))
        if warp:
            cfg = warp_cfg(cfg)
        cfg.save(run / "train_config.yaml")
        t_setup = time.perf_counter() - t_phase

        sub["train"], _ = _subpath(
            f"{name} train", ("trilinear_fwd", "trilinear_bwd"),
            lambda: cli.main(["train", str(run), str(data)]))
        reports = _log_reports(run / "train_log.txt")
        log(f"{name}: train PSNR (smoothed) per report: " + ", ".join(
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
        if warp:
            _check_tables(tr.consts, build_warp(ds.poses, tr.cfg.model),
                          "the trainer's")
        if not tr.try_resume():
            raise RuntimeError("try_resume found no checkpoint")
        _check_resumed(tr, ckpt_lib.restore(run / "checkpoints"))
        if warp:
            _check_tables(tr.consts, build_warp(ds.poses, tr.cfg.model),
                          "the resumed trainer's")
        log(f"{name}: resumed at step {tr.step} bitwise equal to the "
            f"checkpoint{', tables included' if warp else ''}; batch "
            f"source: {tr.batch_source}")
        n_log = len((run / "train_log.txt").read_text().splitlines())
        cli.main(["train", str(run), str(data)])
        if (len((run / "train_log.txt").read_text().splitlines()) != n_log
                or ckpt_lib.latest_step(run / "checkpoints") != RUN_STEPS):
            raise RuntimeError("the second train call trained")

        sub["test"], _ = _subpath(
            f"{name} test", ("trilinear_fwd",),
            lambda: cli.main(["test", str(run), str(data)]))
        summary = (run / "test_result" / "summary.tsv").read_text()
        pairs = [read_image(run / "test_result" / f"{i:08d}.png")
                 for i in range(ds.n_images)]
        w = pairs[0].shape[1] // 2
        test_psnr = float(np.mean([psnr(x[:, w:], x[:, :w]) for x in pairs]))
        test_ssim = float(np.mean([ssim(x[:, w:], x[:, :w]) for x in pairs]))
        log(f"{name}: test summary.tsv: {summary.strip()!r}; renders "
            f"{pairs[0].shape[0]}x{w}: mean PSNR {test_psnr:.3f}, SSIM "
            f"{test_ssim:.4f}")

        loc = Localizer.from_checkpoint(run)
        if warp:
            _check_tables(loc.consts, build_warp(ds.poses, cfg.model),
                          "the localizer's")
        full = [loc.render_image(ds.poses[i]).cpu().numpy()
                for i in range(ds.n_images)]
        view_psnr = float(np.mean([psnr(f, g) for f, g in
                                   zip(full, ds.images)]))
        view_ssim = float(np.mean([ssim(f, g) for f, g in
                                   zip(full, ds.images)]))
        log(f"{name}: training views at {ds.height}x{ds.width}: mean PSNR "
            f"{view_psnr:.3f}, SSIM {view_ssim:.4f}")

        svc = LocalizerService(loc)
        true_world = loc.camera2world(ds.poses[SERVE_VIEW])
        moved = true_world.copy()
        moved[:3, 3] += POSE_SHIFT
        image = ds.images[SERVE_VIEW].tolist()
        requests = {}
        modes = [(0, ("trilinear_fwd",)),
                 (1, ("trilinear_fwd", "trilinear_bwd_frac"))]
        if warp:
            modes.append((2, ("trilinear_fwd", "trilinear_bwd_frac")))
        for mode, used in modes:
            if not svc.handle({"cmd": "init_pose",
                               "pose": moved.tolist()})["ok"]:
                raise RuntimeError("init_pose failed")
            req = {"cmd": "localize", "image": image, "mode": mode}
            if mode == 0:
                req["particle_num"] = PARTICLES
            torch.cuda.reset_peak_memory_stats(dev)
            sub[f"mode{mode}"], r = _subpath(f"{name} mode {mode}", used,
                                             lambda: svc.handle(req))
            check_reply(r, f"{name} mode-{mode} request")
            requests[mode] = {
                "position_error_before": _pose_error(moved, true_world),
                "position_error_after": _pose_error(r["pose"], true_world),
                "score": r["score"],
                "ms": sub[f"mode{mode}"]["wall_s"] * 1e3,
                "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 2**30}
            log(f"{name}: mode-{mode} request on view {SERVE_VIEW}: position "
                f"error {requests[mode]['position_error_before']:.4f} -> "
                f"{requests[mode]['position_error_after']:.4f} (world units), "
                f"score {r['score']:.4g}, {requests[mode]['ms']:.1f} ms, "
                f"peak memory {requests[mode]['peak_mem_gb']:.2f} GiB")

        timing = None if warp else loop_vs_bare(tr)
        batch_source = tr.batch_source
        tr.close()
    wall_s = time.perf_counter() - t_phase
    log(f"{name} phase: {wall_s:.1f} s (set-up {t_setup:.1f} s, "
        f"train {sub['train']['wall_s']:.1f} s for {RUN_STEPS} steps)")
    return {"subpaths": sub, "reports": reports, "test_summary": summary,
            "test_psnr": test_psnr, "test_ssim": test_ssim,
            "view_psnr": view_psnr, "view_ssim": view_ssim,
            "requests": requests, "timing": timing,
            "batch_source": batch_source, "wall_s": wall_s}


def _check_tables(consts: dict, ref, whose: str) -> None:
    """``consts`` hold the tables ``ref`` (``build_warp``) bitwise."""
    for key, arr in (("warp_anchors", ref.anchors), ("warp_rows", ref.rows)):
        if not np.array_equal(consts["field"][key].cpu().numpy(), arr):
            raise RuntimeError(f"{whose} {key} differ from build_warp's")


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
    res = {"wall_ms": wall_ms, "device_ms": device_ms,
           "top": [[name[:60], ms] for name, ms in top]}
    spans = [e for e in prof.key_averages() if e.key == "mesh/all_reduce"
             and e.device_type == torch.autograd.DeviceType.CPU]
    if spans:
        # the collective: its host time, NCCL's kernels, and the copies
        # to and from pinned host memory that gloo's all-reduce of CUDA
        # tensors makes (it reduces on the host)
        res["collective"] = {
            "calls": sum(e.count for e in spans),
            "host_ms": sum(e.cpu_time_total for e in spans) / 1e3,
            "nccl_device_ms": sum(ms for k, ms in kernels.items()
                                  if "nccl" in k.lower()),
            "host_copy_ms": sum(ms for k, ms in kernels.items()
                                if k.startswith(("Memcpy DtoH",
                                                 "Memcpy HtoD")))}
    runs = scope_ms(prof, "compute_runs")
    if runs["calls"]:
        log(f"  run dedup (compute_runs, {runs['calls']} calls): "
            f"{runs['device_ms']:.3f} ms of device kernels")
        res["compute_runs"] = runs
    warp = scope_ms(prof, "warp_points")
    if warp["calls"]:
        log(f"  the warp (warp_points, {warp['calls']} calls): "
            f"{warp['device_ms']:.3f} ms of device kernels: "
            + ", ".join(f"{op} {ms:.3f}" for op, ms in warp["ops"].items()))
        res["warp"] = warp
    return res


def scope_ms(prof, name: str) -> dict:
    """The device time of the kernels launched inside every
    ``record_function(name)`` range of a profile (forward only: autograd
    runs a backward outside the range), in all and by the range's
    direct child ops."""
    ops, calls = {}, 0
    for evt in prof.events():
        if evt.name != name or evt.device_type != torch.autograd.DeviceType.CPU:
            continue
        calls += 1
        for child in evt.cpu_children:
            us = getattr(child, "device_time_total", None)
            if us is None:
                us = child.cuda_time_total
            ops[child.name] = ops.get(child.name, 0.0) + us / 1e3
    ops = dict(sorted(ops.items(), key=lambda kv: -kv[1]))
    return {"calls": calls, "device_ms": sum(ops.values()), "ops": ops}


def cross_check_phase(cfg: Config, seed: int, dev: torch.device,
                      consts: dict | None = None, what: str = "render"
                      ) -> dict:
    """512 rays through the renderer on the card and on the CPU, with
    O(1) features (``consts``: the warp tables of a perspective ``cfg``,
    the hash constants of an xor ``cfg``). Tolerance 1e-3: CUDA and CPU
    round transcendental functions differently, and the finest level
    (scale 1024) turns an ulp of sample position into ~1e-4 of cell
    fraction."""
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
                                  occ_vals=occ_vals.to(where),
                                  consts=_to(consts or {}, where))
        outs[name] = (res.colors.cpu(), res.depths.cpu())
    dc = float((outs["cuda"][0] - outs["cpu"][0]).abs().max())
    dd = float(((outs["cuda"][1] - outs["cpu"][1]).abs()
                / (outs["cpu"][1].abs() + 1e-3)).max())
    std = float(outs["cpu"][0].std())
    log(f"{what} on card vs CPU, 512 rays: max |d color| = {dc:.3e}, "
        f"max rel d depth = {dd:.3e}; color std {std:.3f}")
    if not (dc <= 1e-3 and dd <= 1e-3):
        raise RuntimeError(f"{what} on the card disagrees with the CPU")
    return {"max_color_err": dc, "max_rel_depth_err": dd, "color_std": std}


# -- phase 9: the ROS2 node ---------------------------------------------------

@contextlib.contextmanager
def ros2_node_module(spin):
    """``f2nerf_tpu_torch.apps.ros2_node`` imported against the stub ROS
    modules of ``tests/_ros2_stubs.py`` (ROS2 itself lives only in a ROS2
    workspace; the node gates ``rclpy`` at import time), ``rclpy.spin``
    being ``spin``; ``sys.modules`` is restored on exit."""
    name = "f2nerf_tpu_torch.apps.ros2_node"
    with mock.patch.dict(sys.modules, ros2_stubs.modules(spin)):
        sys.modules.pop(name, None)
        mod = importlib.import_module(name)
        if not mod.HAVE_RCLPY:
            raise RuntimeError("ros2_node did not take the stub rclpy")
        yield mod


def bgr8_message(rgb: np.ndarray, stamp: int) -> ros2_stubs.Image:
    """A float [H, W, 3] RGB frame in [0, 1] as a bgr8 Image message."""
    q = np.clip(rgb * 255.0, 0, 255).astype(np.uint8)
    msg = ros2_stubs.Image()
    msg.height, msg.width, msg.encoding = q.shape[0], q.shape[1], "bgr8"
    msg.step = q.shape[1] * 3
    msg.data = np.ascontiguousarray(q[..., ::-1]).tobytes()
    msg.header.stamp = stamp
    return msg


def _pose_vector(pose: ros2_stubs.Pose) -> np.ndarray:
    """(x, y, z, qx, qy, qz, qw), the quaternion's sign fixed by qw."""
    v = np.array([pose.position.x, pose.position.y, pose.position.z,
                  pose.orientation.x, pose.orientation.y, pose.orientation.z,
                  pose.orientation.w])
    v[3:] *= 1.0 if v[6] >= 0 else -1.0
    return v


def drive_node(rn, node, init, frames, seed: int | None) -> list[float]:
    """Stands in for the topics: a frame before activation (refused),
    ``trigger_node_srv(True)``, the initial pose, then ``frames``; the
    localizer's particle draws seeded with ``seed``. Returns each
    frame's wall ms (host clock, synchronized)."""
    if seed is not None:
        node.service.localizer._rng = np.random.default_rng(seed)
    node.callback_image(frames[0])
    if len(node.get_logger().errors) != 1 or node.pub_pose.published:
        raise RuntimeError("the node localized before trigger_node_srv")
    res = types.SimpleNamespace(success=None)
    node.service_trigger_node(types.SimpleNamespace(data=True), res)
    if not (res.success and node.is_activated):
        raise RuntimeError("trigger_node_srv did not activate the node")
    node.callback_initial_pose(init)
    times = []
    for f in frames:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        node.callback_image(f)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    if len(node.get_logger().errors) != 1:
        raise RuntimeError(f"node errors: {node.get_logger().errors}")
    return times


def check_published(node, frames, shape: tuple) -> None:
    """One pose, pose with covariance, score and image per frame, well
    formed, each stamped with its frame."""
    n = len(frames)
    pubs = (node.pub_pose, node.pub_pose_cov, node.pub_score, node.pub_image)
    if [len(p.published) for p in pubs] != [n] * 4:
        raise RuntimeError(f"published {[len(p.published) for p in pubs]} "
                           f"messages per topic for {n} frames")
    for k, f in enumerate(frames):
        ps, pc = node.pub_pose.published[k], node.pub_pose_cov.published[k]
        v = _pose_vector(ps.pose)
        if not (np.isfinite(v).all()
                and abs(np.linalg.norm(v[3:]) - 1.0) < 1e-5
                and ps.header.stamp == pc.header.stamp == f.header.stamp
                and ps.header.frame_id == "map"
                and np.array_equal(_pose_vector(pc.pose.pose), v)
                and len(pc.pose.covariance) == 36
                and np.isfinite(node.pub_score.published[k].data)):
            raise RuntimeError(f"frame {k}: malformed pose or score")
        img = node.pub_image.published[k]
        if ((img.height, img.width) != shape[:2] or img.encoding != "rgb8"
                or len(img.data) != shape[0] * shape[1] * 3):
            raise RuntimeError(f"frame {k}: published image {img.height}x"
                               f"{img.width} {img.encoding}")


def node_phase(seed: int, dev: torch.device, root: pathlib.Path) -> dict:
    """Phase 9: ``apps.ros2_node.main`` over phase 6's run directory
    (``root/run``) on the card, behind stub ROS modules, in modes 0 and 1:
    an initial pose ``POSE_SHIFT`` off view ``SERVE_VIEW`` and two bgr8
    frames of that view. Each mode's published poses are held to 1e-6
    against a ``LocalizerService`` of its own on the same run, seed and
    inputs, and its images to the service's render bitwise; then one
    node at the serving phase's 850x1920 frame (``node_frame_check``)."""
    stubs = types.SimpleNamespace(drive=None)
    run = root / "run"
    ds = load_dataset(root / "data")
    out = {"subpaths": {}}
    with unimportable("yaml", "PIL"), ros2_node_module(
            lambda node: stubs.drive(node)) as rn:
        probe = Localizer.from_checkpoint(run, device=dev)
        true_world = probe.camera2world(ds.poses[SERVE_VIEW])
        del probe
        moved = true_world.copy()
        moved[:3, 3] += POSE_SHIFT
        init = ros2_stubs.PoseWithCovarianceStamped()
        init.pose.pose = rn.matrix_to_pose_msg(ros2_stubs.Pose, moved)
        frames = [bgr8_message(ds.images[SERVE_VIEW], stamp)
                  for stamp in (11, 12)]
        for mode, used in ((0, ("trilinear_fwd",)),
                           (1, ("trilinear_fwd", "trilinear_bwd_frac"))):
            got = {}

            def drive(node):
                got["node"] = node
                got["frame_ms"] = drive_node(rn, node, init, frames, seed)

            stubs.drive = drive
            argv = [str(run), "--optimization_mode", str(mode),
                    "--resize_factor", "1", "--particle_num", str(PARTICLES)]
            sub, rc = _subpath(f"node mode {mode}", used,
                               lambda: rn.main(argv))
            node = got["node"]
            if rc != 0 or node.service.localizer.device != dev:
                raise RuntimeError(f"node main returned {rc} on "
                                   f"{node.service.localizer.device}")
            check_published(node, frames, (ds.height, ds.width))

            # the service alone, on its own localizer, same seed and inputs
            svc = LocalizerService(Localizer.from_checkpoint(
                run, LocalizerParam(resize_factor=1), device=dev))
            svc.localizer._rng = np.random.default_rng(seed)
            svc.handle({"cmd": "init_pose", "pose": rn.pose_msg_to_matrix(
                init.pose.pose.position, init.pose.pose.orientation).tolist()})
            svc_ms, pose_err, images_equal = [], 0.0, True
            for k, f in enumerate(frames):
                image = rn.image_msg_to_array(f)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r = svc.handle({"cmd": "localize", "image": image,
                                "mode": mode, "particle_num": PARTICLES,
                                "return_image": True})
                torch.cuda.synchronize()
                svc_ms.append((time.perf_counter() - t0) * 1e3)
                check_reply(r, f"direct mode-{mode} request {k}")
                want = _pose_vector(rn.matrix_to_pose_msg(
                    ros2_stubs.Pose, np.asarray(r["pose"])))
                got_v = _pose_vector(node.pub_pose.published[k].pose)
                pose_err = max(pose_err, float(np.abs(got_v - want).max()))
                want_img = rn.array_to_image_msg(
                    ros2_stubs.Image, np.asarray(r["rendered"], np.float32),
                    "map", 0)
                images_equal &= (node.pub_image.published[k].data
                                 == want_img.data)
            last = node.pub_pose.published[-1].pose.position
            err_after = float(np.linalg.norm(
                np.array([last.x, last.y, last.z]) - true_world[:3, 3]))
            res = {"frame_ms": got["frame_ms"], "service_ms": svc_ms,
                   "max_pose_diff": pose_err, "images_equal": images_equal,
                   "position_error_before": _pose_error(moved, true_world),
                   "position_error_after": err_after,
                   "scores": [m.data for m in node.pub_score.published]}
            log(f"node mode {mode} (main on {dev}, {ds.height}x{ds.width} "
                f"frames): per frame {[round(t, 2) for t in res['frame_ms']]}"
                f" ms vs the service alone "
                f"{[round(t, 2) for t in svc_ms]} ms; published pose vs the "
                f"service's: max |d| = {pose_err:.2e} (tol 1e-6), images "
                f"bitwise equal: {images_equal}; position error "
                f"{res['position_error_before']:.4f} -> {err_after:.4f} "
                f"(world units)")
            if not (pose_err <= 1e-6 and images_equal):
                raise RuntimeError(f"node mode {mode} disagrees with the "
                                   f"service")
            out[f"mode{mode}"] = res
            out["subpaths"][f"mode{mode}"] = sub
        out["mode0_850x1920"], out["subpaths"]["mode0_850x1920"] = \
            node_frame_check(rn, seed, dev)
    return out


def node_frame_check(rn, seed: int, dev: torch.device) -> tuple[dict, dict]:
    """One node over the serving phase's localizer (``Config()``,
    850x1920 frames at resize factor 8), two mode-0 frames of 850x1920:
    the node's per-frame wall time beside the service alone on the same
    arrays, and the host parts alone: the message to a float32 array,
    and the nested-list hand-off the JAX node makes (``tolist`` and back),
    which the port's node skips."""
    loc = make_localizer(Config(), seed, dev)
    svc = LocalizerService(loc)
    node = rn.NerfBasedLocalizerNode(svc, optimization_mode=0,
                                     particle_num=PARTICLES)
    pose, target = target_frame(loc)
    init = ros2_stubs.PoseWithCovarianceStamped()
    init.pose.pose = rn.matrix_to_pose_msg(ros2_stubs.Pose,
                                           loc.camera2world(pose))
    big = resize_image(target, FRAME_H, FRAME_W)
    frames = [bgr8_message(big, stamp) for stamp in (21, 22)]
    sub, frame_ms = _subpath("node mode 0 at 850x1920", ("trilinear_fwd",),
                             lambda: drive_node(rn, node, init, frames, seed))
    check_published(node, frames, (loc.infer_height, loc.infer_width))
    svc_ms, conv_ms, list_ms = [], [], []
    for f in frames:
        t0 = time.perf_counter()
        image = rn.image_msg_to_array(f)
        conv_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        np.asarray(image.tolist(), dtype=np.float32)
        list_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = svc.handle({"cmd": "localize", "image": image, "mode": 0,
                        "particle_num": PARTICLES, "return_image": True})
        torch.cuda.synchronize()
        svc_ms.append((time.perf_counter() - t0) * 1e3)
        check_reply(r, "850x1920 mode-0 request")
    share = 1.0 - float(np.mean(svc_ms)) / float(np.mean(frame_ms))
    log(f"node mode 0 at {FRAME_H}x{FRAME_W} frames (rendered "
        f"{loc.infer_height}x{loc.infer_width}): per frame "
        f"{[round(t, 2) for t in frame_ms]} ms vs the service alone "
        f"{[round(t, 2) for t in svc_ms]} ms (the node's own share "
        f"{share:.1%}); alone: message -> array "
        f"{[round(t, 2) for t in conv_ms]} ms, the JAX node's list hand-off "
        f"(tolist + asarray) {[round(t, 1) for t in list_ms]} ms")
    return ({"frame_ms": frame_ms, "service_ms": svc_ms,
             "node_share": share, "msg_to_array_ms": conv_ms,
             "list_handoff_ms": list_ms}, sub)


# -- phase 10: the dense two-pass ---------------------------------------------

DENSE_RAYS = bench.DENSE_RAYS   # bench.py --dense: 512 rays x 1024 samples
DENSE_WINDOW = 4            # steps a timing window; in turns S, T, T, S
DENSE_BIASES = tuple(np.arange(2.0, 16.5, 0.5))   # density biases scanned


def dense_cfg(two_pass: bool, bf16: bool = True) -> Config:
    """``bench.py --dense``'s point (``bench.py:196-201``): ``Config()``
    with the dense sampler, 512 rays a step."""
    cfg = train_cfg(DENSE_RAYS)
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, sampler_mode="dense", dense_two_pass=two_pass,
        bf16_features=bf16))


def dense_params(cfg: Config, seed: int, dev: torch.device,
                 bias: float | None) -> dict:
    """The seeded init (``bias`` None: ~1e-4 features, nothing
    terminates) or O(1) features with density bias ``bias``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    params = renderer.init(g, cfg.model, N_IMAGES, dev)
    if bias is not None:
        pool = params["field"]["feat_pool"]
        params["field"]["feat_pool"] = torch.rand(
            pool.shape, generator=g, device=dev) * 2 - 1
        params["field"]["mlp"]["b"][0] = bias
    return params


def dense_render(params, cfg: Config, b, noise):
    """A TRAIN render of batch ``b`` (cam, ij, gt) on bench.py's cameras."""
    poses, intr = cameras(b[0].device)
    cam = b[0].long()
    rays_o, rays_d = rays_from_pose(poses[cam], intr[cam], b[1].float())
    return renderer.render(params, rays_o, rays_d, cfg.model, emb_idx=cam,
                           noise=noise)


def _clone(tree: dict) -> dict:
    """Detached copies of every leaf (new leaves for an optimizer)."""
    return {k: _clone(v) if isinstance(v, dict) else v.detach().clone()
            for k, v in tree.items()}


def _worst(a: torch.Tensor, b: torch.Tensor, rtol: float, atol: float
           ) -> float:
    """max |a - b| / (atol + rtol |b|): within tolerance when <= 1."""
    a, b = a.detach(), b.detach()
    return float(((a - b).abs() / (atol + rtol * b.abs())).max())


def two_pass_check(params, b, noise, bf16: bool) -> dict:
    """The two-pass against the single pass on one batch, outputs and the
    grads of sum(colors) + sum(depths) + sum(weights * t) in every param
    leaf, at JAX's own tolerances (``tests/test_renderer.py:224-250``:
    colors rtol/atol 1e-5, depths 1e-4, weights rtol 1e-5 atol 1e-6, the
    mask exactly, ``sec_density`` under the mask and exactly 0 outside;
    grads rtol 5e-3 atol 1e-6) with f32 tables (``bf16=False``, as JAX
    holds them). With bf16 tables the grads are held as phase 7 holds
    them, atol 1e-2 of each leaf's largest |grad|: one bf16 rounding of
    each page-gradient cell can go either way when the f32 sums differ in
    order."""
    outs = {}
    for two_pass in (False, True):
        p = _clone(params)
        leaves = flatten(p)
        for v in leaves.values():
            v.requires_grad_(True)
        res = dense_render(p, dense_cfg(two_pass, bf16), b, noise)
        (res.colors.sum() + res.depths.sum()
         + (res.weights * res.t).sum()).backward()
        outs[two_pass] = (res, {k: v.grad for k, v in leaves.items()})
    (sp, gs), (tp, gt) = outs[False], outs[True]
    if not torch.equal(sp.mask, tp.mask):
        raise RuntimeError("two-pass mask differs from the single pass")
    m = sp.mask
    worst = {"colors": _worst(tp.colors, sp.colors, 1e-5, 1e-5),
             "depths": _worst(tp.depths, sp.depths, 1e-4, 1e-4),
             "weights": _worst(tp.weights, sp.weights, 1e-5, 1e-6),
             "sec_density": _worst(tp.sec_density * m, sp.sec_density * m,
                                   1e-5, 1e-6)}
    tail = float((tp.sec_density.detach() * ~m).abs().max())
    grads = {}
    for k, g in gt.items():
        if bf16:
            grads[k] = float((g - gs[k]).abs().max()) / (
                1e-2 * max(float(gs[k].abs().max()), 1e-30))
        else:
            grads[k] = _worst(g, gs[k], 5e-3, 1e-6)
    worst["grads"] = max(grads.values())
    ok = all(v <= 1.0 for v in worst.values()) and tail == 0.0
    return {"worst": worst, "grads": grads, "tail": tail, "ok": ok,
            "explore_none": tp.explore is None}


def _capture_compacted(params, cfg: Config, b, noise) -> tuple:
    """The compacted survivor stream of one two-pass render: the
    (page_idx, local_frac) of pass 2's encode."""
    with torch.no_grad(), captured_page_indices() as captured:
        dense_render(params, cfg, b, noise)
    if len(captured) != 2:
        raise RuntimeError(f"{len(captured)} encodes in a two-pass render")
    page_idx, local, frac = captured[1]
    return page_idx, torch.cat([local.float(), frac], dim=-1)


def dense_timing(params, b_list, dev: torch.device, what: str) -> dict:
    """Single pass and two-pass training steps from the same field, each
    with its own copy and optimizer, ``DENSE_WINDOW`` steps a window in
    turns single, two, two, single; step ms on the host clock around
    synchronized steps, launches and peak memory per mode, the buckets
    the two-pass took, then one profiled step of each."""
    sizes = []
    orig = hash_field.query_compacted

    def spy(p, points, *a, **kw):
        sizes.append(points.shape[0])
        return orig(p, points, *a, **kw)

    poses, intr = cameras(dev)
    runs = {}
    for mode, two_pass in (("single_pass", False), ("two_pass", True)):
        p = _clone(params)
        opt = make_optimizer(p, dense_cfg(two_pass).train)
        runs[mode] = {"params": p,
                      "step": make_train_step(dense_cfg(two_pass), opt),
                      "k": 0, "ms": [], "peak_gb": 0.0,
                      "launches": dict.fromkeys(ALL_KERNELS, 0)}
    with mock.patch.object(hash_field, "query_compacted", spy):
        for mode in ("single_pass", "two_pass", "two_pass", "single_pass"):
            r = runs[mode]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            zero_launches()
            for _ in range(DENSE_WINDOW):
                b = b_list[r["k"] % len(b_list)]
                t0 = time.perf_counter()
                r["step"](r["params"], None, poses, intr, STEP0 + r["k"], *b)
                torch.cuda.synchronize()
                r["ms"].append((time.perf_counter() - t0) * 1e3)
                r["k"] += 1
            for name, count in read_launches().items():
                r["launches"][name] += count
            r["peak_gb"] = max(r["peak_gb"], torch.cuda.max_memory_allocated(
                dev) / 2**30)
        out = {}
        for mode, r in runs.items():
            check_launches(f"dense {what} {mode}", r["launches"],
                           ("trilinear_fwd", "trilinear_bwd"))
            b = b_list[0]
            prof = profile_call(
                lambda: r["step"](r["params"], None, poses, intr,
                                  STEP0 + r["k"], *b),
                f"dense {what} {mode} step")
            out[mode] = {"step_ms": r["ms"],
                         "mean_ms": float(np.mean(r["ms"][1:])),
                         "peak_mem_gb": r["peak_gb"],
                         "launches": r["launches"], "profile": prof}
    out["buckets"] = sorted(set(sizes))
    log(f"dense {what}: step ms single pass {[round(t, 2) for t in out['single_pass']['step_ms']]}"
        f" vs two-pass {[round(t, 2) for t in out['two_pass']['step_ms']]} "
        f"(means from the 2nd step {out['single_pass']['mean_ms']:.2f} vs "
        f"{out['two_pass']['mean_ms']:.2f}); device ms "
        f"{out['single_pass']['profile']['device_ms']:.2f} vs "
        f"{out['two_pass']['profile']['device_ms']:.2f}; peak memory "
        f"{out['single_pass']['peak_mem_gb']:.2f} vs "
        f"{out['two_pass']['peak_mem_gb']:.2f} GiB; buckets taken "
        f"{out['buckets']}")
    return out


def dense_phase(seed: int, dev: torch.device, kernels: list) -> dict:
    """Phase 10 at ``bench.py --dense``'s point: the fields (the seeded
    init, where nothing terminates, and O(1) features with the first bias
    of ``DENSE_BIASES`` whose survivors land in each prefix bucket), the
    two-pass held against the single pass in the full bucket and in RS/8
    (f32 and bf16 tables, ``two_pass_check``), two runs of a two-pass step
    giving bitwise-equal ``feat_pool`` grads, both modes timed on every
    field (``dense_timing``), and each prefix bucket's compacted survivor
    stream as an input set of ``trilinear_fwd`` and ``trilinear_bwd``
    (added to ``kernels``' entries)."""
    cfg = dense_cfg(True)
    n = DENSE_RAYS * cfg.model.n_samples
    rng = np.random.default_rng(seed + 10)
    b_list = [batch(rng, DENSE_RAYS, dev) for _ in range(2 * DENSE_WINDOW)]
    noise = draw_noise(cfg, STEP0, DENSE_RAYS, dev)
    fields, scan = {}, []
    for bias in (None, *map(float, DENSE_BIASES)):
        p = dense_params(cfg, seed, dev, bias)
        with torch.no_grad():
            n_surv = int(dense_render(p, dense_cfg(False), b_list[0],
                                      noise).mask.sum())
        bucket = renderer.two_pass_bucket(n, n_surv)
        name = "RS" if bucket == n else f"RS/{n // bucket}"
        scan.append((bias, n_surv / n, name))
        if name not in fields:
            fields[name] = {"params": p, "bias": bias,
                            "survivor_share": n_surv / n, "bucket": bucket}
    log(f"dense fields at {DENSE_RAYS} rays x {cfg.model.n_samples} samples "
        f"({n} points): density bias -> survivor share, bucket: "
        + ", ".join(f"{b}: {s:.3f} {nm}" for b, s, nm in scan))
    if "RS" not in fields or "RS/8" not in fields:
        raise RuntimeError(f"no full or RS/8 field among {sorted(fields)}")

    checks = {}
    for name in ("RS", "RS/8"):
        for bf16 in (False, True):
            key = f"{name} {'bf16' if bf16 else 'f32'}"
            checks[key] = two_pass_check(fields[name]["params"], b_list[0],
                                         noise, bf16)
            log(f"two-pass vs single pass, {key} (survivor share "
                f"{fields[name]['survivor_share']:.4f}, bucket "
                f"{fields[name]['bucket']}): worst err/tol "
                f"{ {k: f'{v:.3f}' for k, v in checks[key]['worst'].items()} }"
                f", sec_density outside the mask {checks[key]['tail']}")
    bad = [k for k, c in checks.items()
           if not (c["ok"] and c["explore_none"])]
    if bad:
        raise RuntimeError(f"the two-pass disagrees with the single pass: "
                           f"{bad}")

    poses, intr = cameras(dev)
    grads = []
    for _ in range(2):
        p = _clone(fields["RS/8"]["params"])
        opt = make_optimizer(p, cfg.train)
        make_train_step(cfg, opt)(p, None, poses, intr, STEP0, *b_list[0],
                                  noise=noise)
        grads.append({k: v.grad.detach().clone()
                      for k, v in opt.named.items()})
    unequal = sorted(k for k in grads[0]
                     if not torch.equal(grads[0][k], grads[1][k]))
    log(f"two runs of a two-pass step (RS/8): grads not bitwise equal for "
        f"{unequal}")
    if "field/feat_pool" in unequal:
        raise RuntimeError("two-pass feat_pool grads differ between runs")
    del grads

    timing = {name: dense_timing(f["params"], b_list, dev, name)
              for name, f in fields.items()}
    subpaths = {mode: {"launches": {k: sum(t[mode]["launches"][k]
                                           for t in timing.values())
                                    for k in ALL_KERNELS}}
                for mode in ("two_pass", "single_pass")}

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    by_name = {k["name"]: k for k in kernels}
    meta = hash_field.paged_meta(cfg.model)
    for name, f in fields.items():
        if name == "RS":
            continue
        page_idx, lf = _capture_compacted(f["params"], cfg, b_list[0], noise)
        haloed = hash_field.haloed_table(f["params"]["field"], cfg.model)
        key = f"dense_survivors_{name.replace('/', '_')}"
        by_name["trilinear_fwd"]["in_situ"][key] = fwd_set(
            f"dense {name} survivors", (haloed, page_idx, lf), flush)
        g = torch.randn((page_idx.shape[1], meta.n_levels * meta.n_channels),
                        generator=torch.Generator(device=dev).manual_seed(
                            seed + 12), device=dev)
        by_name["trilinear_bwd"]["sets"][key] = bwd_set(
            f"dense {name} survivors", g, page_idx, lf, meta.total_pages,
            flush)
    dedup = dense_dedup(fields, b_list, noise, dev)
    subpaths.update(dedup.pop("subpaths"))
    return {"subpaths": subpaths,
            "fields": {k: {kk: v for kk, v in f.items() if kk != "params"}
                       for k, f in fields.items()},
            "checks": checks, "bitwise_unequal": unequal, "timing": timing,
            "dedup": dedup}


# -- phase 11: the xor hash ---------------------------------------------------

XOR_STEPS = 4


def xor_cfg(cfg: Config) -> Config:
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, hash_mode="xor"))


def xor_consts(cfg: Config, seed: int, dev: torch.device) -> dict:
    """The field's xor constants (primes from ``np_seed`` 2022, seeded
    biases)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return {"field": hash_field.init_consts(g, cfg.model, dev)}


def xor_phase(seed: int, dev: torch.device) -> dict:
    """Phase 11: ``XOR_STEPS`` training steps of ``Config()`` with
    ``hash_mode="xor"`` at ``bench.py``'s occupancy point (phase 4's),
    none of the three kernels launched; step ms, peak memory, one
    profiled step; whether two runs of a step give bitwise-equal grads
    (reported: the xor backward is autograd's ``index_add_``)."""
    cfg = xor_cfg(train_cfg(TRAIN_RAYS))
    consts = xor_consts(cfg, seed, dev)
    params, opt, step_fn = make_trainer(cfg, seed, dev)
    poses, intr = cameras(dev)
    grid = seeded_grid(cfg, dev)
    rng = np.random.default_rng(seed)
    batches = [batch(rng, TRAIN_RAYS, dev) for _ in range(XOR_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_launches()
    times, losses = [], []
    for k in range(XOR_STEPS):
        t0 = time.perf_counter()
        grid, m = step_fn(params, grid, poses, intr, STEP0 + k, *batches[k],
                          consts=consts)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m.loss))
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
    check_launches("xor/training", launches, ())
    if not (np.all(np.isfinite(losses)) and all(
            bool(torch.isfinite(p).all()) for p in opt.named.values())):
        raise RuntimeError(f"xor training diverged: losses {losses}")
    prof = profile_call(lambda: step_fn(params, grid, poses, intr,
                                        STEP0 + XOR_STEPS, *batches[0],
                                        consts=consts), "xor train step")
    grads = []
    for _ in range(2):
        p, o, s = make_trainer(cfg, seed, dev)
        s(p, seeded_grid(cfg, dev), poses, intr, STEP0 + 1, *batches[0],
          consts=consts)
        grads.append({k: v.grad.detach().clone() for k, v in o.named.items()})
    unequal = sorted(k for k in grads[0]
                     if not torch.equal(grads[0][k], grads[1][k]))
    log(f"xor/training: {TRAIN_RAYS} rays a step, step ms "
        f"{[round(t, 2) for t in times]} (first includes the refresh at "
        f"{STEP0}), peak memory {peak_gb:.2f} GiB, losses {losses}; two "
        f"runs of a step: grads not bitwise equal for {unequal}")
    return {"step_ms": times, "mean_ms": float(np.mean(times[1:])),
            "peak_mem_gb": peak_gb, "launches": launches, "losses": losses,
            "profile": prof, "bitwise_unequal": unequal}


# -- phase 12: LPIPS ----------------------------------------------------------

def lpips_phase(seed: int, dev: torch.device, root: pathlib.Path) -> dict:
    """Phase 12: LPIPS(vgg) with random weights (``make_random_weights``;
    the real VGG16 weights need a download) between two 128x128 renders
    of phase 6's map and their views, on the card and on the CPU: the
    distances agree to 1e-4 relative, under PyTorch's default precision
    flags (the module pins fp32 itself)."""
    from f2nerf_tpu_torch.utils import lpips

    path = root / "lpips_random.pt"
    lpips.make_random_weights(path, seed=seed)
    ds = load_dataset(root / "data")
    with unimportable("yaml", "PIL"):
        loc = Localizer.from_checkpoint(root / "run", device=dev)
    views = (0, SERVE_VIEW)
    x = torch.stack([loc.render_image(ds.poses[i]).float().cpu()
                     for i in views]).permute(0, 3, 1, 2) * 2 - 1
    y = torch.as_tensor(np.stack([ds.images[i] for i in views])
                        ).permute(0, 3, 1, 2).float() * 2 - 1
    nets = {"cuda": lpips.load(path), "cpu": lpips.load(path, device="cpu")}
    if nets["cuda"].device != dev:
        raise RuntimeError(f"lpips.load put the network on "
                           f"{nets['cuda'].device}")
    dist, ms = {}, {}
    # under PyTorch's default (cuDNN may use TF32), which main() turns off
    # for the other phases: the module pins fp32 itself
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
        for name, net in nets.items():
            net(x, y)
            t0 = time.perf_counter()
            dist[name] = net(x, y)
            ms[name] = (time.perf_counter() - t0) * 1e3
        same = nets["cuda"](x, x)
    rel = abs(dist["cuda"] - dist["cpu"]) / abs(dist["cpu"])
    log(f"LPIPS (random weights), 2 renders of {x.shape[2]}x{x.shape[3]} vs "
        f"their views: card {dist['cuda']:.6f} ({ms['cuda']:.1f} ms) vs CPU "
        f"{dist['cpu']:.6f} ({ms['cpu']:.1f} ms), rel {rel:.2e} (tol 1e-4); "
        f"LPIPS(x, x) = {same}")
    if not (np.isfinite(dist["cuda"]) and dist["cuda"] > 0 and rel <= 1e-4
            and same == 0.0):
        raise RuntimeError("LPIPS on the card disagrees with the CPU")
    return {"cuda": dist["cuda"], "cpu": dist["cpu"], "rel": rel, "ms": ms}


# -- phase 13: the multi-device path ------------------------------------------

DIST_STEPS = 4           # steps STEP0 .. STEP0 + 3: the refresh at STEP0
DIST_BLOCKS = 4          # grad_blocks of the bitwise mode on the card
DIST_MODES = {"train": 0, "grad_blocks": DIST_BLOCKS}   # path: grad_blocks
DIST_RUN_STEPS = 50      # apps.main train at world size 2
DIST_REPORT = 10
DIST_TIMEOUT_S = 600     # a worker still running then fails the phase
# any two runs' renders, particle weights and reply poses
DIST_RENDER_TOL = 1e-6
# (c)'s default mode against (a), the CPU test's tolerances by dtype: the
# f32 metrics rtol 1e-5; grads atol 1e-3 x the leaf's largest |grad| for
# the f32 leaves and 1e-2 x for feat_pool, whose grad sums bf16 page rows
# (a row rounds by 2^-8 whatever the grouping); params as phase 7's check
DIST_GRAD_TOL = {"field/feat_pool": 1e-2}


def dist_cfg(blocks: int) -> Config:
    cfg = train_cfg(TRAIN_RAYS)
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, grad_blocks=blocks))


def _ranks_agree(mesh, tensors: list) -> bool:
    """Whether every rank holds rank 0's values of ``tensors`` bitwise."""
    flat = torch.cat([t.detach().reshape(-1).to(mesh.device)
                      for t in tensors])
    ref = mesh_lib.replicate(mesh, flat.clone())
    return not mesh_lib.any_rank(mesh, not torch.equal(flat, ref))


def dist_train(blocks: int, seed: int, dev: torch.device, mesh,
               label: str) -> dict:
    """DIST_STEPS steps of the training phase's point (its seeded params,
    grid and first batches, the draws of ``draw_noise``) on ``mesh`` (None:
    in process, no process group): the state the checks compare, step
    times, peak memory, launches, and one more step profiled."""
    cfg = dist_cfg(blocks)
    params, opt, _ = make_trainer(cfg, seed, dev)
    step_fn = make_train_step(cfg, opt, mesh=mesh)
    poses, intr = cameras(dev)
    grid = seeded_grid(cfg, dev)
    rng = np.random.default_rng(seed)
    batches = [mesh_lib.shard_batch(mesh, *batch(rng, TRAIN_RAYS, dev))
               for _ in range(DIST_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_launches()
    times, metrics, lrs = [], [], []
    for k in range(DIST_STEPS):
        lrs.append(max(g["lr"] for g in opt.adam.param_groups))
        t0 = time.perf_counter()
        grid, m = step_fn(params, grid, poses, intr, STEP0 + k, *batches[k])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        metrics.append(torch.stack(tuple(m)))
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
    named = opt.named
    state = {"metrics": torch.stack(metrics).cpu(), "lr": lrs,
             "grid": grid.cpu(),
             "params": {n: p.detach().cpu() for n, p in named.items()},
             "grads": {n: p.grad.cpu() for n, p in named.items()},
             "exp_avg": {n: opt.adam.state[p]["exp_avg"].cpu()
                         for n, p in named.items()},
             "exp_avg_sq": {n: opt.adam.state[p]["exp_avg_sq"].cpu()
                            for n, p in named.items()}}
    agree = (mesh is None or _ranks_agree(mesh, [
        grid, *named.values(), *(p.grad for p in named.values()),
        *(opt.adam.state[p][k] for p in named.values()
          for k in ("exp_avg", "exp_avg_sq"))]))
    log(f"{label}: {'grad_blocks=%d' % blocks if blocks else 'default'} "
        f"steps {STEP0}-{STEP0 + DIST_STEPS - 1} at {TRAIN_RAYS} rays: "
        f"{[round(t, 2) for t in times]} ms (the first refreshes); peak "
        f"memory {peak_gb:.2f} GiB; losses "
        f"{[round(float(x), 6) for x in state['metrics'][:, 0]]}")
    prof = profile_call(lambda: step_fn(params, grid, poses, intr,
                                        STEP0 + DIST_STEPS, *batches[0]),
                        f"{label} step")
    return {"state": state, "ranks_agree": agree, "step_ms": times,
            "peak_mem_gb": peak_gb, "launches": launches, "profile": prof}


def dist_serve(seed: int, dev: torch.device, mesh, label: str) -> dict:
    """The serving phase's 3 mode-0 requests and one mode-1 request of the
    differential phase's O(1) map through a ``LocalizerService`` on
    ``mesh``; then the particle weights of 16 seeded poses and the render
    at the identity pose, which the checks compare."""
    cfg = Config()
    out = {}
    for mode, params, used in (
            (0, None, ("trilinear_fwd",)),
            (1, o1_params(cfg, seed + 6, dev),
             ("trilinear_fwd", "trilinear_bwd_frac"))):
        loc = make_localizer(cfg, seed, dev, params=params, mesh=mesh)
        svc = LocalizerService(loc)
        pose, target = target_frame(loc)
        if not svc.handle({"cmd": "init_pose",
                           "pose": loc.camera2world(pose).tolist()})["ok"]:
            raise RuntimeError("init_pose failed")
        req = {"cmd": "localize", "image": target.tolist(), "mode": mode}
        if mode == 0:
            req["particle_num"] = PARTICLES
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        zero_launches()
        times, poses = [], []
        for k in range(N_REQUESTS if mode == 0 else 1):
            t0 = time.perf_counter()
            r = svc.handle(req)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            check_reply(r, f"{label} mode-{mode} request {k}")
            poses.append(r["pose"])
        launches = read_launches()
        check_launches(f"{label} mode {mode}", launches, used)
        res = {"ms": times, "poses": torch.tensor(poses), "launches": launches,
               "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 2**30}
        if mode == 0:
            probe = np.random.default_rng(seed + 9)
            cands = np.repeat(pose[None], 16, 0)
            cands[:, :, 3] += probe.normal(0.0, 0.02, (16, 3))
            res["weights"] = torch.as_tensor(
                loc.evaluate_poses(cands.astype(np.float32), target))
            res["render"] = loc.render_image(pose).cpu()
        log(f"{label}: mode-{mode} requests {[round(t, 1) for t in times]} "
            f"ms, peak memory {res['peak_mem_gb']:.2f} GiB")
        out[f"mode{mode}"] = res
    return out


def dist_worker(args) -> int:
    """One rank of phase 13's (b) or (c): both training modes, then the
    requests, on a mesh of the process group; results saved for rank 0
    to check."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh_lib.maybe_initialize_distributed(backend=args.backend,
                                                device=args.device)
    if dev is None:
        raise RuntimeError("--dist-worker needs WORLD_SIZE, RANK, "
                           "MASTER_ADDR and MASTER_PORT")
    mesh = mesh_lib.make_mesh(device=dev)
    label = f"({args.dist_worker}) rank {mesh.rank} of {mesh.size}"
    res = {}
    try:
        for path, blocks in DIST_MODES.items():
            res[path] = dist_train(blocks, args.seed, dev, mesh, label)
            if mesh.rank:
                res[path].pop("state")
        res["serve"] = dist_serve(args.seed, dev, mesh, label)
    finally:
        dist.destroy_process_group()
    torch.save(res, pathlib.Path(args.work) / f"rank{mesh.rank}.pt")
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _wait_all(procs: list, what: str) -> float:
    """Wait for every process (each at most DIST_TIMEOUT_S), echo its
    output, kill the rest on a failure; returns the wall seconds."""
    t0 = time.perf_counter()
    try:
        for k, p in enumerate(procs):
            out, err = p.communicate(timeout=DIST_TIMEOUT_S)
            for line in out.splitlines():
                log(f"  [{what} {k}] {line}")
            if p.returncode != 0:
                raise RuntimeError(f"{what} process {k} exited "
                                   f"{p.returncode}:\n{err[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return time.perf_counter() - t0


def run_ranks(name: str, world: int, backend: str, device: str | None,
              seed: int, work: pathlib.Path) -> list[dict]:
    """Phase 13's worker as ``world`` processes of a ``backend`` group
    (torchrun's environment, a free port on localhost); each rank's
    results."""
    work.mkdir(parents=True)
    env = dict(os.environ, WORLD_SIZE=str(world), MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()))
    cmd = [sys.executable, str(pathlib.Path(__file__).resolve()),
           "--dist-worker", name, "--work", str(work), "--seed", str(seed),
           "--backend", backend] + (["--device", device] if device else [])
    procs = [subprocess.Popen(cmd, env=dict(env, RANK=str(r),
                                            LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(world)]
    wall = _wait_all(procs, f"({name}) rank")
    log(f"({name}) {world} process(es), {backend}: {wall:.1f} s")
    return [torch.load(work / f"rank{r}.pt", weights_only=True)
            for r in range(world)]


def _flat_state(state: dict) -> dict:
    out = {"metrics": state["metrics"], "grid": state["grid"]}
    for part in ("params", "grads", "exp_avg", "exp_avg_sq"):
        out.update({f"{part}/{n}": t for n, t in state[part].items()})
    return out


def check_equal(state: dict, ref: dict, what: str) -> None:
    """Every tensor of a run's state ``torch.equal`` to the reference's."""
    a, b = _flat_state(state), _flat_state(ref)
    unequal = [k for k in b if not torch.equal(a[k], b[k])]
    if unequal:
        raise RuntimeError(f"{what}: not bitwise equal in {unequal}")


def check_close(state: dict, ref: dict, what: str) -> dict:
    """(c)'s default mode against (a) at DIST_GRAD_TOL's tolerances;
    returns each leaf's worst error over its tolerance's scale."""
    if not torch.allclose(state["metrics"], ref["metrics"], rtol=1e-5,
                          atol=0):
        raise RuntimeError(f"{what}: metrics {state['metrics']} vs "
                           f"{ref['metrics']}")
    worst = {}
    for name, g in ref["grads"].items():
        scale = float(g.abs().max())
        err = float((state["grads"][name] - g).abs().max())
        worst[f"grad {name}"] = err / max(scale, 1e-30)
        if err > DIST_GRAD_TOL.get(name, 1e-3) * scale:
            raise RuntimeError(f"{what}: grad {name} off by {err:.3e} "
                               f"(largest {scale:.3e})")
    lr_sum, lr_max = sum(ref["lr"]), max(ref["lr"])
    for name, p in ref["params"].items():
        d = (state["params"][name] - p).abs()
        far = float((d > 0.05 * lr_max).float().mean())
        worst[f"param {name}"] = float(d.max()) / lr_max
        if float(d.max()) > 2.05 * lr_sum or far > 1e-3:
            raise RuntimeError(f"{what}: param {name} off by "
                               f"{float(d.max()):.3e}, share beyond 0.05 lr "
                               f"{far:.2e} (lr {ref['lr']})")
    return worst


def check_serve(res: dict, ref: dict, what: str) -> dict:
    """Renders, particle weights and reply poses within DIST_RENDER_TOL."""
    errs = {}
    for key in ("render", "weights"):
        errs[key] = float((res["mode0"][key] - ref["mode0"][key]).abs().max())
    for mode in ("mode0", "mode1"):
        errs[f"{mode} poses"] = float(
            (res[mode]["poses"] - ref[mode]["poses"]).abs().max())
    if max(errs.values()) > DIST_RENDER_TOL:
        raise RuntimeError(f"{what}: requests differ from (a): {errs}")
    return errs


def _collective(prof: dict) -> str:
    c = prof.get("collective")
    if not c:
        return "no collective"
    share = (c["nccl_device_ms"] + c["host_copy_ms"]) / max(
        prof["device_ms"], 1e-9)
    return (f"collective: {c['host_ms']:.2f} ms on the host clock "
            f"({c['host_ms'] / prof['wall_ms']:.1%} of the wall); on the "
            f"device NCCL kernels {c['nccl_device_ms']:.3f} ms and copies "
            f"to / from the host {c['host_copy_ms']:.3f} ms ({share:.1%} "
            f"of the device time)")


def _dist_record(name: str, rank: int, key: str, rk: dict) -> dict:
    """A run's times, device time, collective and peak memory, logged."""
    slicing = (" (two processes time-slicing one card: not a scaling "
               "figure)" if name == "c" else "")
    if key == "serve":
        rec = {m: {"ms": rk[m]["ms"], "peak_mem_gb": rk[m]["peak_mem_gb"]}
               for m in ("mode0", "mode1")}
        log(f"({name}) rank {rank} requests: mode 0 "
            f"{[round(t, 1) for t in rec['mode0']['ms']]} ms, mode 1 "
            f"{[round(t, 1) for t in rec['mode1']['ms']]} ms{slicing}")
        return rec
    prof = rk["profile"]
    rec = {"step_ms": rk["step_ms"], "peak_mem_gb": rk["peak_mem_gb"],
           "device_ms": prof["device_ms"], "wall_ms": prof["wall_ms"],
           "collective": prof.get("collective")}
    log(f"({name}) rank {rank} {key}: steps "
        f"{[round(t, 2) for t in rk['step_ms'][1:]]} ms after the refresh "
        f"step; profiled step {prof['wall_ms']:.2f} ms wall, "
        f"{prof['device_ms']:.2f} ms device; {_collective(prof)}; peak "
        f"{rk['peak_mem_gb']:.2f} GiB{slicing}")
    return rec


def dist_run(seed: int, dev: torch.device, root: pathlib.Path) -> dict:
    """``apps.main train`` through ``torchrun`` at world size 2 (gloo on
    ``cuda:0``) and in process with no process group, on the textured
    dataset, ``grad_blocks`` = DIST_BLOCKS: the two ``state.pt`` equal
    bitwise; then a mode-0 request served from the torchrun run."""
    data = root / "data"
    save_dataset(make_textured_dataset(seed=seed), data)
    cfg = Config.quality(end_iter=DIST_RUN_STEPS)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, grad_blocks=DIST_BLOCKS, report_freq=DIST_REPORT,
        save_freq=DIST_RUN_STEPS, vis_freq=DIST_RUN_STEPS))
    runs = {name: root / name for name in ("a", "c")}
    for run in runs.values():
        run.mkdir(parents=True)
        cfg.save(run / "train_config.yaml")
    sub = {}
    sub["run/train_a"], _ = _subpath(
        "distributed train (a)", ("trilinear_fwd", "trilinear_bwd"),
        lambda: cli.main(["train", str(runs["a"]), str(data)]))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes=1",
           "--nproc_per_node=2", "--master_addr=localhost",
           f"--master_port={_free_port()}", "-m", "f2nerf_tpu_torch.apps.main",
           "train", str(runs["c"]), str(data), "--device", "cuda:0",
           "--backend", "gloo"]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            cwd=pathlib.Path(__file__).resolve().parent)
    wall_c = _wait_all([proc], "torchrun")
    states = {k: ckpt_lib.restore(r / "checkpoints") for k, r in runs.items()}
    a, c = states["a"], states["c"]
    if a["step"] != DIST_RUN_STEPS or c["step"] != DIST_RUN_STEPS:
        raise RuntimeError(f"steps {a['step']} / {c['step']}")
    unequal = [n for n in a["params"]
               if not torch.equal(a["params"][n], c["params"][n])]
    if unequal or not torch.equal(a["occ_grid"], c["occ_grid"]):
        raise RuntimeError(f"torchrun state.pt differs from (a): params "
                           f"{unequal}, grid equal "
                           f"{torch.equal(a['occ_grid'], c['occ_grid'])}")
    reports = {k: _log_reports(r / "train_log.txt") for k, r in runs.items()}
    if ([(x["step"], x["loss"]) for x in reports["a"]]
            != [(x["step"], x["loss"]) for x in reports["c"]]
            or len(reports["c"]) != DIST_RUN_STEPS // DIST_REPORT):
        raise RuntimeError(f"train logs differ: {reports}")
    log(f"torchrun apps.main train, 2 processes on one card (gloo), "
        f"grad_blocks={DIST_BLOCKS}: {DIST_RUN_STEPS} steps in {wall_c:.1f} s "
        f"(process start included) vs {sub['run/train_a']['wall_s']:.1f} s "
        f"in process; state.pt params and grid bitwise equal; losses "
        f"{[x['loss'] for x in reports['c']]}")
    ds = load_dataset(data)
    loc = Localizer.from_checkpoint(runs["c"])
    svc = LocalizerService(loc)
    true_world = loc.camera2world(ds.poses[SERVE_VIEW])
    moved = true_world.copy()
    moved[:3, 3] += POSE_SHIFT
    if not svc.handle({"cmd": "init_pose", "pose": moved.tolist()})["ok"]:
        raise RuntimeError("init_pose failed")
    sub["run/mode0"], r = _subpath(
        "distributed run mode 0", ("trilinear_fwd",),
        lambda: svc.handle({"cmd": "localize", "mode": 0,
                            "image": ds.images[SERVE_VIEW].tolist(),
                            "particle_num": PARTICLES}))
    check_reply(r, "a request served from the torchrun run")
    err = (_pose_error(moved, true_world), _pose_error(r["pose"], true_world))
    log(f"served from the torchrun run: mode 0 on view {SERVE_VIEW}, "
        f"position error {err[0]:.4f} -> {err[1]:.4f}, "
        f"{sub['run/mode0']['wall_s'] * 1e3:.1f} ms")
    return {"subpaths": sub, "torchrun_s": wall_c, "reports": reports["c"],
            "request": {"error_before": err[0], "error_after": err[1],
                        "score": r["score"]}}


def _sum_launches(per_rank) -> dict:
    per_rank = list(per_rank)
    return {k: sum(launches[k] for launches in per_rank) for k in ALL_KERNELS}


def distributed_phase(seed: int, dev: torch.device,
                      root: pathlib.Path) -> dict:
    """Phase 13 (module docstring): (a) in process, (b) NCCL at world size
    1, (c) gloo at world size 2 on one card, each in both training modes
    and serving; the checks; then ``apps.main train`` under torchrun."""
    a = {path: dist_train(blocks, seed, dev, None, "(a) no process group")
         for path, blocks in DIST_MODES.items()}
    a["serve"] = dist_serve(seed, dev, None, "(a) no process group")
    runs = {"a": [a],
            "b": run_ranks("b", 1, "nccl", None, seed, root / "ranks_b"),
            "c": run_ranks("c", 2, "gloo", "cuda:0", seed, root / "ranks_c")}
    sub, summary, serve_err = {}, {}, {}
    for name, ranks in runs.items():
        for path in DIST_MODES:
            if not all(rk[path]["ranks_agree"] for rk in ranks):
                raise RuntimeError(f"({name}) {path}: the ranks disagree")
            # launches by path, summed over the ranks
            sub[f"{name}/{path}"] = {"launches": _sum_launches(
                rk[path]["launches"] for rk in ranks)}
            check_launches(f"distributed ({name}) {path}",
                           sub[f"{name}/{path}"]["launches"],
                           ("trilinear_fwd", "trilinear_bwd"))
        for mode in ("mode0", "mode1"):
            sub[f"{name}/{mode}"] = {"launches": _sum_launches(
                rk["serve"][mode]["launches"] for rk in ranks)}
        for key in (*DIST_MODES, "serve"):
            summary[f"{name}/{key}"] = [_dist_record(name, r, key, rk[key])
                                        for r, rk in enumerate(ranks)]
        if name != "a":
            for r, rk in enumerate(ranks):
                serve_err[f"{name}/rank{r}"] = check_serve(
                    rk["serve"], a["serve"], f"({name}) rank {r}")
    b, c = runs["b"][0], runs["c"][0]
    check_equal(b["train"]["state"], a["train"]["state"],
                "(b) default vs (a)")
    check_equal(b["grad_blocks"]["state"], a["grad_blocks"]["state"],
                "(b) grad_blocks vs (a)")
    check_equal(c["grad_blocks"]["state"], a["grad_blocks"]["state"],
                "(c) grad_blocks vs (a)")
    worst = check_close(c["train"]["state"], a["train"]["state"],
                        "(c) default vs (a)")
    log("(b) NCCL world 1: both modes bitwise (a); (c) gloo world 2: "
        "grad_blocks bitwise (a), default within tolerance (worst error / "
        "scale: " + ", ".join(f"{k} {v:.1e}" for k, v in worst.items())
        + f"); requests' worst differences from (a): {json.dumps(serve_err)}")
    run = dist_run(seed, dev, root / "run")
    sub.update(run.pop("subpaths"))
    return {"subpaths": sub, "summary": summary, "worst": worst,
            "serve_err": serve_err, "run": run}


# -- run dedup on and off (phases 3-5 and 10) ----------------------------------

DEDUP_WINDOW = 6           # train steps a window; windows off, on, on, off
DEDUP_REQUESTS = 2         # requests a window


def no_dedup(cfg: Config) -> Config:
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, encode_dedup=False, dense_two_pass_dedup=False))


def run_counts(fn) -> tuple[dict, object]:
    """``fn()`` with the run counts recorded (``hash_paged.recording_runs``):
    ({"<kind> L<level>": [largest run count, budget]}, what fn returned)."""
    with hash_paged.recording_runs() as rec:
        out = fn()
    counts = {}
    for e in rec:
        key = f"{e['kind']} L{e['level']}"
        runs = int(e["runs"])
        counts[key] = [max(runs, counts.get(key, [0])[0]), e["budget"]]
    return counts, out


def check_runs(path: str, counts: dict) -> None:
    """The certified budgets (along rays) hold on ``path``."""
    log(f"run counts on the {path} path (largest, budget): {counts}")
    over = {k: v for k, v in counts.items()
            if k.startswith("rays") and v[0] > v[1]}
    if over or not counts:
        raise RuntimeError(f"{path}: run counts over their budgets {over} "
                           f"(or none recorded)")


def _tree_equal(a: dict, b: dict) -> list[str]:
    """Names of the leaves of two flat dicts that differ bitwise."""
    return sorted(k for k in a if not torch.equal(a[k], b[k]))


def steps_in_turns(make, batches: list, dev: torch.device, path: str,
                   used: tuple = ("trilinear_fwd", "trilinear_bwd")) -> dict:
    """Train steps with run dedup on and off: ``make(on)`` gives (params,
    optimizer, step function, grid) from the same seed; ``DEDUP_WINDOW``
    steps a window in turns off, on, on, off on the same batches and step
    numbers. The grads of a window's last step, the metrics of every step
    and the params and grid at the end must be bitwise equal. Step ms on
    the host clock, launches per mode, one profiled step of each and the
    run counts of one step with dedup on."""
    poses, intr = cameras(dev)
    runs = {}
    for name in ("on", "off"):
        params, opt, step, grid = make(name == "on")
        runs[name] = {"params": params, "opt": opt, "step": step,
                      "grid": grid, "k": 0, "ms": [], "metrics": [],
                      "grads": [], "launches": dict.fromkeys(ALL_KERNELS, 0)}

    def one_step(r, k):
        r["grid"], m = r["step"](r["params"], r["grid"], poses, intr,
                                 STEP0 + k, *batches[k % len(batches)])
        return m

    for name in ("off", "on", "on", "off"):
        r = runs[name]
        torch.cuda.synchronize()
        zero_launches()
        for _ in range(DEDUP_WINDOW):
            t0 = time.perf_counter()
            m = one_step(r, r["k"])
            torch.cuda.synchronize()
            r["ms"].append((time.perf_counter() - t0) * 1e3)
            r["metrics"].append(torch.stack(tuple(m)))
            r["k"] += 1
        r["grads"].append({k: p.grad.clone()
                           for k, p in r["opt"].named.items()})
        for k, v in read_launches().items():
            r["launches"][k] += v
    on, off = runs["on"], runs["off"]
    unequal = {
        "grads": sorted({n for a, b in zip(on["grads"], off["grads"])
                         for n in _tree_equal(a, b)}),
        "params": _tree_equal({k: p.detach() for k, p in
                               on["opt"].named.items()},
                              {k: p.detach() for k, p in
                               off["opt"].named.items()}),
        "metrics": [k for k, (a, b) in enumerate(zip(on["metrics"],
                                                     off["metrics"]))
                    if not torch.equal(a, b)]}
    if on["grid"] is not None and not torch.equal(on["grid"], off["grid"]):
        unequal["grid"] = ["occ_grid"]
    if any(unequal.values()):
        raise RuntimeError(f"{path}: dedup on and off differ: {unequal}")
    out = {}
    for name, r in runs.items():
        check_launches(f"{path} dedup {name}", r["launches"], used)
        k = r["k"]
        out[name] = {"step_ms": r["ms"], "launches": r["launches"],
                     "profile": profile_call(lambda: one_step(r, k),
                                             f"{path} step, dedup {name}")}
    out["runs"], _ = run_counts(lambda: one_step(on, on["k"] + 1))
    check_runs(f"{path} step", out["runs"])
    log(f"{path}: step ms dedup off {[round(t, 2) for t in off['ms']]} vs "
        f"on {[round(t, 2) for t in on['ms']]}; device ms "
        f"{out['off']['profile']['device_ms']:.3f} vs "
        f"{out['on']['profile']['device_ms']:.3f}; bitwise equal")
    return out


def training_dedup(seed: int, dev: torch.device) -> dict:
    """Phase 4's point with run dedup on and off (``steps_in_turns``)."""
    cfg = train_cfg(TRAIN_RAYS)
    rng = np.random.default_rng(seed + 20)
    batches = [batch(rng, TRAIN_RAYS, dev) for _ in range(2 * DEDUP_WINDOW)]

    def make(on):
        c = cfg if on else no_dedup(cfg)
        return (*make_trainer(c, seed, dev), seeded_grid(c, dev))

    out = steps_in_turns(make, batches, dev, "training")
    return {"subpaths": {f"training/{m}": {"launches": out[m]["launches"]}
                         for m in ("on", "off")}, **out}


def requests_dedup(cfg: Config, seed: int, dev: torch.device, mode: int,
                   params: dict | None = None) -> dict:
    """Requests of ``mode`` through two services over ``params``, run
    dedup on and off, ``DEDUP_REQUESTS`` a window in turns off, on, on,
    off: the replies, a frame's render and (mode 1) the pose gradient
    bitwise equal; request ms, launches, one profiled request of each,
    and the run counts of a full-frame render and (mode 0) of a particle
    render."""
    if params is None:
        params = renderer.init(torch.Generator(device=dev).manual_seed(seed),
                               cfg.model, 4, dev)
    locs = {"on": make_localizer(cfg, seed, dev, params=params),
            "off": make_localizer(no_dedup(cfg), seed, dev, params=params)}
    svcs = {k: LocalizerService(loc) for k, loc in locs.items()}
    pose, target = target_frame(locs["on"])
    for svc in svcs.values():
        if not svc.handle({"cmd": "init_pose", "pose": locs["on"].camera2world(
                pose).tolist()})["ok"]:
            raise RuntimeError("init_pose failed")
    req = {"cmd": "localize", "image": target.tolist(), "mode": mode,
           "particle_num": PARTICLES}
    used = ("trilinear_fwd",) if mode == 0 else ("trilinear_fwd",
                                                 "trilinear_bwd_frac")
    res = {k: {"ms": [], "replies": [],
               "launches": dict.fromkeys(ALL_KERNELS, 0)} for k in svcs}
    for name in ("off", "on", "on", "off"):
        r = res[name]
        torch.cuda.synchronize()
        zero_launches()
        for _ in range(DEDUP_REQUESTS):
            t0 = time.perf_counter()
            reply = svcs[name].handle(req)
            torch.cuda.synchronize()
            r["ms"].append((time.perf_counter() - t0) * 1e3)
            check_reply(reply, f"mode-{mode} request, dedup {name}")
            r["replies"].append(reply)
        for k, v in read_launches().items():
            r["launches"][k] += v
    path = f"mode{mode}"
    if res["on"]["replies"] != res["off"]["replies"]:
        raise RuntimeError(f"{path}: replies differ with dedup on and off")
    frames = {k: loc.render_image(pose) for k, loc in locs.items()}
    if not torch.equal(frames["on"], frames["off"]):
        raise RuntimeError(f"{path}: frame renders differ, dedup on and off")
    if mode == 1:
        grads = {k: loc.pose_gradient(pose, target) for k, loc in
                 locs.items()}
        if not (grads["on"][0] == grads["off"][0]
                and np.array_equal(grads["on"][1], grads["off"][1])):
            raise RuntimeError("the pose gradient differs, dedup on and off")
    out = {}
    for name, r in res.items():
        check_launches(f"{path} dedup {name}", r["launches"], used)
        out[name] = {"request_ms": r["ms"], "launches": r["launches"],
                     "profile": profile_call(lambda: svcs[name].handle(req),
                                             f"{path} request, dedup {name}")}
    out["runs"] = {"frame": run_counts(
        lambda: locs["on"].render_image(pose))[0]}
    check_runs(f"{path} frame", out["runs"]["frame"])
    if mode == 0:
        out["runs"]["particles"] = run_counts(
            lambda: locs["on"].evaluate_poses(
                np.stack([pose] * PARTICLES), target))[0]
        check_runs(f"{path} particles", out["runs"]["particles"])
    log(f"{path}: request ms dedup off {[round(t, 1) for t in res['off']['ms']]}"
        f" vs on {[round(t, 1) for t in res['on']['ms']]}; device ms "
        f"{out['off']['profile']['device_ms']:.3f} vs "
        f"{out['on']['profile']['device_ms']:.3f}; replies bitwise equal")
    out["subpaths"] = {f"{path}/{m}": {"launches": out[m]["launches"]}
                       for m in ("on", "off")}
    return out


def dense_dedup(fields: dict, b_list: list, noise, dev: torch.device) -> dict:
    """Phase 10's fields with run dedup: the compacted survivor stream's
    run counts against ``compacted_budgets`` in each prefix bucket (JAX's
    run-time check, ``dense_two_pass_dedup``: where it fails JAX encodes
    flat, so these are reported, not gated), and two-pass steps with
    ``encode_dedup`` and ``dense_two_pass_dedup`` on and off in turns on
    the RS/8 field and the full field (``steps_in_turns``)."""
    cfg = dense_cfg(True)
    on_cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dense_two_pass_dedup=True))
    out = {"compacted": {}}
    for name, f in fields.items():
        if name == "RS":
            continue
        with torch.no_grad():
            counts, _ = run_counts(lambda: dense_render(
                f["params"], on_cfg, b_list[0], noise))
        ok = all(v[0] <= v[1] for v in counts.values())
        out["compacted"][name] = {"runs": counts, "ok": ok}
        log(f"dense {name}: compacted stream runs (largest, budget) "
            f"{counts}: the check {'holds' if ok else 'fails (flat)'}")
        if not counts:
            raise RuntimeError(f"dense {name}: no compacted run recorded")
    for name in ("RS/8", "RS"):
        def make(on, p=fields[name]["params"]):
            c = on_cfg if on else no_dedup(cfg)
            q = _clone(p)
            opt = make_optimizer(q, c.train)
            return q, opt, make_train_step(c, opt), None

        out[name] = steps_in_turns(make, b_list, dev, f"dense {name}")
    out["subpaths"] = {f"dedup/{name}/{m}": {"launches": out[name][m][
        "launches"]} for name in ("RS/8", "RS") for m in ("on", "off")}
    return out


# -- phase 14: the tools ---------------------------------------------------

TOOLS_STEPS = 2000         # quality_run's steps (Config.quality's 20,000 cut)
TOOLS_FLAGS = ["--scene", "textured", "--n_images", "32", "--hw", "128"]
TOOLS_HOLDOUT = 8


def _tool(fn, *argv: str) -> tuple[object, str]:
    """A tool's ``main`` on ``argv`` with its standard output captured
    (and logged): (what main returned, the text)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(list(argv))
    text = buf.getvalue()
    for line in text.splitlines():
        log(f"  | {line}")
    return rc, text


def _tsv(path: pathlib.Path) -> list[dict]:
    head, *rows = [line.split("\t") for line in
                   path.read_text().splitlines()]
    return [dict(zip(head, r)) for r in rows]


def _mean(rows: list[dict], col: str) -> float:
    return float(np.mean([float(r[col]) for r in rows]))


def tools_phase(seed: int, dev: torch.device, root: pathlib.Path) -> dict:
    """Phase 14: the tools of ``f2nerf_tpu_torch/tools`` as a user runs
    them, with jax, PIL and yaml unimportable: ``make_synthetic_dataset``
    (the textured scene, 32 views of 128x128, every 8th held out into
    ``ds_holdout``), ``quality_run`` on the same split at
    ``Config.quality``'s width for ``TOOLS_STEPS`` steps, ``eval_holdout``
    on the held-out directory, ``eval`` on its [gt | pred] strips with
    random LPIPS weights, ``localize_validation`` on the held-out views
    and ``bench_localize``; launches per sub-path ``tools/<name>``."""
    from f2nerf_tpu_torch.tools import (bench_localize, eval_holdout,
                                        localize_validation,
                                        make_synthetic_dataset, quality_run)
    from f2nerf_tpu_torch.tools import eval as eval_tool
    from f2nerf_tpu_torch.utils import lpips

    root.mkdir(parents=True, exist_ok=True)
    ds_dir, run = root / "ds", root / "run"
    holdout = ["--holdout", str(TOOLS_HOLDOUT)]
    dev_flag = ["--device", str(dev)]
    sub = {}
    with unimportable("jax", "PIL", "yaml"):
        _tool(make_synthetic_dataset.main, str(ds_dir), *TOOLS_FLAGS,
              *holdout)
        sub["tools/quality_run"], (rc, _) = _subpath(
            "tools/quality_run", ("trilinear_fwd", "trilinear_bwd"),
            lambda: _tool(quality_run.main, str(run), *TOOLS_FLAGS,
                          *holdout, "--steps", str(TOOLS_STEPS),
                          "--budget_s", "1200", *dev_flag))
        if rc != 0:
            raise RuntimeError(f"quality_run returned {rc}")
        summary = _tsv(run / "summary.tsv")
        sub["tools/eval_holdout"], (rc, _) = _subpath(
            "tools/eval_holdout", ("trilinear_fwd",),
            lambda: _tool(eval_holdout.main, str(run),
                          str(root / "ds_holdout"), "--save_images",
                          *dev_flag))
        held = _tsv(run / "holdout_summary.tsv")
        for d in ("gt", "pred"):
            (root / d).mkdir()
        for k in range(len(held)):
            strip = read_image(run / f"holdout_{k:02d}.png")
            w = strip.shape[1] // 2
            write_image(root / "gt" / f"{k:02d}.png", strip[:, :w])
            write_image(root / "pred" / f"{k:02d}.png", strip[:, w:])
        lpips.make_random_weights(root / "lpips.pt", seed=seed)
        sub["tools/eval"], _ = _subpath(
            "tools/eval", (), lambda: _tool(
                eval_tool.main, "--gt_dir", str(root / "gt"), "--pred_dir",
                str(root / "pred"), "--lpips_weights",
                str(root / "lpips.pt"), *dev_flag))
        info = json.loads((root / "pred" / "info.json").read_text())
        sub["tools/localize_validation"], (rc, text) = _subpath(
            "tools/localize_validation",
            ("trilinear_fwd", "trilinear_bwd_frac"),
            lambda: _tool(localize_validation.main, str(run), *TOOLS_FLAGS,
                          "--holdout_every", str(TOOLS_HOLDOUT), *dev_flag))
        line = next(x for x in text.splitlines()
                    if x.startswith("mean position error"))
        errs = [float(x.split()[-1].rstrip(","))
                for x in line.split(":", 1)[1].split("(")[0].split(",")]
        sub["tools/bench_localize"], (bench_ms, _) = _subpath(
            "tools/bench_localize", ("trilinear_fwd", "trilinear_bwd_frac"),
            lambda: _tool(bench_localize.main, *dev_flag))
    split = {tag: [r for r in summary if r["split"] == tag]
             for tag in ("train", "holdout")}
    res = {"subpaths": sub, "steps": TOOLS_STEPS,
           "quality_run_s": sub["tools/quality_run"]["wall_s"],
           "train_psnr": _mean(split["train"], "psnr"),
           "train_ssim": _mean(split["train"], "ssim"),
           "holdout_psnr": _mean(split["holdout"], "psnr"),
           "holdout_ssim": _mean(split["holdout"], "ssim"),
           "eval_holdout_psnr": _mean(held, "psnr"),
           "eval_holdout_ssim": _mean(held, "ssim"),
           "eval_holdout_ms": [1e3 * float(r["time_s"]) for r in held],
           "eval": info, "position_error": dict(zip(
               ("before", "after_search", "after_differential"), errs)),
           "localize_rc": rc, "bench_localize_ms": bench_ms}
    log(f"tools: {TOOLS_STEPS} steps in {res['quality_run_s']:.1f} s; "
        f"held-out PSNR {res['holdout_psnr']:.3f} dB / SSIM "
        f"{res['holdout_ssim']:.4f} (quality_run), "
        f"{res['eval_holdout_psnr']:.3f} / {res['eval_holdout_ssim']:.4f} "
        f"(eval_holdout), LPIPS (random weights) {info['lpips_vgg']:.4f}; "
        f"position error {errs}; bench_localize {bench_ms}")
    n_views = int(TOOLS_FLAGS[TOOLS_FLAGS.index("--n_images") + 1])
    n_held = len(range(0, n_views, TOOLS_HOLDOUT))
    ok = (len(summary) == n_views and len(split["holdout"]) == n_held
          and len(held) == n_held and len(errs) == 3
          and np.isfinite(errs).all() and rc in (0, 1)
          and all(np.isfinite(float(r[c])) for r in summary
                  for c in ("psnr", "ssim", "score"))
          and np.isfinite(info["lpips_vgg"]) and info["lpips_vgg"] > 0
          and all(v > 0 for v in bench_ms.values())
          # the held-out views, rendered from the training frame and from
          # the holdout directory's world poses, agree
          and abs(res["eval_holdout_psnr"] - res["holdout_psnr"]) < 0.5
          # and eval scores eval_holdout's 8-bit strips alike
          and abs(info["psnr"] - res["eval_holdout_psnr"]) < 0.1)
    if not ok:
        raise RuntimeError(f"the tools' outputs fail their checks: {res}")
    return res


# -- phase 15: data prep ---------------------------------------------------


_SCAN_END = re.compile(rb"\xff[^\x00\xd0-\xd7\xff]")


def _scan_grid(sos: bytes, sof: bytes, height: int, width: int
               ) -> tuple[int, int]:
    """(columns, rows) of the MCUs of the scan whose SOS segment is
    ``sos`` in a frame (SOF segment ``sof``) of ``height`` x ``width``:
    whole MCUs where the scan interleaves components, else its
    component's blocks."""
    comps = {sof[10 + 3 * i]: (sof[11 + 3 * i] >> 4, sof[11 + 3 * i] & 15)
             for i in range(sof[9])}
    hmax = max(h for h, _ in comps.values())
    vmax = max(v for _, v in comps.values())
    if sos[4] > 1:
        return -(-width // (8 * hmax)), -(-height // (8 * vmax))
    h, v = comps[sos[5]]
    return (-(-(-(-width * h // hmax)) // 8),
            -(-(-(-height * v // vmax)) // 8))


def tile_jpeg(buf: bytes, height: int, width: int) -> bytes:
    """A ``height`` x ``width`` JPEG made of the MCUs of ``buf`` tiled
    across it. ``buf`` must restart at every MCU (DRI of 1), so that each
    MCU's entropy-coded data stands alone (byte-aligned, DC predictors
    and EOB runs reset) and any sequence of them, with RST0-7 between, is
    a valid scan. A progressive ``buf`` is tiled scan by scan (the MCU of
    a one-component scan is one block). A camera-sized frame to time the
    decoders on, made without an encoder."""
    out, pos = [buf[:2]], 2
    restart, sof = None, None
    while buf[pos + 1] != 0xD9:
        marker = buf[pos + 1]
        (n,) = struct.unpack(">H", buf[pos + 2:pos + 4])
        seg = buf[pos:pos + 2 + n]
        pos += 2 + n
        if marker in (0xC0, 0xC1, 0xC2):
            sof = seg
            seg = seg[:5] + struct.pack(">HH", height, width) + seg[9:]
        elif marker == 0xDD:
            (restart,) = struct.unpack(">H", seg[4:6])
        if marker != 0xDA:
            out.append(seg)
            continue
        if restart != 1 or sof is None or sof[9] != 3:
            raise ValueError("tile_jpeg needs a 3-component JPEG that "
                             "restarts at every MCU")
        src_h, src_w = struct.unpack(">HH", sof[5:9])
        sx, sy = _scan_grid(seg, sof, src_h, src_w)
        nx, ny = _scan_grid(seg, sof, height, width)
        end = _SCAN_END.search(buf, pos).start()
        mcus = re.split(rb"\xff[\xd0-\xd7]", buf[pos:end])
        if len(mcus) != sx * sy:
            raise ValueError(f"{len(mcus)} restart intervals for "
                             f"{sx * sy} MCUs")
        out.append(seg)
        for i in range(nx * ny):
            r, c = divmod(i, nx)
            if i:
                out.append(bytes([0xFF, 0xD0 + (i - 1) % 8]))
            out.append(mcus[(r % sy) * sx + c % sx])
        pos = end
    return b"".join(out) + b"\xff\xd9"


def filtered_png(rgb: np.ndarray, filters: tuple = (4, 1)) -> bytes:
    """8-bit RGB PNG bytes of uint8 [H, W, 3], row r filtered by
    ``filters[r % len(filters)]`` (0-4: none, Sub, Up, Average, Paeth), as
    an encoder with adaptive filters writes them: the frame the host
    times the PNG decoders on."""
    h, w, _ = rgb.shape
    x = rgb.reshape(h, 3 * w).astype(np.int16)
    rows, prev = [], np.zeros(3 * w, np.int16)
    for r in range(h):
        f = filters[r % len(filters)]
        cur = x[r]
        a = np.concatenate([np.zeros(3, np.int16), cur[:-3]])
        c = np.concatenate([np.zeros(3, np.int16), prev[:-3]])
        p = a + prev - c
        pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, prev, c))
        pred = (0, a, prev, (a + prev) >> 1, paeth)[f]
        rows.append(bytes([f]) + ((cur - pred) & 0xFF).astype(
            np.uint8).tobytes())
        prev = cur

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows), 6))
            + chunk(b"IEND", b""))


JPEG_FIXTURES = (pathlib.Path(__file__).resolve().parent / "tests"
                 / "torch_fixtures" / "jpeg")
CODEC_FIXTURES = JPEG_FIXTURES.parent / "codec"
BAG_FIXTURES = JPEG_FIXTURES.parent / "bag"
CHUNK_RATE_S = 0.5         # each decode rate is timed over at least this
# restart at every MCU: the tiled frames' sources
TILE_SOURCE = JPEG_FIXTURES / "ycc420_rst1_48x32.jpg"
PROGRESSIVE_TILE_SOURCE = CODEC_FIXTURES / "prog_ycc420_rst1_48x32.jpg"
CAMERA_FRAME = (1080, 1920)              # an Autoware camera's frame
DECODE_REPS = 3                          # the plain decoders: ~1 s a frame
CODEC_REPS = 10
BAG_T0, BAG_DT = 100.0, 0.1              # the views' stamps (s)
POSE_TOPIC = "/localization/pose_estimator/pose_with_covariance"
CAMERA_TOPIC = "/sensing/camera/camera{}/image_rect_color/compressed"
# run_cli_until_done trains full_test's map on from RUN_STEPS to here: on
# an H100 its training views sat above the 18.45 dB that an untrained
# map's grey background scores by 4.48 dB at 600 steps, 4.98 at 2,000 and
# 5.14 at 3,000 (the 5 dB floor)
DATAPREP_STEPS = 4000
CHILD_TIMEOUT_S = 600      # a driver still running then fails the phase
TOOLS_DIR = (pathlib.Path(__file__).resolve().parent / "f2nerf_tpu_torch"
             / "tools")
# the child processes' sitecustomize: jax, PIL and yaml fail to import as
# ``unimportable`` makes them fail in process, and at exit each process
# appends its kernels' launch counts to $CHIP_SMOKE_LAUNCHES
_CHILD_SITE = '''\
import atexit, importlib.abc, json, os, sys

BLOCKED = ("jax", "PIL", "yaml")


class _Unimportable(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is made unimportable for this phase")
        return None


sys.meta_path.insert(0, _Unimportable())


def _launches():
    mod = sys.modules.get("f2nerf_tpu_torch.kernels.trilinear")
    out = os.environ.get("CHIP_SMOKE_LAUNCHES")
    if mod is None or not out:
        return
    rec = {"argv": sys.argv, "launches": {
        name: getattr(mod, name).launches for name in %r}}
    with open(out, "a") as f:
        f.write(json.dumps(rec) + "\\n")


atexit.register(_launches)
''' % (ALL_KERNELS,)


def _median_ms(fn, data: bytes, reps: int) -> tuple[float, np.ndarray]:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(data)
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), out


def codec_check() -> dict:
    """Phase 15a: every committed fixture decodes by the compiled codec
    (``decode_image``) to its stored PIL decode, exactly, and to the
    plain decoders' pixels wherever they read the file; the codec's and
    the plain decoders' host times on three camera-sized frames."""
    from f2nerf_tpu_torch.utils.image_io import (decode_image, decode_jpeg,
                                                 decode_png)

    def plain(data: bytes):
        return decode_png if data[:4] == b"\x89PNG" else decode_jpeg

    n_fixtures = n_plain = 0
    for folder in (JPEG_FIXTURES, CODEC_FIXTURES):
        expected = np.load(folder / "expected.npz")
        names = sorted(p.name for p in folder.iterdir()
                       if p.suffix in (".jpg", ".png"))
        if sorted(expected.files) != names or not names:
            raise RuntimeError(f"fixtures {names} vs decodes "
                               f"{expected.files}")
        for name in names:
            data = (folder / name).read_bytes()
            got = decode_image(data)
            if not np.array_equal(got, expected[name]):
                off = np.abs(got.astype(int) - expected[name]).max()
                raise RuntimeError(f"{name}: the codec differs from PIL's "
                                   f"decode by up to {off}")
            try:
                ref = plain(data)(data)
            except ValueError:          # a kind the plain decoder lacks
                ref = None
            if ref is not None and not np.array_equal(got, ref):
                raise RuntimeError(f"{name}: the codec differs from the "
                                   f"plain decoder")
            n_fixtures += 1
            n_plain += ref is not None
    jpeg = tile_jpeg(TILE_SOURCE.read_bytes(), *CAMERA_FRAME)
    frame = decode_image(jpeg)
    frames = {"jpeg": jpeg,
              "jpeg_progressive": tile_jpeg(
                  PROGRESSIVE_TILE_SOURCE.read_bytes(), *CAMERA_FRAME),
              "png_paeth_sub": filtered_png(frame)}
    mp = CAMERA_FRAME[0] * CAMERA_FRAME[1] / 1e6
    res = {"fixtures": n_fixtures, "plain_read": n_plain, "frames": {}}
    for name, data in frames.items():
        codec_ms, got = _median_ms(decode_image, data, CODEC_REPS)
        if got.shape != (*CAMERA_FRAME, 3):
            raise RuntimeError(f"{name}: decoded {got.shape}")
        row = {"bytes": len(data), "codec_ms": codec_ms,
               "codec_ms_per_mp": codec_ms / mp}
        try:
            plain_ms, ref = _median_ms(plain(data), data, DECODE_REPS)
        except ValueError:              # progressive: the codec only
            plain_ms, ref = None, None
        if ref is not None:
            if not np.array_equal(got, ref):
                raise RuntimeError(f"{name}: the codec differs from the "
                                   f"plain decoder")
            row.update(plain_ms=plain_ms, plain_ms_per_mp=plain_ms / mp,
                       speedup=plain_ms / codec_ms)
        if name.startswith("png") and not np.array_equal(got, frame):
            raise RuntimeError("the filtered PNG does not decode to the "
                               "frame it was written from")
        res["frames"][name] = row
    log(f"image codec: {n_fixtures} fixtures equal their PIL decodes ("
        f"{n_plain} also the plain decoders'); host ms on a "
        f"{CAMERA_FRAME[1]}x{CAMERA_FRAME[0]} frame, codec | plain: " +
        "; ".join(f"{k} ({v['bytes']} bytes) {v['codec_ms']:.2f} "
                  f"({v['codec_ms_per_mp']:.2f} ms/MP) | "
                  + (f"{v['plain_ms']:.1f} ({v['speedup']:.1f}x)"
                     if "plain_ms" in v else "n/a")
                  for k, v in res["frames"].items()))
    return res


def _pose_records(stamps: list, world: np.ndarray, encode) -> list:
    """PoseWithCovarianceStamped records of camera-to-world poses
    ``world`` [N, 3, 4], each mapped through the inverse of the
    converter's axis change, so that ``convert_pose_tsv_to_f2_format``
    gives ``world`` back."""
    from f2nerf_tpu_torch.localize.localizer import matrix_to_quat_xyzw
    from f2nerf_tpu_torch.tools.convert_pose_tsv_to_f2_format import \
        AXIS_CONVERT_MAT_W2N as axis
    from f2nerf_tpu_torch.tools.rosbag_reader import make_stamp

    typ = "geometry_msgs/msg/PoseWithCovarianceStamped"
    out = []
    for t, pose in zip(stamps, world):
        m = np.eye(4)
        m[:3] = pose
        m = axis.T @ m @ axis
        q = matrix_to_quat_xyzw(m[:3, :3])
        msg = {"header": {"stamp": make_stamp(t), "frame_id": "map"},
               "pose": {"pose": {
                   "position": dict(zip("xyz", m[:3, 3].tolist())),
                   "orientation": dict(zip("xyzw", q.tolist()))},
                   "covariance": [0.0] * 36}}
        out.append((POSE_TOPIC, typ, int(round(t * 1e9)), encode(msg, typ)))
    return out


def scene_bag(ds, path: pathlib.Path) -> tuple[np.ndarray, np.ndarray]:
    """Phase 15b: ``ds``'s views as PNG ``CompressedImage`` messages on
    camera0 and its poses (``save_dataset``'s world poses) as pose
    messages stamped at the views' stamps, plus one before the first and
    one after the last, in a ``.db3`` bag. Returns (views uint8, world
    poses)."""
    from f2nerf_tpu_torch.tools import rosbag_reader as rb
    from f2nerf_tpu_torch.utils.image_io import encode_png

    views = np.clip(ds.images * 255.0 + 0.5, 0, 255).astype(np.uint8)
    world = ds.poses.astype(np.float64)
    world[:, :3, 3] = world[:, :3, 3] * ds.radius + ds.center
    stamps = [BAG_T0 + BAG_DT * k for k in range(ds.n_images)]
    typ = "sensor_msgs/msg/CompressedImage"
    msgs = [(CAMERA_TOPIC.format(0), typ, int(round(t * 1e9)), rb.encode(
        {"header": {"stamp": rb.make_stamp(t),
                    "frame_id": "camera0_optical"},
         "format": "png", "data": encode_png(v)}, typ))
        for t, v in zip(stamps, views)]
    pose_t = [stamps[0] - BAG_DT, *stamps, stamps[-1] + BAG_DT]
    pose_w = np.concatenate([world[:1], world, world[-1:]])
    rb.write_bag(str(path), msgs + _pose_records(pose_t, pose_w, rb.encode))
    return views, world


def mixed_messages() -> tuple[list, list, list]:
    """Phase 15b's second bag: the JPEG fixtures on camera0, a raw bgr8
    ``Image`` topic (camera1) and a mono8 one (camera2), with identity
    poses around them. Returns (the records, the topics, the expected
    images in the extractor's merged order)."""
    from f2nerf_tpu_torch.tools import rosbag_reader as rb

    expected = np.load(JPEG_FIXTURES / "expected.npz")
    names = sorted(p.name for p in JPEG_FIXTURES.glob("*.jpg"))
    rng = np.random.default_rng(3)
    h, w = 9, 14
    raw = [(rng.random((h, w, 3)) * 255).astype(np.uint8) for _ in range(3)]
    topics = [CAMERA_TOPIC.format(0), "/sensing/camera/camera1/image_raw",
              "/sensing/camera/camera2/image_raw"]
    msgs, want, t = [], [], BAG_T0
    for name in names:
        msgs.append((topics[0], "sensor_msgs/msg/CompressedImage",
                     int(round(t * 1e9)), rb.encode({
                         "header": {"stamp": rb.make_stamp(t),
                                    "frame_id": "camera0_optical"},
                         "format": "jpeg",
                         "data": (JPEG_FIXTURES / name).read_bytes()},
                         "sensor_msgs/msg/CompressedImage")))
        want.append(expected[name])
        t += BAG_DT
    for cam, enc in ((1, "bgr8"), (2, "mono8")):
        for img in raw:
            if enc == "bgr8":
                data, step, img_rgb = img[..., ::-1].tobytes(), 3 * w, img
            else:
                data, step = img[..., 0].tobytes(), w
                img_rgb = np.repeat(img[..., :1], 3, axis=-1)
            typ = "sensor_msgs/msg/Image"
            msgs.append((topics[cam], typ, int(round(t * 1e9)), rb.encode({
                "header": {"stamp": rb.make_stamp(t),
                           "frame_id": f"camera{cam}_optical"},
                "height": h, "width": w, "encoding": enc,
                "is_bigendian": 0, "step": step, "data": data}, typ)))
            want.append(img_rgb)
            t += BAG_DT
    eye = np.tile(np.eye(3, 4), (2, 1, 1))
    return msgs + _pose_records([BAG_T0 - BAG_DT, t], eye, rb.encode), \
        topics, want


def mixed_bag(path: pathlib.Path) -> tuple[list, list]:
    """:func:`mixed_messages` in a ``.db3`` bag; returns (topics, the
    expected images)."""
    from f2nerf_tpu_torch.tools import rosbag_reader as rb

    msgs, topics, want = mixed_messages()
    rb.write_bag(str(path), msgs)
    return topics, want


def camera_info_record() -> tuple:
    """A ``CameraInfo`` record for camera0 of the mixed bag (the JPEG
    fixtures' largest size), stamped before its first frame."""
    from f2nerf_tpu_torch.tools import rosbag_reader as rb

    typ = "sensor_msgs/msg/CameraInfo"
    t = BAG_T0 - 2 * BAG_DT
    return (CAMERA_TOPIC.format(0).rsplit("/", 2)[0] + "/camera_info", typ,
            int(round(t * 1e9)), rb.encode({
                "header": {"stamp": rb.make_stamp(t),
                           "frame_id": "camera0_optical"},
                "height": 32, "width": 48, "distortion_model": "plumb_bob",
                "d": [0.01, -0.002, 0.0, 0.0, 0.0],
                "k": [40.0, 0.0, 24.0, 0.0, 41.0, 16.0, 0.0, 0.0, 1.0],
                "r": [1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0],
                "p": [40.0, 0.0, 24.0, 0.0, 0.0, 41.0, 16.0, 0.0, 0.0, 0.0,
                      1.0, 0.0],
                "binning_x": 0, "binning_y": 0,
                "roi": {"x_offset": 0, "y_offset": 0, "height": 0,
                        "width": 0, "do_rectify": 0}}, typ))


def zero_calibration() -> dict:
    """The extractor's calibration for the phase's bags: every sensor at
    base_link."""
    zero = dict.fromkeys(("x", "y", "z", "roll", "pitch", "yaw"), 0.0)
    return {"base_link": {"sensor_kit_base_link": zero},
            "sensor_kit_base_link": {f"camera{i}": zero for i in range(3)}}


def mcap_chunks(buf: bytes) -> list[tuple[str, int, bytes]]:
    """The chunks of an mcap file: (compression, uncompressed size,
    compressed records)."""
    from f2nerf_tpu_torch.tools import rosbag_reader as rb

    out = []
    for op, content in rb._mcap_records(buf, 8):
        if op == rb._OP_FOOTER:
            break
        if op == rb._OP_CHUNK:
            usize = struct.unpack_from("<Q", content, 16)[0]
            compression, off = rb._mcap_string(content, 28)
            n = struct.unpack_from("<Q", content, off)[0]
            out.append((compression, usize, content[off + 8:off + 8 + n]))
    return out


def _decoder(compression: str):
    from f2nerf_tpu_torch.utils import decompress

    return {"zstd": decompress.zstd_decompress,
            "lz4": decompress.lz4_frame_decompress}[compression]


def extraction(bag: pathlib.Path, calib: pathlib.Path, out: pathlib.Path,
               topics: list) -> dict:
    """``extract_images_from_rosbag`` on ``bag`` into ``out``, the
    extracted ``camera_info.yaml``'s intrinsics rewritten as the ``K`` /
    ``D`` lists the converter reads (ROADMAP, fact 8; ``K`` a flow list
    over three lines, as calibration files are written by hand), then
    ``convert_pose_tsv_to_f2_format``: {"images": [decoded pixels],
    "pose_tsv", "cams_meta"} (the two TSV texts)."""
    from f2nerf_tpu_torch.core import yaml_io
    from f2nerf_tpu_torch.tools import convert_pose_tsv_to_f2_format as conv
    from f2nerf_tpu_torch.tools import extract_images_from_rosbag as extract
    from f2nerf_tpu_torch.utils.image_io import decode_png

    _tool(extract.main, str(bag), str(calib), str(out), "--image_topics",
          *topics)
    info = yaml_io.load(out / "camera_info.yaml", block_sequences=True)
    k = info["camera_matrix"]["data"]
    rows = [", ".join(map(repr, k[i:i + 3])) for i in (0, 3, 6)]
    (out / "camera_info.yaml").write_text(
        "K: [" + ",\n    ".join(rows) + "]\nD: ["
        + ", ".join(map(repr, info["distortion_coefficients"]["data"]))
        + "]\n")
    _tool(conv.main, str(out / "pose.tsv"))
    return {"images": [decode_png(p.read_bytes())
                       for p in sorted((out / "images").glob("*.png"))],
            "pose_tsv": (out / "pose.tsv").read_text(),
            "cams_meta": (out / "cams_meta.tsv").read_text()}


def pixels_sha256(img: np.ndarray) -> str:
    return hashlib.sha256(
        f"{img.shape}".encode() + np.ascontiguousarray(img).tobytes()
    ).hexdigest()


def _decode_rate(fn, data: bytes, size: int) -> tuple[float, int]:
    """Output MB/s of ``fn(data, size)`` over repeats of at least
    ``CHUNK_RATE_S`` seconds; (rate, repeats)."""
    reps, t0 = 0, time.perf_counter()
    while True:
        fn(data, size)
        reps += 1
        dt = time.perf_counter() - t0
        if dt >= CHUNK_RATE_S:
            return reps * size / dt / 1e6, reps


def bag_codec_check(root: pathlib.Path, calib: pathlib.Path,
                    build_s: float | None = None) -> dict:
    """Phase 15c: every committed fixture of ``tests/torch_fixtures/bag``
    (raw zstd and LZ4 frames, and the mixed bag's records in a zstd- and
    an LZ4-chunked mcap file) decodes by the compiled chunk codec to its
    stored length and SHA-256; both mcap bags and a ``.db3`` bag of the
    same records go through the extractor and the converter to the same
    images (bitwise), ``pose.tsv`` and ``cams_meta.tsv``, and to the
    stored images and ``pose.tsv`` (the JAX extractor's, with
    ``zstandard``); the codec's build seconds and its decode rate (MB/s
    of output) on each raw frame fixture, the largest zstd and LZ4 ones
    marked, on the host. ``build_s``: phase 1's build seconds
    of the codec, reported as given."""
    from f2nerf_tpu_torch.tools import rosbag_reader as rb

    root.mkdir(parents=True, exist_ok=True)
    expected = json.loads((BAG_FIXTURES / "expected.json").read_text())
    sizes = {}
    for name, want in sorted(expected["frames"].items()):
        data = (BAG_FIXTURES / name).read_bytes()
        got = _decoder(want["compression"])(data, want["size"])
        if hashlib.sha256(got).hexdigest() != want["sha256"]:
            raise RuntimeError(f"{name}: decodes to other bytes than "
                               f"stored")
        sizes[name] = (len(data), want["size"])
    msgs, topics, _ = mixed_messages()
    msgs = msgs + [camera_info_record()]
    rb.write_bag(str(root / "chunked.db3"), msgs)
    results = {"chunked.db3": extraction(root / "chunked.db3", calib,
                                         root / "chunked_db3", topics)}
    for name, want in sorted(expected["bags"].items()):
        buf = (BAG_FIXTURES / name).read_bytes()
        chunks = mcap_chunks(buf)
        if [(c, n) for c, n, _ in chunks] != [(want["compression"],
                                               want["chunk_size"])]:
            raise RuntimeError(f"{name}: chunks {[c[:2] for c in chunks]}")
        comp, usize, data = chunks[0]
        if hashlib.sha256(_decoder(comp)(data, usize)).hexdigest() \
                != want["chunk_sha256"]:
            raise RuntimeError(f"{name}: its chunk decodes to other bytes "
                               f"than stored")
        if sorted(rb.read_bag_any(str(BAG_FIXTURES / name))) != sorted(msgs):
            raise RuntimeError(f"{name}: its records differ from the "
                               f"mixed bag's")
        res = extraction(BAG_FIXTURES / name, calib,
                         root / name.replace(".", "_"), topics)
        if ([pixels_sha256(i) for i in res["images"]] != want["images"]
                or res["pose_tsv"] != want["pose_tsv"]):
            raise RuntimeError(f"{name}: the extracted images or poses "
                               f"differ from the JAX extractor's")
        results[name] = res
    ref = results["chunked.db3"]
    for name, res in results.items():
        if (len(res["images"]) != len(ref["images"]) or not all(
                np.array_equal(a, b)
                for a, b in zip(res["images"], ref["images"]))
                or res["pose_tsv"] != ref["pose_tsv"]
                or res["cams_meta"] != ref["cams_meta"]):
            raise RuntimeError(f"{name}: extraction differs from the .db3 "
                               f"bag's")
    rates = {}
    for name, want in sorted(expected["frames"].items()):
        data = (BAG_FIXTURES / name).read_bytes()
        rate, reps = _decode_rate(_decoder(want["compression"]), data,
                                  want["size"])
        rates[name] = {"bytes_in": len(data), "bytes_out": want["size"],
                       "mb_per_s": rate, "repeats": reps}
    largest = {comp: max((n for n, w in expected["frames"].items()
                          if w["compression"] == comp),
                         key=lambda n: rates[n]["bytes_in"])
               for comp in ("zstd", "lz4")}
    res = {"fixtures": len(expected["frames"]) + len(expected["bags"]),
           "images": len(ref["images"]),
           "build_s": build_s, "decode": rates,
           "largest": largest}
    smi = nvidia_smi() if torch.cuda.is_available() else "no card"
    log(f"chunk codec: {res['fixtures']} fixtures decode to their stored "
        f"SHA-256s; the zstd and LZ4 mcap bags extract to the .db3 bag's "
        f"{res['images']} images, pose.tsv and cams_meta.tsv and to the JAX "
        f"extractor's; build {res['build_s']} s [{smi}]")
    for name, v in rates.items():
        mark = " (the largest)" if name in largest.values() else ""
        log(f"  host decode {name}{mark}: {v['bytes_in']} -> "
            f"{v['bytes_out']} bytes, {v['mb_per_s']:.1f} MB/s of output "
            f"over {v['repeats']} repeats [{smi}]")
    return res


def child_env(root: pathlib.Path, launches: pathlib.Path, **extra) -> dict:
    """The drivers' environment: ``python`` is this interpreter, and
    ``root/site`` (on ``PYTHONPATH``) holds the sitecustomize that blocks
    jax, PIL and yaml and records the launch counts into ``launches``."""
    site = root / "site"
    (site / "bin").mkdir(parents=True, exist_ok=True)
    (site / "sitecustomize.py").write_text(_CHILD_SITE)
    py = site / "bin" / "python"
    py.write_text(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
    py.chmod(0o755)
    return dict(os.environ, PYTHONPATH=str(site), PYTHONUNBUFFERED="1",
                PATH=f"{site / 'bin'}{os.pathsep}{os.environ['PATH']}",
                CHIP_SMOKE_LAUNCHES=str(launches), **extra)


def run_driver(cmd: list, env: dict, what: str) -> tuple[int, list]:
    """``cmd`` in a session of its own, killed with everything it started
    after ``CHILD_TIMEOUT_S`` or on an error; returns (exit code, its
    output lines as (seconds since the start, text))."""
    t0 = time.perf_counter()
    proc = subprocess.Popen([str(c) for c in cmd], env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            start_new_session=True)
    timer = threading.Timer(CHILD_TIMEOUT_S,
                            lambda: os.killpg(proc.pid, signal.SIGKILL))
    timer.start()
    lines = []
    try:
        for line in proc.stdout:
            lines.append((time.perf_counter() - t0, line.rstrip("\n")))
            log(f"  [{what} {lines[-1][0]:6.1f} s] {line.rstrip()}")
        proc.wait()
    finally:
        timer.cancel()
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    return proc.returncode, lines


def child_launches(path: pathlib.Path, command: str | None = None) -> dict:
    """The launch counts the child processes recorded, summed over those
    whose arguments hold ``command`` (all when None)."""
    total = dict.fromkeys(ALL_KERNELS, 0)
    for line in path.read_text().splitlines() if path.exists() else []:
        rec = json.loads(line)
        if command is None or command in rec["argv"]:
            for name, n in rec["launches"].items():
                total[name] += n
    return total


def views_psnr(run: pathlib.Path, ds) -> float:
    """Mean PSNR of every training view rendered at full resolution from
    the run directory's newest checkpoint."""
    loc = Localizer.from_checkpoint(run)
    return float(np.mean([psnr(loc.render_image(ds.poses[i]).cpu().numpy(),
                               ds.images[i]) for i in range(ds.n_images)]))


def _first(lines: list, text: str) -> float:
    return next(t for t, line in lines if text in line)


def dataprep_phase(seed: int, dev: torch.device, root: pathlib.Path,
                   phase6: dict | None = None,
                   codec_build_s: float | None = None) -> dict:
    """Phase 15: a bag built here -> extraction -> conversion ->
    ``full_test.sh`` and a windowed ``run_cli_until_done.sh`` -> the
    offset tool, with jax, PIL and yaml unimportable (see the module
    docstring). ``phase6``: phase 6's result, whose training-view PSNR is
    reported beside this map's; ``codec_build_s``: phase 1's build seconds
    of the chunk codec."""
    from f2nerf_tpu_torch.core import yaml_io
    from f2nerf_tpu_torch.tools import convert_pose_tsv_to_f2_format as conv
    from f2nerf_tpu_torch.tools import extract_images_from_rosbag as extract
    from f2nerf_tpu_torch.tools import modified_offset_by_particles_log as off
    from f2nerf_tpu_torch.utils.image_io import decode_png

    root.mkdir(parents=True, exist_ok=True)
    res, sub = {}, {}
    with unimportable("jax", "PIL", "yaml", "zstandard", "lz4"):
        res["codec"] = codec_check()
        # b: the bags, extraction and conversion
        ds = make_textured_dataset(seed=seed)
        views, world = scene_bag(ds, root / "scene.db3")
        topics, want = mixed_bag(root / "mixed.db3")
        calib = root / "calib.yaml"
        yaml_io.dump(zero_calibration(), calib)
        data = root / "data"
        t0 = time.perf_counter()
        _tool(extract.main, str(root / "scene.db3"), str(calib), str(data),
              "--image_topics", CAMERA_TOPIC.format(0))
        res["extract_s"] = time.perf_counter() - t0
        pngs = sorted((data / "images").glob("*.png"))
        if len(pngs) != ds.n_images or not all(
                np.array_equal(decode_png(p.read_bytes()), v)
                for p, v in zip(pngs, views)):
            raise RuntimeError(f"{len(pngs)} extracted images differ from "
                               f"the {ds.n_images} views")
        # the converter reads K and D (ROADMAP, fact 8)
        yaml_io.dump({"K": ds.intrinsics[0].astype(float).ravel().tolist(),
                      "D": [0.0] * 5}, data / "camera_info.yaml")
        _tool(conv.main, str(data / "pose.tsv"))
        meta = np.loadtxt(data / "cams_meta.tsv", skiprows=1, ndmin=2)
        res["pose_err"] = float(np.abs(meta[:, :12].reshape(-1, 3, 4)
                                       - world).max())
        if meta.shape[0] != ds.n_images or res["pose_err"] > 1e-6:
            raise RuntimeError(f"cams_meta.tsv: {meta.shape[0]} poses, "
                               f"largest error {res['pose_err']:.3g}")
        out2 = root / "mixed"
        _tool(extract.main, str(root / "mixed.db3"), str(calib), str(out2),
              "--image_topics", *topics)
        got = [decode_png(p.read_bytes())
               for p in sorted((out2 / "images").glob("*.png"))]
        if len(got) != len(want) or not all(
                np.array_equal(g, w) for g, w in zip(got, want)):
            raise RuntimeError("the mixed bag's images differ from their "
                               "stored decodes")
        log(f"data prep: {ds.n_images} PNG views and {len(want)} JPEG / "
            f"bgr8 / mono8 frames extracted bitwise in "
            f"{res['extract_s']:.2f} s; cams_meta.tsv poses within "
            f"{res['pose_err']:.2e} of the scene's")
        # c: compressed mcap bags, through the chunk codec
        res["chunk_codec"] = bag_codec_check(root / "chunked", calib,
                                             codec_build_s)

        # d: full_test.sh, as phase 6 trains (the card's memory that this
        # process caches is handed back to the drivers first)
        torch.cuda.empty_cache()
        run = root / "run"
        run.mkdir()
        cfg = Config.quality(end_iter=RUN_STEPS)
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, report_freq=RUN_REPORT, save_freq=RUN_STEPS // 2,
            vis_freq=RUN_STEPS))
        cfg.save(run / "train_config.yaml")
        launches = root / "launches_full_test.jsonl"
        rc, lines = run_driver(["bash", TOOLS_DIR / "full_test.sh", run,
                                data], child_env(root, launches), "full_test")
        if rc != 0:
            raise RuntimeError(f"full_test.sh exited {rc}")
        # the first report comes RUN_REPORT steps after the SIGTERM
        # handler is in place (CUDA's set-up comes after the sample_near
        # line): the window below is timed from it
        startup = _first(lines, "Iter:")
        train_s = _first(lines, "Train done") - startup
        for name, command, used in (
                ("dataprep/train", "train", ("trilinear_fwd",
                                             "trilinear_bwd")),
                ("dataprep/test", "test", ("trilinear_fwd",))):
            sub[name] = {"wall_s": (train_s if command == "train" else
                                    lines[-1][0] - _first(lines,
                                                          "Train done")),
                         "launches": child_launches(launches, command)}
            check_launches(name, sub[name]["launches"], used)
        reports = _log_reports(run / "train_log.txt")
        dsl = load_dataset(data)
        res["view_psnr"] = views_psnr(run, dsl)
        tr = Trainer(cfg, dsl, result_dir=root / "untrained")
        tr.save_checkpoint()
        tr.close()
        res["untrained_psnr"] = views_psnr(root / "untrained", dsl)
        res.update(startup_s=startup, train_s=train_s,
                   train_psnr=reports[-1]["psnr"] if reports else None)
        log(f"full_test.sh: process start to the first report "
            f"{startup:.1f} s, then {RUN_STEPS - RUN_REPORT} steps in "
            f"{train_s:.1f} s, train PSNR (smoothed) "
            f"{res['train_psnr']}; training views {res['view_psnr']:.3f} dB "
            f"(phase 6's map: {(phase6 or {}).get('view_psnr')}) against "
            f"{res['untrained_psnr']:.3f} dB untrained")

        # e: run_cli_until_done.sh trains the same map on to
        # DATAPREP_STEPS in windows, the first cut at about half of them
        more = DATAPREP_STEPS - RUN_STEPS
        wcfg = Config.quality(end_iter=DATAPREP_STEPS)
        wcfg = dataclasses.replace(wcfg, train=dataclasses.replace(
            wcfg.train, report_freq=RUN_REPORT, save_freq=DATAPREP_STEPS,
            vis_freq=10 ** 9))
        wcfg.save(run / "train_config.yaml")
        window_s = int(np.ceil(startup + 0.5 * train_s * more
                               / (RUN_STEPS - RUN_REPORT) + 2))
        launches = root / "launches_windows.jsonl"
        wlog = root / "windows.log"
        t0 = time.perf_counter()
        rc, _ = run_driver(["bash", TOOLS_DIR / "run_cli_until_done.sh",
                            wlog, run, data],
                           child_env(root, launches, WINDOW_S=str(window_s),
                                     MAX_WINDOWS="6"), "run_cli_until_done")
        text = wlog.read_text()
        for line in text.splitlines():
            if "Iter:" not in line:
                log(f"  | {line}")
        windows = sum(line.startswith("=== window ") and "exit" not in line
                      for line in text.splitlines())
        last = ckpt_lib.latest_step(run / "checkpoints")
        sub["dataprep/cli_windows"] = {
            "wall_s": time.perf_counter() - t0,
            "launches": child_launches(launches)}
        check_launches("dataprep/cli_windows",
                       sub["dataprep/cli_windows"]["launches"],
                       ("trilinear_fwd", "trilinear_bwd"))
        res["windows"] = {"window_s": window_s, "windows": windows,
                          "last_checkpoint": last}
        if (rc != 0 or windows < 2 or "SIGTERM: checkpointed" not in text
                or text.splitlines()[-1] != "DONE"
                or last != DATAPREP_STEPS):
            raise RuntimeError(f"run_cli_until_done.sh: rc {rc}, {windows} "
                               f"windows of {window_s} s, last checkpoint "
                               f"{last}")
        res["final_psnr"] = views_psnr(run, dsl)
        log(f"run_cli_until_done.sh: {windows} windows of {window_s} s "
            f"trained the map from {RUN_STEPS} to {DATAPREP_STEPS} steps in "
            f"{sub['dataprep/cli_windows']['wall_s']:.1f} s; training views "
            f"{res['final_psnr']:.3f} dB (floor: untrained + 5 = "
            f"{res['untrained_psnr'] + 5:.3f})")

        # f: the offset tool on an Autoware parameter file
        res["offset"] = offset_check(root, off, yaml_io)
    res["subpaths"] = sub
    if not res["final_psnr"] >= res["untrained_psnr"] + 5.0:
        raise RuntimeError(f"the map's training views: "
                           f"{res['final_psnr']:.3f} dB, not 5 dB above the "
                           f"untrained map's {res['untrained_psnr']:.3f}")
    return res


OFFSET_PARAMS = """\
/**:
  ros__parameters:
    base_frame: base_link
    offset_position_x: 0.5
    offset_position_y: -0.1
    offset_position_z: 1.2
    offset_rotation_w: 0.9961946980917455
    offset_rotation_x: 0.0
    offset_rotation_y: 0.08715574274765817
    offset_rotation_z: 0.0
    particle_num: 100
"""


def offset_check(root: pathlib.Path, off, yaml_io) -> dict:
    """Phase 15f: ``modified_offset_by_particles_log --write`` on a seeded
    particle log and a ``/**:`` parameter file: the written offsets are
    the log's best-particle delta composed onto the file's (1e-5), the
    keys in the file's order."""
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(5)
    poses = np.stack([np.concatenate(
        [Rotation.from_rotvec(rng.normal(0, 0.05, 3)).as_matrix(),
         rng.normal(0, 0.1, (3, 1))], axis=1) for _ in range(8)])
    weights = rng.random(8)
    cols = [f"m{i}{j}" for i in range(3) for j in range(4)] + ["weight"]
    rows = ["\t".join(cols)] + [
        "\t".join(f"{v:.9f}" for v in (*p.ravel(), w))
        for p, w in zip(poses, weights)]
    (root / "particles.tsv").write_text("\n".join(rows) + "\n")
    params = root / "params.yaml"
    params.write_text(OFFSET_PARAMS)
    _tool(off.main, str(root / "particles.tsv"), "--params_yaml",
          str(params), "--write")
    got = yaml_io.load(params, block_sequences=True)["/**"]["ros__parameters"]
    before = yaml_io.loads(OFFSET_PARAMS)["/**"]["ros__parameters"]
    best = int(weights.argmax())
    pos = (np.array([before[f"offset_position_{a}"] for a in "xyz"])
           + poses[best][:3, 3] - poses[0][:3, 3])
    rot = Rotation.from_quat([before[f"offset_rotation_{a}"] for a in "xyzw"])
    quat = Rotation.from_matrix(poses[best][:3, :3] @ poses[0][:3, :3].T
                                @ rot.as_matrix()).as_quat()
    got_q = np.array([got[f"offset_rotation_{a}"] for a in "xyzw"])
    err = max(float(np.abs(np.array([got[f"offset_position_{a}"]
                                     for a in "xyz"]) - pos).max()),
              float(min(np.abs(got_q - quat).max(),
                        np.abs(got_q + quat).max())))
    if err > 1e-5 or list(got) != list(before):
        raise RuntimeError(f"offsets off by {err:.3g} or keys reordered: "
                           f"{list(got)}")
    log(f"modified_offset_by_particles_log: best particle {best}, written "
        f"offsets within {err:.2e}, key order kept")
    return {"best": best, "err": err}


# -- phase 16: the parts benches ---------------------------------------------

DENSE_RUN_STEPS = 500      # the dense run bench_dense_trained restores
DENSE_RUN_RAYS = 512


def parts_phase(seed: int, dev: torch.device, root: pathlib.Path) -> dict:
    """Phase 16: the four parts benches at their JAX scripts' points; the
    dense run that ``bench_dense_trained`` restores is trained here with
    ``apps.main train`` (see the module docstring)."""
    from f2nerf_tpu_torch.tools import (bench_dense_parts,
                                        bench_dense_trained,
                                        bench_encode_parts, bench_step_parts)

    root.mkdir(parents=True, exist_ok=True)
    cfg = Config()
    sub, res = {}, {}
    with unimportable("jax", "PIL", "yaml"):
        for name, used, run, report in (
                ("step", ("trilinear_fwd", "trilinear_bwd"),
                 lambda: bench_step_parts.measure(cfg, device=dev),
                 lambda out: bench_step_parts.report(out, cfg)),
                ("encode", ALL_KERNELS,
                 lambda: bench_encode_parts.measure(cfg, device=dev),
                 bench_encode_parts.report),
                ("dense", ("trilinear_fwd", "trilinear_bwd"),
                 lambda: bench_dense_parts.measure(cfg, device=dev),
                 bench_dense_parts.report)):
            sub[f"parts/{name}"], res[name] = _subpath(f"parts/{name}",
                                                       used, run)
            for line in report(res[name]):
                log(f"  parts/{name}: {line}")
        data, run = root / "data", root / "dense_run"
        save_dataset(make_textured_dataset(seed=seed), data)
        run.mkdir()
        dcfg = Config.quality(end_iter=DENSE_RUN_STEPS)
        dcfg = dataclasses.replace(
            dcfg, model=dataclasses.replace(dcfg.model, sampler_mode="dense"),
            train=dataclasses.replace(
                dcfg.train, pts_batch_size=DENSE_RUN_RAYS * 512,
                report_freq=100, save_freq=DENSE_RUN_STEPS,
                vis_freq=10 ** 9))
        dcfg.save(run / "train_config.yaml")
        t0 = time.perf_counter()
        cli.main(["train", str(run), str(data)])
        res["dense_run_s"] = time.perf_counter() - t0
        sub["parts/dense_trained"], out = _subpath(
            "parts/dense_trained", ("trilinear_fwd", "trilinear_bwd"),
            lambda: bench_dense_trained.measure(run, device=dev))
    for line in out["lines"]:
        log(f"  parts/dense_trained: {line}")
    res["dense_trained"] = out
    log(f"parts: the dense run ({DENSE_RUN_STEPS} steps at "
        f"{DENSE_RUN_RAYS} rays, {res['dense_run_s']:.1f} s) keeps "
        f"{100 * out['share']:.2f}% of the statistics rays' samples as "
        f"survivors (mean prefix {out['prefix']['mean']:.1f} of "
        f"{out['prefix']['samples']})")
    times = [t for part in ("step", "encode", "dense")
             for t in res[part].values() if isinstance(t, dict)]
    times += list(out["arms"].values())
    if not all(t["wall_ms"] > 0 and t["device_ms"] > 0 for t in times) \
            or not 0.0 < out["share"] <= 1.0 or len(out["arms"]) != 3:
        raise RuntimeError(f"the parts benches' numbers fail their checks: "
                           f"{res}")
    res["subpaths"] = sub
    return res


# -- phase 17: the held-out diagnostics and bench_scaling -----------------

DIAG_TOL_DB = 0.05     # view 8 by diag_holdout vs its summary.tsv row
AB_TOL_DB = 0.01       # eval_appearance_ab's none / ss=1 vs summary means
DIAG_VIEWS = {"holdout": 8, "train": 7}
SCALING_FLAGS = ["--rays", "8192", "--counts", "1"]   # Config(), one card
GLOO_FLAGS = ["--multiprocess", "2", "--quick", "--iters", "2", "--rays",
              "256"]


def _json_lines(text: str) -> list[dict]:
    return [json.loads(x) for x in text.splitlines() if x.startswith("{")]


def diag_phase(seed: int, dev: torch.device, run: pathlib.Path,
               training: dict | None) -> dict:
    """Phase 17 (module docstring) on phase 14's quality run ``run``;
    ``training``: phase 4's result, for its rays/s."""
    from f2nerf_tpu_torch.tools import (bench_scaling, diag_holdout,
                                        eval_appearance_ab)

    dev_flag = ["--device", str(dev)]
    scene = ["--scene", TOOLS_FLAGS[TOOLS_FLAGS.index("--scene") + 1],
             "--n_images", TOOLS_FLAGS[TOOLS_FLAGS.index("--n_images") + 1],
             "--hw", TOOLS_FLAGS[TOOLS_FLAGS.index("--hw") + 1],
             "--holdout_every", str(TOOLS_HOLDOUT)]
    summary = _tsv(run / "summary.tsv")
    sub, res = {}, {}
    with unimportable("jax", "PIL", "yaml"):
        sub["diag/diag_holdout"], (rc, text) = _subpath(
            "diag/diag_holdout", ("trilinear_fwd",),
            lambda: _tool(diag_holdout.main, str(run), *scene,
                          "--holdout_view", str(DIAG_VIEWS["holdout"]),
                          "--train_view", str(DIAG_VIEWS["train"]),
                          *dev_flag))
        views = {}
        for line in text.splitlines():
            m = re.match(r"view (\d+) (\w+): psnr (\S+) "
                         r"depth\[p10,p50,p90\]=\[(.*)\]", line)
            if m:
                views[m[2]] = {"view": int(m[1]), "psnr": float(m[3]),
                               "depth_p10_p50_p90": [
                                   float(x) for x in m[4].split(",")]}
        res["diag_holdout"] = views
        sub["diag/eval_appearance_ab"], (rc_ab, text) = _subpath(
            "diag/eval_appearance_ab", ("trilinear_fwd",),
            lambda: _tool(eval_appearance_ab.main, str(run), *scene,
                          "--embs", "none,mean,own", *dev_flag))
        arms = {}
        for line in text.splitlines():
            if line.startswith("emb="):
                f = line.split()
                arms[f"{f[0]} {f[1]}"] = dict(zip(
                    ("train_psnr", "holdout_psnr", "train_ssim",
                     "holdout_ssim", "gap"), map(float, f[2:7])))
        res["eval_appearance_ab"] = arms
        for mode in ("train", "render"):
            sub[f"diag/scaling_{mode}"], (_, text) = _subpath(
                f"diag/scaling_{mode}",
                ("trilinear_fwd", "trilinear_bwd") if mode == "train"
                else ("trilinear_fwd",),
                lambda mode=mode: _tool(bench_scaling.main, "--mode", mode,
                                        *SCALING_FLAGS, *dev_flag))
            res[f"scaling_{mode}"] = _json_lines(text)
        t0 = time.perf_counter()
        _, text = _tool(bench_scaling.main, *GLOO_FLAGS)
        res["scaling_gloo_cpu"] = _json_lines(text)
        res["scaling_gloo_cpu_s"] = time.perf_counter() - t0
    split = {tag: [r for r in summary if r["split"] == tag]
             for tag in ("train", "holdout")}
    row8 = next(float(r["psnr"]) for r in summary
                if int(r["image_idx"]) == DIAG_VIEWS["holdout"])
    base = arms.get("emb=none ss=1", {})
    means = {tag: _mean(split[tag], "psnr") for tag in split}
    train_rate = res["scaling_train"][0]["rays_per_s"] \
        if res["scaling_train"] else float("nan")
    phase4 = training["rays_per_s"] if training else float("nan")
    gloo = res["scaling_gloo_cpu"]
    log(f"diag: view {DIAG_VIEWS['holdout']} held out "
        f"{views.get('holdout', {}).get('psnr')} dB by diag_holdout vs "
        f"{row8:.4f} in summary.tsv; frozen directions "
        f"{views.get('holdout_fixdir', {}).get('psnr')} dB; eval_appearance"
        f"_ab none/ss=1 {base} vs summary means {means}")
    log(f"diag: bench_scaling at Config(), 8192 rays, 1 card: train "
        f"{train_rate} rays/s (phase 4: {phase4:.0f}), render "
        f"{res['scaling_render'][0]['rays_per_s'] if res['scaling_render'] else None}"
        f" rays/s; two gloo CPU ranks (--quick, a CPU figure, not the "
        f"card's): {gloo[-1] if gloo else None} in "
        f"{res['scaling_gloo_cpu_s']:.1f} s")
    finite = all(np.isfinite([v["psnr"], *v["depth_p10_p50_p90"]]).all()
                 for v in views.values())
    ok = (rc == 0 and rc_ab == 0 and len(views) == 4 and finite
          and abs(views["holdout"]["psnr"] - row8) <= DIAG_TOL_DB
          and len(arms) == 6 and base
          and abs(base["train_psnr"] - means["train"]) <= AB_TOL_DB
          and abs(base["holdout_psnr"] - means["holdout"]) <= AB_TOL_DB
          and all(len(res[f"scaling_{m}"]) == 2 and
                  res[f"scaling_{m}"][0]["rays_per_s"] > 0
                  for m in ("train", "render"))
          and [x.get("devices") for x in gloo] == [1, 2, None]
          and gloo[-1]["value"] > 0)
    res.update(summary_view8_psnr=row8, summary_means=means,
               phase4_rays_per_s=phase4)
    if not ok:
        raise RuntimeError(f"the diagnostics' outputs fail their checks: "
                           f"{res}")
    res["subpaths"] = sub
    return res


# -- phase 18: the JAX system's entry points ----------------------------------

TRAIN_KERNELS = ("trilinear_fwd", "trilinear_bwd")
# bench.py's arms, each run by bench.measure at the script's iterations,
# and the unit each must print (bench.py:267-279)
ENTRY_ARMS = {"default": [], "noqm": ["--no-quality-machinery"],
              "warp": ["--warp", "perspective"], "dense": ["--dense"],
              "quick": ["--quick"]}
ENTRY_UNITS = {
    "default": "rays/s/chip (fwd+bwd+adam, occ sampler, 64 samples/ray)",
    "noqm": "rays/s/chip (fwd+bwd+adam, occ sampler, 64 samples/ray, "
            "quality machinery off (r1 parity point))",
    "warp": "rays/s/chip (fwd+bwd+adam, occ sampler, 64 samples/ray, "
            "perspective warp (no run dedup))",
    "dense": "rays/s/chip (fwd+bwd+adam, dense, 1024 samples/ray, "
             "reference-parity point 512x1024)",
    "quick": "rays/s/chip (tiny cfg)"}
ENTRY_CLI = ["--iters", "10", "--no-cache-write"]
ENTRY_CHECK_RAYS = 64      # entry()'s rays held against the CPU
DRY_USED = {"dense": TRAIN_KERNELS, "occ": TRAIN_KERNELS,
            "flagship": TRAIN_KERNELS,
            "localize": ("trilinear_fwd", "trilinear_bwd_frac")}
DRY_LINE = re.compile(r"dryrun_multichip\((\d+), (\w+)\): OK, "
                      r"(loss|weights)=(.*)")


def _dry_lines(lines: list, world: int) -> dict:
    """The arms' OK lines of a dry run at ``world`` ranks."""
    out = {}
    for line in lines:
        m = DRY_LINE.match(line)
        if m and int(m[1]) == world:
            out[m[2]] = json.loads(m[4])
    if sorted(out) != sorted(graft_entry.ARMS):
        raise RuntimeError(f"dryrun {world}: OK lines for {sorted(out)}")
    return out


def entry_phase(seed: int, dev: torch.device, root: pathlib.Path,
                anchors: dict) -> dict:
    """Phase 18 (module docstring). ``anchors``: phases 4, 8(a) and 10's
    rays/s of the same steps."""
    sub, res = {}, {}
    for arm, argv in ENTRY_ARMS.items():
        args = bench.parse_args(argv)
        seen = []        # (rays/s so far, steps so far) after each chunk
        sub[arm], (value, unit, iters) = _subpath(
            f"entry/{arm}", TRAIN_KERNELS,
            lambda: bench.measure(args, dev, progress=lambda v, u, n: (
                v is not None and seen.append((v, n)))))
        if not (value > 0 and unit == ENTRY_UNITS[arm]):
            raise RuntimeError(f"bench {arm}: {value} {unit!r}")
        # each chunk's own rate, from the running totals
        rays = bench.arm_config(args).train.rays_per_step
        ends = [n * rays / v for v, n in seen]
        res[arm] = {"rays_per_s": value, "iters": iters, "chunk_rays_per_s": [
            (n1 - n0) * rays / (t1 - t0) for (_, n0), (_, n1), t0, t1
            in zip([(0, 0)] + seen[:-1], seen, [0.0] + ends[:-1], ends)]}
    log("bench.measure rays/s per arm: " + ", ".join(
        f"{arm} {r['rays_per_s']:.0f} (chunks "
        f"{[round(c) for c in r['chunk_rays_per_s']]})"
        for arm, r in res.items())
        + "; the same steps elsewhere: " + ", ".join(
            f"{k} {v:.0f}" for k, v in anchors.items() if v is not None))
    env = child_env(root, root / "cli_launches.jsonl")
    rc, lines = run_driver([sys.executable, "-m", "f2nerf_tpu_torch.bench",
                            *ENTRY_CLI], env, "bench cli")
    last = json.loads(lines[-1][1]) if rc == 0 and lines else {}
    if (list(last) != ["metric", "value", "unit", "vs_baseline"]
            or not last["value"] > 0 or last["unit"] != ENTRY_UNITS["default"]
            or any(w in last["unit"]
                   for w in ("watchdog", "CACHED", "exceeded"))):
        raise RuntimeError(f"bench CLI exited {rc}, last line {lines[-1:]}")
    res["cli"] = last
    sub["cli"] = {"launches": child_launches(root / "cli_launches.jsonl")}
    check_launches("entry/cli", sub["cli"]["launches"], TRAIN_KERNELS)

    def render():
        fn, args = graft_entry.entry(dev)
        return fn, args, fn(*args)

    sub["render"], (fn, args, (colors, depths)) = _subpath(
        "entry/render", ("trilinear_fwd",), render)
    n = args[2].shape[0]
    if (colors.shape != (n, 3) or depths.shape != (n,)
            or not (torch.isfinite(colors).all()
                    and torch.isfinite(depths).all())):
        raise RuntimeError(f"entry: shapes {colors.shape}, {depths.shape} "
                           f"or non-finite values")
    cpu = torch.device("cpu")
    k = ENTRY_CHECK_RAYS
    c_cpu, d_cpu = fn(_to(args[0], cpu), _to(args[1], cpu),
                      args[2][:k].cpu(), args[3][:k].cpu(), args[4].cpu())
    dc = float((colors[:k].cpu() - c_cpu).abs().max())
    dd = float(((depths[:k].cpu() - d_cpu).abs() / (d_cpu.abs() + 1e-3)).max())
    log(f"entry: OK {[list(colors.shape), list(depths.shape)]}; {k} rays "
        f"card vs CPU: max |d color| {dc:.3e}, max rel d depth {dd:.3e}")
    if not (dc <= 1e-3 and dd <= 1e-3):
        raise RuntimeError("entry's render on the card disagrees with the CPU")
    res["render"] = {"rays": n, "max_color_err": dc, "max_rel_depth_err": dd}
    del fn, args, colors, depths

    # dryrun_multichip(1) in this process: a NCCL group of one rank
    dist_env = {"WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0",
                "MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port())}
    dry1 = {}
    with mock.patch.dict(os.environ, dist_env):
        try:
            for tag in graft_entry.ARMS:
                sub[f"dry_{tag}"], out = _subpath(
                    f"entry/dry_{tag}", DRY_USED[tag],
                    lambda: graft_entry.dryrun_multichip(1, arms=(tag,)))
                dry1[tag] = out[tag]
            backend = dist.get_backend()
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
    if backend != "nccl":
        raise RuntimeError(f"dryrun 1 ran on {backend}")
    res["dryrun_1_nccl"] = {k: (v.tolist() if isinstance(v, np.ndarray)
                                else v) for k, v in dry1.items()}
    env = child_env(root, root / "dry_launches.jsonl")
    t0 = time.perf_counter()
    rc, lines = run_driver([sys.executable, "-m", "f2nerf_tpu_torch.graft_entry",
                            "dryrun", "2", "--backend", "gloo"], env,
                           "dryrun 2")
    if rc != 0:
        raise RuntimeError(f"dryrun 2 --backend gloo exited {rc}")
    res["dryrun_2_gloo"] = _dry_lines([x for _, x in lines], 2)
    res["dryrun_2_gloo"]["wall_s"] = time.perf_counter() - t0
    sub["dry_gloo2"] = {"launches": child_launches(root / "dry_launches.jsonl")}
    log(f"dryrun 1 (NCCL, in process): {res['dryrun_1_nccl']}; dryrun 2 (two "
        f"gloo ranks on cuda:0): {res['dryrun_2_gloo']}; launches of its "
        f"ranks {sub['dry_gloo2']['launches']}")
    return {"subpaths": sub, **res}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    # phase 13 runs this script as the ranks of a process group
    ap.add_argument("--dist-worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--work", help=argparse.SUPPRESS)
    ap.add_argument("--backend", help=argparse.SUPPRESS)
    ap.add_argument("--device", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if args.dist_worker:
        return dist_worker(args)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"device: {kind}; nvidia-smi: {smi}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    secs = build.build_all(build.kernel_names() + list(build.HOST_SOURCES))
    log(f"built {sorted(secs)} in {time.perf_counter() - t0:.1f} s ("
        + ", ".join(f"{n} {t:.1f} s" for n, t in sorted(secs.items())) + ")")
    for name in secs:
        # each kernel instance's mangled name, then its registers, spills
        # and shared memory
        for line in build.build_log(name).splitlines():
            if any(k in line for k in ("entry function", "registers",
                                       "spill")):
                log(f"  {name}: {line.split(':', 1)[-1].strip()}")

    failed = []

    def phase(name, fn, *a, **kw):
        """Run one phase; a failure is logged and the script goes on, so
        that one run shows every phase's numbers, then exits non-zero."""
        try:
            return fn(*a, **kw)
        except Exception:                   # noqa: BLE001 — report, go on
            traceback.print_exc()
            log(f"PHASE FAILED: {name}")
            failed.append(name)
            return None

    cfg = Config()
    situ = in_situ_inputs(cfg, args.seed, dev)
    kernels = [kernel_phase(cfg, args.seed, dev, situ),
               bwd_kernel_phase(train_cfg(TRAIN_RAYS), args.seed, dev),
               frac_kernel_phase(cfg, args.seed, dev, situ)]
    del situ
    phase("warp kernels", warp_kernel_phase, args.seed, dev, kernels)
    narrow = narrow_channels_check(args.seed, dev)
    for k in kernels:
        k["max_abs_err_c3"] = narrow[k["name"]]
    paths = {"serving": phase("serving", serving_phase, cfg, args.seed, dev),
             "training": phase("training", training_phase,
                               train_cfg(TRAIN_RAYS), args.seed, dev),
             "differential": phase("differential", differential_phase, cfg,
                                   args.seed, dev)}
    runs = {}

    def add_paths(prefix: str, res: dict | None) -> None:
        if res is not None:
            for name, sub in res.pop("subpaths").items():
                paths[f"{prefix}{name}"] = sub

    for name, fn, a in (
            ("training", training_dedup, (args.seed, dev)),
            ("mode0", requests_dedup, (cfg, args.seed, dev, 0)),
            ("mode1", requests_dedup, (cfg, args.seed, dev, 1,
                                       o1_params(cfg, args.seed + 6, dev)))):
        runs[f"dedup/{name}"] = phase(f"{name} dedup", fn, *a)
        add_paths("dedup/", runs[f"dedup/{name}"])
    wcfg = warp_cfg(train_cfg(TRAIN_RAYS))
    paths["warp/training"] = phase(
        "warp training", training_phase, wcfg, args.seed, dev,
        consts=ring_warp_consts(wcfg, dev), path="warp/training")
    with tempfile.TemporaryDirectory() as tmp:
        work = pathlib.Path(tmp)
        for prefix, warp in (("", False), ("warp/", True)):
            res = phase(f"{prefix}run directory", run_directory_phase,
                        args.seed, dev, work / (prefix or "contract"),
                        warp=warp)
            add_paths(f"{prefix}run_directory/", res)
            runs[f"{prefix}run_directory"] = res
        runs["node"] = phase("node", node_phase, args.seed, dev,
                             work / "contract")
        add_paths("node/", runs["node"])
        runs["lpips"] = phase("lpips", lpips_phase, args.seed, dev,
                              work / "contract")
        runs["distributed"] = phase("distributed", distributed_phase,
                                    args.seed, dev, work / "distributed")
        add_paths("distributed/", runs["distributed"])
        runs["tools"] = phase("tools", tools_phase, args.seed, dev,
                              work / "tools")
        add_paths("", runs["tools"])
        runs["dataprep"] = phase("data prep", dataprep_phase, args.seed, dev,
                                 work / "dataprep", runs["run_directory"],
                                 secs["chunk_codec"])
        add_paths("", runs["dataprep"])
        runs["parts"] = phase("parts", parts_phase, args.seed, dev,
                              work / "parts")
        add_paths("", runs["parts"])
        runs["diag"] = phase("diag", diag_phase, args.seed, dev,
                             work / "tools" / "run", paths["training"])
        add_paths("", runs["diag"])
    runs["dense"] = phase("dense two-pass", dense_phase, args.seed, dev,
                          kernels)
    add_paths("dense/", runs["dense"])
    paths["xor/training"] = phase("xor training", xor_phase, args.seed, dev)
    dense_rs = (runs["dense"] or {}).get("timing", {}).get("RS")
    anchors = {
        "phase 4": (paths["training"] or {}).get("rays_per_s"),
        "phase 8(a) warp": (paths["warp/training"] or {}).get("rays_per_s"),
        # bench.py --dense runs the single pass (dense_two_pass is off)
        "phase 10 dense": (DENSE_RAYS / dense_rs["single_pass"]["mean_ms"]
                           * 1e3 if dense_rs else None)}
    with tempfile.TemporaryDirectory() as tmp:
        runs["entry"] = phase("entry points", entry_phase, args.seed, dev,
                              pathlib.Path(tmp), anchors)
        add_paths("entry/", runs["entry"])
    corridor = make_corridor_dataset(seed=args.seed)
    ccfg = warp_cfg(cfg)
    cconsts = warp_consts(corridor.poses, ccfg.model, dev)
    xcfg = xor_cfg(cfg)
    checks = {
        "render": phase("render check", cross_check_phase, cfg, args.seed,
                        dev),
        "warp render": phase("warp render check", cross_check_phase, ccfg,
                             args.seed, dev, consts=cconsts,
                             what="warp render"),
        "xor render": phase("xor render check", cross_check_phase, xcfg,
                            args.seed, dev,
                            consts=xor_consts(xcfg, args.seed, dev),
                            what="xor render"),
        "step": phase("step check", step_check_phase, args.seed, dev),
        "pose": phase("pose check", pose_check_phase, cfg, args.seed, dev),
        "warp pose": phase("warp pose check", pose_check_phase, ccfg,
                           args.seed, dev, consts=cconsts,
                           grad_tol=WARP_POSE_TOL)}
    if failed:
        log(f"chip_smoke: failed phases {failed}")
        return 1

    for k in kernels:
        by_path = {path: res["launches"][k["name"]]
                   for path, res in paths.items()}
        k["launches"] = sum(by_path.values())
        k["launches_by_path"] = by_path
    for path, res in paths.items():
        log(f"{path}: {json.dumps(res)}")
    for name, res in runs.items():
        log(f"{name}: {json.dumps(res)}")
    for name, res in checks.items():
        log(f"{name} check: {json.dumps(res)}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
