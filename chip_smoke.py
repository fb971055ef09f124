#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases (each passes or raises; the script exits 0 only if all pass):

1. Device and build: print the card, its power limit, and build every
   CUDA kernel under f2nerf_tpu_torch/kernels/csrc (one nvcc per
   source, all started together).
2. Kernels at full width: each kernel on the inputs of one mode-0
   localize request at the default ``Config()`` model, held against its
   plain PyTorch version and timed with CUDA events.
3. Serving: a ``Localizer`` at the full-width ``Config()`` model (seeded
   random weights, the seeded 25%-occupied grid of ``bench.py``) behind
   a ``LocalizerService``: ``init_pose``, three mode-0 ``localize``
   requests of 64 particles, ``status``. The kernels' launch counts are
   set to 0 just before and read just after; every kernel must have
   launched.
4. End-to-end check: the same renderer on 512 rays on the card and on
   the CPU (plain versions), with O(1) features.

Then one JSON line per the kernels, the ``nvidia-smi`` name and power
limit, and as the last line ``{"ok": true, "device": {...}}``. Without a
CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from f2nerf_tpu_torch.apps.serve import LocalizerService
from f2nerf_tpu_torch.core.config import Config
from f2nerf_tpu_torch.kernels import build, trilinear
from f2nerf_tpu_torch.localize.localizer import Localizer, LocalizerParam
from f2nerf_tpu_torch.models import hash_field, occupancy, renderer
from f2nerf_tpu_torch.ops import hash_paged

# H100 SXM peaks (NVIDIA data sheet) for the bound: HBM3 bytes/s and
# f32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
KERNEL_TOL = 1e-5          # kernel vs plain version, same inputs
FRAME_H, FRAME_W, RESIZE = 850, 1920, 8   # scripts/bench_localize.py
N_REQUESTS, PARTICLES = 3, 64


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


def request_inputs(cfg: Config, seed: int, dev: torch.device):
    """Encode inputs of one mode-0 request: 64 particles x 256 pixels x
    64 samples = 1,048,576 points, uniform in [-2, 2)^3, over the full
    table with pages drawn U[-1, 1] (O(1) features), bf16."""
    meta = hash_field.paged_meta(cfg.model)
    g = torch.Generator(device=dev).manual_seed(seed)
    pages = torch.rand((meta.total_pages, meta.n_channels, 4, 4, 4),
                       generator=g, device=dev) * 2 - 1
    haloed = hash_paged.halo_pages(pages, meta).to(torch.bfloat16)
    n = PARTICLES * 256 * cfg.model.occ_keep \
        * cfg.model.occ_samples_per_segment
    pts = torch.rand((n, 3), generator=g, device=dev) * 4 - 2
    page_idx, local, frac = hash_paged.page_indices(pts, meta)
    return haloed, page_idx, torch.cat([local.float(), frac], dim=-1)


def trilinear_bound_ms(haloed, page_idx, local_frac) -> float:
    """Least time for this call's work on an H100 SXM: each input byte
    read once (the table cells the corners touch, counted once), the
    output written once; ~80 f32 flops per (point, level) is far below
    the compute bound."""
    n_pages, width = haloed.shape
    c = width // hash_paged.ROW_PAD
    touched = torch.zeros(n_pages * hash_paged.ROW_PAD, dtype=torch.bool,
                          device=haloed.device)
    lx, ly, lz = (local_frac[..., k].long() for k in range(3))
    base = page_idx.long() * hash_paged.ROW_PAD
    for k in range(8):
        dx, dy, dz = k >> 2, (k >> 1) & 1, k & 1
        touched[base + 25 * (lx + dx) + 5 * (ly + dy) + (lz + dz)] = True
    table_bytes = int(touched.sum()) * c * haloed.element_size()
    pairs = page_idx.numel()
    io_bytes = (page_idx.numel() * 4 + local_frac.numel() * 4
                + pairs * c * 4)
    flops = pairs * 8 * (2 + 2 * c)
    return max((table_bytes + io_bytes) / HBM_BYTES_PER_S,
               flops / F32_FLOPS) * 1e3


def kernel_phase(cfg: Config, seed: int, dev: torch.device) -> dict:
    haloed, page_idx, lf = request_inputs(cfg, seed, dev)
    out = trilinear.trilinear_fwd(haloed, page_idx, lf)
    torch.cuda.synchronize()
    ref = trilinear.trilinear_fwd_ref(haloed, page_idx, lf,
                                      chunk=cfg.model.encode_chunk)
    err = float((out - ref).abs().max())
    log(f"trilinear_fwd bf16 N={page_idx.shape[1]} L={page_idx.shape[0]}: "
        f"max |kernel - plain| = {err:.3e} (tol {KERNEL_TOL})")
    if not (np.isfinite(err) and err <= KERNEL_TOL):
        raise RuntimeError(f"trilinear_fwd disagrees with its plain "
                           f"version: {err}")
    err32 = float((trilinear.trilinear_fwd(haloed.float(), page_idx, lf)
                   - trilinear.trilinear_fwd_ref(haloed.float(), page_idx,
                                                 lf)).abs().max())
    log(f"trilinear_fwd f32: max |kernel - plain| = {err32:.3e}")
    if not err32 <= KERNEL_TOL:
        raise RuntimeError(f"trilinear_fwd f32 disagrees: {err32}")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    ms = cuda_ms(lambda: trilinear.trilinear_fwd(haloed, page_idx, lf),
                 flush=flush)
    plain_ms = cuda_ms(lambda: trilinear.trilinear_fwd_ref(
        haloed, page_idx, lf, chunk=cfg.model.encode_chunk), flush=flush)
    warm_ms = cuda_ms(lambda: trilinear.trilinear_fwd(haloed, page_idx, lf))
    bound_ms = trilinear_bound_ms(haloed, page_idx, lf)
    log(f"trilinear_fwd: {ms:.4f} ms (L2 flushed), {warm_ms:.4f} ms "
        f"(back to back), plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms")
    return {"name": "trilinear_fwd", "route": "cuda",
            "source": "f2nerf_tpu_torch/kernels/csrc/trilinear_fwd.cu",
            "replaces": "f2nerf_tpu/kernels/trilinear.py:146 (contract_fwd)",
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "ref_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": None}


def seeded_occ_vals(cfg: Config, dev: torch.device) -> torch.Tensor:
    """bench.py's seeded ~25%-occupied grid, as sampler values."""
    res = cfg.model.occ_grid_res
    occ_rng = np.random.default_rng(1)
    seeded = (occ_rng.random((res, res, res)) < 0.25).astype(np.float32) \
        * (2.0 * occupancy.sigma_threshold(cfg.model))
    grid = torch.as_tensor(np.stack([seeded, seeded]), device=dev)
    return occupancy.occ_values(grid, cfg.model)


def make_localizer(cfg: Config, seed: int, dev: torch.device) -> Localizer:
    g = torch.Generator(device=dev).manual_seed(seed)
    params = renderer.init(g, cfg.model, 4, dev)
    intr = np.array([[1000.0, 0, FRAME_W / 2], [0, 1000.0, FRAME_H / 2],
                     [0, 0, 1.0]], np.float32)
    return Localizer(params, cfg, intr, np.zeros(3), 1.0, FRAME_H, FRAME_W,
                     param=LocalizerParam(resize_factor=RESIZE),
                     occ_vals=seeded_occ_vals(cfg, dev), seed=seed,
                     device=dev)


def _to(tree, where):
    return {k: _to(v, where) if isinstance(v, dict) else v.to(where)
            for k, v in tree.items()}


def serving_phase(cfg: Config, seed: int, dev: torch.device) -> dict:
    loc = make_localizer(cfg, seed, dev)
    svc = LocalizerService(loc)
    pose = np.eye(3, 4, dtype=np.float32)
    target_pose = pose.copy()
    target_pose[:, 3] += [0.01, -0.005, 0.02]
    target = loc.render_image(target_pose).cpu().numpy()
    log(f"localizer {loc.infer_height}x{loc.infer_width}, "
        f"{hash_field.paged_meta(cfg.model).total_pages} pages")

    trilinear.trilinear_fwd.launches = 0
    torch.cuda.synchronize()
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
        pose_w = np.asarray(r.get("pose", np.nan), dtype=np.float64)
        if not (r.get("ok") and pose_w.shape == (4, 4)
                and np.isfinite(pose_w).all()
                and np.isfinite(r.get("score", np.nan))):
            raise RuntimeError(f"localize request {k} failed: {r}")
        log(f"mode-0 request {k}: {times[-1]:.1f} ms, score "
            f"{r['score']:.4g}")
    st = svc.handle({"cmd": "status"})
    if not (st["ok"] and st["frames"] == N_REQUESTS):
        raise RuntimeError(f"status: {st}")
    torch.cuda.synchronize()
    launches = {"trilinear_fwd": trilinear.trilinear_fwd.launches}
    log(f"launches on the serving path: {launches}")
    for name, count in launches.items():
        if count <= 0:
            raise RuntimeError(f"{name} never launched on the serving path")
    return {"request_ms": times, "launches": launches,
            "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 2**30,
            "profile": profile_request(svc, req)}


def profile_request(svc: LocalizerService, req: dict) -> dict:
    """One more mode-0 request under torch.profiler: wall time, device
    kernel time by name, and the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        svc.handle(req)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        kernels[evt.key] = kernels.get(evt.key, 0.0) + us / 1e3
    device_ms = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    log(f"profiled request: wall {wall_ms:.2f} ms, device kernels "
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
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    params = renderer.init(g, cfg.model, 4, dev)
    pool = params["field"]["feat_pool"]
    params["field"]["feat_pool"] = torch.rand(
        pool.shape, generator=g, device=dev) * 2 - 1
    params["field"]["mlp"]["b"][0] = 4.0
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
        lines = {line.split(":", 1)[-1].strip()
                 for line in build.build_log(name).splitlines()
                 if "registers" in line or "spill" in line}
        for line in sorted(lines):
            log(f"  {name}: {line}")

    cfg = Config()
    kernel = kernel_phase(cfg, args.seed, dev)
    serving = serving_phase(cfg, args.seed, dev)
    cross_check_phase(cfg, args.seed, dev)

    kernel["launches"] = serving["launches"]["trilinear_fwd"]
    log(f"serving: {json.dumps(serving)}")
    print(json.dumps({"kernels": [kernel]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
