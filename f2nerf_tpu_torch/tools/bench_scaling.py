"""Train-step (or sharded render) throughput at 1, 2, ..., k ranks and
its scaling efficiency (port of ``scripts/bench_scaling.py`` to
``torch.distributed``).

    python -m f2nerf_tpu_torch.tools.bench_scaling [--quick] [--iters 20] \\
        [--rays R] [--counts 1,2] [--mode train|render] [--device cpu]
    torchrun --nproc_per_node=K -m f2nerf_tpu_torch.tools.bench_scaling ...
    python -m f2nerf_tpu_torch.tools.bench_scaling --multiprocess 2 --quick

The ray batch is sharded over the ranks and the params are replicated
(``parallel/mesh.py``). Under ``torchrun`` every rank joins the process
group from its environment (``maybe_initialize_distributed``); for each
count c of the sweep, every rank builds the subgroup of the first c
ranks, those c ranks run the bench on it, and the others wait at a
barrier. ``--multiprocess N`` launches N ranks of this tool on the CPU
(gloo, ``--device cpu``) and relays rank 0's output: a plumbing check,
not a speed figure. Rank 0 prints one JSON line per count, then the
per-rank efficiency relative to the smallest count. One card gives
``--counts 1`` only: NCCL refuses two ranks on one card, so a scaling
figure needs a machine with several cards.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch
import torch.distributed as dist

from f2nerf_tpu_torch.core.config import Config
from f2nerf_tpu_torch.core.device import resolve_device
from f2nerf_tpu_torch.models import hash_field, occupancy, renderer
from f2nerf_tpu_torch.parallel.mesh import (DataMesh,
                                            maybe_initialize_distributed,
                                            replicate, shard_batch)
from f2nerf_tpu_torch.tools.common import add_device_flag, launch_ranks
from f2nerf_tpu_torch.train.optim import make_optimizer
from f2nerf_tpu_torch.train.step import make_train_step

SWEEP = (1, 2, 4, 8, 16, 32)       # the default counts, up to the ranks


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _init(cfg: Config, dev: torch.device, mesh: DataMesh):
    """Seeded params and constants for 8 images, made equal on the ranks."""
    gen = torch.Generator(device=dev).manual_seed(0)
    params = renderer.init(gen, cfg.model, 8, dev)
    consts = {"field": hash_field.init_consts(gen, cfg.model, dev)}
    replicate(mesh, [params, consts])
    return params, consts


def bench_devices(mesh: DataMesh, cfg: Config, iters: int) -> float:
    """Rays/s of the train step over ``mesh``: 8 identity cameras of
    256 x 256 at f = 200, batches from ``default_rng(0)`` (every rank
    draws the global batch and takes its rows), one warm-up step, then
    ``iters`` timed steps up to a synchronize."""
    dev = mesh.device
    batch = cfg.train.rays_per_step
    params, consts = _init(cfg, dev, mesh)
    optimizer = make_optimizer(params, cfg.train)
    occ = occupancy.init_grid(cfg.model, dev)
    poses = torch.eye(3, 4, device=dev)[None].repeat(8, 1, 1)
    intr = torch.tensor([[200.0, 0, 128.0], [0, 200.0, 128.0],
                         [0, 0, 1.0]], device=dev)[None].repeat(8, 1, 1)
    rng = np.random.default_rng(0)

    def batch_data():
        cam = rng.integers(0, 8, batch).astype(np.int32)
        ij = np.stack([rng.integers(0, 256, batch),
                       rng.integers(0, 256, batch)], -1).astype(np.int32)
        gt = rng.random((batch, 3)).astype(np.float32)
        return [torch.as_tensor(x, device=dev)
                for x in shard_batch(mesh, cam, ij, gt)]

    step_fn = make_train_step(cfg, optimizer, mesh=mesh)
    occ, _ = step_fn(params, occ, poses, intr, 0, *batch_data(),
                     consts=consts)
    batches = [batch_data() for _ in range(iters)]
    _sync(dev)
    t0 = time.perf_counter()
    for k, b in enumerate(batches):
        occ, _ = step_fn(params, occ, poses, intr, k + 1, *b, consts=consts)
    _sync(dev)
    return iters * batch / (time.perf_counter() - t0)


def bench_render(mesh: DataMesh, cfg: Config, iters: int) -> float:
    """Rays/s of the sharded VALIDATE render (``render_rays_chunked`` with
    ``mesh``): one chunk of ``rays_per_step`` seeded rays against the
    warm-up occupancy, its colors summed on the host each call."""
    dev = mesh.device
    params, consts = _init(cfg, dev, mesh)
    batch = cfg.train.rays_per_step
    rng = np.random.default_rng(0)
    rays_o = torch.as_tensor(rng.normal(0, 0.3, (batch, 3)).astype(
        np.float32), device=dev)
    rays_d = torch.as_tensor(rng.normal(0, 1.0, (batch, 3)).astype(
        np.float32), device=dev)
    occ = None
    if cfg.model.sampler_mode == "occ":
        occ = occupancy.occ_values(occupancy.init_grid(cfg.model, dev),
                                   cfg.model, warmup=True)

    def run():
        c, _ = renderer.render_rays_chunked(
            params, rays_o, rays_d, cfg.model, chunk=batch, occ_vals=occ,
            consts=consts, mesh=mesh)
        return float(c.sum())        # the host read ends the call

    run()
    t0 = time.perf_counter()
    for _ in range(iters):
        run()
    return iters * batch / (time.perf_counter() - t0)


def summary(results: dict[int, float]) -> dict:
    """The scaling-efficiency line: each count's per-rank rate over the
    smallest count's (``results`` in sweep order)."""
    counts = list(results)
    base = results[counts[0]] / counts[0]
    eff = {c: (results[c] / c) / base for c in counts}
    return {"metric": "scaling_efficiency",
            "per_devices": {str(c): round(e, 4) for c, e in eff.items()},
            "value": round(eff[counts[-1]], 4),
            "unit": f"rays/s efficiency at {counts[-1]} devices vs 1"}


def _launch_multiprocess(args) -> None:
    """Start ``args.multiprocess`` gloo ranks of this tool on the CPU
    and relay rank 0's output (``common.launch_ranks``)."""
    base = ["--multiprocess", str(args.multiprocess), "--iters",
            str(args.iters), "--mode", args.mode, "--device", "cpu"]
    if args.quick:
        base.append("--quick")
    if args.rays:
        base += ["--rays", str(args.rays)]
    if args.counts:
        base += ["--counts", args.counts]
    launch_ranks("f2nerf_tpu_torch.tools.bench_scaling", args.multiprocess,
                 lambda r, port: base + ["--port", str(port),
                                         "--worker", str(r)])


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(
        epilog="One card measures --counts 1 only; a scaling figure needs "
               "a machine with several cards.")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--rays", type=int, default=None)
    ap.add_argument("--counts", type=str, default=None,
                    help="comma-separated device counts (default sweep)")
    ap.add_argument("--mode", choices=("train", "render"),
                    default="train")
    ap.add_argument("--multiprocess", type=int, default=0,
                    help="launch N gloo ranks of this tool on the CPU "
                         "(torchrun's environment on localhost) and bench "
                         "over their process group: the multi-process "
                         "paths, per-rank batch slices included")
    ap.add_argument("--worker", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None,
                    help=argparse.SUPPRESS)
    add_device_flag(ap)
    args = ap.parse_args(argv)

    if args.multiprocess > 0 and args.worker is None:
        _launch_multiprocess(args)
        return

    dev = maybe_initialize_distributed(device=args.device)
    if dev is None:
        dev = resolve_device(args.device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0

    cfg = Config.tiny() if args.quick else Config()
    rays = args.rays or (1024 if args.quick else 8192)
    cfg = dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train,
                                       pts_batch_size=rays * 512))
    counts = ([int(c) for c in args.counts.split(",")] if args.counts
              else [c for c in SWEEP if c <= world])
    if max(counts) > world:
        raise SystemExit(f"counts {counts} exceed the {world} ranks")
    fn = bench_devices if args.mode == "train" else bench_render
    results = {}
    for c in counts:
        # every rank takes part in building every subgroup
        group = dist.new_group(list(range(c))) if c > 1 else None
        if rank < c:
            rate = fn(DataMesh(group, rank, c, dev), cfg, args.iters)
            results[c] = rate
            if rank == 0:
                print(json.dumps({"devices": c, "rays_per_s": round(rate, 1),
                                  "rays_per_s_per_chip": round(rate / c,
                                                               1)}),
                      flush=True)
        if world > 1:
            dist.barrier()
    if rank == 0:
        print(json.dumps(summary(results)), flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
