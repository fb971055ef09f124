"""Entry points: the flagship VALIDATE render and the multi-device
dry run of the full training step (port of ``__graft_entry__.py``).

    python -m f2nerf_tpu_torch.graft_entry [--device cpu]
    python -m f2nerf_tpu_torch.graft_entry dryrun [N] [--device D] \\
        [--backend nccl|gloo]
    torchrun --nproc_per_node=N -m f2nerf_tpu_torch.graft_entry dryrun N

Without ``dryrun``: :func:`entry`'s render once, then ``entry: OK`` and
the output shapes. With it: under ``torchrun`` (``WORLD_SIZE`` set) every
rank runs :func:`dryrun_multichip` in place; otherwise the command starts
N ranks of itself on this host (``tools.common.launch_ranks``) and relays
rank 0's lines. ``--device cpu`` makes them gloo ranks on the CPU; on the
card each rank takes ``cuda:LOCAL_RANK`` over NCCL, and ``--backend
gloo`` puts every rank on ``cuda:0`` (NCCL refuses two ranks on one
card).

Where the port differs from the script: the params come from the port's
``renderer.init`` and ``entry``'s rays from a seeded ``torch.Generator``
on the device (the script draws from ``jax.random.key``, whose bits the
port cannot reproduce); the batches are the script's ``default_rng(0)``
draws. The mesh is one process per rank holding replicated params,
constants, optimizer state and grid, each rendering its slice of the
global batch (``parallel/mesh.py``), where the script has one program
over a JAX device mesh.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from f2nerf_tpu_torch.core.config import Config
from f2nerf_tpu_torch.core.device import resolve_device
from f2nerf_tpu_torch.models import hash_field, occupancy, renderer
from f2nerf_tpu_torch.parallel.mesh import (DataMesh, make_mesh,
                                            maybe_initialize_distributed,
                                            replicate, shard_batch)
from f2nerf_tpu_torch.tools.common import add_device_flag, launch_ranks
from f2nerf_tpu_torch.train.optim import make_optimizer
from f2nerf_tpu_torch.train.step import make_train_step

ARMS = ("dense", "occ", "flagship", "localize")


def entry(device: str | torch.device | None = None):
    """(fn, example_args): the VALIDATE render of the flagship model, the
    paged hash grid at the reference's 2^19-per-level capacity with
    occupancy-guided sampling, SH shading and masked compositing, on
    ``rays_per_step`` rays. ``fn(params, consts, rays_o, rays_d,
    occ_bits)`` returns (colors [R, 3], depths [R])."""
    dev = resolve_device(device)
    cfg = Config()
    gen = torch.Generator(device=dev).manual_seed(cfg.train.seed)
    params = renderer.init(gen, cfg.model, 8, dev)
    consts = {"field": hash_field.init_consts(gen, cfg.model, dev)}
    occ_bits = occupancy.occupancy_bits(occupancy.init_grid(cfg.model, dev),
                                        cfg.model)
    n_rays = cfg.train.rays_per_step
    ray_gen = torch.Generator(device=dev).manual_seed(0)
    rays_o = torch.randn((n_rays, 3), generator=ray_gen, device=dev) * 0.1
    rays_d = (torch.randn((n_rays, 3), generator=ray_gen, device=dev)
              + torch.tensor([0.0, 0.0, -1.0], device=dev))

    def fn(params, consts, rays_o, rays_d, occ_bits):
        with torch.no_grad():
            res = renderer.render(params, rays_o, rays_d, cfg.model,
                                  occ_vals=occ_bits, consts=consts)
        return res.colors, res.depths

    return fn, (params, consts, rays_o, rays_d, occ_bits)


def arm_config(tag: str, n_devices: int) -> tuple[Config, int, int]:
    """(config, global batch, step) of a training arm of the dry run:
    ``dense`` and ``occ`` at ``Config.tiny()`` (the occupancy arm on a
    16^3 grid, 4 segments of 2 samples kept), 8 rays a rank, step 0;
    ``flagship`` at ``Config()`` with f32 features, 64 rays a rank, on
    the first refresh step past both occupancy warm-ups, so that the
    partial refresh runs."""
    if tag == "flagship":
        cfg = Config()
        batch = 64 * n_devices
        model = dataclasses.replace(cfg.model, bf16_features=False)
        step = ((max(model.occ_warmup_steps, model.occ_refresh_warmup)
                 // model.occ_update_every + 1) * model.occ_update_every)
    else:
        cfg = Config.tiny()
        batch = 8 * n_devices
        model = dataclasses.replace(
            cfg.model, sampler_mode=tag,
            **({"occ_grid_res": 16, "occ_segments": 16, "occ_keep": 4,
                "occ_samples_per_segment": 2} if tag == "occ" else {}))
        step = 0
    return dataclasses.replace(
        cfg, model=model, train=dataclasses.replace(
            cfg.train, pts_batch_size=batch * 512)), batch, step


def _dryrun_one(mesh: DataMesh, cfg: Config, batch: int, tag: str,
                step: int = 0, params: dict | None = None, noise=None
                ) -> float:
    """One training step over ``mesh`` from fresh state (4 cameras of 32
    x 32 at f = 32, the global batch from ``default_rng(0)``, this rank's
    rows); returns the global loss, which must be finite. ``params`` and
    ``noise`` (the global batch's draws) default to seeded ones."""
    dev = mesh.device
    n_images = 4
    gen = torch.Generator(device=dev).manual_seed(0)
    if params is None:
        params = renderer.init(gen, cfg.model, n_images, dev)
    consts = {"field": hash_field.init_consts(gen, cfg.model, dev)}
    optimizer = make_optimizer(params, cfg.train)
    grid = occupancy.init_grid(cfg.model, dev)
    replicate(mesh, [params, consts, optimizer.adam.state, grid])

    poses = torch.eye(3, 4, device=dev).repeat(n_images, 1, 1)
    intr = torch.tensor([[32.0, 0, 16.0], [0, 32.0, 16.0], [0, 0, 1.0]],
                        device=dev).repeat(n_images, 1, 1)
    rng = np.random.default_rng(0)
    cam = rng.integers(0, n_images, batch).astype(np.int32)
    ij = rng.integers(0, 32, (batch, 2)).astype(np.int32)
    gt = rng.random((batch, 3)).astype(np.float32)
    local = [torch.as_tensor(x, device=dev)
             for x in shard_batch(mesh, cam, ij, gt)]

    step_fn = make_train_step(cfg, optimizer, mesh=mesh)
    grid, metrics = step_fn(params, grid, poses, intr, step, *local,
                            noise=noise, consts=consts)
    loss = float(metrics.loss)
    if not np.isfinite(loss):
        raise RuntimeError(f"dryrun {tag}: non-finite loss {loss}")
    if mesh.rank == 0:
        print(f"dryrun_multichip({mesh.size}, {tag}): OK, loss={loss:.4f}",
              flush=True)
    return loss


def _dryrun_localize(mesh: DataMesh, params: dict | None = None
                     ) -> np.ndarray:
    """The localizer over ``mesh`` (its renders sharded): the weights of
    two particles, which must sum to 1 within 1e-3, and one differential
    step, which must stay finite; returns the weights."""
    from f2nerf_tpu_torch.localize.localizer import Localizer, LocalizerParam

    cfg = Config.tiny()
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, n_samples=16))
    dev = mesh.device
    gen = torch.Generator(device=dev).manual_seed(0)
    if params is None:
        params = renderer.init(gen, cfg.model, 2, dev)
    consts = {"field": hash_field.init_consts(gen, cfg.model, dev)}
    h = w = 24
    intr = np.array([[24.0, 0, 12.0], [0, 24.0, 12.0], [0, 0, 1.0]],
                    dtype=np.float32)
    loc = Localizer(params, cfg, intr, np.zeros(3), 1.0, h, w,
                    param=LocalizerParam(render_pixel_num=64), seed=0,
                    consts=consts, mesh=mesh)
    pose = np.eye(3, 4, dtype=np.float32)
    off = pose.copy()
    off[:3, 3] += 0.1
    img = np.full((h, w, 3), 0.5, dtype=np.float32)
    weights = loc.evaluate_poses(np.stack([pose, off]), img)
    if not (np.isfinite(weights).all() and abs(weights.sum() - 1.0) < 1e-3):
        raise RuntimeError(f"dryrun localize: weights {weights}")
    out = loc.optimize_pose_by_differential(pose, img, iteration_num=1,
                                            lr=1e-3)
    if not np.isfinite(out[-1]).all():
        raise RuntimeError(f"dryrun localize: pose {out[-1]}")
    if mesh.rank == 0:
        print(f"dryrun_multichip({mesh.size}, localize): OK, "
              f"weights={np.round(weights, 3).tolist()}", flush=True)
    return weights


def dryrun_multichip(n_devices: int, device: str | torch.device | None = None,
                     backend: str | None = None, arms: tuple = ARMS) -> dict:
    """The full training step over an ``n_devices`` data mesh, one step in
    each training arm (:func:`arm_config`), then the localizer arm: the
    ray batch sharded over the ranks, params and constants replicated,
    the gradient all-reduced. Joins torchrun's process group when its
    environment is set (``maybe_initialize_distributed``; the caller
    destroys it); without one, ``n_devices`` must be 1. Raises unless the
    world size is ``n_devices``. Returns each arm's loss (the localizer's
    weights)."""
    dev = maybe_initialize_distributed(backend=backend, device=device)
    mesh = make_mesh(device=dev if dev is not None else device)
    if mesh.size != n_devices:
        raise RuntimeError(f"need {n_devices} ranks, have {mesh.size}")
    out = {}
    for tag in arms:
        if tag == "localize":
            out[tag] = _dryrun_localize(mesh)
        else:
            cfg, batch, step = arm_config(tag, n_devices)
            out[tag] = _dryrun_one(mesh, cfg, batch, tag, step=step)
    return out


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("command", nargs="?", choices=("dryrun",))
    ap.add_argument("n", nargs="?", type=int, default=8,
                    help="ranks of the dry run")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="the dry run's process-group backend (default: "
                         "NCCL on the card, gloo on the CPU)")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    if args.command is None:
        fn, fn_args = entry(args.device)
        out = fn(*fn_args)
        if out[0].is_cuda:
            torch.cuda.synchronize()
        print("entry: OK", [list(o.shape) for o in out], flush=True)
        return
    device = args.device
    if device is None and args.backend == "gloo":
        device = "cuda:0"
    if "WORLD_SIZE" in os.environ:
        try:
            dryrun_multichip(args.n, device=device, backend=args.backend)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        return
    flags = [] if device is None else ["--device", str(device)]
    if args.backend:
        flags += ["--backend", args.backend]
    launch_ranks("f2nerf_tpu_torch.graft_entry", args.n,
                 lambda r, port: ["dryrun", str(args.n), *flags])


if __name__ == "__main__":
    main()
