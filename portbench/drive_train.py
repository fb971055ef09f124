"""Traffic of kind ``train``: the map trainer's job, the step function of
``train/step.make_train_step`` called once per batch.

Set-up makes the map's weights, constants and cameras by the
configuration's field (``portbench/fields/<name>.py``) and, for the
occupancy sampler, its grid, from the seed, then one optimizer and one
step function for them, the optimizer's schedule standing at the first
step as a resumed trainer's does. It then drives that step through its first
``checked_steps`` steps on batches drawn from the seed, through the same
call and host-to-device feed as the window, keeping the loss of each,
the first gradient as Adam's state holds it after one step, the grid
after the first step and the params after the last. These steps also
warm up every shape the window uses: the first step is an occupancy
refresh step where the sampler has one.

The window goes on with the same objects: a fresh batch drawn on the
host each step and handed to the step, until ``--seconds`` have passed,
then one device synchronize. ``train_rays_per_s`` is every ray of the
window over its whole wall time. After the window the plain reference
follows the first steps from the same weights and batches
(``checks.train_numbers``).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from portbench import checks, common, inputs
from portbench import work as W
from portbench.reference import field as F
from portbench.reference import train as RT


def run(cell, seed: int, seconds: float, trace: bool, dev: torch.device,
        hooks=None, t_start: float = 0.0, controls: tuple = ()
        ) -> common.Outcome:
    from f2nerf_tpu_torch.core.config import Config
    from f2nerf_tpu_torch.train.optim import make_optimizer
    from f2nerf_tpu_torch.train.step import make_train_step

    clock = common.SetupClock(t_start)
    clock.mark("imports")
    mix = cell.mix
    cfg = Config.from_dict(cell.config["config"])
    model = F.model_ns(cell.config["config"]["model"])
    train = cell.config["config"]["train"]
    n_img, hw = int(mix["images"]), int(mix["image_hw"])
    rays = cfg.train.rays_per_step
    s = inputs.sub_seeds(seed, ("weights", "grid", "batches"))
    occ = model.sampler_mode == "occ"
    scene = cell.field.train_scene(model, mix, s["weights"], dev)
    field = cell.field.features(model, scene)
    params, poses, intr = scene.params, scene.poses, scene.intr
    grid = inputs.seeded_grid(model, s["grid"], dev) if occ else None
    p0 = {k: v.detach().cpu().clone() for k, v in RT.flatten(params).items()}
    grid0 = None if grid is None else grid.cpu().clone()
    rng = np.random.default_rng(s["batches"])
    step0 = inputs.first_step(model)
    clock.mark("weights, grid and cameras")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    optimizer = make_optimizer(params, cfg.train)
    optimizer.set_count(step0)
    step_fn = make_train_step(cfg, optimizer)
    if hooks is not None:
        step_fn = hooks.program(step_fn, optimizer)
    consts = {"field": scene.consts}

    def feed(batch):
        return tuple(torch.as_tensor(x, device=dev) for x in batch)

    checked = [inputs.batch_data(rng, rays, n_img, hw)
               for _ in range(int(mix["checked_steps"]))]
    got = {"loss": [], "grid": None}
    for j, batch in enumerate(checked):
        grid, m = step_fn(params, grid, poses, intr, step0 + j, *feed(batch),
                          consts=consts)
        got["loss"].append(m.loss)
        if j == 0:
            # an optimizer that took no step holds no moment: no gradient
            got["grad"] = {k: optimizer.adam.state[p].get(
                "exp_avg", torch.zeros_like(p)).detach().cpu()
                / (1.0 - RT.BETAS[0]) for k, p in optimizer.named.items()}
            got["grid"] = None if grid is None else grid.detach().cpu()
    got["params"] = {k: p.detach().cpu().clone()
                     for k, p in optimizer.named.items()}
    got["loss"] = [float(x) for x in got["loss"]]
    common.sync(dev)
    setup_s = clock.mark("set-up: the checked steps")

    step = step0 + len(checked)
    losses = []
    n_trace = int(mix["trace_steps"]) if trace else 0
    traced_steps = []

    def one_step():
        nonlocal grid, step
        with common.span("portbench.step", n_trace > 0):
            grid, m = step_fn(params, grid, poses, intr, step,
                              *feed(inputs.batch_data(rng, rays, n_img, hw)),
                              consts=consts)
        losses.append(m.loss)
        step += 1

    with common.profiled(n_trace > 0, dev) as traced:
        for _ in range(n_trace):
            traced_steps.append(step)
            one_step()
    t_w0 = time.perf_counter()
    done0 = len(losses)
    with common.CollectorClock():
        while True:
            one_step()
            if time.perf_counter() - t_w0 >= seconds:
                break
        common.sync(dev)
    wall = time.perf_counter() - t_w0
    n_window = len(losses) - done0
    e2e = {"train_rays_per_s": n_window * rays / wall, "setup_s": setup_s}
    print(f"window: {n_window} steps in {wall:.3f} s", file=sys.stderr)
    peak = common.memory_peak(dev)
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    attempted = len(checked) + len(losses)
    del step_fn, optimizer, params, grid, losses
    common.free(dev)

    F.strict_fp32()
    stated = F.table_dtype(model)

    def reference(dtype):
        return RT.steps(p0, grid0, model, train, checked, poses, intr, step0,
                        step0, dtype, field)

    ref = reference(stated)
    numbers = checks.train_numbers(got, ref, p0)
    control_numbers = {}
    for name in controls:
        with common.control_precision(name, stated) as dtype:
            ctl = reference(dtype)
        ctl["grid"] = ctl["grid"][0] if ctl["grid"] else None
        control_numbers[name] = checks.train_numbers(ctl, ref, p0)
    refresh = sum(RT.refresh_phase(model, k) is not None
                  for k in traced_steps)
    work = {"unit": "step", "units": n_trace, "rays": rays,
            "unit_wall_s": wall / n_window,
            "refresh_steps": refresh,
            "refresh_points": (model.occ_grid_res ** 3
                               // model.occ_refresh_phases) if occ else 0,
            "param_count": sum(v.numel() for v in p0.values()),
            **W.shapes(model)}
    return common.Outcome(end_to_end=e2e, attempted=attempted, failed=failed,
                          setup_s=setup_s, memory_peak_bytes=peak,
                          numbers=numbers, trace=traced.trace, work=work,
                          controls=control_numbers)
