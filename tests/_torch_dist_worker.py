"""One rank of ``tests/test_torch_parallel.py``'s gloo process group on
the CPU. Imports only torch, numpy and the port.

    WORLD_SIZE=k RANK=r LOCAL_RANK=r MASTER_ADDR=localhost MASTER_PORT=p \
        python tests/_torch_dist_worker.py <in_dir> <out_dir> <scenario,...>

``in_dir`` holds ``inputs.npz`` (arrays, made by the test from a seed and
the JAX package), ``configs.json`` (the configs as dicts) and ``data/``
(the trainer's dataset directory). Each
scenario adds its results to this rank's ``<out_dir>/k{k}_rank{r}.npz``.
Every scenario runs on every rank: each is a collective program.
"""

from __future__ import annotations

import json
import pathlib
import sys

import numpy as np
import torch
import torch.distributed as dist

from f2nerf_tpu_torch.convert import flatten, tree_from_numpy, unflatten
from f2nerf_tpu_torch.core.config import Config
from f2nerf_tpu_torch.data.dataset import load_dataset
from f2nerf_tpu_torch.localize.localizer import Localizer, LocalizerParam
from f2nerf_tpu_torch.models import hash_field, occupancy, renderer
from f2nerf_tpu_torch.parallel import mesh as mesh_lib
from f2nerf_tpu_torch.train.loop import Trainer
from f2nerf_tpu_torch.train.optim import make_optimizer
from f2nerf_tpu_torch.train.step import StepNoise, make_train_step

# the localizer scenario's frame: 9 x 13 = 117 pixels, odd, so the
# differential step pads its grid at k = 2
LOC_H, LOC_W = 9, 13
LOC_INTR = np.array([[12.0, 0, 6.5], [0, 12.0, 4.5], [0, 0, 1]], np.float32)


def _group(inp: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in inp.items()
            if k.startswith(prefix)}


def _noise(inp: dict, key: str, step: int) -> StepNoise:
    fields = _group(inp, f"noise/{key}/{step}/")
    return StepNoise(**{name: (torch.from_numpy(fields[name])
                               if name in fields else None)
                        for name in StepNoise._fields})


def run_steps(mesh, cfg: Config, inp: dict, key: str) -> dict:
    """``n_steps`` train steps of config ``key`` from its params, grid and
    global batch, each with the injected global draws; per step the
    lr, the metrics, the global grads, the params and the Adam moments."""
    params = tree_from_numpy(unflatten(_group(inp, f"params/{key}/")), "cpu")
    opt = make_optimizer(params, cfg.train)
    step_fn = make_train_step(cfg, opt, mesh=mesh)
    grid = (torch.from_numpy(inp[f"grid/{key}"]).clone()
            if cfg.model.sampler_mode == "occ" else None)
    poses = torch.from_numpy(inp[f"poses/{key}"])
    intr = torch.from_numpy(inp[f"intr/{key}"])
    step0 = int(inp[f"step0/{key}"])
    out = {}
    buckets = []
    query_compacted = hash_field.query_compacted

    def spy(params, points, *a, **kw):
        # the dense two-pass's bucket: this rank's own survivor count
        buckets.append(points.shape[0])
        return query_compacted(params, points, *a, **kw)

    hash_field.query_compacted = spy
    for k in range(int(inp[f"n_steps/{key}"])):
        cam, ij, gt = mesh_lib.shard_batch(mesh, *(
            torch.from_numpy(inp[f"batch/{key}/{k}/{x}"])
            for x in ("cam", "ij", "gt")))
        # the lr this step's update takes
        out[f"{k}/lr"] = np.float64(opt.adam.param_groups[0]["lr"])
        grid, m = step_fn(params, grid, poses, intr, step0 + k, cam, ij, gt,
                          noise=_noise(inp, key, step0 + k))
        out[f"{k}/metrics"] = torch.stack(tuple(m)).numpy()
        for name, p in opt.named.items():
            out[f"{k}/grads/{name}"] = p.grad.numpy().copy()
            out[f"{k}/params/{name}"] = p.detach().numpy().copy()
            st = opt.adam.state[p]
            out[f"{k}/mu/{name}"] = st["exp_avg"].numpy().copy()
            out[f"{k}/nu/{name}"] = st["exp_avg_sq"].numpy().copy()
        if grid is not None:
            out[f"{k}/grid"] = grid.numpy().copy()
    hash_field.query_compacted = query_compacted
    out["buckets"] = np.array(buckets, np.int64)
    return out


def scenario_steps(mesh, configs, inp, in_dir, out_dir) -> dict:
    out = {}
    for key in configs[f"steps_k{mesh.size}"]:
        cfg = Config.from_dict(configs[key])
        res = run_steps(mesh, cfg, inp, key)
        out.update({f"steps/{key}/{k}": v for k, v in res.items()})
        if key == "tiny":
            # a second run of the same program: bitwise the first
            again = run_steps(mesh, cfg, inp, key)
            out.update({f"again/{key}/{k}": v for k, v in again.items()})
    return out


def scenario_render(mesh, configs, inp, in_dir, out_dir) -> dict:
    """render_image at 24x24 (chunk 100) and 25x23 (chunk 99: rounded up
    to a multiple of k, the last chunk padded)."""
    cfg = Config.from_dict(configs["tiny"])
    params = tree_from_numpy(unflatten(_group(inp, "params/render/")), "cpu")
    pose = torch.from_numpy(inp["render/pose"])
    intr = torch.from_numpy(inp["render/intr"])
    out = {}
    for name, h, w, chunk in (("24x24", 24, 24, 100), ("25x23", 25, 23, 99)):
        rgb, depth = renderer.render_image(params, pose, intr, h, w,
                                           cfg.model, chunk=chunk, mesh=mesh)
        out[f"render/{name}/rgb"] = rgb.numpy()
        out[f"render/{name}/depth"] = depth.numpy()
    return out


def scenario_localize(mesh, configs, inp, in_dir, out_dir) -> dict:
    """Mode 0's particle weights, the pose gradient and one mode-1 step
    of a localizer on the occupancy config."""
    cfg = Config.from_dict(configs["loc"])
    params = tree_from_numpy(unflatten(_group(inp, "params/loc/")), "cpu")
    occ_vals = occupancy.occ_values(torch.from_numpy(inp["grid/loc"]),
                                    cfg.model)
    loc = Localizer(params, cfg, LOC_INTR, np.zeros(3), 1.0, LOC_H, LOC_W,
                    param=LocalizerParam(render_pixel_num=64),
                    occ_vals=occ_vals, seed=5, mesh=mesh)
    image, pose0 = inp["loc/image"], inp["loc/pose0"]
    parts = loc.optimize_pose_by_random_search(pose0, image, particle_num=8,
                                               noise_coeff=1.0)
    loss, grad = loc.pose_gradient(pose0, image)
    step = loc.optimize_pose_by_differential(pose0, image, 1, lr=1e-3)[0]
    return {"loc/weights": np.array([p.weight for p in parts]),
            "loc/poses": np.stack([p.pose for p in parts]),
            "loc/loss": np.float64(loss), "loc/grad": grad,
            "loc/step_pose": step,
            "loc/render": loc.render_image(pose0).numpy()}


def scenario_trainer(mesh, configs, inp, in_dir, out_dir) -> dict:
    """A ``Trainer`` of 4 steps into one run directory (k = the mesh's
    size), then a checkpoint; what each rank holds and whether it opened
    the log. Then a ``Trainer`` of 4 default-mode steps with explore
    sparsity on (no run directory): its params and last loss."""
    ds = load_dataset(in_dir / "data")
    out = _trainer_run(mesh, Config.from_dict(configs["trainer"]), ds,
                       out_dir)
    tr = Trainer(Config.from_dict(configs["trainer_default"]), ds,
                 device="cpu", mesh=mesh)
    # a grid that cuts rays, so explore rays sample ineligible segments
    tr.occ_grid = torch.from_numpy(inp["grid/ratio"]).clone()
    explore = []
    render = renderer.render

    def spy(*a, **kw):
        # this rank's share of the explore term's denominator
        res = render(*a, **kw)
        explore.append(float(res.explore.float().sum()))
        return res

    renderer.render = spy
    try:
        last = tr.run()
    finally:
        renderer.render = render
        tr.close()
    out.update({f"trainer_default/params/{k}": v.detach().numpy().copy()
                for k, v in flatten(tr.params).items()})
    out["trainer_default/loss"] = np.float64(last["loss"])
    out["trainer_default/step"] = np.int64(tr.step)
    out["trainer_default/explore"] = np.array(explore)
    return out


def _trainer_run(mesh, cfg: Config, ds, out_dir) -> dict:
    """The run-directory trainer of :func:`scenario_trainer`."""
    run = out_dir / f"trainer_k{mesh.size}"
    tr = Trainer(cfg, ds, result_dir=run, device="cpu", mesh=mesh)
    try:
        tr.run()
        tr.save_checkpoint()
        out = {f"trainer/params/{k}": v.detach().numpy().copy()
               for k, v in flatten(tr.params).items()}
        out["trainer/log_open"] = np.bool_(tr._log_file is not None)
        out["trainer/step"] = np.int64(tr.step)
        # a second trainer resumes from the run: every rank reads it
        tr2 = Trainer(cfg, ds, result_dir=run, device="cpu", mesh=mesh)
        out["trainer/resumed"] = np.bool_(tr2.try_resume())
        out["trainer/resumed_equal"] = np.bool_(all(
            torch.equal(a, b) for a, b in zip(
                tr.optimizer.named.values(), tr2.optimizer.named.values())))
        tr2.close()
    finally:
        tr.close()
    return out


def scenario_helpers(mesh, configs, inp, in_dir, out_dir) -> dict:
    """The mesh helpers across ranks."""
    r, k = mesh.rank, mesh.size
    rows = torch.arange(8 * k, dtype=torch.float32).reshape(4 * k, 2)
    mine, = mesh_lib.shard_batch(mesh, rows)
    tree = {"a": torch.full((3,), float(r)),
            "b": [torch.full((2, 2), 10.0 + r)],
            "step": torch.tensor(float(r))}
    mesh_lib.replicate(mesh, tree)
    gathered = mesh_lib.all_gather_rows(mesh, mine)
    total = mesh_lib.all_reduce_sum(mesh, torch.tensor([float(r + 1)]))
    try:
        mesh_lib.shard_batch(mesh, torch.zeros(4 * k + 1))
        raised = False
    except ValueError:
        raised = True
    return {"helpers/mine": mine.numpy(), "helpers/gathered": gathered.numpy(),
            "helpers/a": tree["a"].numpy(), "helpers/b": tree["b"][0].numpy(),
            "helpers/step": tree["step"].numpy(),
            "helpers/total": total.numpy(),
            "helpers/any_rank1": np.bool_(mesh_lib.any_rank(mesh, r == 1)),
            "helpers/any_none": np.bool_(mesh_lib.any_rank(mesh, False)),
            "helpers/raised": np.bool_(raised)}


SCENARIOS = {"steps": scenario_steps, "render": scenario_render,
             "localize": scenario_localize, "trainer": scenario_trainer,
             "helpers": scenario_helpers}


def main() -> int:
    in_dir, out_dir = pathlib.Path(sys.argv[1]), pathlib.Path(sys.argv[2])
    scenarios = sys.argv[3].split(",")
    # one thread a rank: the CPU sums then split alike at every k
    torch.set_num_threads(1)
    dev = mesh_lib.maybe_initialize_distributed(device="cpu")
    if dev is None:
        raise RuntimeError("WORLD_SIZE is not set")
    mesh = mesh_lib.make_mesh(device=dev)
    configs = json.loads((in_dir / "configs.json").read_text())
    with np.load(in_dir / "inputs.npz") as data:
        inp = {k: data[k] for k in data.files}
    out = {}
    try:
        for name in scenarios:
            out.update(SCENARIOS[name](mesh, configs, inp, in_dir, out_dir))
    finally:
        dist.destroy_process_group()
    np.savez(out_dir / f"k{mesh.size}_rank{mesh.rank}.npz", **out)
    print(json.dumps({"rank": mesh.rank, "size": mesh.size,
                      "keys": len(out)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
