"""Port parity across devices: ``f2nerf_tpu_torch.parallel`` and the
sharded train step, ``grad_blocks``, sharded renders, the localizer's
mesh, the trainer and the ``torchrun`` CLI, against the port on one
device and the JAX package's mesh (``tests/test_parallel.py``'s
``_run_step``: 8 virtual CPU devices, params and batch from its
``_setup``).

The port's ranks are gloo processes on the CPU
(``tests/_torch_dist_worker.py``, which imports only torch and the
port), spawned once per world size k in {1, 2, 4} by one module-scoped
fixture; every rank runs every scenario of its world and writes npz.
Each step gets the JAX step's own draws (``test_torch_train.jax_noise``,
per block in ``grad_blocks`` mode), the global batch's, which every rank
slices.

Tolerances:
* default mode, k = 2 against k = 1 and against JAX's 2-device mesh:
  JAX's own (``test_parallel``): loss rtol 1e-5; params after the first
  update (lr 0) atol 2e-6, rtol 1e-4. The grads (sums over the batch in
  another grouping) and the params after updates with lr > 0 at
  ``test_torch_train``'s step tolerances: grads atol 1e-3 x the leaf's
  largest |grad| (1e-2 from the third step), params atol 0.05 lr.
* the dense two-pass (the port; JAX runs its single pass), each rank in
  the bucket of its own survivors: the same, but params as
  ``test_torch_two_pass`` holds them (every entry within 2.05 lr, at
  most 0.1% beyond 0.05 lr: its boosted density makes near-zero grads).
* ``grad_blocks`` = 8: params and Adam state ``torch.equal`` at k = 1,
  2, 4 after every step; k = 1 against JAX at the step tolerances.
* renders: color atol 1e-6, depth 1e-5 (``test_parallel``).
* the default-mode ``Trainer``, k = 2 against k = 1 after 4 steps: the
  last loss rtol 1e-5, params atol 0.05 x the run's largest lr.
* the localizer, k = 2 against k = 1: particles bitwise (one host
  Generator), weights atol 1e-6, the pose gradient atol 1e-5 x its
  largest entry and the loss rtol 1e-6, the pose after one Adam step
  atol 1e-7 (the step is lr x the normalized gradient, lr 1e-3).
"""

import dataclasses
import json
import os
import pathlib
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import _torch_dist_worker as worker
import test_parallel as tp
import test_torch_train as tt
from f2nerf_tpu.models import occupancy as jocc
from f2nerf_tpu.models import renderer as jrend
from f2nerf_tpu.train.optim import make_optimizer as jmake_optimizer
from f2nerf_tpu.train.step import make_train_step as jmake_train_step
from f2nerf_tpu_torch.convert import flatten, tree_from_numpy
from f2nerf_tpu_torch.core.config import Config as TConfig
from f2nerf_tpu_torch.data.dataset import load_dataset, save_dataset
from f2nerf_tpu_torch.data.synthetic import make_sphere_dataset
from f2nerf_tpu_torch.localize.localizer import Localizer
from f2nerf_tpu_torch.models import occupancy as tocc
from f2nerf_tpu_torch.models import renderer as trend
from f2nerf_tpu_torch.parallel import mesh as mesh_lib
from f2nerf_tpu_torch.train import checkpoint as ckpt_lib
from f2nerf_tpu_torch.train import optim as topt
from f2nerf_tpu_torch.train import step as tstep

REPO = pathlib.Path(__file__).resolve().parent.parent
WORKER = REPO / "tests" / "_torch_dist_worker.py"
RAYS = 64
STEPS = {"tiny": (0, 3), "blocks": (0, 3), "occ": (600, 2), "ratio": (600, 2),
         "two_pass": (14, 2), "occ_jax": (600, 2), "ratio_jax": (600, 2)}
# the scenes each world size steps through
STEPS_K = {1: ["tiny", "blocks", "occ", "ratio", "two_pass"],
           2: list(STEPS), 4: ["blocks"]}
SCENARIOS = {1: "helpers,steps,render,localize,trainer",
             2: "helpers,steps,render,localize,trainer",
             4: "helpers,steps,render"}
WORKER_TIMEOUT_S = 240
# The occupancy scenes' seeds. The port against itself (k = 2 vs k = 1)
# takes seed 1. The port against JAX takes seed 2 (the "_jax" scenes):
# with seed 1 at 64 rays the refreshed grid differs from JAX's jitted
# step by 1 ulp in a few cells, which moves one kept segment of one ray,
# 1.7e-2 of shader/b0's largest grad, at k = 1 as at k = 2 and on one
# JAX device as on two, so not the mesh's doing (ROADMAP.md section C,
# fact 7).
OCC_SEED, OCC_SEED_JAX = 1, 2
# the JAX-side scene of each key the JAX test names
JAX_KEY = {"tiny": "tiny", "occ": "occ_jax", "ratio": "ratio_jax",
           "two_pass": "two_pass"}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _configs(tiny_cfg, occ_cfg) -> dict:
    """The JAX configs of the scenarios."""
    ratio = dataclasses.replace(
        occ_cfg,
        model=dataclasses.replace(occ_cfg.model, occ_explore_eps=0.3),
        train=dataclasses.replace(
            occ_cfg.train, explore_sparsity_weight=1e-2, occ_reg_weight=1e-2,
            occ_reg_t=1.0, global_sparsity_weight=1e-2,
            global_sparsity_points=256))
    trainer = dataclasses.replace(tiny_cfg, train=dataclasses.replace(
        tiny_cfg.train, pts_batch_size=RAYS * 512, grad_blocks=4, end_iter=4,
        report_freq=2, vis_freq=4, save_freq=4))
    # the default mode that `torchrun ... train` gives, with the ratio
    # terms on whose denominators loss_fn all-reduces (explore sparsity
    # as Config.quality turns it on, occ_reg), through Trainer(mesh=)
    trainer_default = dataclasses.replace(
        ratio, train=dataclasses.replace(
            ratio.train, pts_batch_size=RAYS * 512, grad_blocks=0,
            end_iter=4, report_freq=2),
        model=dataclasses.replace(ratio.model, occ_warmup_steps=0))
    # the port runs the dense two-pass on it, JAX the single pass (the
    # same function; JAX's jitted two-pass compiles every bucket's grads)
    two_pass = dataclasses.replace(tiny_cfg, model=dataclasses.replace(
        tiny_cfg.model, density_shift=-2.0))
    return {"tiny": tiny_cfg, "occ": occ_cfg, "ratio": ratio,
            "occ_jax": occ_cfg, "ratio_jax": ratio,
            "trainer_default": trainer_default,
            "blocks": dataclasses.replace(tiny_cfg, train=dataclasses.replace(
                tiny_cfg.train, grad_blocks=8)),
            "two_pass": two_pass, "loc": occ_cfg, "trainer": trainer}


def _o1_inputs(jcfg, seed):
    """Params with O(1) features, poses around the origin and a grid
    whose mean channel cuts rays (explore slots have targets)."""
    params, _ = jrend.init(jax.random.key(seed), jcfg.model, 4)
    tree = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(seed)
    tree["field"]["feat_pool"] = rng.uniform(
        -1.0, 1.0, tree["field"]["feat_pool"].shape).astype(np.float32)
    tree["field"]["mlp"]["b"] = tree["field"]["mlp"]["b"].copy()
    tree["field"]["mlp"]["b"][0] = 2.0
    poses = np.tile(np.eye(3, 4, dtype=np.float32)[None], (4, 1, 1))
    poses[:, :, 3] = rng.uniform(-0.3, 0.3, (4, 3))
    intr = np.tile(np.array([[12.0, 0, 8], [0, 12.0, 8], [0, 0, 1]],
                            np.float32)[None], (4, 1, 1))
    batch = (rng.integers(0, 4, RAYS).astype(np.int32),
             rng.integers(0, 16, (RAYS, 2)).astype(np.int32),
             rng.random((RAYS, 3)).astype(np.float32))
    g = jcfg.model.occ_grid_res
    occ = (rng.random((g, g, g)) < 0.25).astype(np.float32)
    grid = np.stack([occ * 2 * jocc.sigma_threshold(jcfg.model), occ * 2e3])
    return tree, poses, intr, batch, grid


def _parallel_inputs(jcfg):
    """``test_parallel._setup``: JAX's own mesh-test params and batch."""
    (params, _, _, occ, _, poses, intr, cam, ij, gt) = tp._setup(jcfg, RAYS)
    return (jax.tree.map(np.asarray, params), np.asarray(poses),
            np.asarray(intr), (cam, ij, gt), np.asarray(occ))


def _jax_run(jcfg, inputs, n_devices, step0, n_steps):
    """JAX's step jitted on an ``n_devices`` mesh as ``_run_step`` builds
    it (a 1-device run unsharded), from ``inputs``, grads recorded."""
    tree, poses, intr, (cam, ij, gt), grid = inputs
    _, consts = jrend.init(jax.random.key(0), jcfg.model, 4)
    jopt = optax.chain(tt._record(), jmake_optimizer(jcfg.train))
    params = jax.tree.map(jnp.asarray, tree)
    state = jopt.init(params)
    args = [jnp.asarray(grid), consts, jnp.asarray(poses), jnp.asarray(intr)]
    batch = [jnp.asarray(x) for x in (cam, ij, gt)]
    mesh = None
    if n_devices > 1:
        mesh = Mesh(np.array(jax.devices()[:n_devices]), ("data",))
        repl, shard = NamedSharding(mesh, P()), NamedSharding(mesh, P("data"))
        params, state = jax.device_put((params, state), repl)
        args = [jax.device_put(a, repl) for a in args]
        batch = [jax.device_put(b, shard) for b in batch]
    step_fn = jax.jit(jmake_train_step(jcfg, jopt, mesh=mesh))
    out = []
    for k in range(n_steps):
        params, state, args[0], m = step_fn(
            params, state, *args, jnp.asarray(step0 + k, jnp.int32), *batch)
        out.append({"metrics": np.array([float(x) for x in m]),
                    "grads": flatten(jax.tree.map(np.asarray, state[0])),
                    "params": flatten(jax.tree.map(np.asarray, params))})
    return out


def _write_inputs(path: pathlib.Path, cfgs: dict) -> dict:
    """inputs.npz and configs.json for the workers; returns what the
    tests need on this side (inputs per config, the JAX-free pieces)."""
    arrays, side = {}, {}
    for key, (step0, n_steps) in STEPS.items():
        jcfg = cfgs[key]
        seed = {"two_pass": 4, "occ_jax": OCC_SEED_JAX,
                "ratio_jax": OCC_SEED_JAX}.get(key, OCC_SEED)
        inputs = (_parallel_inputs(jcfg) if key in ("tiny", "blocks")
                  else _o1_inputs(jcfg, seed=seed))
        side[key] = inputs
        tree, poses, intr, batch, grid = inputs
        arrays.update({f"params/{key}/{n}": v
                       for n, v in flatten(tree).items()})
        arrays.update({f"poses/{key}": poses, f"intr/{key}": intr,
                       f"grid/{key}": grid, f"step0/{key}": np.int64(step0),
                       f"n_steps/{key}": np.int64(n_steps)})
        for k in range(n_steps):
            for name, x in zip(("cam", "ij", "gt"), batch):
                arrays[f"batch/{key}/{k}/{name}"] = np.asarray(x)
            noise = tt.jax_noise(jcfg, step0 + k, RAYS)
            for name, x in noise._asdict().items():
                if x is not None:
                    arrays[f"noise/{key}/{step0 + k}/{name}"] = x.numpy()
    # render: test_parallel's sharded-render scene
    params, _ = jrend.init(jax.random.key(0), cfgs["tiny"].model, 4)
    side["render"] = jax.tree.map(np.asarray, params)
    arrays.update({f"params/render/{n}": v
                   for n, v in flatten(side["render"]).items()})
    arrays["render/pose"] = np.eye(3, 4, dtype=np.float32)
    arrays["render/intr"] = np.array(
        [[20.0, 0, 12.0], [0, 20.0, 12.0], [0, 0, 1.0]], np.float32)
    # the localizer: O(1) features on the occupancy config; the target
    # frame rendered by the port from a shifted pose
    tree, _, _, _, grid = _o1_inputs(cfgs["loc"], seed=3)
    tree["field"]["mlp"]["b"][0] = 6.0
    arrays.update({f"params/loc/{n}": v for n, v in flatten(tree).items()})
    arrays["grid/loc"] = grid
    pose0 = np.eye(3, 4, dtype=np.float32)
    pose0[:, 3] = [0.05, 0.0, 0.3]
    target = pose0.copy()
    target[:, 3] += [0.02, -0.01, 0.03]
    tcfg = TConfig.from_dict(dataclasses.asdict(cfgs["loc"]))
    loc = Localizer(tree_from_numpy(tree, "cpu"), tcfg, worker.LOC_INTR,
                    np.zeros(3), 1.0, worker.LOC_H, worker.LOC_W,
                    occ_vals=tocc.occ_values(torch.from_numpy(grid),
                                             tcfg.model), device="cpu")
    arrays["loc/image"] = loc.render_image(target).numpy()
    arrays["loc/pose0"] = pose0
    np.savez(path / "inputs.npz", **arrays)
    configs = {k: dataclasses.asdict(c) for k, c in cfgs.items()}
    configs["two_pass"]["model"]["dense_two_pass"] = True
    configs.update({f"steps_k{k}": keys for k, keys in STEPS_K.items()})
    (path / "configs.json").write_text(json.dumps(configs))
    return side


def _spawn(k: int, in_dir: pathlib.Path, out_dir: pathlib.Path):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO), WORLD_SIZE=str(k),
               MASTER_ADDR="localhost", MASTER_PORT=str(port))
    return [subprocess.Popen(
        [sys.executable, str(WORKER), str(in_dir), str(out_dir),
         SCENARIOS[k]],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(k)]


def _torchrun(run: pathlib.Path, data: pathlib.Path, k: int):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nnodes=1",
         f"--nproc_per_node={k}", "--master_addr=localhost",
         f"--master_port={_free_port()}", "-m", "f2nerf_tpu_torch.apps.main",
         "train", str(run), str(data), "--device", "cpu"],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def _wait(procs, what: str) -> None:
    try:
        for p in procs:
            out, err = p.communicate(timeout=WORKER_TIMEOUT_S)
            assert p.returncode == 0, f"{what} failed:\n{out}\n{err}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def world(tmp_path_factory, tiny_cfg, occ_cfg):
    """Every world size's ranks and the torchrun CLI run, spawned at once
    while the JAX references compile."""
    root = tmp_path_factory.mktemp("dist")
    cfgs = _configs(tiny_cfg, occ_cfg)
    side = _write_inputs(root, cfgs)
    # the trainer scenarios and the CLI read one dataset directory
    data = root / "data"
    save_dataset(make_sphere_dataset(n_images=4, h=16, w=16), data)
    run = root / "cli_run"
    run.mkdir()
    tcfg = TConfig.from_dict(dataclasses.asdict(cfgs["trainer"]))
    tcfg.save(run / "train_config.yaml")
    procs = {k: _spawn(k, root, root) for k in SCENARIOS}
    cli = _torchrun(run, data, 2)
    try:
        jref = {key: _jax_run(cfgs[key], side[key],
                              1 if key == "blocks" else 2, *STEPS[key])
                for key in ("blocks", *JAX_KEY.values())}
        jrender = {}
        jparams, jconsts = jrend.init(jax.random.key(0),
                                      cfgs["tiny"].model, 4)
        pose = jnp.eye(3, 4)
        intr = jnp.asarray([[20.0, 0, 12.0], [0, 20.0, 12.0],
                            [0, 0, 1.0]])
        for name, h, w, chunk in (("24x24", 24, 24, 100),
                                  ("25x23", 25, 23, 99)):
            rgb, depth = jrend.render_image(jparams, jconsts, pose, intr, h,
                                            w, cfgs["tiny"].model,
                                            chunk=chunk)
            jrender[name] = (np.asarray(rgb), np.asarray(depth))
    finally:
        for k, ps in procs.items():
            _wait(ps, f"world size {k}")
        _wait([cli], "torchrun train")
    out = {}
    for k in SCENARIOS:
        for r in range(k):
            with np.load(root / f"k{k}_rank{r}.npz") as z:
                out[k, r] = {n: z[n] for n in z.files}
    return {"out": out, "jax": jref, "jrender": jrender, "cfgs": cfgs,
            "side": side, "root": root, "cli_run": run, "data": data}


def _leaves(res: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in res.items()
            if k.startswith(prefix)}


# -- mesh helpers -----------------------------------------------------------

def test_mesh_helpers_single_process(monkeypatch):
    """Without torchrun's environment nothing is initialized and the mesh
    is one process; with it and no card of its own, the call raises."""
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert mesh_lib.maybe_initialize_distributed() is None
    mesh = mesh_lib.make_mesh(device="cpu")
    assert (mesh.group, mesh.rank, mesh.size) == (None, 0, 1)
    assert mesh_lib.DATA_AXIS == "data"
    rows = np.arange(6).reshape(3, 2)
    assert mesh_lib.shard_batch(mesh, rows)[0] is rows
    t = torch.ones(3)
    assert mesh_lib.all_gather_rows(mesh, t) is t
    assert mesh_lib.all_reduce_sum(mesh, t) is t
    assert mesh_lib.replicate(mesh, {"a": t})["a"] is t
    assert mesh_lib.any_rank(mesh, True) and mesh_lib.is_writer(mesh)
    four = mesh_lib.DataMesh(None, 3, 4, torch.device("cpu"))
    np.testing.assert_array_equal(
        mesh_lib.shard_batch(four, np.arange(8))[0], [6, 7])
    with pytest.raises(ValueError, match="divide"):
        mesh_lib.shard_batch(four, np.arange(6))
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="no card of its own"):
        mesh_lib.maybe_initialize_distributed()


@pytest.mark.parametrize("k", [2, 4])
def test_mesh_helpers_across_ranks(world, k):
    rows = np.arange(8 * k, dtype=np.float32).reshape(4 * k, 2)
    for r in range(k):
        res = world["out"][k, r]
        np.testing.assert_array_equal(res["helpers/mine"],
                                      rows[4 * r:4 * (r + 1)])
        np.testing.assert_array_equal(res["helpers/gathered"], rows)
        # rank 0's tensors, off-device ones (a CPU step counter) too
        np.testing.assert_array_equal(res["helpers/a"], np.zeros(3))
        np.testing.assert_array_equal(res["helpers/b"], np.full((2, 2), 10))
        assert float(res["helpers/step"]) == 0.0
        assert float(res["helpers/total"][0]) == k * (k + 1) / 2
        assert res["helpers/any_rank1"] and not res["helpers/any_none"]
        assert res["helpers/raised"]


# -- the train step ---------------------------------------------------------

def _check_step(port: dict, ref: dict, k: int, lr_max: float, first: bool,
                what: str) -> None:
    """One step of the port against a reference at the module's default
    mode tolerances (``two_pass``: params as ``test_torch_two_pass``
    holds them, whose boosted density makes near-zero grads)."""
    np.testing.assert_allclose(port[f"{k}/metrics"], ref["metrics"],
                               rtol=1e-5, err_msg=f"{what} step {k}")
    rel = 1e-3 if k < 2 else 1e-2
    for name, g in ref["grads"].items():
        scale = float(np.abs(g).max())
        np.testing.assert_allclose(port[f"{k}/grads/{name}"], g, rtol=0,
                                   atol=rel * scale,
                                   err_msg=f"{what} step {k} grad {name}")
    for name, p in ref["params"].items():
        if first:
            np.testing.assert_allclose(port[f"{k}/params/{name}"], p,
                                       atol=2e-6, rtol=1e-4,
                                       err_msg=f"{what} step {k} {name}")
        if what == "two_pass":
            dev = np.abs(port[f"{k}/params/{name}"] - p)
            assert dev.max() <= 2.05 * lr_max, (k, name, dev.max())
            assert np.mean(dev > 0.05 * lr_max) <= 1e-3, (k, name)
            continue
        np.testing.assert_allclose(port[f"{k}/params/{name}"], p, rtol=0,
                                   atol=0.05 * lr_max,
                                   err_msg=f"{what} step {k} {name}")


def _as_ref(res: dict, k: int) -> dict:
    return {"metrics": res[f"{k}/metrics"],
            "grads": _leaves(res, f"{k}/grads/"),
            "params": _leaves(res, f"{k}/params/")}


@pytest.mark.parametrize("key", ["tiny", "occ", "ratio", "two_pass"])
def test_default_step_k2_vs_k1(world, key):
    """The sharded default step at k = 2 against the port at k = 1."""
    two = _leaves(world["out"][2, 0], f"steps/{key}/")
    one = _leaves(world["out"][1, 0], f"steps/{key}/")
    n = STEPS[key][1]
    lr_max = max(float(one[f"{k}/lr"]) for k in range(n))
    for k in range(n):
        _check_step(two, _as_ref(one, k), k, lr_max, k == 0, key)
    if key in ("occ", "ratio"):   # the occupancy refresh ran and agrees
        np.testing.assert_allclose(two[f"{n - 1}/grid"], one[f"{n - 1}/grid"],
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("key", ["tiny", "occ", "ratio", "two_pass"])
def test_default_step_k2_vs_jax_mesh(world, key):
    """The sharded default step at k = 2 against JAX's 2-device mesh step
    (``ratio``: explore sparsity with ``occ_explore_eps`` > 0, ``occ_reg``
    and global sparsity on; ``two_pass``: the port's dense two-pass, each
    rank in the bucket of its own survivors, against JAX's single pass)."""
    jkey = JAX_KEY[key]
    two = _leaves(world["out"][2, 0], f"steps/{jkey}/")
    n = STEPS[jkey][1]
    lr_max = max(float(two[f"{k}/lr"]) for k in range(n))
    assert float(two["0/lr"]) == 0.0 and lr_max > 0.0
    for k, ref in enumerate(world["jax"][jkey]):
        _check_step(two, ref, k, lr_max, k == 0, key)


def test_two_pass_buckets_per_rank(world):
    """Under the mesh each rank picks its two-pass bucket from its own
    survivors: a compact one (n/8, n/4 or n/2 of its 32 x 32 samples)
    every step, on every rank and at k = 1 (of 64 x 32)."""
    for (k, r), res in world["out"].items():
        if k > 2:
            continue
        n = RAYS // k * world["cfgs"]["two_pass"].model.n_samples
        buckets = res["steps/two_pass/buckets"]
        assert len(buckets) == STEPS["two_pass"][1], (k, r)
        assert set(buckets.tolist()) <= {n // 8, n // 4, n // 2}, (k, r)


def test_default_step_ranks_agree_and_repeat(world):
    """Every rank holds the same params and moments after each step, and
    a second k = 2 run is bitwise the first."""
    for key in ("tiny", "occ", "ratio", "two_pass"):
        a = _leaves(world["out"][2, 0], f"steps/{key}/")
        b = _leaves(world["out"][2, 1], f"steps/{key}/")
        assert a.keys() == b.keys()
        for name in a:
            assert np.array_equal(a[name], b[name]), (key, name)
    a = _leaves(world["out"][2, 0], "steps/tiny/")
    again = _leaves(world["out"][2, 0], "again/tiny/")
    assert a.keys() == again.keys()
    for name in a:
        assert np.array_equal(a[name], again[name]), name


def test_grad_blocks_bitwise_across_k(world):
    """grad_blocks = 8: params and Adam state equal at k = 1, 2, 4 (every
    rank) after every step, and the updates moved the params."""
    ref = _leaves(world["out"][1, 0], "steps/blocks/")
    moved = [name for name in ref if name.startswith("2/params/")
             and not np.array_equal(ref[name], ref[name.replace("2/", "0/")])]
    assert moved
    for k in (2, 4):
        for r in range(k):
            res = _leaves(world["out"][k, r], "steps/blocks/")
            assert res.keys() == ref.keys()
            for name, v in ref.items():
                if "/grads/" in name:
                    continue
                assert torch.equal(torch.from_numpy(res[name]),
                                   torch.from_numpy(v)), (k, r, name)


def test_grad_blocks_k1_vs_jax(world):
    """grad_blocks = 8 at k = 1 against JAX's ``_block_grads`` (one
    device), each block with its ``fold_in(key, b)`` draws."""
    one = _leaves(world["out"][1, 0], "steps/blocks/")
    n = STEPS["blocks"][1]
    lr_max = max(float(one[f"{k}/lr"]) for k in range(n))
    for k, ref in enumerate(world["jax"]["blocks"]):
        _check_step(one, ref, k, lr_max, k == 0, "blocks")


def test_grad_blocks_draws(occ_cfg):
    """Block b's draws come from (seed, step, b) alone: a block of V
    blocks is the same draw whatever the batch; the refresh is the
    step's; the global-sparsity points are one set a block."""
    cfg = dataclasses.replace(occ_cfg, train=dataclasses.replace(
        occ_cfg.train, grad_blocks=4, global_sparsity_weight=1e-2,
        global_sparsity_points=16))
    tcfg = TConfig.from_dict(dataclasses.asdict(cfg))
    plain = TConfig.from_dict(dataclasses.asdict(dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, grad_blocks=0))))
    cpu = torch.device("cpu")
    a = tstep.draw_noise(tcfg, 601, 32, cpu)
    assert a.bg.shape == (32, 3) and a.gs_points.shape == (4, 16, 3)
    assert torch.equal(a.refresh, tstep.draw_noise(plain, 601, 32,
                                                   cpu).refresh)
    gen = tstep._generator(cpu, tcfg.train.seed, 601, 2)
    block2 = tstep._ray_draws(gen, tcfg, 8, cpu)
    assert torch.equal(a.bg[16:24], block2["bg"])
    assert torch.equal(a.within[16:24], block2["within"])
    assert torch.equal(a.gs_points[2], block2["gs_points"])
    mesh = mesh_lib.DataMesh(None, 1, 2, cpu)
    half = tstep.shard_noise(mesh, a)
    assert torch.equal(half.bg, a.bg[16:]) and half.refresh is a.refresh
    assert torch.equal(half.gs_points, a.gs_points[2:])
    with pytest.raises(ValueError, match="divide"):
        tstep.draw_noise(tcfg, 601, 30, cpu)


def test_make_train_step_checks_blocks(tiny_cfg):
    tcfg = TConfig.from_dict(dataclasses.asdict(dataclasses.replace(
        tiny_cfg, train=dataclasses.replace(tiny_cfg.train, grad_blocks=4))))
    p = {"w": torch.ones(2)}
    opt = topt.make_optimizer(p, tcfg.train)
    with pytest.raises(ValueError, match="mesh size 3"):
        tstep.make_train_step(tcfg, opt,
                              mesh=mesh_lib.DataMesh(None, 0, 3, "cpu"))
    step_fn = tstep.make_train_step(tcfg, opt)
    with pytest.raises(ValueError, match="rays/step=6"):
        step_fn(p, None, torch.zeros(1, 3, 4), torch.zeros(1, 3, 3), 0,
                torch.zeros(6), torch.zeros(6, 2), torch.zeros(6, 3))


# -- renders and the localizer ----------------------------------------------

@pytest.mark.parametrize("name", ["24x24", "25x23"])
def test_render_image_mesh(world, name):
    """render_image(mesh=) at k = 2 and 4, every rank, against one device
    (the port, and JAX); 25x23 at chunk 99 pads its last chunk."""
    h, w = (int(x) for x in name.split("x"))
    tcfg = TConfig.from_dict(dataclasses.asdict(world["cfgs"]["tiny"]))
    chunk = 100 if name == "24x24" else 99
    rgb, depth = trend.render_image(
        tree_from_numpy(world["side"]["render"], "cpu"),
        torch.eye(3, 4), torch.tensor([[20.0, 0, 12.0], [0, 20.0, 12.0],
                                       [0, 0, 1.0]]), h, w, tcfg.model,
        chunk=chunk)
    jrgb, jdepth = world["jrender"][name]
    np.testing.assert_allclose(rgb.numpy(), jrgb, atol=1e-6)
    np.testing.assert_allclose(depth.numpy(), jdepth, atol=1e-5)
    for k in (2, 4):
        for r in range(k):
            res = world["out"][k, r]
            np.testing.assert_allclose(res[f"render/{name}/rgb"],
                                       rgb.numpy(), atol=1e-6)
            np.testing.assert_allclose(res[f"render/{name}/depth"],
                                       depth.numpy(), atol=1e-5)
            np.testing.assert_allclose(res[f"render/{name}/rgb"], jrgb,
                                       atol=1e-6)
            np.testing.assert_allclose(res[f"render/{name}/depth"], jdepth,
                                       atol=1e-5)


def test_localizer_mesh(world):
    """Mode 0's particles and weights, the pose gradient (117 pixels,
    padded at k = 2) and one mode-1 step at k = 2 against k = 1."""
    one = world["out"][1, 0]
    for r in range(2):
        two = world["out"][2, r]
        np.testing.assert_array_equal(two["loc/poses"], one["loc/poses"])
        np.testing.assert_allclose(two["loc/weights"], one["loc/weights"],
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(two["loc/loss"], one["loc/loss"],
                                   rtol=1e-6)
        g = one["loc/grad"]
        assert np.abs(g).max() > 0
        np.testing.assert_allclose(two["loc/grad"], g, rtol=0,
                                   atol=1e-5 * np.abs(g).max())
        np.testing.assert_allclose(two["loc/step_pose"], one["loc/step_pose"],
                                   rtol=0, atol=1e-7)
        # particle 0 is the initial pose; the step moved it
        assert not np.array_equal(one["loc/step_pose"], one["loc/poses"][0])
        np.testing.assert_allclose(two["loc/render"], one["loc/render"],
                                   atol=1e-6)


# -- the trainer and the CLI ------------------------------------------------

def _log_lines(run: pathlib.Path) -> list[str]:
    return [line for line in (run / "train_log.txt").read_text().splitlines()
            if "Iter:" in line]


def test_trainer_mesh(world):
    """A k = 2 ``Trainer`` (grad_blocks = 4, 4 steps) holds the k = 1
    params bitwise on every rank; only rank 0 opened the log, which has
    one line a report; the run directory resumes on every rank and
    serves through ``Localizer.from_checkpoint``."""
    one = _leaves(world["out"][1, 0], "trainer/params/")
    for r in range(2):
        res = world["out"][2, r]
        two = _leaves(res, "trainer/params/")
        assert two.keys() == one.keys()
        for name, v in one.items():
            assert np.array_equal(two[name], v), (r, name)
        assert bool(res["trainer/log_open"]) == (r == 0)
        assert int(res["trainer/step"]) == 4
        assert res["trainer/resumed"] and res["trainer/resumed_equal"]
    run = world["root"] / "trainer_k2"
    assert [int(x.split("Iter:")[1].split()[0]) for x in _log_lines(run)] \
        == [2, 4]
    assert ckpt_lib.all_steps(run / "checkpoints") == [4]
    assert len(list((run / "images").glob("*.png"))) == 1
    loc = Localizer.from_checkpoint(run, device="cpu")
    for name, v in one.items():
        leaf = flatten(loc.params)[name]
        assert np.array_equal(leaf.numpy(), v), name
    img = loc.render_image(np.eye(3, 4, dtype=np.float32))
    assert img.shape == (16, 16, 3) and torch.isfinite(img).all()


def test_trainer_mesh_default_mode(world):
    """A k = 2 ``Trainer`` in default mode (grad_blocks = 0, what
    ``torchrun ... train`` runs), explore sparsity and occ_reg on over a
    grid that cuts rays (no warm-up), 4 steps, against k = 1 at the default-mode step tolerances: the last
    loss rtol 1e-5, the params atol 0.05 x the largest lr of the run."""
    tcfg = TConfig.from_dict(dataclasses.asdict(
        world["cfgs"]["trainer_default"]))
    assert tcfg.train.grad_blocks == 0
    assert tcfg.train.explore_sparsity_weight > 0
    assert tcfg.model.occ_explore_eps > 0
    lr_max = max(topt.lr_schedule(tcfg.train)(c) for c in range(4))
    assert lr_max > 0
    one = world["out"][1, 0]
    # the explore term's denominator: every step's explore samples, at
    # k = 1 and summed over the k = 2 ranks
    explore = one["trainer_default/explore"]
    assert len(explore) == 4 and (explore > 0).all()
    np.testing.assert_array_equal(
        world["out"][2, 0]["trainer_default/explore"]
        + world["out"][2, 1]["trainer_default/explore"], explore)
    for r in range(2):
        two = world["out"][2, r]
        assert int(two["trainer_default/step"]) == 4
        np.testing.assert_allclose(two["trainer_default/loss"],
                                   one["trainer_default/loss"], rtol=1e-5)
        ref = _leaves(one, "trainer_default/params/")
        got = _leaves(two, "trainer_default/params/")
        assert got.keys() == ref.keys()
        for name, v in ref.items():
            np.testing.assert_allclose(got[name], v, rtol=0,
                                       atol=0.05 * lr_max,
                                       err_msg=f"rank {r} {name}")


def test_cli_torchrun_train(world):
    """``torchrun --nproc_per_node=2 -m f2nerf_tpu_torch.apps.main train``
    on the CPU (gloo) writes one run directory whose ``state.pt`` holds
    the in-process trainer's params bitwise (grad_blocks = 4) and which
    ``from_checkpoint`` serves."""
    run = world["cli_run"]
    ref = _leaves(world["out"][1, 0], "trainer/params/")
    assert len(_log_lines(run)) == 2
    state = ckpt_lib.restore(run / "checkpoints")
    assert state["step"] == 4 and set(state["params"]) == set(ref)
    for name, v in ref.items():
        assert np.array_equal(state["params"][name].numpy(), v), name
    loc = Localizer.from_checkpoint(run, device="cpu")
    img = loc.render_image(load_dataset(world["data"]).poses[0])
    assert img.shape == (16, 16, 3) and torch.isfinite(img).all()
