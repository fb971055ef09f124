"""Port parity: the training step (f2nerf_tpu_torch.train against
f2nerf_tpu.train) on the CPU, in fp32, with the JAX params converted by
f2nerf_tpu_torch.convert and the JAX step's own random draws injected
as a StepNoise.

Each run takes three consecutive steps of both trainers from the same
params, batch and occupancy grid (a fresh optimizer, so the first update
has lr 0 and the next two do not), and the tests compare, step by step:
the metrics, every grad leaf, every param after the update and the
occupancy grid.

Tolerances:
* metrics rtol 1e-5 (f32 reductions over the batch in another order);
* grads: atol 1e-3 x the leaf's largest |grad| in the first two steps,
  which start from the same params (the first update has lr 0), and
  1e-2 x in the third. The sums behind a grad (over every sample of the
  batch, and for the pool over thousands of f32 terms plus the halo
  transpose) cancel to ~1e-2 of their terms, so f32 rounding in another
  order shows at ~1e-4 of the largest grad (measured up to 2e-4); the
  third step starts from params that already differ by the rounding of
  one Adam step (below), which moves its grads ~10x more (measured up
  to 1.5e-3);
* params after an update: atol 0.05 x lr. An Adam step moves a param by
  about lr x m/sqrt(v) whatever the size of the grad, so a grad's
  relative error becomes the param's error in units of lr (measured up
  to 0.026 lr, on entries with grads near zero);
* occupancy grid rtol 1e-5 (densities of the same params).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from f2nerf_tpu.models import occupancy as jocc
from f2nerf_tpu.models import renderer as jrend
from f2nerf_tpu.models import warp as jwarp
from f2nerf_tpu.train.optim import lr_schedule as jlr_schedule
from f2nerf_tpu.train.optim import make_optimizer as jmake_optimizer
from f2nerf_tpu.train.step import make_train_step as jmake_train_step
from f2nerf_tpu_torch.convert import (flatten, occ_grid_from_numpy,
                                      opt_state_from_numpy, tree_from_numpy)
from f2nerf_tpu_torch.core.config import Config as TConfig
from f2nerf_tpu_torch.models import warp as twarp
from f2nerf_tpu_torch.train import optim as topt
from f2nerf_tpu_torch.train import step as tstep

N_IMAGES = 4
N_STEPS = 3


def jax_noise(jcfg, step, n_rays):
    """The JAX step's draws, rebuilt from its key schedule
    (step.py:230-233, renderer.py:112-113, occupancy.py:161, 240, 270,
    319, step.py:140-146), as a port StepNoise. With ``grad_blocks`` V
    the per-ray draws and the global-sparsity points are block b's, from
    ``fold_in(key, b)`` (step.py:188-190), concatenated (points stacked)
    in block order."""
    m = jcfg.model
    key = jax.random.fold_in(jax.random.key(jcfg.train.seed),
                             jnp.uint32(step))
    refresh = None
    if m.sampler_mode == "occ":
        k_occ, key = jax.random.split(key)
        n_cells = m.occ_grid_res ** 3 // m.occ_refresh_phases
        refresh = jax.random.uniform(k_occ, (n_cells, 3))
    n_blocks = jcfg.train.grad_blocks
    if n_blocks > 0:
        blocks = [_ray_draws(jcfg, jax.random.fold_in(key, jnp.uint32(b)),
                             n_rays // n_blocks) for b in range(n_blocks)]
        draws = {name: None if blocks[0][name] is None else
                 (np.stack if name == "gs_points" else np.concatenate)(
                     [b[name] for b in blocks])
                 for name in blocks[0]}
    else:
        draws = _ray_draws(jcfg, key, n_rays)

    def t(x):
        return None if x is None else torch.tensor(np.asarray(x))

    return tstep.StepNoise(refresh=t(refresh),
                           **{name: t(x) for name, x in draws.items()})


def _ray_draws(jcfg, key, n_rays):
    """The renderer's and the global-sparsity term's draws from ``key``."""
    m = jcfg.model
    march = rank = within = explore = gs_points = None
    key_noise, key_bg = jax.random.split(key)
    bg = jax.random.uniform(key_bg, (n_rays, 3))
    if m.sampler_mode == "occ":
        k = key_noise
        if m.occ_explore_eps > 0.0:
            k, key_explore = jax.random.split(k)
            explore = jax.random.bernoulli(key_explore, m.occ_explore_eps,
                                           (n_rays, 1))
        key_rank, key_within = jax.random.split(k)
        rank = jax.random.uniform(key_rank, (n_rays, m.occ_keep))
        within = jax.random.uniform(
            key_within, (n_rays, m.occ_keep, m.occ_samples_per_segment))
    else:
        march = jax.random.uniform(key_noise, (n_rays, m.n_samples))
    if jcfg.train.global_sparsity_weight > 0.0:
        dom_r = 1.0 + m.contraction_radius
        gs_points = jax.random.uniform(
            jax.random.fold_in(key, 0x675),
            (jcfg.train.global_sparsity_points, 3), minval=-dom_r,
            maxval=dom_r)
    return {name: None if x is None else np.asarray(x)
            for name, x in dict(bg=bg, march=march, rank=rank, within=within,
                                explore=explore,
                                gs_points=gs_points).items()}


def _record():
    """An optax stage that passes the grads through and keeps them as
    its state, so the jitted JAX step hands its grads back."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (g, g))


def _setup(jcfg, seed):
    """Params with O(1) features, a batch, poses and an occupancy grid
    whose mean channel cuts rays (so explore slots have targets)."""
    params, _ = jrend.init(jax.random.key(seed), jcfg.model, N_IMAGES)
    tree = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(seed)
    tree["field"]["feat_pool"] = rng.uniform(
        -1.0, 1.0, tree["field"]["feat_pool"].shape).astype(np.float32)
    tree["field"]["mlp"]["b"] = tree["field"]["mlp"]["b"].copy()
    tree["field"]["mlp"]["b"][0] = 2.0
    poses = np.tile(np.eye(3, 4, dtype=np.float32)[None], (N_IMAGES, 1, 1))
    poses[:, :, 3] = rng.uniform(-0.3, 0.3, (N_IMAGES, 3))
    intr = np.tile(np.array([[12.0, 0, 8], [0, 12.0, 8], [0, 0, 1]],
                            np.float32)[None], (N_IMAGES, 1, 1))
    r = jcfg.train.rays_per_step
    batches = [(rng.integers(0, N_IMAGES, r).astype(np.int32),
                rng.integers(0, 16, (r, 2)).astype(np.int32),
                rng.random((r, 3)).astype(np.float32))
               for _ in range(N_STEPS)]
    g = jcfg.model.occ_grid_res
    thresh = jocc.sigma_threshold(jcfg.model)
    occ = (rng.random((g, g, g)) < 0.25).astype(np.float32)
    grid = np.stack([occ * 2 * thresh, occ * 2e3])
    return tree, poses, intr, batches, grid


def _run(jcfg, seed, step0, n_steps=N_STEPS):
    """n_steps of each trainer from the same state; per step the
    metrics, grads, params after the update, occ grid, and the JAX
    state (for the carried-state test). A perspective-warp config gets
    the warp tables of the poses, each package building its own."""
    tcfg = TConfig.from_dict(dataclasses.asdict(jcfg))
    tree, poses, intr, batches, grid = _setup(jcfg, seed)
    use_occ = jcfg.model.sampler_mode == "occ"
    jconsts, tconsts = {"field": {}}, {}
    if jcfg.model.warp_mode == "perspective":
        tables = jwarp.build_warp(poses, jcfg.model)
        jconsts = {"field": {"warp_anchors": tables.anchors,
                             "warp_rows": tables.rows}}
        tconsts = twarp.warp_consts(poses, tcfg.model, "cpu")

    jopt = optax.chain(_record(), jmake_optimizer(jcfg.train))
    jstep = jax.jit(jmake_train_step(jcfg, jopt))
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jopt.init(jparams)
    jgrid = jnp.asarray(grid) if use_occ else jnp.zeros((1,))

    tparams = tree_from_numpy(tree, "cpu")
    opt = topt.make_optimizer(tparams, tcfg.train)
    tstep_fn = tstep.make_train_step(tcfg, opt)
    tgrid = torch.tensor(grid) if use_occ else None
    tposes, tintr = torch.tensor(poses), torch.tensor(intr)

    out = {"jax": [], "port": [], "lr": []}
    for k in range(n_steps):
        step = step0 + k
        cam, ij, gt = batches[k % len(batches)]
        out["jax"].append(dict(params=jparams, state=jstate, grid=jgrid))
        jparams, jstate, jgrid, jm = jstep(
            jparams, jstate, jgrid, jconsts, jnp.asarray(poses),
            jnp.asarray(intr), jnp.asarray(step, jnp.int32),
            jnp.asarray(cam), jnp.asarray(ij), jnp.asarray(gt))
        grads = jstate[0]
        if jcfg.train.grad_clip_norm > 0.0:
            # the port's leaves hold the grads Adam consumes: clipped
            grads, _ = optax.clip_by_global_norm(
                jcfg.train.grad_clip_norm).update(grads, None)
        out["jax"][-1].update(
            metrics=np.array([float(x) for x in jm]),
            grads=flatten(jax.tree.map(np.asarray, grads)),
            new_params=flatten(jax.tree.map(np.asarray, jparams)),
            new_grid=np.asarray(jgrid))
        out["lr"].append(opt.adam.param_groups[0]["lr"])
        noise = jax_noise(jcfg, step, len(cam))
        tgrid, tm = tstep_fn(tparams, tgrid, tposes, tintr, step,
                             torch.tensor(cam), torch.tensor(ij),
                             torch.tensor(gt), noise=noise, consts=tconsts)
        out["port"].append(dict(
            metrics=np.array([float(x) for x in tm]),
            grads={n: p.grad.numpy().copy() for n, p in opt.named.items()},
            new_params={n: p.detach().numpy().copy()
                        for n, p in opt.named.items()},
            new_grid=None if tgrid is None else tgrid.numpy().copy()))
    out.update(jcfg=jcfg, tcfg=tcfg, poses=poses, intr=intr,
               batches=batches, step0=step0, use_occ=use_occ,
               tconsts=tconsts)
    return out


@pytest.fixture(scope="module")
def runs(tiny_cfg, occ_cfg):
    # tiny: dense sampler, steps 14-16 inside the weight-variance ramp;
    # occ: past occ_warmup_steps, fast refresh cadence (every step,
    # rotating phase), one explore slot of four
    return {"tiny": _run(tiny_cfg, seed=0, step0=14),
            "occ": _run(occ_cfg, seed=1, step0=600)}


@pytest.fixture(scope="module")
def optional_run(occ_cfg):
    """Every optional loss term and optimizer stage on at once."""
    cfg = dataclasses.replace(
        occ_cfg,
        model=dataclasses.replace(occ_cfg.model, occ_explore_eps=0.3),
        train=dataclasses.replace(
            occ_cfg.train, var_loss_mode="distortion",
            explore_sparsity_weight=1e-2, occ_reg_weight=1e-2,
            occ_reg_t=1.0, global_sparsity_weight=1e-2,
            global_sparsity_points=256, level_anneal_end=1200,
            loss_scale=128.0, grad_clip_norm=1e-3,
            feat_pool_weight_decay=1e-3, train_app_emb=False))
    return _run(cfg, seed=2, step0=300, n_steps=2)


def _runs(request, which):
    if which == "optional":
        return request.getfixturevalue("optional_run")
    return request.getfixturevalue("runs")[which]


WHICH = ["tiny", "occ", "optional"]


@pytest.mark.parametrize("which", WHICH)
def test_step_metrics(which, request):
    run = _runs(request, which)
    for k, (j, t) in enumerate(zip(run["jax"], run["port"])):
        np.testing.assert_allclose(t["metrics"], j["metrics"], rtol=1e-5,
                                   err_msg=f"step {k}")
        assert np.all(np.isfinite(t["metrics"]))


@pytest.mark.parametrize("which", WHICH)
def test_step_grads(which, request):
    run = _runs(request, which)
    for k, (j, t) in enumerate(zip(run["jax"], run["port"])):
        assert set(t["grads"]) == set(j["grads"])
        rel = 1e-3 if k < 2 else 1e-2
        for name, gj in j["grads"].items():
            scale = float(np.abs(gj).max())
            # app_emb gets no grad when train_app_emb is off
            assert scale > 0 or name == "app_emb", (k, name)
            np.testing.assert_allclose(t["grads"][name], gj, rtol=0,
                                       atol=rel * scale,
                                       err_msg=f"step {k} {name}")


@pytest.mark.parametrize("which", WHICH)
def test_step_params(which, request):
    run = _runs(request, which)
    lr_max = max(run["lr"])
    assert run["lr"][0] == 0.0 and lr_max > 0.0
    for k, (j, t) in enumerate(zip(run["jax"], run["port"])):
        before = flatten(jax.tree.map(np.asarray, j["params"]))
        for name, pj in j["new_params"].items():
            pt = t["new_params"][name]
            if k == 0:     # lr 0: no param moves
                np.testing.assert_array_equal(pt, before[name])
            np.testing.assert_allclose(pt, pj, rtol=0, atol=0.05 * lr_max,
                                       err_msg=f"step {k} {name}")
        if k > 0:          # and the updates did move them
            assert any(not np.array_equal(pj, before[n])
                       for n, pj in j["new_params"].items())


@pytest.mark.parametrize("which", ["occ", "optional"])
def test_step_occ_grid(which, request):
    run = _runs(request, which)
    for k, (j, t) in enumerate(zip(run["jax"], run["port"])):
        # the refresh ran this step: the grid moved
        assert not np.array_equal(t["new_grid"], np.asarray(j["grid"]))
        np.testing.assert_allclose(t["new_grid"], j["new_grid"], rtol=1e-5,
                                   atol=1e-7, err_msg=f"step {k}")


def test_converted_state_step(runs):
    """JAX takes two steps; its params, optimizer state and occupancy grid
    are carried across; both take the third step and agree."""
    run = runs["occ"]
    k = 2
    before = run["jax"][k]
    tparams = tree_from_numpy(jax.tree.map(np.asarray, before["params"]),
                                "cpu")
    opt = topt.make_optimizer(tparams, run["tcfg"].train)
    opt_state_from_numpy(opt, jax.tree.map(np.asarray, before["state"]))
    assert opt.count == 2
    step_fn = tstep.make_train_step(run["tcfg"], opt)
    cam, ij, gt = run["batches"][k]
    step = run["step0"] + k
    grid, m = step_fn(tparams, occ_grid_from_numpy(before["grid"], "cpu"),
                      torch.tensor(run["poses"]), torch.tensor(run["intr"]),
                      step, torch.tensor(cam), torch.tensor(ij),
                      torch.tensor(gt),
                      noise=jax_noise(run["jcfg"], step, len(cam)))
    ref = run["jax"][k]
    np.testing.assert_allclose([float(x) for x in m], ref["metrics"],
                               rtol=1e-5)
    np.testing.assert_allclose(grid.numpy(), ref["new_grid"], rtol=1e-5,
                               atol=1e-7)
    # the update from the carried state: the same as JAX's third, and
    # as close as the port's own (which took the first two itself)
    for name, p in opt.named.items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   ref["new_params"][name], rtol=0,
                                   atol=0.05 * max(run["lr"]), err_msg=name)


def test_lr_factor_matches_jax(tiny_cfg):
    t = dataclasses.replace(tiny_cfg.train, end_iter=100,
                            learning_rate_warm_up_end_iter=10)
    tt = TConfig.from_dict(dataclasses.asdict(
        dataclasses.replace(tiny_cfg, train=t))).train
    sched_j, sched_t = jlr_schedule(t), topt.lr_schedule(tt)
    for count in (0, 1, 5, 10, 11, 55, 100):
        np.testing.assert_allclose(sched_t(count), float(sched_j(count)),
                                   rtol=1e-6, atol=0, err_msg=str(count))
    assert topt.lr_factor(tt, 0) == 0.0
    assert topt.lr_factor(tt, 10) == 1.0
    np.testing.assert_allclose(topt.lr_factor(tt, 100), t.learning_rate_alpha,
                               rtol=1e-12)


def test_optimizer_counts_its_own_updates(tiny_cfg):
    """The schedule follows the optimizer's update count, not the step:
    the first update has lr 0 (JAX scale_by_learning_rate's count)."""
    tcfg = TConfig.from_dict(dataclasses.asdict(tiny_cfg))
    p = {"field": {"feat_pool": torch.ones(2, 2), "mlp": {"w": torch.ones(3)}}}
    opt = topt.make_optimizer(p, tcfg.train)
    lrs = []
    for _ in range(3):
        lrs.append(opt.adam.param_groups[0]["lr"])
        for q in opt.named.values():
            q.grad = torch.ones_like(q)
        opt.step()
    assert lrs[0] == 0.0 and lrs[1] > 0.0 and opt.count == 3
    np.testing.assert_allclose(lrs[1], tcfg.train.learning_rate
                               / tcfg.train.learning_rate_warm_up_end_iter)
    # weight decay: the pool group has none, the rest 1e-6
    assert [g["weight_decay"] for g in opt.adam.param_groups] == [1e-6, 0.0]


def test_draw_noise_is_per_step(occ_cfg):
    """Draws depend on (seed, step) only; shapes follow the config; the
    refresh jitter exists exactly on refresh steps."""
    tcfg = TConfig.from_dict(dataclasses.asdict(occ_cfg))
    a = tstep.draw_noise(tcfg, 601, 32, torch.device("cpu"))
    tstep.draw_noise(tcfg, 7, 32, torch.device("cpu"))
    b = tstep.draw_noise(tcfg, 601, 32, torch.device("cpu"))
    for x, y in zip(a, b):
        assert (x is None and y is None) or torch.equal(x, y)
    m = tcfg.model
    assert a.rank.shape == (32, m.occ_keep)
    assert a.within.shape == (32, m.occ_keep, m.occ_samples_per_segment)
    assert a.march is None and a.explore is None and a.gs_points is None
    assert a.refresh.shape == (m.occ_grid_res ** 3 // 4, 3)
    # slow cadence after occ_refresh_warmup: every occ_update_every steps
    late = m.occ_refresh_warmup + 1
    assert tstep.refresh_phase(tcfg, late) is None
    assert tstep.draw_noise(tcfg, late, 8, torch.device("cpu")).refresh \
        is None
    assert tstep.refresh_phase(tcfg, 2048 + 4 * 3) == (2048 // 4 + 3) % 4
